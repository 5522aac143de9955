"""The port's FID statistics, evaluation harness and eval_run against the
JAX package's.

* eval/fid.py: the same float64 numpy code: RunningMoments, the Frechet
  distance, FIDMetric and pixel_stat_features equal to 1e-12.
* eval/harness.py on the tiny flagship-shaped DIT of
  tests/test_torch_dit.py, fp32 on both sides, JAX's draws replayed
  (fold_in / split derivations below): sequence_nll, zero_shot_similarity
  (five scorer settings) and the per-candidate scores of
  zero_shot_accuracy at rtol 1e-4, atol 1e-5 (two blocks and the head in
  another summation order, as tests/test_torch_train_step.py holds the
  loss); the infill battery's masks exactly and its tokens token for
  token; token_entropy exactly; generative_perplexity at 1e-5 (an fp32
  log-softmax and mean in another order).
* eval_run: a run dir that the port's Trainer wrote (tiny, CPU), evaluated
  by unidisc_tpu_torch.eval_run.main in fp32 (its dtype hook) with JAX's
  val draws (PRNGKey(i) a batch) and the sampler's noise injected; the JAX
  package's eval_run needs an Orbax checkpoint, so its steps are driven
  here on the same EMA weights (make_eval_step, build_sampler,
  token_entropy, the dummy codec, FIDMetric over random_conv_features, the
  judges). Every key of eval_results.json is compared: step, NFE and the
  token statistics exactly, val metrics at rtol 1e-4, the timings finite
  and positive, FID at rtol 1e-5 (fp32 features within 1e-6), the judge
  LM's perplexity and the CLIP score at 1e-4. mauve/score is held to the
  port's MAUVE of JAX's texts and JAX's features (1e-4): its k-means is
  not sklearn's (tests/test_torch_judges.py holds it to sklearn's), and 10
  unstructured texts in 2 buckets have several near-equal k-means optima
  between which MAUVE jumps (here sklearn's gives 0.278, the port's
  0.723), so sklearn's pick is no reference on this input.
"""

import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dit import configs, param_tree, port_model, random_dit
from test_torch_judges import write_assets
from test_torch_train_step import loss_draws
from unidisc_tpu.data.token_shards import (TokenShardDataset as JaxShards,
                                           WeightedDatasetSampler as
                                           JaxSampler)
from unidisc_tpu.eval import fid as jfid
from unidisc_tpu.eval import harness as jh
from unidisc_tpu.eval import judges as jjudges
from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.models.port import port_dit_state_dict
from unidisc_tpu.sampling import sampler as jax_sampler
from unidisc_tpu.tokenizers.image_codecs import get_codec as jax_codec
from unidisc_tpu.tokenizers.text import get_tokenizer as jax_tokenizer
from unidisc_tpu.training import train_state as jts
from unidisc_tpu_torch import eval_run
from unidisc_tpu_torch.data.synthetic import SyntheticDataLoader
from unidisc_tpu_torch.data.token_shards import write_shard
from unidisc_tpu_torch.device import cap_test_threads
from unidisc_tpu_torch.eval import fid, harness, judges
from unidisc_tpu_torch.serving.engine import restore_run
from unidisc_tpu_torch.training.trainer import Trainer

cap_test_threads()

RTOL, ATOL = 1e-4, 1e-5


# ---------------------------------------------------------------------------
# eval/fid.py
# ---------------------------------------------------------------------------

def test_fid_statistics_equal_jax():
    rng = np.random.RandomState(0)
    data = rng.randn(300, 6)
    got, want = fid.RunningMoments(6), jfid.RunningMoments(6)
    for chunk in np.array_split(data, 7):
        got.update(chunk)
        want.update(chunk)
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-12)
    np.testing.assert_allclose(got.cov, want.cov, rtol=1e-12)
    np.testing.assert_allclose(got.cov, np.cov(data.T), atol=1e-10)
    a = rng.randn(6, 6)
    cov = a @ a.T + np.eye(6)
    for shift in (0.0, 1.0):
        np.testing.assert_allclose(
            fid.frechet_distance(got.mean, got.cov, got.mean + shift, cov),
            jfid.frechet_distance(got.mean, got.cov, got.mean + shift, cov),
            rtol=1e-12, atol=1e-12)
    real = rng.rand(16, 16, 16, 3) * 2 - 1
    fake = np.clip(real + 0.3, -1, 1)
    np.testing.assert_array_equal(fid.pixel_stat_features(real),
                                  jfid.pixel_stat_features(real))
    metrics = []
    for mod in (fid, jfid):
        f = mod.FIDMetric(mod.pixel_stat_features, 96)
        f.update_real(real)
        f.update_fake(fake)
        metrics.append(f.compute())
    np.testing.assert_allclose(metrics[0], metrics[1], rtol=1e-12)


# ---------------------------------------------------------------------------
# eval/harness.py
# ---------------------------------------------------------------------------

def test_token_entropy_and_generative_perplexity_equal_jax():
    ids = np.random.RandomState(0).randint(0, 32, (4, 20))
    assert harness.token_entropy(ids, 32) == jh.token_entropy(ids, 32)
    logits = np.random.RandomState(1).randn(4, 20, 32).astype(np.float32)
    for eos in (None, 3):
        got = harness.generative_perplexity(
            lambda x: torch.from_numpy(logits), ids, eos_id=eos)
        want = jh.generative_perplexity(lambda x: jnp.asarray(logits), ids,
                                        eos_id=eos)
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_speed_eval_keys_and_nfe():
    from unidisc_tpu_torch.sampling.sampler import SampleResult
    calls = []

    def fake(x):
        calls.append(x)
        return SampleResult(tokens=torch.zeros(2, 8, dtype=torch.long),
                            nfe=5)

    stats = harness.speed_eval(fake, (0,), iters=3, tokens_per_sample=8,
                               batch=2)
    assert set(stats) == {"p50_latency_s", "avg_time_per_sample",
                          "avg_time_per_token", "tokens_per_sec",
                          "avg_nfe_cnt"}
    assert stats["avg_nfe_cnt"] == 5.0 and len(calls) == 4
    assert all(v > 0 for v in stats.values())


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, JAX model, JAX params, port model) of the
    tiny flagship-shaped DIT, fp32."""
    jcfg, tcfg = configs(**{"model.force_argmax_valid_indices": True})
    jmodel, params = random_dit(jcfg.model, compute_dtype=jnp.float32)
    return jcfg, tcfg, jmodel, params, port_model(tcfg, params)


def pair_batch(m, seed, b=3):
    rng = np.random.RandomState(seed)
    txt = m.txt_length
    ids = np.concatenate([rng.randint(0, m.text_vocab_size - 1, (b, txt)),
                          rng.randint(m.text_vocab_size, m.vocab_size,
                                      (b, m.length - txt))], 1)
    ids[:, 2] = 0              # a pad id in every row
    modality = np.concatenate([np.zeros((b, txt)),
                               np.ones((b, m.length - txt))], 1)
    return {"input_ids": ids.astype(np.int32),
            "modality": modality.astype(np.int32)}


def q_xt_move(key, shape):
    """The "move" uniforms of JAX's q_xt(key, ...)."""
    return torch.from_numpy(np.asarray(
        jax.random.uniform(jax.random.split(key, 3)[0], shape)))


def nll_draws(rng, n, shape):
    """sequence_nll's: rng, k = split(rng) a timestep, q_xt(k)."""
    out = []
    for _ in range(n):
        rng, k = jax.random.split(rng)
        out.append({"move": q_xt_move(k, shape)})
    return out


def similarity_draws(rng, n, shape):
    """zero_shot_similarity's: q_xt(fold_in(rng, i))."""
    return [{"move": q_xt_move(jax.random.fold_in(rng, i), shape)}
            for i in range(n)]


def jax_apply(jmodel):
    return lambda p, x, s, mod: jmodel.apply({"params": p}, x, s,
                                             modality=mod)


def test_sequence_nll_matches_jax(tiny):
    jcfg, tcfg, jmodel, params, model = tiny
    batch = pair_batch(jcfg.model, 0)
    rng = jax.random.PRNGKey(3)
    want = jh.sequence_nll(jcfg, jax_apply(jmodel), params,
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           rng, n_timesteps=4)
    got = harness.sequence_nll(
        tcfg, harness.model_apply_fn(tcfg, model), None,
        {k: torch.from_numpy(v) for k, v in batch.items()}, n_timesteps=4,
        draws=nll_draws(rng, 4, batch["input_ids"].shape))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


SIMILARITY = {"plain": {}, "cfg": {"cfg_w": 2.0},
              "img_cond_unweighed": {"txt_cond": False, "unweighed": True},
              "unconditional": {"do_unconditional": True},
              "forced_cfg": {"cfg_w": 1.5, "force_cfg_value": True}}


@pytest.mark.parametrize("name", sorted(SIMILARITY))
def test_zero_shot_similarity_matches_jax(tiny, name):
    jcfg, tcfg, jmodel, params, model = tiny
    batch = pair_batch(jcfg.model, 1)
    rng = jax.random.PRNGKey(5)
    kw = dict(n_timesteps=3, **SIMILARITY[name])
    want = jh.zero_shot_similarity(
        jcfg, jax_apply(jmodel), params,
        {k: jnp.asarray(v) for k, v in batch.items()}, rng, **kw)
    got = harness.zero_shot_similarity(
        tcfg, harness.model_apply_fn(tcfg, model), None,
        {k: torch.from_numpy(v) for k, v in batch.items()},
        draws=similarity_draws(rng, 3, batch["input_ids"].shape), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("scorer", ["similarity", "nelbo"])
def test_zero_shot_accuracy_matches_jax(tiny, scorer):
    """Every candidate under the same noise, as JAX scores them all under
    one key; the accuracy is then the same argmin over equal scores."""
    jcfg, tcfg, jmodel, params, model = tiny
    sets = [{"candidates": [pair_batch(jcfg.model, s) for s in (2, 3, 4)]}]
    rng = jax.random.PRNGKey(7)
    shape = sets[0]["candidates"][0]["input_ids"].shape
    draws = similarity_draws(rng, 2, shape) if scorer == "similarity" \
        else nll_draws(rng, 8, shape)
    kw = {"n_timesteps": 2} if scorer == "similarity" else {}
    want = jh.zero_shot_accuracy(
        jcfg, jax_apply(jmodel), params, rng,
        [{"candidates": [{k: jnp.asarray(v) for k, v in c.items()}
                         for c in s["candidates"]]} for s in sets],
        scorer=scorer, **kw)
    got = harness.zero_shot_accuracy(
        tcfg, harness.model_apply_fn(tcfg, model), None, 0,
        [{"candidates": [{k: torch.from_numpy(v) for k, v in c.items()}
                         for c in s["candidates"]]} for s in sets],
        scorer=scorer, draws=draws, **kw)
    assert got == want


def test_infill_battery_matches_jax(tiny):
    jcfg, tcfg, jmodel, params, model = tiny
    m = jcfg.model
    steps, b = 3, 3
    cfg_over = {"sampling.predictor": "maskgit", "sampling.steps": steps,
                "model.force_argmax_valid_indices": True}
    jc, tc = configs(**cfg_over)
    batch = pair_batch(m, 8, b)
    batch["input_ids"][:, 5] = m.text_vocab_size - 2      # an EOS at 5
    rng = np.random.RandomState(9)
    injected = {"exp": rng.exponential(size=(steps, b, m.length,
                                             m.vocab_size)).astype(
                                                 np.float32),
                "gumbel": rng.gumbel(size=(steps, b, m.length)).astype(
                    np.float32)}
    jsample = jax.jit(jax_sampler.build_sampler(jax_apply(jmodel), jc,
                                                inject_noise=True))
    key = jax.random.PRNGKey(11)
    want = jh.infill_battery(
        lambda r, x0, unmask, mod: jsample(
            params, r, x0, unmask, mod,
            injected={k: jnp.asarray(v) for k, v in injected.items()}),
        batch, jc, key)
    # JAX's draws: split(rng, 3) into the text, square and sample keys
    k_txt, k_sq, _ = jax.random.split(key, 3)
    k_d, k_s = jax.random.split(jax.random.fold_in(k_txt, 1))
    kd, ki, kj = jax.random.split(k_sq, 3)
    side = int(m.img_length ** 0.5)
    as_t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    draws = {"move": as_t(jax.random.uniform(k_txt, (b, m.length))),
             "region_d": as_t(jax.random.uniform(k_d, (b,))),
             "region_start": as_t(jax.random.uniform(k_s, (b,))),
             "square_d": as_t(jax.random.randint(kd, (b, 1, 1), side // 2,
                                                 side - 1)).reshape(b),
             "square_i": as_t(jax.random.uniform(ki, (b, 1, 1))).reshape(b),
             "square_j": as_t(jax.random.uniform(kj, (b, 1, 1))).reshape(b)}
    from unidisc_tpu_torch.sampling.sampler import build_sampler
    sample = build_sampler(model, tc, inject_noise=True, device="cpu")
    got = harness.infill_battery(
        lambda x0, unmask, mod: sample(
            x0, unmask, mod,
            injected={k: torch.from_numpy(v) for k, v in injected.items()}),
        batch, tc, draws=draws)
    for k in ("original", "masked", "regenerated", "mask"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert got["nfe"] == want["nfe"]
    assert got["masked_token_match"] == want["masked_token_match"]
    assert got["mask"][:, m.txt_length:].any() and got["mask"][:, :5].any()


# ---------------------------------------------------------------------------
# eval_run
# ---------------------------------------------------------------------------

EVAL_B, EVAL_STEPS = 4, 3
TRAIN_OVER = {"sampling.predictor": "maskgit", "sampling.cfg": 2.0,
              "sampling.steps": EVAL_STEPS, "trainer.warmup_steps": 0,
              "trainer.lr": 1e-3, "trainer.ema_decay": 0.5,
              "model.force_argmax_valid_indices": True}
REF_TEXTS = ["a red cube", "a photo of a dog", "two cats on a mat",
             "the blue sky", "a small house", "a dog in the park"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A tiny run dir that the port's Trainer wrote (2 steps on the CPU),
    token shards, the FID and MAUVE references and a judge-asset dir
    (the CLIP and GPT-2 judges only: FID falls back to random_conv)."""
    root = tmp_path_factory.mktemp("eval_run")
    jcfg, tcfg = configs(**TRAIN_OVER)
    trainer = Trainer(tcfg, str(root / "run"), device="cpu", log_every=100)
    loader = SyntheticDataLoader(tcfg, EVAL_B, seed=1)
    trainer.fit(loader, max_steps=2)
    trainer.close()
    rows = next(SyntheticDataLoader(tcfg, 3 * EVAL_B, seed=2))
    write_shard(str(root / "shards"), rows["input_ids"], rows["modality"])
    np.save(root / "ref.npy", np.random.RandomState(3).uniform(
        -1, 1, (6, 64, 64, 3)).astype(np.float32))
    (root / "ref.txt").write_text("\n".join(REF_TEXTS) + "\n")
    write_assets(root / "assets", inception=False, hps=False,
                 aesthetic=False)
    return root, jcfg, tcfg


def eval_noise(m):
    rng = np.random.RandomState(4)
    return {"exp": rng.exponential(size=(EVAL_STEPS, EVAL_B, m.length,
                                         m.vocab_size)).astype(np.float32),
            "gumbel": rng.gumbel(size=(EVAL_STEPS, EVAL_B, m.length))
            .astype(np.float32)}


def port_eval(root, jcfg, *extra):
    injected = {k: torch.from_numpy(v) for k, v in
                eval_noise(jcfg.model).items()}
    return eval_run.main(
        ["--ckpt", str(root / "run"), "--data", str(root / "shards"),
         "--batch", str(EVAL_B), "--max-batches", "2", "--use-ema",
         "--codec", "dummy", "--image-size", "64", "--fid-ref",
         str(root / "ref.npy"), "--mauve-ref", str(root / "ref.txt"),
         "--device", "cpu", *extra],
        draws=lambda i, b: loss_draws(jax.random.PRNGKey(i), b,
                                      jcfg.model),
        injected=injected, dtype="float32")


def jax_eval(root, jcfg, assets=None, clip=False):
    """JAX eval_run's steps on the run dir's EMA weights."""
    m = jcfg.model
    _, weights, step = restore_run(str(root / "run"), ema=True)
    params = port_dit_state_dict(param_tree(m, jnp.float32),
                                 {k: v.numpy() for k, v in weights.items()})
    jmodel = JaxDIT(m, compute_dtype=jnp.float32)
    out = {"step": int(step)}
    loader = JaxSampler([JaxShards(str(root / "shards"))],
                        batch_size=EVAL_B, seed=7, shuffle=False)
    eval_step = jax.jit(jts.make_eval_step(jcfg, jmodel, use_ema=False))
    state = jts.init_train_state(jcfg, params)
    sums = np.zeros(6)
    for i, batch in enumerate(itertools.islice(loader, 2)):
        mt = eval_step(state, {k: jnp.asarray(v) for k, v in batch.items()
                               if hasattr(v, "shape")},
                       jax.random.PRNGKey(i))
        sums += np.asarray([mt.nll_sum, mt.token_count, mt.nll_txt_sum,
                            mt.txt_count, mt.nll_img_sum, mt.img_count],
                           np.float64)
    nll, ln2 = sums[0] / sums[1], np.log(2.0)
    out.update({"val/nll": nll, "val/bpd": nll / ln2,
                "val/ppl": float(np.exp(nll)),
                "val/txt_ppl": float(np.exp(sums[2] / sums[3])),
                "val/img_bpd": sums[4] / sums[5] / ln2})
    sample = jax.jit(jax_sampler.build_sampler(jax_apply(jmodel), jcfg,
                                               inject_noise=True))
    x0 = np.zeros((EVAL_B, m.length), np.int32)
    modality = np.concatenate([np.zeros((EVAL_B, m.txt_length), np.int32),
                               np.ones((EVAL_B, m.img_length), np.int32)],
                              -1)
    res = sample(params, jax.random.PRNGKey(0), x0, x0.astype(bool),
                 modality, injected={k: jnp.asarray(v) for k, v in
                                     eval_noise(m).items()})
    toks = np.asarray(res.tokens)
    out["avg_nfe_cnt"] = float(res.nfe)
    out["gen/token_entropy"] = jh.token_entropy(toks, m.vocab_size)
    out["gen/txt_vocab_respected"] = float(
        (toks[:, :m.txt_length] < m.text_vocab_size).mean())
    codec = jax_codec("dummy", image_size=64)
    imgs = np.asarray(codec.decode(codec.params, np.clip(
        toks[:, m.txt_length:] - m.text_vocab_size, 0,
        m.image_vocab_size - 1)))
    metric = jfid.FIDMetric(jjudges.random_conv_features(), 192)
    metric.update_real(np.load(root / "ref.npy"))
    metric.update_fake(imgs)
    out["fid/random_conv(seed7)"] = metric.compute()
    tok = jax_tokenizer()
    texts = [tok.decode(r[r < m.text_vocab_size - 1])
             for r in toks[:, :m.txt_length]]
    feat_fn = None
    if assets is not None:
        nll_fn, feat_fn = jjudges.judge_lm(str(assets / "gpt2-large"))
        out["gen/judge_ppl"] = float(np.exp(np.mean(nll_fn(texts))))
    out["mauve/features"] = "gpt2-large" if feat_fn else "bag_of_ngrams"
    # the port's MAUVE of JAX's texts and features (module docstring)
    out["mauve/score"] = judges.mauve_score(REF_TEXTS, texts,
                                            feature_fn=feat_fn)["mauve"]
    if clip:
        u8 = ((np.clip(imgs, -1, 1) + 1) * 127.5).astype(np.uint8)
        out["clip/score"] = float(np.mean(jjudges.clip_score_fn(
            str(assets / "clip-vit-large-patch14"))(u8, texts)))
    return out


TIMINGS = ("p50_latency_s", "avg_time_per_sample", "avg_time_per_token",
           "tokens_per_sec")
EXACT = ("step", "avg_nfe_cnt", "gen/token_entropy",
         "gen/txt_vocab_respected", "mauve/features")


def compare(got, want):
    assert set(got) == set(want) | set(TIMINGS), sorted(
        set(got) ^ (set(want) | set(TIMINGS)))
    for k in TIMINGS:
        assert np.isfinite(got[k]) and got[k] > 0, k
    for k, w in want.items():
        g = got[k]
        if k in EXACT:
            assert g == w, (k, g, w)
        elif k.startswith("fid/"):
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def test_eval_run_matches_jax_key_by_key(run):
    """No judge assets: FID on random_conv, MAUVE on bag-of-ngrams."""
    root, jcfg, _ = run
    got = port_eval(root, jcfg)
    compare(got, jax_eval(root, jcfg))
    assert got["mauve/features"] == "bag_of_ngrams"
    on_disk = json.loads((root / "run" / "eval_results.json").read_text())
    assert set(on_disk) == set(got)


def test_eval_run_with_judge_assets_matches_jax(run, monkeypatch):
    """The CLIP and GPT-2 judges from --assets (FID still falls back: no
    inception file there): MAUVE on GPT-2 features, the judge LM's
    perplexity and the CLIP score."""
    monkeypatch.delenv("UNIDISC_ASSETS", raising=False)
    root, jcfg, _ = run
    got = port_eval(root, jcfg, "--assets", str(root / "assets"), "--clip")
    compare(got, jax_eval(root, jcfg, root / "assets", clip=True))
    assert got["mauve/features"] == "gpt2-large"


def test_eval_run_val_nll_equals_trainer_validate(run):
    """bf16, the Trainer's own draws: eval_run's val metrics are the
    Trainer's validate on the same batches."""
    from unidisc_tpu_torch.data.token_shards import (TokenShardDataset,
                                                     WeightedDatasetSampler)
    root, _, tcfg = run
    got = eval_run.main(["--ckpt", str(root / "run"), "--data",
                         str(root / "shards"), "--batch", str(EVAL_B),
                         "--max-batches", "2", "--device", "cpu",
                         "--use-ema", "--gen-batches", "1"])
    trainer = Trainer(tcfg, str(root / "run"), device="cpu", log_every=100)
    assert trainer.maybe_restore() == 2
    want = trainer.validate(WeightedDatasetSampler(
        [TokenShardDataset(str(root / "shards"))], batch_size=EVAL_B,
        seed=7, shuffle=False), step=2, max_batches=2)
    trainer.close()
    for k in ("val/nll", "val/bpd", "val/ppl", "val/txt_ppl",
              "val/img_bpd"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert "fid/random_conv(seed7)" not in got and "mauve/score" not in got


def test_eval_run_needs_the_card_unless_asked(run):
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    root, _, _ = run
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_run.main(["--ckpt", str(root / "run")])
    assert os.path.exists(root / "run" / "checkpoints")
