"""The port's scoring battery, rewards, auto-enhance, caption augmentation,
viz and profiling against the JAX package's.

Tolerances:
* numpy code copied with its random streams (caption_llm, the scoring
  inputs, the heuristic rewards, analyze_rewards, viz): exactly; PNGs are
  compared as decoded pixels (the port writes through utils/png.py, the
  JAX package through PIL).
* partial_remask and the auto-enhance selection under JAX's replayed
  draws and a deterministic fake sampler: masks and tokens exactly,
  rewards at 1e-6 (the JAX reward is float32, the port's float64).
* the model-likelihood rewards (sequence_nll on the tiny fp32 DIT of
  tests/test_torch_dit.py, JAX's draws replayed): rtol 1e-4, atol 1e-5,
  as tests/test_torch_eval.py holds sequence_nll.
* the end-to-end battery: the port's engine (its own seeded noise) writes
  the generations; the JAX package's generate_rewards scores the same
  directory: token_entropy and image_diversity exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dit import configs, port_model, random_dit
from test_torch_eval import jax_apply, nll_draws
from unidisc_tpu.eval import auto_enhance as jae
from unidisc_tpu.eval import rewards as jrewards
from unidisc_tpu.eval import scoring as jscoring
from unidisc_tpu.sampling.sampler import SampleResult as JaxResult
from unidisc_tpu.serving.engine import InferenceEngine as JaxEngine
from unidisc_tpu.tokenizers.image_codecs import get_codec as jax_codec
from unidisc_tpu.tokenizers.text import get_tokenizer as jax_tokenizer
from unidisc_tpu.utils import caption_llm as jcap
from unidisc_tpu.utils import viz as jviz
from unidisc_tpu_torch.device import cap_test_threads
from unidisc_tpu_torch.eval import auto_enhance, rewards, scoring
from unidisc_tpu_torch.eval.harness import model_apply_fn
from unidisc_tpu_torch.sampling.sampler import SampleResult
from unidisc_tpu_torch.serving.engine import InferenceEngine
from unidisc_tpu_torch.tokenizers.image_codecs import get_codec
from unidisc_tpu_torch.tokenizers.text import get_tokenizer
from unidisc_tpu_torch.utils import caption_llm, profiling, viz
from unidisc_tpu_torch.utils.png import decode_png

cap_test_threads()

RTOL, ATOL = 1e-4, 1e-5


def pil_pixels(path):
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def test_generate_input_equals_jax(tmp_path):
    jscoring.generate_input(tmp_path / "jax", num_pairs=3, image_size=64,
                            seed=1)
    scoring.generate_input(tmp_path / "port", num_pairs=3, image_size=64,
                           seed=1)
    pairs = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert pairs == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in pairs:
        want, got = tmp_path / "jax" / name, tmp_path / "port" / name
        for txt in ("caption.txt", "mask_caption.txt"):
            assert (got / txt).read_text() == (want / txt).read_text()
        for png in ("image.png", "mask.png"):
            np.testing.assert_array_equal(
                decode_png((got / png).read_bytes()), pil_pixels(want / png))
        np.testing.assert_array_equal(scoring._load_png(got / "image.png"),
                                      jscoring._load_png(want / "image.png"))


def test_masks_and_scenes_equal_jax():
    for seed in range(4):
        caption = "a red square on a blue background"
        assert scoring.mask_caption_spans(
            caption, np.random.default_rng(seed)) == \
            jscoring.mask_caption_spans(caption, np.random.default_rng(seed))
        np.testing.assert_array_equal(
            scoring.random_rect_mask(np.random.default_rng(seed), 64),
            jscoring.random_rect_mask(np.random.default_rng(seed), 64))
        for fn in ("_render_scene", "_render_scene_pos"):
            got = getattr(scoring, fn)(np.random.default_rng(seed), 32)
            want = getattr(jscoring, fn)(np.random.default_rng(seed), 32)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]


SCORING = {"model.text_vocab_size": 261, "model.image_vocab_size": 64,
           "model.length": 32, "model.txt_length": 16,
           "model.img_length": 16, "model.force_argmax_valid_indices": True,
           "model.dropout": 0.0, "sampling.steps": 2,
           "sampling.predictor": "maskgit"}


@pytest.fixture(scope="module")
def engines():
    """The JAX scoring engine of tests/test_scoring.py and the port's on
    the same weights and the dummy codec."""
    jcfg, tcfg = configs(**SCORING)
    jmodel, params = random_dit(jcfg.model, compute_dtype=jnp.float32)
    jeng = JaxEngine(jcfg, jmodel, params,
                     codec=jax_codec("dummy", image_size=64, vocab=64))
    teng = InferenceEngine(tcfg, port_model(tcfg, params),
                           codec=get_codec("dummy", image_size=64, vocab=64,
                                           device="cpu"), device="cpu")
    return jeng, teng


def test_battery_end_to_end(tmp_path, engines):
    jeng, eng = engines
    scoring.generate_input(tmp_path / "in", num_pairs=2, image_size=64,
                           seed=0)
    written = scoring.call_model(tmp_path / "in", tmp_path / "gen", eng,
                                 num_pairs=2, seed=0)
    assert len(written) == 2 * len(scoring.MODES)
    for d in written:
        assert decode_png((d / "image.png").read_bytes()).shape == \
            (64, 64, 3)
        assert (d / "caption.txt").exists()
        assert json.loads((d / "config.json").read_text())["mode"] in \
            scoring.MODES
    got = scoring.generate_rewards(tmp_path / "gen",
                                   tmp_path / "rewards.json", eng,
                                   batch_size=4)
    want = jscoring.generate_rewards(tmp_path / "gen",
                                     tmp_path / "jax_rewards.json", jeng,
                                     batch_size=4)
    assert set(got) == set(want) == {str(d.relative_to(tmp_path / "gen"))
                                     for d in written}
    for k, rec in got.items():
        assert rec["mode"] == want[k]["mode"]
        assert set(rec["rewards"]) == {"model_likelihood", "token_entropy",
                                       "image_diversity"}
        for name in ("token_entropy", "image_diversity"):
            assert rec["rewards"][name] == want[k]["rewards"][name]
        assert np.isfinite(rec["rewards"]["model_likelihood"])
    out = scoring.analyze_rewards(tmp_path / "rewards.json",
                                  output_file=tmp_path / "summary.json")
    assert out == jscoring.analyze_rewards(tmp_path / "rewards.json")
    assert set(out["summary"]) == set(scoring.MODES)
    for mode in out["summary"].values():
        assert all(s["n"] == 2 for s in mode["rewards"].values())


def test_scoring_cli(tmp_path):
    """The CLI's host commands; the engine-backed ones run on the card
    unless --device cpu is given (the presets' image spans are not square
    grids, so the battery itself runs above on a square one)."""
    scoring.main(["generate-input", str(tmp_path / "in"), "--num-pairs",
                  "2", "--image-size", "64", "--seed", "3"])
    assert len(list((tmp_path / "in").iterdir())) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            scoring.main(["call-model", "--input-dir", str(tmp_path / "in"),
                          "--output-dir", str(tmp_path / "gen")])
    recs = {f"{mode}__pair_{i:06d}": {"mode": mode, "rewards": {
        "token_entropy": float(i + j), "image_diversity": 0.5 * j}}
        for i in range(2) for j, mode in enumerate(scoring.MODES)}
    (tmp_path / "r.json").write_text(json.dumps(recs))
    scoring.main(["analyze-rewards", str(tmp_path / "r.json"),
                  "--output-file", str(tmp_path / "s.json")])
    assert json.loads((tmp_path / "s.json").read_text()) == \
        jscoring.analyze_rewards(tmp_path / "r.json")


# ---------------------------------------------------------------------------
# rewards
# ---------------------------------------------------------------------------

def test_reward_registry_equals_jax():
    rng = np.random.RandomState(0)
    batch = {"input_ids": rng.randint(0, 16, (3, 40)),
             "image_ids": rng.randint(0, 8, (3, 16))}
    for name, kw in (("token_entropy", {"vocab_size": 16}),
                     ("image_diversity", {})):
        np.testing.assert_array_equal(
            rewards.get_scorer(name, **kw)(batch),
            jrewards.get_scorer(name, **kw)(batch))
    mix = rewards.combine([rewards.get_scorer("token_entropy",
                                              vocab_size=16),
                           rewards.get_scorer("image_diversity")],
                          [1.0, 2.0])
    jmix = jrewards.combine([jrewards.get_scorer("token_entropy",
                                                 vocab_size=16),
                             jrewards.get_scorer("image_diversity")],
                            [1.0, 2.0])
    np.testing.assert_array_equal(mix(batch), jmix(batch))
    assert sorted(rewards._REGISTRY) == sorted(jrewards._REGISTRY)
    for name in ("clip", "dfn", "chameleon_perplexity"):
        with pytest.raises(RuntimeError, match="judge weights"):
            rewards.get_scorer(name)(batch)
    with pytest.raises(KeyError):
        rewards.get_scorer("nope")


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = configs(**{"model.force_argmax_valid_indices": True})
    jmodel, params = random_dit(jcfg.model, compute_dtype=jnp.float32)
    return jcfg, tcfg, jmodel, params, port_model(tcfg, params)


def token_rows(m, b, seed):
    rng = np.random.RandomState(seed)
    return np.concatenate(
        [rng.randint(0, m.text_vocab_size - 1, (b, m.txt_length)),
         rng.randint(m.text_vocab_size, m.vocab_size,
                     (b, m.img_length))], 1).astype(np.int32)


def test_model_likelihood_rewards_match_jax(tiny):
    jcfg, tcfg, jmodel, params, model = tiny
    m = jcfg.model
    toks = token_rows(m, 3, 0)
    rng = jax.random.PRNGKey(2)
    batch = {"input_ids": toks,
             "modality": np.concatenate([np.zeros((3, m.txt_length)),
                                         np.ones((3, m.img_length))],
                                        1).astype(np.int32)}
    apply_fn = model_apply_fn(tcfg, model)
    want = jrewards.get_scorer("model_likelihood", config=jcfg,
                               apply_fn=jax_apply(jmodel), params=params,
                               rng=rng)(batch)
    got = rewards.get_scorer("model_likelihood", config=tcfg,
                             apply_fn=apply_fn,
                             draws=nll_draws(rng, 4, toks.shape))(batch)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    want = jae.model_likelihood_reward(jcfg, jax_apply(jmodel), params,
                                       rng)(jnp.asarray(toks))
    got = auto_enhance.model_likelihood_reward(
        tcfg, apply_fn, draws=nll_draws(rng, 4, toks.shape))(toks)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# auto-enhance
# ---------------------------------------------------------------------------

B, TXT, IMG = 4, 16, 32
L, V = TXT + IMG, 40


def enhance_config():
    return configs(**{"model.length": L, "model.txt_length": TXT,
                      "model.img_length": IMG,
                      "model.text_vocab_size": 20,
                      "model.image_vocab_size": 20})


def remask_draws(key, b, **kw):
    """partial_remask's draws under JAX's key: split(key, 4) into the two
    rate normals and the two move uniforms."""
    k_t, k_i, k_ut, k_ui = jax.random.split(key, 4)
    as_t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    return {"txt_rate": as_t(jax.random.normal(k_t, (b, 1))),
            "img_rate": as_t(jax.random.normal(k_i, (b, 1))),
            "txt_move": as_t(jax.random.uniform(k_ut, (b, TXT))),
            "img_move": as_t(jax.random.uniform(k_ui, (b, IMG)))}


@pytest.mark.parametrize("low", [False, True])
def test_partial_remask_matches_jax(low):
    kw = dict(mean_img=0.75, std_img=0.04 / 1.645) if low else {}
    key = jax.random.PRNGKey(3)
    want = jae.partial_remask(key, 64, TXT, IMG, **kw)
    got = auto_enhance.partial_remask(64, TXT, IMG,
                                      draws=remask_draws(key, 64), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    keep = auto_enhance.partial_remask(
        256, TXT, IMG, torch.Generator().manual_seed(0)).numpy()
    txt_rate, img_rate = 1 - keep[:, :TXT].mean(), 1 - keep[:, TXT:].mean()
    assert 0.75 < txt_rate < 0.95 and img_rate > txt_rate


def fake_fill(x0, unmask):
    """A deterministic regeneration: each masked token from its row's
    first token and its position."""
    pos = np.arange(x0.shape[-1])
    return (x0[..., :1] * 3 + pos * 7 + 1) % V


def test_auto_enhance_matches_jax():
    jcfg, tcfg = enhance_config()
    k = 6

    def jsampler(params, rng, x0, unmask, modality):
        return JaxResult(tokens=jnp.where(unmask, x0, fake_fill(x0, unmask)),
                         nfe=jnp.int32(1))

    def sampler(x0, unmask, modality):
        return SampleResult(tokens=torch.where(
            unmask, x0, torch.as_tensor(fake_fill(x0.numpy(), None))),
            nfe=1)

    def reward_even(tokens):
        return (tokens % 2 == 0).mean(-1) if isinstance(tokens, jax.Array) \
            else (tokens % 2 == 0).double().mean(-1)

    tokens = np.random.RandomState(0).randint(0, V, (B, L)).astype(np.int32)
    key = jax.random.PRNGKey(1)
    best_j, rew_j = jae.build_auto_enhance(jsampler, jcfg, reward_even,
                                           n_candidates=k)(
        {}, key, jnp.asarray(tokens), jnp.zeros((B, L), jnp.int32))
    draws = [remask_draws(jax.random.split(c)[0], B)
             for c in jax.random.split(key, k)]
    best, rew = auto_enhance.build_auto_enhance(sampler, tcfg, reward_even,
                                                n_candidates=k)(
        tokens, np.zeros((B, L), np.int32), draws=draws)
    np.testing.assert_array_equal(best.numpy(), np.asarray(best_j))
    np.testing.assert_allclose(rew.numpy(), np.asarray(rew_j), rtol=1e-6)
    assert (reward_even(best) >= reward_even(torch.as_tensor(tokens))).all()


def test_caption_enhance_matches_jax():
    txt, img = 24, 16
    over = {"model.length": txt + img, "model.txt_length": txt,
            "model.img_length": img, "model.text_vocab_size": 300,
            "model.image_vocab_size": 20}
    jcfg, tcfg = configs(**over)

    def jsampler(params, rng, x0, unmask, modality):
        return JaxResult(tokens=jnp.where(unmask, x0, fake_fill(x0, None)),
                         nfe=jnp.int32(1))

    def sampler(x0, unmask, modality):
        return SampleResult(tokens=torch.where(
            unmask, x0, torch.as_tensor(fake_fill(x0.numpy(), None))),
            nfe=1)

    def reward(tokens):
        return (tokens % 3 == 0).mean(-1) if isinstance(tokens, jax.Array) \
            else (tokens % 3 == 0).double().mean(-1)

    jtok, tok = jax_tokenizer("byte"), get_tokenizer("byte")
    txt_ids = tok(["a red boat", "one green tree"],
                  max_length=txt)["input_ids"]
    tokens = np.concatenate([txt_ids, np.random.RandomState(0).randint(
        300, 320, (2, img))], -1).astype(np.int32)
    best_j, rew_j, var_j = jae.build_caption_enhance(
        jsampler, jcfg, reward, jtok,
        jcap.get_caption_augmenter("procedural", n=6),
        max_augmentations=4)({}, jax.random.PRNGKey(0), jnp.asarray(tokens),
                             jnp.zeros_like(jnp.asarray(tokens)))
    best, rew, var = auto_enhance.build_caption_enhance(
        sampler, tcfg, reward, tok,
        caption_llm.get_caption_augmenter("procedural", n=6),
        max_augmentations=4)(tokens, np.zeros_like(tokens))
    assert var == var_j
    np.testing.assert_array_equal(best.numpy(), np.asarray(best_j))
    np.testing.assert_allclose(rew.numpy(), np.asarray(rew_j), rtol=1e-6)


# ---------------------------------------------------------------------------
# caption_llm
# ---------------------------------------------------------------------------

CAPTIONS = ["a red sailboat on the blue ocean under one yellow sun",
            "a dog", "two cats at night in a kitchen", "x"]


@pytest.mark.parametrize("seed", [0, 3])
def test_caption_augmenters_equal_jax(seed):
    for cap in CAPTIONS:
        for n in (1, 6, 12):
            assert caption_llm.procedural_negatives(cap, n, seed) == \
                jcap.procedural_negatives(cap, n, seed)
    got = caption_llm.augment_batch(
        caption_llm.get_caption_augmenter("procedural", n=12, seed=seed),
        CAPTIONS, max_per_caption=5, shuffle_seed=seed)
    assert got == jcap.augment_batch(
        jcap.get_caption_augmenter("procedural", n=12, seed=seed),
        CAPTIONS, max_per_caption=5, shuffle_seed=seed)
    with pytest.raises(NotImplementedError):
        caption_llm.get_caption_augmenter("api")
    with pytest.raises(ValueError):
        caption_llm.get_caption_augmenter("nope")


def test_ar_augmenter_equals_jax():
    def fake_sample(tok):
        def sample(prompt_ids, n):
            rows = np.full((n, 16), tok.pad_token_id, np.int32)
            for i, s in enumerate(["blue boat", "red dog"]):
                enc = tok.encode(s, add_bos=False, add_eos=False)[:16]
                rows[i, :len(enc)] = enc
            return rows
        return sample

    jtok, tok = jax_tokenizer("byte"), get_tokenizer("byte")
    got = caption_llm.get_caption_augmenter(
        "ar", sample_text_fn=fake_sample(tok), tokenizer=tok, n=6)(
        CAPTIONS[0])
    want = jcap.get_caption_augmenter(
        "ar", sample_text_fn=fake_sample(jtok), tokenizer=jtok, n=6)(
        CAPTIONS[0])
    assert got == want and got[1] == "ar-elm" and len(got[0]) == 6


# ---------------------------------------------------------------------------
# viz and profiling
# ---------------------------------------------------------------------------

def test_viz_equals_jax(tmp_path):
    imgs = np.random.RandomState(0).uniform(-1, 1, (5, 8, 8, 3))
    for kw in ({}, {"cols": 2, "pad": 1}):
        np.testing.assert_array_equal(viz.image_grid(imgs, **kw),
                                      jviz.image_grid(imgs, **kw))
    got = viz.save_image_grid(imgs, str(tmp_path / "a" / "g.png"))
    want = jviz.save_image_grid(imgs, str(tmp_path / "b" / "g.png"))
    np.testing.assert_array_equal(decode_png(open(got, "rb").read()),
                                  pil_pixels(want))
    got = viz.save_denoising_strip(list(imgs[:3]), str(tmp_path / "s.png"))
    want = jviz.save_denoising_strip(list(imgs[:3]),
                                     str(tmp_path / "js.png"))
    np.testing.assert_array_equal(decode_png(open(got, "rb").read()),
                                  pil_pixels(want))
    np.testing.assert_array_equal(viz.token_heatmap(np.arange(32), 64, 4),
                                  jviz.token_heatmap(np.arange(32), 64, 4))
    assert viz.to_uint8(imgs).dtype == np.uint8


def test_profiler_writes_a_chrome_trace(tmp_path):
    prof = profiling.Profiler(str(tmp_path / "trace"), active_steps=2,
                              warmup_steps=1)
    times = {}
    x = torch.randn(64, 64)
    for _ in range(4):
        with profiling.annotate("eval_step"), \
                profiling.wall_timer("step", times):
            x = torch.tanh(x @ x)
        prof.step()
    prof.close()
    assert prof.trace_path is not None
    trace = json.loads(open(prof.trace_path).read())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "eval_step" in names and any("mm" in str(n) for n in names)
    assert times["step"] > 0
    if not torch.cuda.is_available():
        assert profiling.memory_stats() == {}
