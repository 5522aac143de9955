"""The port's ``ar`` objective against the JAX package's, and a DIT-AR
trained by the port's Trainer and served from its run dir.

* compute_batch_loss with trainer.parameterization="ar" on a tiny causal
  DIT with the flagship's model flags (rms, QK-norm, sandwich norm,
  modality embedding, 2D rope, force_argmax_valid_indices; the
  ar_baseline overlay: causal, no time conditioning): plain, the row flip,
  ar_inpainting (with and without the flip), its forced rate and the
  modality dropout, with JAX's draws replayed: rtol 1e-4 / atol 1e-5, as
  tests/test_torch_train_step.py holds the subs losses.
* One whole train step with ar_inpainting and the flip against JAX's
  make_train_step, held as test_train_step_matches_jax holds subs. JAX's
  step fails in its metrics with a modality batch and ar_inpainting (it
  slices the (B, L) modality against the (B, 2L - 1) token mask); the test
  gives JAX's `_split_metrics` the doubled modality, as the port's does.
* A tiny DIT-AR trained by Trainer for 3 steps on token shards writes a
  run dir that build_engine(checkpoint=) serves through complete_text,
  with the trainer's final EMA as its weights.

The JAX draws: split(rng, 3) -> (t, mask, dropout) keys; the inpainting
rate draws from the t key, its mask from the mask key at (B, 2L); the flip
from fold_in(rng, 13), the modality dropout from fold_in(rng, 17).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dit import param_tree
from unidisc_tpu.config import Config as JaxConfig
from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.training import train_state as jts
from unidisc_tpu_torch.config import FLAGSHIP_TRAIN_OVERRIDES, Config
from unidisc_tpu_torch.data.token_shards import (TokenShardDataset,
                                                 WeightedDatasetSampler,
                                                 write_shard)
from unidisc_tpu_torch.models.dit import DIT
from unidisc_tpu_torch.models.port import (dit_state_dict_from_jax,
                                           train_state_from_jax)
from unidisc_tpu_torch.serving.engine import build_engine
from unidisc_tpu_torch.training import train_state as tts
from unidisc_tpu_torch.training.trainer import Trainer
from unidisc_tpu_torch.device import cap_test_threads

from test_torch_train_step import (B, IMG, RTOL, TXT, assert_tree_close,
                                   make_batch, random_params)

cap_test_threads()

L = TXT + IMG
AR = {
    **FLAGSHIP_TRAIN_OVERRIDES,
    "model.hidden_size": 128, "model.n_heads": 2, "model.n_blocks": 2,
    "model.cond_dim": 32, "model.length": L, "model.txt_length": TXT,
    "model.img_length": IMG, "model.text_vocab_size": 24,
    "model.image_vocab_size": 40, "model.zero_linear_init": False,
    "model.attn_backend": "xla",
    "trainer.parameterization": "ar", "trainer.ar_shift": True,
    "model.full_attention": False, "model.time_conditioning": False,
    "trainer.warmup_steps": 0, "trainer.lr": 1e-3,
    "trainer.ema_decay": 0.9, "trainer.weight_decay": 0.01,
    "trainer.opt_eps": 1e-4,
}


def configs(**extra):
    over = {**AR, **extra}
    return (JaxConfig.make("tiny", **over).validate(),
            Config.make("tiny", **over).validate())


def ar_draws(rng, b, m):
    """The draws of JAX compute_batch_loss(rng, ...) on the ar path."""
    rng_t, rng_mask, _ = jax.random.split(rng, 3)
    d = {"t": jax.random.uniform(rng_t, (b,)),
         "inpaint": jax.random.uniform(rng_mask, (b, 2 * m.length)),
         "flip": jax.random.uniform(jax.random.fold_in(rng, 13), (b,)),
         "ar_drop": jax.random.uniform(jax.random.fold_in(rng, 17), (b,))}
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = configs()
    return random_params(param_tree(jcfg.model, jnp.float32), seed=3)


AR_VARIANTS = {
    "plain": {},
    "flip": {"trainer.rand_flip_ar_prob": 0.5},
    "inpainting": {"trainer.ar_inpainting": True},
    "inpainting_flip": {"trainer.ar_inpainting": True,
                        "trainer.rand_flip_ar_prob": 0.5},
    "inpainting_force_val": {"trainer.ar_inpainting": True,
                             "trainer.ar_inpainting_force_val": 0.3},
    "modality_dropout": {"trainer.rand_ar_modality_dropout": 0.5},
    "no_restriction": {"model.force_argmax_valid_indices": False},
}


@pytest.mark.parametrize("variant,train", [
    *((v, True) for v in sorted(AR_VARIANTS)),
    # eval: no flip and no modality dropout
    ("flip", False), ("modality_dropout", False)])
def test_ar_batch_loss_matches_jax(jax_params, variant, train):
    jcfg, tcfg = configs(**AR_VARIANTS[variant])
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    batch = make_batch(jcfg.model, seed=5)
    rng = jax.random.PRNGKey(11)
    want = jts.compute_batch_loss(
        jcfg, jts.make_apply_fn(jcfg, jmodel), jax_params, rng,
        {k: jnp.asarray(v) for k, v in batch.items()}, train=train)
    model = DIT(tcfg.model, compute_dtype=torch.float32)
    model.load_state_dict(dit_state_dict_from_jax(jax_params))
    draws = ar_draws(rng, B, jcfg.model)
    with torch.no_grad():
        got = tts.compute_batch_loss(
            tcfg, tts.make_apply_fn(tcfg, model), None,
            {k: torch.from_numpy(v) for k, v in batch.items()}, train=train,
            draws=draws)
    if variant == "flip" and train:
        assert 0 < int((draws["flip"] < 0.5).sum()) < B  # some rows flip
    for name in got._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert tuple(g.shape) == w.shape, name
        if g.dtype == torch.bool:
            assert np.array_equal(g.numpy(), w), name
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=1e-5,
                                       err_msg=name)


def _doubling_split_metrics(out, modality, loss, grad_norm,
                            _orig=jts._split_metrics):
    if modality is not None and modality.shape[-1] < out.token_mask.shape[-1]:
        modality = jnp.concatenate([modality, modality], axis=-1)
    return _orig(out, modality, loss, grad_norm)


def test_ar_inpainting_train_step_matches_jax(jax_params, monkeypatch):
    monkeypatch.setattr(jts, "_split_metrics", _doubling_split_metrics)
    jcfg, tcfg = configs(**{"trainer.ar_inpainting": True,
                            "trainer.rand_flip_ar_prob": 0.5})
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    jstate = jts.init_train_state(jcfg, jax_params)
    batch = make_batch(jcfg.model, seed=6)
    rng = jax.random.PRNGKey(13)
    jnew, jm = jax.jit(jts.make_train_step(jcfg, jmodel))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)

    tcfg = dataclasses.replace(
        tcfg, model=dataclasses.replace(tcfg.model, attn_backend="auto"))
    model = DIT(tcfg.model, compute_dtype=torch.float32)
    state = tts.init_train_state(tcfg, model)
    state.load_state_dict(train_state_from_jax(jax.device_get(jstate)))
    state, m = tts.make_train_step(tcfg, model)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        draws=ar_draws(jax.random.fold_in(rng, 0), B, jcfg.model))

    want = train_state_from_jax(jax.device_get(jnew))
    got = state.state_dict()
    for key in ("step", "adam_count", "schedule_count"):
        assert int(got[key]) == int(want[key]) == 1, key
    for key in ("params", "mu", "nu", "ema_params"):
        assert_tree_close(got[key], want[key], key)
    for name in m._fields:
        np.testing.assert_allclose(float(getattr(m, name)),
                                   float(getattr(jm, name)), rtol=RTOL,
                                   atol=1e-6, err_msg=name)
    # only the clean half counts: L - 1 targets... of the 2L - 1 a row
    assert int(m.token_count) == B * L
    before = dit_state_dict_from_jax(jax_params)
    assert max(float((state.params[k].detach() - before[k]).abs().max())
               for k in before) > 1e-4


def test_trained_dit_ar_serves_from_its_run_dir(tmp_path):
    """ROADMAP item 5a's "done when": a tiny DIT-AR trained by the port's
    Trainer on token shards writes a run dir that build_engine serves
    through complete_text, with the trainer's final EMA."""
    over = {"model.length": 24, "model.txt_length": 8,
            "model.img_length": 16, "model.text_vocab_size": 300,
            "model.image_vocab_size": 40, "model.hidden_size": 64,
            "model.n_heads": 1, "model.n_blocks": 1, "model.dropout": 0.0,
            "model.modality_embed": True,
            "model.force_argmax_valid_indices": True,
            "trainer.warmup_steps": 1, "trainer.lr": 1e-3,
            "trainer.ar_inpainting": True, "trainer.rand_flip_ar_prob": 0.5}
    cfg = Config.make("tiny", **over).apply_experiments(
        "ar_baseline").validate()
    m = cfg.model
    rng = np.random.RandomState(0)
    n = 16
    tokens = np.concatenate(
        [rng.randint(4, 260, (n, m.txt_length)),
         rng.randint(m.text_vocab_size, m.vocab_size - 1,
                     (n, m.img_length))], 1).astype(np.int32)
    modality = np.concatenate([np.zeros((n, m.txt_length)),
                               np.ones((n, m.img_length))], 1)
    write_shard(str(tmp_path / "shards"), tokens, modality)
    loader = WeightedDatasetSampler([TokenShardDataset(
        str(tmp_path / "shards"))], batch_size=4, seed=1)
    run = str(tmp_path / "run")
    trainer = Trainer(cfg, run, device="cpu", log_every=1, ckpt_every=0)
    result = trainer.fit(loader, max_steps=3)
    final_ema = {k: v.detach().clone()
                 for k, v in trainer.state.ema_params.items()}
    trainer.close()
    assert result["step"] == 3 and np.isfinite(result["loss"])

    eng = build_engine(checkpoint=run, device="cpu")
    try:
        served = eng.model.state_dict()
        for k, v in final_ema.items():
            assert torch.equal(served[k].float(), v), k
        got = eng.complete_text("\x01\x02\x03", max_new_tokens=6,
                                seed=2).result(timeout=120)
        assert 1 <= len(got["tokens"]) <= 6
        assert all(0 <= t < m.text_vocab_size for t in got["tokens"])
        assert isinstance(got["text"], str)
    finally:
        if eng._continuous is not None:
            eng._continuous.shutdown()
