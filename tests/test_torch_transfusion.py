"""The port's transfusion branch (models/continuous.py,
sampling/continuous.py) against JAX's.

A tiny DIT (fp32) wrapped by TransfusionDIT, 8 text + 16 image positions,
latent_dim 8, weights drawn from abstract shapes and carried over by
transfusion_state_dict_from_jax. The forward's logits and latent
prediction are held at the DIT file's tolerance (atol 2e-4, rtol 1e-3:
fp32 on both sides, summation order only); the transfusion mask exactly;
the DDIM trajectory (12 steps, the same starting noise: JAX's normal draw
from the sampler's key) at atol 1e-3, rtol 1e-3 on the final latents: each
step feeds the last one's latents back through the model, so the
per-step differences compound; the cosine schedule and the loss at
rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from unidisc_tpu.config import Config as JaxConfig
from unidisc_tpu.models import continuous as jcont
from unidisc_tpu.sampling import continuous as jscont
from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.device import cap_test_threads
from unidisc_tpu_torch.models.continuous import (TransfusionDIT,
                                                 transfusion_mask)
from unidisc_tpu_torch.models.port import transfusion_state_dict_from_jax
from unidisc_tpu_torch.sampling.continuous import (build_continuous_sampler,
                                                   continuous_image_loss,
                                                   cosine_alpha_bar)

cap_test_threads()

B, TXT, IMG, LD, STEPS = 2, 8, 16, 8, 12
L = TXT + IMG
ATOL, RTOL = 2e-4, 1e-3
OVER = {"model.length": L, "model.txt_length": TXT, "model.img_length": IMG,
        "model.text_vocab_size": 32, "model.image_vocab_size": 0,
        "model.time_conditioning": True, "model.dropout": 0.0,
        "model.qk_norm": True, "model.norm_type": "rms",
        "model.modality_embed": True, "model.zero_linear_init": False,
        "sampling.steps": STEPS}


def modality(text_only_row=False):
    mod = np.concatenate([np.zeros((B, TXT)), np.ones((B, IMG))],
                         1).astype(np.int32)
    if text_only_row:
        mod[1] = 0
    return mod


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JaxConfig.make("tiny", **OVER), Config.make("tiny", **OVER)
    jmodel = jcont.TransfusionDIT(jcfg.model, latent_dim=LD,
                                  compute_dtype=jnp.float32)
    mod = jnp.asarray(modality())
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.zeros((B, L), jnp.int32),
                              jnp.zeros((B, L, LD)), jnp.zeros((B,)), mod,
                              jcont.transfusion_mask(B, L, TXT, mod)
                              )["params"], jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    flat = {}
    for k, v in traverse_util.flatten_dict(shapes, sep="/").items():
        if k.endswith(("weight", "scale")):
            arr = 1.0 + 0.1 * rng.standard_normal(v.shape)
        else:
            fan = v.shape[-2] if len(v.shape) >= 2 else v.shape[-1]
            arr = rng.standard_normal(v.shape) / np.sqrt(fan)
        flat[k] = jnp.asarray(arr, jnp.float32)
    params = traverse_util.unflatten_dict(flat, sep="/")
    model = TransfusionDIT(tcfg.model, latent_dim=LD,
                           compute_dtype=torch.float32).eval()
    model.load_state_dict(transfusion_state_dict_from_jax(params))
    return jcfg, tcfg, jmodel, params, model


@pytest.mark.parametrize("text_only_row", [False, True])
def test_transfusion_mask_matches_jax(text_only_row):
    mod = modality(text_only_row)
    want = np.asarray(jcont.transfusion_mask(B, L, TXT, jnp.asarray(mod)))
    got = transfusion_mask(B, L, TXT, torch.from_numpy(mod)).numpy()
    np.testing.assert_array_equal(got, want)


def test_transfusion_forward_matches_jax(models):
    jcfg, _, jmodel, params, model = models
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 32, (B, L)).astype(np.int32)
    latents = rng.standard_normal((B, L, LD)).astype(np.float32)
    sigma = np.asarray([0.3, 0.9], np.float32)
    mod = modality()
    mask = jcont.transfusion_mask(B, L, TXT, jnp.asarray(mod))
    want_logits, want_pred = jmodel.apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(latents),
        jnp.asarray(sigma), jnp.asarray(mod), mask)
    with torch.no_grad():
        logits, pred = model(torch.from_numpy(ids).long(),
                             torch.from_numpy(latents),
                             torch.from_numpy(sigma),
                             torch.from_numpy(mod).long(),
                             torch.from_numpy(np.array(mask)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred),
                               atol=ATOL, rtol=RTOL)
    assert pred.dtype == torch.float32


def test_ddim_trajectory_matches_jax(models):
    jcfg, tcfg, jmodel, params, model = models
    ids = np.random.RandomState(2).randint(0, 32, (B, L)).astype(np.int32)
    mod = modality()
    key = jax.random.PRNGKey(4)

    def japply(p, ids, z, sigma, modality, mask):
        return jmodel.apply({"params": p}, ids, z, sigma, modality, mask)
    want = jax.jit(jscont.build_continuous_sampler(
        japply, jcfg, latent_dim=LD))(params, key, jnp.asarray(ids),
                                      jnp.asarray(mod))
    z0 = np.asarray(jax.random.normal(key, (B, L, LD)))
    got = build_continuous_sampler(model, tcfg, latent_dim=LD,
                                   device="cpu")(ids, mod,
                                                 z=torch.from_numpy(z0))
    want = np.asarray(want)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)
    assert (got.numpy()[:, :TXT] == 0).all()


def test_schedule_and_loss_match_jax():
    ts = np.linspace(0, 1, 11).astype(np.float32)
    np.testing.assert_allclose(
        cosine_alpha_bar(torch.from_numpy(ts)).numpy(),
        np.asarray(jscont.cosine_alpha_bar(jnp.asarray(ts))), rtol=1e-6,
        atol=1e-7)
    rng = np.random.RandomState(3)
    pred, tgt = (rng.standard_normal((B, L, LD)).astype(np.float32)
                 for _ in range(2))
    mod = modality(text_only_row=True)
    want = float(jscont.continuous_image_loss(jnp.asarray(pred),
                                              jnp.asarray(tgt),
                                              jnp.asarray(mod)))
    got = float(continuous_image_loss(torch.from_numpy(pred),
                                      torch.from_numpy(tgt),
                                      torch.from_numpy(mod)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
