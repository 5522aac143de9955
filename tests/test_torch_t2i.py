"""The port's text->image sampler against the JAX one, token for token.

Both samplers take the same numpy Gumbel arrays through the injected-noise
contract, run CFG 2.0 over a few maskgit steps on identical weights (the
tiny flagship-shaped DIT of tests/test_torch_dit.py, fp32 on both sides),
and must emit identical tokens, in float and in int8 W8A8 (the JAX tree
quantized by the JAX package and carried over, with the int8 vocab head of
the span-factored sampler). The host-side schedule helpers are held to the
JAX ones exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.models.dit import init_dit
from unidisc_tpu.ops.quant import quantize_dit_params
from unidisc_tpu.sampling import sampler as jax_sampler
from unidisc_tpu.sampling.t2i_fast import \
    build_t2i_sampler as jax_build_t2i_sampler
from unidisc_tpu_torch.sampling import sampler
from unidisc_tpu_torch.sampling.t2i_fast import build_t2i_sampler
from test_torch_dit import B, TXT, IMG, configs, port_model, random_params
from test_torch_quant import configs as int8_configs

STEPS = 5


def run_both(seed=0, int8=False, configs=configs, **extra):
    over = {"sampling.predictor": "maskgit", "sampling.steps": STEPS,
            "sampling.cfg": 2.0, **extra}
    jcfg, tcfg = configs(**over)
    m = jcfg.model
    jmodel, params = init_dit(jax.random.PRNGKey(seed), m,
                              compute_dtype=jnp.float32)
    params = random_params(params, seed=seed)
    if int8:
        params = quantize_dit_params(params)
        jcfg, tcfg = configs(**over, **{"model.quant": "int8"})
        m = jcfg.model
        jmodel = JaxDIT(m, compute_dtype=jnp.float32)
    rng = np.random.RandomState(seed)
    lt, li = m.txt_length, m.img_length
    txt = rng.randint(0, m.text_vocab_size - 1, (B, lt)).astype(np.int32)
    injected = {
        "gumbel_tok": rng.gumbel(size=(STEPS, B, li, m.image_vocab_size)
                                 ).astype(np.float32),
        "gumbel_conf": rng.gumbel(size=(STEPS, B, li)).astype(np.float32),
    }
    jsample = jax.jit(jax_build_t2i_sampler(jmodel, jcfg, inject_noise=True,
                                            return_trajectory=True))
    want, want_traj = jsample(params, jax.random.PRNGKey(0),
                              jnp.asarray(txt),
                              injected={k: jnp.asarray(v)
                                        for k, v in injected.items()})
    model = port_model(tcfg, params)
    sample = build_t2i_sampler(model, tcfg, inject_noise=True,
                               return_trajectory=True, device="cpu")
    got, got_traj = sample(torch.from_numpy(txt),
                           injected={k: torch.from_numpy(v)
                                     for k, v in injected.items()})
    return want, want_traj, got, got_traj, tcfg


@pytest.mark.parametrize("extra", [
    {},
    {"sampling.maskgit_dilation": 2},
    {"sampling.cfg_min_timestep": 0.3, "sampling.cfg_max_timestep": 0.9},
], ids=["cfg", "dilation", "cfg_window"])
def test_t2i_sampler_matches_jax_token_for_token(extra):
    want, want_traj, got, got_traj, tcfg = run_both(**extra)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_array_equal(got_traj.numpy(), np.asarray(want_traj))
    assert got.nfe == int(want.nfe)
    m = tcfg.model
    img = got.tokens.numpy()[:, TXT:]
    assert np.all((img >= m.text_vocab_size) & (img < m.vocab_size))


def test_int8_t2i_sampler_matches_jax_token_for_token():
    """int8 W8A8 with the plain products on the tiny model: token for
    token. (The JAX fused prologue cannot run at this L: its fallback for
    shapes that do not tile fails to broadcast the adaLN rows; see
    ROADMAP.md section 3.)"""
    want, want_traj, got, got_traj, tcfg = run_both(
        int8=True, **{"model.quant_backend": "xla",
                      "model.quant_fused": False})
    np.testing.assert_array_equal(got_traj.numpy(), np.asarray(want_traj))
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))


def test_int8_t2i_sampler_flagship_settings_agree_with_jax():
    """The flagship's int8 settings (every product through the int8
    kernel's path, the fused prologue) on the L 256 model of
    test_torch_quant.py, where the JAX side runs its Pallas kernels in
    interpret mode. Its logits agree with JAX's only at int8 grain there
    (test_torch_quant.py says why), which moves a token whose two best
    candidates lie closer than that: measured 4 of the 2,560 tokens of the
    5-step trajectory. Tolerance: >= 99% of the trajectory's tokens and of
    the final tokens equal."""
    want, want_traj, got, got_traj, tcfg = run_both(
        int8=True, configs=int8_configs, **{"model.quant_backend": "pallas",
                                            "model.quant_fused": True})
    assert (got_traj.numpy() == np.asarray(want_traj)).mean() >= 0.99
    assert (got.tokens.numpy() == np.asarray(want.tokens)).mean() >= 0.99
    m = tcfg.model
    img = got.tokens.numpy()[:, m.txt_length:]
    assert np.all((img >= m.text_vocab_size) & (img < m.vocab_size))


def test_sampler_draws_from_generator_without_injection():
    _, tcfg = configs(**{"sampling.predictor": "maskgit",
                         "sampling.steps": 3, "sampling.cfg": 2.0})
    from unidisc_tpu_torch.models.dit import DIT
    model = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    sample = build_t2i_sampler(model, tcfg, device="cpu")
    txt = torch.zeros((B, TXT), dtype=torch.long)
    a = sample(txt, generator=torch.Generator().manual_seed(3)).tokens
    b = sample(txt, generator=torch.Generator().manual_seed(3)).tokens
    assert torch.equal(a, b)
    assert not (a[:, TXT:] == tcfg.model.mask_index).any()


@pytest.mark.parametrize("mode", ["arccos", "cosine", "linear", "root",
                                  "square"])
@pytest.mark.parametrize("steps", [2, 7, 32, 128])
def test_adaptive_schedule_matches_jax(mode, steps):
    num = np.asarray([256, 16, 1, 100])
    want = np.asarray(jax_sampler.adaptive_schedule(jnp.asarray(num), steps,
                                                    mode))
    np.testing.assert_array_equal(sampler.adaptive_schedule(num, steps, mode),
                                  want)


def test_timesteps_match_jnp_linspace():
    for n in (2, 6, 9, 33, 129):
        np.testing.assert_array_equal(sampler.linspace_f32(1.0, 1e-5, n),
                                      np.asarray(jnp.linspace(1.0, 1e-5, n)))


def test_confidence_threshold_matches_jax():
    rng = np.random.RandomState(0)
    conf = rng.standard_normal((4, 20)).astype(np.float32)
    conf[1, 5:] = -np.inf
    num = np.asarray([3, 8, 0, 20], np.int32)
    want = np.asarray(jax_sampler.confidence_threshold(jnp.asarray(conf),
                                                       jnp.asarray(num)))
    got = sampler.confidence_threshold(torch.from_numpy(conf),
                                       torch.from_numpy(num)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(cfg=None), dict(cfg=2.0), dict(cfg=-1),
    dict(cfg=3.0, cfg_min_timestep=0.2),
    dict(cfg=3.0, cfg_max_timestep=0.7),
    dict(cfg=3.0, cfg_min_timestep=0.2, cfg_max_timestep=0.7),
])
def test_guidance_weight_matches_jax(kw):
    from unidisc_tpu.config import SamplingConfig as JaxSampling
    from unidisc_tpu_torch.config import SamplingConfig
    t = np.asarray([1.0, 0.75, 0.5, 0.1, 1e-5], np.float32)
    want = jax_sampler.guidance_weight(JaxSampling(**kw), jnp.asarray(t))
    got = sampler.guidance_weight(SamplingConfig(**kw), t)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, np.asarray(want))
