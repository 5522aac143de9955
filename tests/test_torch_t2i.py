"""The port's text->image sampler against the JAX one, token for token.

Both samplers take the same numpy Gumbel arrays through the injected-noise
contract, run CFG 2.0 over a few maskgit steps on identical weights (the
tiny flagship-shaped DIT of tests/test_torch_dit.py, fp32 on both sides),
and must emit identical tokens, in float and in int8 W8A8 (the JAX tree
quantized by the JAX package and carried over, with the int8 vocab head of
the span-factored sampler). The conditioning-frozen variants (cached_cond,
cond_refresh 0, 1 and 2, a bf16 or an int8 KV cache, the distilled_stack
overlay) are held token for token too. The host-side schedule helpers are
held to the JAX ones exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.ops.quant import quantize_dit_params
from unidisc_tpu.sampling import sampler as jax_sampler
from unidisc_tpu.sampling.t2i_fast import \
    build_t2i_sampler as jax_build_t2i_sampler
from unidisc_tpu_torch.sampling import sampler
from unidisc_tpu_torch.sampling.t2i_fast import build_t2i_sampler
from test_torch_dit import B, TXT, IMG, configs, port_model, random_dit
from test_torch_quant import configs as int8_configs
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

STEPS = 5


def run_both(seed=0, int8=False, configs=configs, experiments=(),
             cached_cond=False, cond_refresh=0, **extra):
    over = {"sampling.predictor": "maskgit", "sampling.steps": STEPS,
            "sampling.cfg": 2.0, **extra}

    def make(**more):
        jcfg, tcfg = configs(**over, **more)
        return (jcfg.apply_experiments(*experiments),
                tcfg.apply_experiments(*experiments))

    jcfg, tcfg = make()
    m = jcfg.model
    jmodel, params = random_dit(m, seed=seed, compute_dtype=jnp.float32)
    if int8:
        params = quantize_dit_params(params)
        jcfg, tcfg = make(**{"model.quant": "int8"})
        m = jcfg.model
        jmodel = JaxDIT(m, compute_dtype=jnp.float32)
    steps = jcfg.sampling.steps
    rng = np.random.RandomState(seed)
    lt, li = m.txt_length, m.img_length
    txt = rng.randint(0, m.text_vocab_size - 1, (B, lt)).astype(np.int32)
    injected = {
        "gumbel_tok": rng.gumbel(size=(steps, B, li, m.image_vocab_size)
                                 ).astype(np.float32),
        "gumbel_conf": rng.gumbel(size=(steps, B, li)).astype(np.float32),
    }
    cached = dict(cached_cond=cached_cond, cond_refresh=cond_refresh)
    jsample = jax.jit(jax_build_t2i_sampler(jmodel, jcfg, inject_noise=True,
                                            return_trajectory=True,
                                            **cached))
    want, want_traj = jsample(params, jax.random.PRNGKey(0),
                              jnp.asarray(txt),
                              injected={k: jnp.asarray(v)
                                        for k, v in injected.items()})
    model = port_model(tcfg, params)
    sample = build_t2i_sampler(model, tcfg, inject_noise=True,
                               return_trajectory=True, device="cpu",
                               **cached)
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


CACHED_CASES = {
    # name: (int8, cond_refresh, extra overrides, experiments)
    "frozen": (False, 0, {}, ()),
    "refresh_1": (False, 1, {}, ()),
    "refresh_2": (False, 2, {}, ()),
    "int8_frozen": (True, 0, {}, ()),
    "int8_refresh_2": (True, 2, {}, ()),
    "int8_kv_cache_refresh_2": (True, 2, {"model.kv_cache_dtype": "int8"},
                                ()),
    "int8_kv_cache_frozen": (True, 0, {"model.kv_cache_dtype": "int8"}, ()),
    "distilled_stack": (False, 0, {}, ("distilled_stack",)),
    "int8_distilled_stack": (True, 0, {}, ("distilled_stack",)),
}
# Both packages round the timestep conditioning c to bf16 in the
# span-factored head, also for an fp32 model, so an fp32 ulp of the
# timestep MLP (summation order) can move c by one bf16 step and the image
# logits by ~1e-2 (measured 0.012-0.021 of a 2.6 scale, in the uncached
# sampler as well). A position whose two best Gumbel-perturbed candidates
# lie that close picks another token, and its confidence rank moves. In
# the float distilled_stack case (no CFG, dilation 2, 8 steps) one such
# tie falls at step 4, the first unrestricted step: 97.4% of the
# trajectory's tokens and 30 of the 32 final tokens agree; every other
# case agrees token for token.
CACHED_AGREE = {"distilled_stack": 0.95}


@pytest.mark.parametrize("case", list(CACHED_CASES))
def test_cached_cond_sampler_matches_jax_token_for_token(case):
    """Conditioning-frozen sampling (cached_cond) with the frozen text K/V
    (cond_refresh 0) and with cache refreshes every 1 and 2 steps, in float
    and in int8 W8A8 (plain products, unfused: the JAX fused prologue
    cannot run at this L), with a bf16 and an int8 KV cache, and under the
    distilled_stack overlay (no CFG, 8 steps, dilation 2): the trajectory
    and the tokens equal JAX's (see CACHED_AGREE for the one case held to
    an agreement share)."""
    int8, refresh, extra, experiments = CACHED_CASES[case]
    if int8:
        extra = {**extra, "model.quant_backend": "xla",
                 "model.quant_fused": False}
    want, want_traj, got, got_traj, tcfg = run_both(
        int8=int8, cached_cond=True, cond_refresh=refresh,
        experiments=experiments, **extra)
    assert got_traj.shape[0] == tcfg.sampling.steps
    assert got.nfe == int(want.nfe)
    agree = CACHED_AGREE.get(case)
    if agree is None:
        np.testing.assert_array_equal(got_traj.numpy(),
                                      np.asarray(want_traj))
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))
    else:
        assert (got_traj.numpy() == np.asarray(want_traj)).mean() >= agree
        assert (got.tokens.numpy() == np.asarray(want.tokens)).mean() \
            >= 0.9
    m = tcfg.model
    img = got.tokens.numpy()[:, TXT:]
    assert np.all((img >= m.text_vocab_size) & (img < m.vocab_size))


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_cond_refresh_1_equals_uncached_sampling(int8):
    """A cache rebuilt at every step is a full forward at every step: the
    tokens of cached_cond=False."""
    _, tcfg = configs(**{"sampling.predictor": "maskgit",
                         "sampling.steps": STEPS, "sampling.cfg": 2.0})
    from unidisc_tpu_torch.models.dit import DIT, randomize_
    from unidisc_tpu_torch.ops.quant import quantize_model
    model = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    randomize_(model, seed=11)
    if int8:
        tcfg, model = quantize_model(tcfg, model)
    m = tcfg.model
    rng = np.random.RandomState(12)
    txt = torch.from_numpy(rng.randint(0, m.text_vocab_size - 1, (B, TXT)))
    injected = {
        "gumbel_tok": torch.from_numpy(rng.gumbel(
            size=(STEPS, B, IMG, m.image_vocab_size)).astype(np.float32)),
        "gumbel_conf": torch.from_numpy(rng.gumbel(
            size=(STEPS, B, IMG)).astype(np.float32))}
    out = [build_t2i_sampler(model, tcfg, inject_noise=True,
                             return_trajectory=True, device="cpu",
                             **kw)(txt, injected=injected)
           for kw in (dict(), dict(cached_cond=True, cond_refresh=1))]
    (a, a_traj), (b, b_traj) = out
    assert torch.equal(a_traj, b_traj) and torch.equal(a.tokens, b.tokens)


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
