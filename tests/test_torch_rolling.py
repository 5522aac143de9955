"""The port's rolling diffusion batching (serving/rolling.py) against the
JAX package's, on the tiny flagship-shaped DIT of tests/test_torch_dit.py
(fp32 on both sides, the same weights).

Mirrors tests/test_rolling.py's cases: under the same injected noise the
port's rolling samplers (generic and t2i) give JAX's tokens, token for
token, in lockstep, with ragged per-row steps and with staggered
admission, and a lockstep run gives the whole-batch sampler's tokens;
under the keyed noise a request's tokens do not depend on when it was
admitted or on the rows beside it (a solo run equals the staggered one);
padding rows are dropped; a one-step request reveals everything; the
threaded batchers give the state machine's rows, and a crashed worker or
a shutdown fails their futures. The device forms of the schedule and of
the guidance weight equal JAX's traced ones exactly.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.config import SamplingConfig as JaxSampling
from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.sampling import sampler as jax_sampler
from unidisc_tpu.serving import rolling as jax_rolling
from unidisc_tpu_torch.config import SamplingConfig
from unidisc_tpu_torch.sampling.sampler import (build_sampler,
                                                guidance_weight_t)
from unidisc_tpu_torch.sampling.t2i_fast import build_t2i_sampler
from unidisc_tpu_torch.serving.rolling import (RollingDiffusionBatcher,
                                               RollingT2IBatcher,
                                               adaptive_schedule_ragged,
                                               build_rolling_sampler,
                                               build_rolling_t2i,
                                               keyed_uniform)
from test_torch_dit import configs, param_tree, port_model, random_params
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

STEPS = 4
TIMEOUT = 60    # seconds a future may take; a fault fails, never hangs
OVER = {"sampling.predictor": "maskgit", "sampling.steps": STEPS,
        "sampling.cfg": 1.5, "model.force_argmax_valid_indices": True}

_MODELS = {}


def setup(**extra):
    """(JAX config, port config, JAX module, JAX params, port model)."""
    key = tuple(sorted(extra.items()))
    if key not in _MODELS:
        jcfg, tcfg = configs(**{**OVER, **extra})
        jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
        params = random_params(param_tree(jcfg.model, jnp.float32), seed=0)
        _MODELS[key] = (jcfg, tcfg, jmodel, params, port_model(tcfg, params))
    return _MODELS[key]


def jax_forward(jmodel):
    return lambda p, x, s, m: jmodel.apply({"params": p}, x, s, modality=m)


def rows(m, b, seed=0):
    """Text-conditioned rows: x0, unmask, modality (numpy)."""
    rng = np.random.RandomState(seed)
    x0 = np.zeros((b, m.length), np.int64)
    x0[:, :m.txt_length] = rng.randint(1, m.mask_index, (b, m.txt_length))
    unmask = np.zeros((b, m.length), bool)
    unmask[:, :m.txt_length] = True
    modality = np.concatenate([np.zeros((b, m.txt_length), np.int64),
                               np.ones((b, m.img_length), np.int64)], -1)
    return x0, unmask, modality


def generic_noise(m, slots, seed):
    rng = np.random.RandomState(seed)
    return {"exp": rng.exponential(size=(STEPS, slots, m.length,
                                         m.vocab_size)).astype(np.float32),
            "gumbel": rng.gumbel(size=(STEPS, slots, m.length)
                                 ).astype(np.float32)}


def t2i_noise(m, slots, seed):
    rng = np.random.RandomState(seed)
    li = m.img_length
    return {"gumbel_tok": rng.gumbel(size=(STEPS, slots, li,
                                           m.image_vocab_size)
                                     ).astype(np.float32),
            "gumbel_conf": rng.gumbel(size=(STEPS, slots, li)
                                      ).astype(np.float32)}


def finished(step, row_steps, extra, active):
    return bool(((step >= row_steps + extra) | ~active).all())


def drive(built, state, injected=None, max_chunks=32):
    """step_chunk until every active row is at its own finish line."""
    for _ in range(max_chunks):
        if finished(state.step, state.row_steps, built.extra, state.active):
            break
        built.step_chunk(state, injected)
    return state


def jax_drive(built, params, state, injected=None, max_chunks=32):
    for _ in range(max_chunks):
        if finished(np.asarray(state.step), np.asarray(state.row_steps),
                    built.extra, np.asarray(state.active)):
            break
        state = (built.step_chunk(params, state, injected)
                 if injected is not None else
                 built.step_chunk(params, state))
    return state


def as_jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def as_torch(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


# a staggered ragged run: (chunk of admission, slot, row, seed, steps)
ADMISSIONS = [(0, 0, 0, 10, 2), (1, 1, 1, 11, STEPS), (1, 2, 2, 12, 3)]


# ---------------------------------------------------------------------------
# lockstep, ragged and staggered parity under injected noise
# ---------------------------------------------------------------------------

def test_lockstep_parity_with_static_sampler_and_jax():
    """All slots admitted at once, injected noise: the port's rolling
    tokens equal its whole-batch sampler's and JAX's rolling ones."""
    jcfg, tcfg, jmodel, params, model = setup()
    m = tcfg.model
    B = 3
    x0, unmask, modality = rows(m, B)
    noise = generic_noise(m, B, seed=7)

    static = build_sampler(model, tcfg, inject_noise=True, device="cpu")
    want_static = static(torch.from_numpy(x0), torch.from_numpy(unmask),
                         torch.from_numpy(modality),
                         injected=as_torch(noise)).tokens

    jbuilt = jax_rolling.build_rolling_sampler(
        jax_forward(jmodel), jcfg, slots=B, chunk=2, inject_noise=True)
    jst = jbuilt.insert_many(jbuilt.init_state(), jnp.arange(B),
                             jnp.asarray(x0), jnp.asarray(unmask),
                             jnp.asarray(modality), jnp.zeros((B,), jnp.int32))
    jst = jax_drive(jbuilt, params, jst, as_jax(noise))

    built = build_rolling_sampler(model, tcfg, slots=B, chunk=2,
                                  inject_noise=True, device="cpu")
    st = built.insert_many(built.init_state(), np.arange(B), x0, unmask,
                           modality, np.zeros(B))
    st = drive(built, st, as_torch(noise))
    np.testing.assert_array_equal(st.x.numpy(), np.asarray(jst.x))
    np.testing.assert_array_equal(st.x.numpy(), want_static.numpy())
    assert st.step.tolist() == [STEPS + 1] * B


def test_staggered_ragged_rows_match_jax_under_injected_noise():
    """Rows admitted at different chunks with 2, 4 and 3 steps (and a
    padding row in one admission group): tokens and steps equal JAX's."""
    jcfg, tcfg, jmodel, params, model = setup()
    m = tcfg.model
    S = 4
    x0, unmask, modality = rows(m, 3, seed=5)
    unmask[2, 3:m.txt_length] = False          # a row that infills text
    noise = generic_noise(m, S, seed=9)
    jbuilt = jax_rolling.build_rolling_sampler(
        jax_forward(jmodel), jcfg, slots=S, chunk=1, inject_noise=True)
    built = build_rolling_sampler(model, tcfg, slots=S, chunk=1,
                                  inject_noise=True, device="cpu")
    jst, st = jbuilt.init_state(), built.init_state()
    for chunk in range(2):
        group = [a for a in ADMISSIONS if a[0] == chunk]
        slots = [a[1] for a in group] + [S]           # + a padding row
        idx = [a[2] for a in group] + [0]
        seeds = [a[3] for a in group] + [0]
        steps = [a[4] for a in group] + [STEPS]
        jst = jbuilt.insert_many(
            jst, jnp.asarray(slots), jnp.asarray(x0[idx]),
            jnp.asarray(unmask[idx]), jnp.asarray(modality[idx]),
            jnp.asarray(seeds, jnp.int32), jnp.asarray(steps, jnp.int32))
        built.insert_many(st, slots, x0[idx], unmask[idx], modality[idx],
                          seeds, steps)
        jst = jbuilt.step_chunk(params, jst, as_jax(noise))
        built.step_chunk(st, as_torch(noise))
    jst = jax_drive(jbuilt, params, jst, as_jax(noise))
    drive(built, st, as_torch(noise))
    np.testing.assert_array_equal(st.x.numpy(), np.asarray(jst.x))
    np.testing.assert_array_equal(st.step.numpy(), np.asarray(jst.step))
    np.testing.assert_array_equal(st.schedule.numpy(),
                                  np.asarray(jst.schedule))
    assert st.step.tolist()[:3] == [3, 5, 4]


def test_rolling_t2i_lockstep_parity_with_static_and_jax():
    """Rolling t2i, all admitted at once, injected noise: JAX's rolling
    t2i tokens and the port's whole-batch t2i sampler's."""
    jcfg, tcfg, jmodel, params, model = setup()
    m = tcfg.model
    B = 3
    txt = np.random.RandomState(2).randint(1, m.mask_index,
                                           (B, m.txt_length))
    noise = t2i_noise(m, B, seed=8)
    static = build_t2i_sampler(model, tcfg, inject_noise=True, device="cpu")
    want_static = static(torch.from_numpy(txt),
                         injected=as_torch(noise)).tokens
    jbuilt = jax_rolling.build_rolling_t2i(jmodel, jcfg, slots=B, chunk=2,
                                           inject_noise=True)
    jst = jbuilt.insert_many(jbuilt.init_state(), jnp.arange(B),
                             jnp.asarray(txt, jnp.int32),
                             jnp.zeros((B,), jnp.int32))
    jst = jax_drive(jbuilt, params, jst, as_jax(noise))
    built = build_rolling_t2i(model, tcfg, slots=B, chunk=2,
                              inject_noise=True, device="cpu")
    st = built.insert_many(built.init_state(), np.arange(B), txt,
                           np.zeros(B))
    st = drive(built, st, as_torch(noise))
    np.testing.assert_array_equal(st.x.numpy(), np.asarray(jst.x))
    np.testing.assert_array_equal(st.x.numpy(), want_static.numpy())


def test_rolling_t2i_staggered_ragged_rows_match_jax():
    jcfg, tcfg, jmodel, params, model = setup()
    m = tcfg.model
    S = 4
    txt = np.random.RandomState(4).randint(1, m.mask_index,
                                           (2, m.txt_length))
    noise = t2i_noise(m, S, seed=11)
    jbuilt = jax_rolling.build_rolling_t2i(jmodel, jcfg, slots=S, chunk=1,
                                           inject_noise=True)
    built = build_rolling_t2i(model, tcfg, slots=S, chunk=1,
                              inject_noise=True, device="cpu")
    jst = jbuilt.insert_many(jbuilt.init_state(), jnp.asarray([0]),
                             jnp.asarray(txt[:1], jnp.int32),
                             jnp.asarray([50], jnp.int32),
                             jnp.asarray([2], jnp.int32))
    st = built.insert_many(built.init_state(), [0], txt[:1], [50], [2])
    jst = jbuilt.step_chunk(params, jst, as_jax(noise))
    built.step_chunk(st, as_torch(noise))
    jst = jbuilt.insert_many(jst, jnp.asarray([1]),
                             jnp.asarray(txt[1:], jnp.int32),
                             jnp.asarray([51], jnp.int32),
                             jnp.asarray([STEPS], jnp.int32))
    built.insert_many(st, [1], txt[1:], [51], [STEPS])
    jst = jax_drive(jbuilt, params, jst, as_jax(noise))
    drive(built, st, as_torch(noise))
    np.testing.assert_array_equal(st.x.numpy(), np.asarray(jst.x))
    np.testing.assert_array_equal(st.step.numpy(), np.asarray(jst.step))
    # the text spans stay as given
    np.testing.assert_array_equal(st.x[:2, :m.txt_length].numpy(), txt)


# ---------------------------------------------------------------------------
# keyed noise: determinism under any admission timing
# ---------------------------------------------------------------------------

def solo_generic(built, x0, unmask, modality, r, seed, steps=None):
    st = built.insert_many(built.init_state(), [0], x0[r:r + 1],
                           unmask[r:r + 1], modality[r:r + 1], [seed],
                           None if steps is None else [steps])
    return drive(built, st).x[0].clone()


def test_rolling_rows_independent_of_admission_timing():
    """A request's tokens are a pure function of its seed and inputs:
    identical alone or admitted mid-flight beside rows at other steps."""
    _, tcfg, _, _, model = setup()
    m = tcfg.model
    x0, unmask, modality = rows(m, 3, seed=3)
    built = build_rolling_sampler(model, tcfg, slots=4, chunk=1,
                                  device="cpu")
    solos = [solo_generic(built, x0, unmask, modality, r, 10 + r)
             for r in range(3)]
    st = built.init_state()
    for r in range(3):
        built.insert_many(st, [r], x0[r:r + 1], unmask[r:r + 1],
                          modality[r:r + 1], [10 + r])
        built.step_chunk(st)
    drive(built, st)
    for r in range(3):
        assert torch.equal(st.x[r], solos[r])
    # another seed draws other noise
    assert not torch.equal(
        solo_generic(built, x0, unmask, modality, 0, 99), solos[0])


def test_mixed_step_counts_share_a_batch():
    """A 2-step and a 4-step request co-resident: each row equals its solo
    run at the same (seed, steps) and stops at its own finish line."""
    _, tcfg, _, _, model = setup()
    m = tcfg.model
    x0, unmask, modality = rows(m, 2, seed=9)
    built = build_rolling_sampler(model, tcfg, slots=4, chunk=1,
                                  device="cpu")
    ref_fast = solo_generic(built, x0, unmask, modality, 0, 30, 2)
    ref_full = solo_generic(built, x0, unmask, modality, 1, 31, STEPS)
    st = built.insert_many(built.init_state(), [0, 1], x0, unmask, modality,
                           [30, 31], [2, STEPS])
    drive(built, st)
    assert st.step.tolist()[:2] == [2 + 1, STEPS + 1]
    assert torch.equal(st.x[0], ref_fast) and torch.equal(st.x[1], ref_full)


def test_rolling_t2i_staggered_determinism_under_keyed_noise():
    _, tcfg, _, _, model = setup()
    m = tcfg.model
    txt = np.random.RandomState(4).randint(1, m.mask_index,
                                           (2, m.txt_length))
    built = build_rolling_t2i(model, tcfg, slots=4, chunk=1, device="cpu")

    def solo(r, seed, steps):
        st = built.insert_many(built.init_state(), [0], txt[r:r + 1],
                               [seed], [steps])
        return drive(built, st).x[0].clone()

    ref0, ref1 = solo(0, 50, 2), solo(1, 51, STEPS)
    st = built.insert_many(built.init_state(), [0], txt[:1], [50], [2])
    built.step_chunk(st)
    built.insert_many(st, [1], txt[1:], [51], [STEPS])
    drive(built, st)
    assert torch.equal(st.x[0], ref0) and torch.equal(st.x[1], ref1)
    assert not (st.x[:2, m.txt_length:] == m.mask_index).any()


def test_keyed_uniform_is_a_function_of_seed_step_tag_and_index():
    seed = torch.tensor([0, 1, 2 ** 31 - 1, 5])
    step = torch.tensor([0, 3, 7, 0])
    u = keyed_uniform(seed, step, 1, 1000)
    assert u.dtype == torch.float32 and u.shape == (4, 1000)
    assert float(u.min()) > 0 and float(u.max()) < 1
    assert abs(float(u.mean()) - 0.5) < 0.02
    # rows are independent of each other and of the row order
    again = keyed_uniform(seed.flip(0), step.flip(0), 1, 1000).flip(0)
    assert torch.equal(u, again)
    assert torch.equal(keyed_uniform(seed[1:2], step[1:2], 1, 10), u[1:2, :10])
    # every input moves the draw
    assert not torch.equal(keyed_uniform(seed, step, 2, 1000), u)
    assert not torch.equal(keyed_uniform(seed, step + 1, 1, 1000), u)
    assert (u[0] != u[3]).any()           # seed 0 vs 5 at the same step
    # the same bits on every call (integer ops only)
    assert torch.equal(keyed_uniform(seed, step, 1, 1000), u)


# ---------------------------------------------------------------------------
# the state machine's edges
# ---------------------------------------------------------------------------

def test_insert_padding_rows_dropped():
    _, tcfg, _, _, model = setup()
    m = tcfg.model
    built = build_rolling_sampler(model, tcfg, slots=4, chunk=1,
                                  device="cpu")
    x0, unmask, modality = rows(m, 2)
    st = built.insert_many(built.init_state(), [1, 4], x0, unmask, modality,
                           [5, 6])
    assert st.active.tolist() == [False, True, False, False]
    assert st.seed.tolist() == [0, 5, 0, 0]
    assert int(st.step[3]) == built.done_at       # slot S - 1 untouched
    with pytest.raises(ValueError, match="negative"):
        built.insert_many(st, [-1], x0[:1], unmask[:1], modality[:1], [0])


def test_steps_one_schedule_reveals_everything():
    """steps=1: the ragged schedule puts the whole budget on the single
    step (the 0/0 guard), and a one-step request finishes unmasked."""
    sche = adaptive_schedule_ragged(torch.tensor([16, 7]),
                                    torch.tensor([1, 1]), 4, "arccos")
    assert sche[:, 0].tolist() == [16, 7] and int(sche[:, 1:].sum()) == 0
    _, tcfg, _, _, model = setup()
    x0, unmask, modality = rows(tcfg.model, 1)
    built = build_rolling_sampler(model, tcfg, slots=2, chunk=2,
                                  device="cpu")
    st = built.insert_many(built.init_state(), [0], x0, unmask, modality,
                           [1], [1])
    drive(built, st)
    assert not (st.x[0] == tcfg.model.mask_index).any()


@pytest.mark.parametrize("over, match", [
    ({"sampling.predictor": "ddpm"}, "maskgit"),
    ({"sampling.cfg": -1}, "cfg == -1"),
])
def test_rejects_what_jax_refuses(over, match):
    _, tcfg, _, _, model = setup()
    tcfg = tcfg.override(**over)
    with pytest.raises(ValueError, match=match):
        build_rolling_sampler(model, tcfg, slots=2, device="cpu")
    with pytest.raises(ValueError, match=match):
        build_rolling_t2i(model, tcfg, slots=2, device="cpu")
    with pytest.raises(ValueError, match="dilated"):
        build_rolling_t2i(model, setup()[1].override(
            **{"sampling.maskgit_dilation": 2}), slots=2, device="cpu")


@pytest.mark.parametrize("mode", ["arccos", "cosine", "linear", "root",
                                  "square"])
def test_adaptive_schedule_ragged_matches_jax(mode):
    """Against JAX's traced function: every step count 1..32 as uniform
    rows, and ragged rows, each at several masked counts."""
    fn = jax.jit(jax_rolling.adaptive_schedule_ragged, static_argnums=(2, 3))
    num = np.asarray([256, 255, 100, 16, 7, 1, 0, 383])
    for steps in range(1, 33):
        steps_v = np.full(num.shape, steps)
        want = np.asarray(fn(jnp.asarray(num), jnp.asarray(steps_v), 32,
                             mode))
        got = adaptive_schedule_ragged(torch.from_numpy(num),
                                       torch.from_numpy(steps_v), 32, mode)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(steps))
    rng = np.random.RandomState(0)
    for _ in range(4):
        steps_v = rng.randint(1, 33, num.shape)
        want = np.asarray(fn(jnp.asarray(num), jnp.asarray(steps_v), 32,
                             mode))
        got = adaptive_schedule_ragged(torch.from_numpy(num),
                                       torch.from_numpy(steps_v), 32, mode)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [
    dict(cfg=None), dict(cfg=2.0), dict(cfg=-1),
    dict(cfg=3.0, cfg_min_timestep=0.2),
    dict(cfg=3.0, cfg_max_timestep=0.7),
    dict(cfg=3.0, cfg_min_timestep=0.2, cfg_max_timestep=0.7),
])
def test_device_guidance_weight_matches_jax(kw):
    """guidance_weight_t on per-row timesteps against JAX's
    guidance_weight on traced ones, bit for bit."""
    steps = np.asarray([4, 32, 8, 1, 32, 7])
    step = np.asarray([0, 31, 5, 1, 16, 6])
    t = np.where(step >= steps, 1e-5,
                 1.0 - step.astype(np.float32) * np.float32(1 - 1e-5)
                 / steps.astype(np.float32)).astype(np.float32)
    want = jax.jit(lambda t: jax_sampler.guidance_weight(
        JaxSampling(**kw), t))(jnp.asarray(t))
    got = guidance_weight_t(SamplingConfig(**kw), torch.from_numpy(t))
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the threaded front ends
# ---------------------------------------------------------------------------

def test_threaded_batcher_matches_state_machine():
    _, tcfg, _, _, model = setup()
    m = tcfg.model
    x0, unmask, modality = rows(m, 3, seed=5)
    built = build_rolling_sampler(model, tcfg, slots=4, chunk=2,
                                  device="cpu")
    want = [solo_generic(built, x0, unmask, modality, r, 20 + r).numpy()
            for r in range(3)]
    batcher = RollingDiffusionBatcher(model, tcfg, slots=4, chunk=2,
                                      device="cpu")
    try:
        batcher.warmup()
        futs = []
        for r in range(3):
            futs.append(batcher.submit(x0[r], unmask[r], modality[r],
                                       seed=20 + r))
            time.sleep(0.02)                  # staggered arrivals
        got = [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        batcher.shutdown()
    for r in range(3):
        np.testing.assert_array_equal(got[r], want[r])


def test_batcher_per_request_steps():
    _, tcfg, _, _, model = setup()
    m = tcfg.model
    x0, unmask, modality = rows(m, 2, seed=11)
    txt = x0[:, :m.txt_length]
    built = build_rolling_sampler(model, tcfg, slots=4, chunk=2,
                                  device="cpu")
    want = [solo_generic(built, x0, unmask, modality, 0, 40, 2).numpy(),
            solo_generic(built, x0, unmask, modality, 1, 41, STEPS).numpy()]
    t2i = build_rolling_t2i(model, tcfg, slots=4, chunk=2, device="cpu")
    st = t2i.insert_many(t2i.init_state(), [0], txt[:1], [42], [3])
    want_t2i = drive(t2i, st).x[0].numpy()
    batcher = RollingDiffusionBatcher(model, tcfg, slots=4, chunk=2,
                                      device="cpu")
    t2i_batcher = RollingT2IBatcher(model, tcfg, slots=4, chunk=2,
                                    device="cpu")
    try:
        f0 = batcher.submit(x0[0], unmask[0], modality[0], seed=40, steps=2)
        f1 = batcher.submit(x0[1], unmask[1], modality[1], seed=41)
        f2 = t2i_batcher.submit(txt[0], seed=42, steps=3)
        np.testing.assert_array_equal(f0.result(timeout=TIMEOUT), want[0])
        np.testing.assert_array_equal(f1.result(timeout=TIMEOUT), want[1])
        np.testing.assert_array_equal(f2.result(timeout=TIMEOUT), want_t2i)
        with pytest.raises(ValueError, match="steps"):
            batcher.submit(x0[0], unmask[0], steps=99)
    finally:
        batcher.shutdown()
        t2i_batcher.shutdown()


def test_worker_crash_fails_futures_not_hangs():
    """A device error in the worker fails every owned and pending future;
    the worker recovers and serves again."""
    _, tcfg, _, _, model = setup()
    x0, unmask, modality = rows(tcfg.model, 1)
    batcher = RollingDiffusionBatcher(model, tcfg, slots=2, chunk=2,
                                      device="cpu")
    try:
        chunk = batcher.step_chunk

        def exploding(*a, **k):
            raise RuntimeError("injected device failure")

        batcher.step_chunk = exploding
        fut = batcher.submit(x0[0], unmask[0], modality[0], seed=0)
        with pytest.raises(RuntimeError, match="injected device"):
            fut.result(timeout=TIMEOUT)
        assert not batcher.state.active.any()       # the state was reset
        batcher.step_chunk = chunk
        out = batcher.submit(x0[0], unmask[0], modality[0],
                             seed=0).result(timeout=TIMEOUT)
        assert out.shape == (tcfg.model.length,)
    finally:
        batcher.shutdown()


def test_shutdown_fails_outstanding_futures():
    _, tcfg, _, _, model = setup()
    x0, unmask, modality = rows(tcfg.model, 1)
    batcher = RollingDiffusionBatcher(model, tcfg, slots=2, chunk=1,
                                      device="cpu")
    fut = batcher.submit(x0[0], unmask[0], modality[0], seed=0)
    batcher.shutdown()
    try:
        assert fut.result(timeout=5).shape == (tcfg.model.length,)
    except RuntimeError as e:
        assert "shut down" in str(e)
    with pytest.raises(RuntimeError, match="shut down"):
        batcher.submit(x0[0], unmask[0], modality[0])


def test_engine_rolling_route():
    """InferenceEngine(rolling=N): text->image (the t2i batcher) and
    caption requests (the generic one) run through the rolling batchers
    with the JAX engine's row seeds, reproducibly; nfe is steps + 1."""
    from unidisc_tpu_torch.serving.engine import build_engine
    from test_torch_dit import OVERRIDES
    eng = build_engine(preset="tiny", device="cpu", rolling=4,
                       overrides={**OVERRIDES, **OVER,
                                  "model.text_vocab_size": 300})
    try:
        out = eng.run(text="a red square", seed=3)
        assert out["task"] == "gen_image" and out["nfe"] == STEPS + 1
        assert out["image_ids"].shape == (1, eng.m.img_length)
        assert (out["image_ids"] >= 0).all()
        again = eng.run(text="a red square", seed=3)
        np.testing.assert_array_equal(out["image_ids"], again["image_ids"])
        cap = eng.run(image_ids=np.arange(eng.m.img_length) % 7, seed=1,
                      steps=2)
        assert cap["task"] == "gen_text" and cap["nfe"] == 3
        assert set(eng._rolling) == {"t2i", "generic"}
        # the t2i row is the rolling t2i sampler's at the engine's row seed
        built = eng._rolling["t2i"].built
        p = eng.prepare(text="a red square")
        st = built.insert_many(built.init_state(), [0],
                               p["x0"][None, :eng.m.txt_length],
                               [(3 * 0x9E3779B1) & 0x7FFFFFFF])
        row = drive(built, st).x[0].numpy()
        np.testing.assert_array_equal(
            out["image_ids"][0], row[eng.m.txt_length:]
            - eng.m.text_vocab_size)
    finally:
        for b in eng._rolling.values():
            b.shutdown()
