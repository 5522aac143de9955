"""The port's optimizer, loss and train step against the JAX package's.

* make_lr_schedule: all four schedules against the JAX (optax) schedules
  at the start, in and at the end of warmup, and beyond: rtol 1e-6 with
  an absolute floor of 1e-6 x the peak LR (both sides compute in fp32,
  and the last place of cos or of 1 - count / steps is a large relative
  error of an LR near 0).
* The optimizer against optax.chain(clip_by_global_norm, adamw) over 3
  steps, with the clip triggered and not: rtol 1e-5.
* compute_batch_loss with injected draws in every ported branch (the
  ``ar`` ones in tests/test_torch_ar_train.py): rtol 1e-4.
* One whole train step on the tiny preset with the flagship's model flags
  and loss settings, the JAX TrainState carried over by
  train_state_from_jax and the JAX draws replayed: loss, grad norm, new
  params, Adam moments and counts, EMA. Both sides compute in fp32; they
  differ in summation order through the forward and backward, so each
  tensor is held to rtol 1e-4 with an absolute floor of 1e-4 x its largest
  magnitude. The test runs Adam with eps 1e-4: Adam's first step divides
  each gradient by its own magnitude, so a gradient near 0 turns a
  summation-order difference of the gradient into a difference of the
  update up to 1/eps times larger; at the default 1e-8 one element in
  ~1e5 flips its update. At 1e-4 the update still moves every parameter
  whose gradient is well above 1e-4 by about the LR. JAX runs its
  attention through the Pallas kernels (forward and `_flash_bwd` in
  interpret mode) in one case and through XLA einsum attention in another;
  the port runs its kernel path (the plain versions on the CPU) in both. A
  third case accumulates 2 microbatches.

The JAX draws come from one key: fold_in(key, step), then split(., 3)
into (t, mask, dropout) keys, and the splits and fold_ins of q_xt. The
helpers below replay that derivation and hand the numbers to the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from test_torch_dit import param_tree
from unidisc_tpu.config import Config as JaxConfig
from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.training import train_state as jts
from unidisc_tpu_torch.config import FLAGSHIP_TRAIN_OVERRIDES, Config
from unidisc_tpu_torch.models.dit import DIT
from unidisc_tpu_torch.models.port import (dit_state_dict_from_jax,
                                           train_state_from_jax)
from unidisc_tpu_torch.training import train_state as tts
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

B, TXT, IMG = 4, 8, 16
L = TXT + IMG
RTOL = 1e-4

TINY = {
    **{k: v for k, v in FLAGSHIP_TRAIN_OVERRIDES.items()},
    "model.hidden_size": 128, "model.n_heads": 2, "model.n_blocks": 2,
    "model.cond_dim": 32, "model.length": L, "model.txt_length": TXT,
    "model.img_length": IMG, "model.text_vocab_size": 24,
    "model.image_vocab_size": 40, "model.zero_linear_init": False,
    "trainer.warmup_steps": 0, "trainer.lr": 1e-3,
    "trainer.ema_decay": 0.9, "trainer.weight_decay": 0.01,
    "trainer.opt_eps": 1e-4,
}


def configs(**extra):
    over = {**TINY, **extra}
    return (JaxConfig.make("tiny", **over).validate(),
            Config.make("tiny", **over).validate())


def random_params(params, seed=0):
    rng = np.random.RandomState(seed)
    flat = traverse_util.flatten_dict(params, sep="/")
    out = {}
    for k, v in flat.items():
        shape = np.shape(v)
        if k.endswith(("weight", "scale")):
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            fan = shape[-2] if len(shape) >= 2 else shape[-1]
            arr = rng.standard_normal(shape) / np.sqrt(fan)
        out[k] = jnp.asarray(arr, jnp.float32)
    return traverse_util.unflatten_dict(out, sep="/")


def make_batch(m, seed=0):
    rng = np.random.RandomState(seed)
    ids = np.concatenate([rng.randint(0, m.text_vocab_size - 1, (B, TXT)),
                          rng.randint(m.text_vocab_size, m.vocab_size,
                                      (B, IMG))], 1).astype(np.int32)
    modality = np.concatenate([np.zeros((B, TXT)), np.ones((B, IMG))],
                              1).astype(np.int32)
    return {"input_ids": ids, "modality": modality}


def loss_draws(rng, b, m):
    """The draws of JAX compute_batch_loss(rng, ...) with b rows."""
    rng_t, rng_mask, _ = jax.random.split(rng, 3)
    k_move, k_txt, k_img = jax.random.split(rng_mask, 3)
    k_rand = jax.random.fold_in(rng_mask, 9)
    k_t, k_i = jax.random.split(k_rand)
    shape = (b, m.length)
    d = {"t": jax.random.uniform(rng_t, (b,)),
         "move": jax.random.uniform(k_move, shape),
         "txt": jax.random.uniform(k_txt, (b, 1)),
         "img": jax.random.uniform(k_img, (b, 1)),
         "drop": jax.random.uniform(jax.random.fold_in(rng_mask, 5), (b,)),
         "txt_rand": jax.random.randint(k_t, shape, 0,
                                        m.text_vocab_size - 1),
         "img_rand": jax.random.randint(k_i, shape, m.text_vocab_size,
                                        m.vocab_size),
         "rand": jax.random.randint(k_rand, shape, 0, m.vocab_size),
         "joint": jax.random.uniform(jax.random.fold_in(rng, 11), (b,))}
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def step_draws(rng, step, accum, m):
    """The draws of JAX make_train_step's step `step`."""
    rng = jax.random.fold_in(rng, step)
    if accum == 1:
        return loss_draws(rng, B, m)
    out = []
    for _ in range(accum):
        rng, k = jax.random.split(rng)
        out.append(loss_draws(k, B // accum, m))
    return out


def assert_tree_close(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        w = np.asarray(want[k], np.float64)
        g = np.asarray(got[k].detach(), np.float64)
        floor = 1e-4 * float(np.abs(w).max()) + 1e-12
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=floor,
                                   err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = configs()
    return random_params(param_tree(jcfg.model, jnp.float32))


# ---------------------------------------------------------------------------
# schedules and optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["constant_warmup", "cosine_decay",
                                      "constant_warmup_cosine_decay",
                                      "cosine_hard_restarts"])
def test_lr_schedule_matches_optax(schedule):
    over = {"trainer.lr_schedule": schedule, "trainer.warmup_steps": 10,
            "trainer.max_steps": 50, "trainer.warmup_lr_init": 1e-6,
            "trainer.num_cycles": 2}
    want_fn = jts.make_lr_schedule(JaxConfig.make("tiny", **over))
    got_fn = tts.make_lr_schedule(Config.make("tiny", **over))
    peak = Config.make("tiny", **over).trainer.lr
    for count in (0, 1, 5, 10, 11, 30, 49, 50, 80):
        want = float(want_fn(jnp.asarray(count, jnp.int32)))
        got = float(got_fn(torch.tensor(count, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * peak,
                                   err_msg=f"{schedule} at {count}")


def test_default_schedule_starts_at_zero():
    """Step 0 runs at warmup_lr_init = 0: the first update is zero."""
    want_fn = jts.make_lr_schedule(JaxConfig.make("tiny"))
    fn = tts.make_lr_schedule(Config.make("tiny"))
    got = [float(fn(torch.tensor(c, dtype=torch.int32)))
           for c in (0, 1, 2500)]
    want = [float(want_fn(jnp.asarray(c, jnp.int32))) for c in (0, 1, 2500)]
    assert got[0] == want[0] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * 3e-4)
    np.testing.assert_allclose(got, [0.0, 1.2e-7, 3e-4], rtol=1e-4)


@pytest.mark.parametrize("clip", [0.05, 100.0])
def test_optimizer_matches_optax_over_three_steps(clip):
    over = {"trainer.gradient_clip_val": clip, "trainer.warmup_steps": 2,
            "trainer.weight_decay": 0.1, "trainer.lr": 1e-2}
    jcfg, tcfg = (JaxConfig.make("tiny", **over), Config.make("tiny", **over))
    rng = np.random.RandomState(0)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    opt = jts.make_optimizer(jcfg)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = opt.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tflat = tts.flat_parameters(tparams)
    topt = tts.make_optimizer(tcfg)
    tstate = topt.init(tflat)
    for _ in range(3):
        grads = {k: (0.3 * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                           for g in grads.values()))
        assert (norm >= clip) == (clip < 1)      # the clip fires or not
        upd, jstate = opt.update({k: jnp.asarray(v) for k, v in
                                  grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        topt.apply(tflat, tts.flatten(torch.from_numpy(grads[k])
                                      for k in tparams), tstate)
    for k in shapes:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]),
                                   rtol=1e-5, atol=1e-7)
    adam = jstate[1][0]
    assert int(tstate.adam.count) == int(adam.count) == 3
    assert int(tstate.schedule_count) == int(jstate[1][2].count) == 3
    mu = tts.flat_views(tstate.adam.mu, tparams)
    nu = tts.flat_views(tstate.adam.nu, tparams)
    for k in shapes:
        np.testing.assert_allclose(mu[k].numpy(), np.asarray(adam.mu[k]),
                                   rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(nu[k].numpy(), np.asarray(adam.nu[k]),
                                   rtol=1e-5, atol=1e-10)


def test_optimizer_skip_keeps_everything():
    tcfg = Config.make("tiny", **{"trainer.warmup_steps": 0})
    p = torch.ones(3)
    opt = tts.make_optimizer(tcfg)
    st = opt.init(p)
    opt.apply(p, torch.full((3,), 0.5), st, ok=torch.tensor(False))
    assert torch.equal(p, torch.ones(3))
    assert int(st.adam.count) == 0 and int(st.schedule_count) == 0
    assert not st.adam.mu.any() and not st.adam.nu.any()


# ---------------------------------------------------------------------------
# compute_batch_loss
# ---------------------------------------------------------------------------

LOSS_VARIANTS = {
    "flagship": {},
    "entire_modality_fires": {"trainer.mask_entire_modality": 0.9},
    "static_entire_modality": {"trainer.mask_entire_modality": 0.9,
                               "trainer.multimodal_batches": False},
    "importance_sampling": {"trainer.importance_sampling": True},
    "change_of_variables": {"trainer.change_of_variables": True},
    "joint_ar_nar": {"trainer.joint_ar_nar_prob": 0.5},
    "joint_ar_nar_warmup": {"trainer.joint_ar_nar_prob": 0.3,
                            "trainer.joint_ar_nar_prob_warmup_steps": 4},
    "ar_llm_loss": {"trainer.ar_llm_loss": True},
    "no_ce_weighting": {"trainer.no_ce_weighting": True},
    "uniform_mode": {"trainer.discrete_diffusion_mode": "uniform"},
    # the legacy losses (diffusion/legacy.py) over the same corruption
    "sedd": {"trainer.parameterization": "sedd"},
    "d3pm": {"trainer.parameterization": "d3pm"},
    "no_modality_weights": {"trainer.text_loss_weight": None,
                            "trainer.img_loss_weight": None,
                            "model.force_argmax_valid_indices": False},
}


@pytest.mark.parametrize("variant,train", [
    *((v, True) for v in sorted(LOSS_VARIANTS)),
    # eval: no entire-modality masking and no joint AR rows
    ("flagship", False), ("joint_ar_nar", False)])
def test_compute_batch_loss_matches_jax(jax_params, variant, train):
    jcfg, tcfg = configs(**LOSS_VARIANTS[variant])
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    batch = make_batch(jcfg.model, seed=1)
    rng = jax.random.PRNGKey(3)
    step = 2
    want = jts.compute_batch_loss(
        jcfg, jts.make_apply_fn(jcfg, jmodel), jax_params, rng,
        {k: jnp.asarray(v) for k, v in batch.items()}, train=train,
        step=jnp.asarray(step, jnp.int32))
    model = DIT(tcfg.model, compute_dtype=torch.float32)
    model.load_state_dict(dit_state_dict_from_jax(jax_params))
    with torch.no_grad():
        got = tts.compute_batch_loss(
            tcfg, tts.make_apply_fn(tcfg, model), None,
            {k: torch.from_numpy(v) for k, v in batch.items()}, train=train,
            step=torch.tensor(step), draws=loss_draws(rng, B, jcfg.model))
    for name in got._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        if g.dtype == torch.bool:
            assert np.array_equal(g.numpy(), w), name
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=1e-5,
                                       err_msg=name)


def test_unported_branches_raise(jax_params):
    """The optimizers, remat, dropout and add_label are ported (the
    OTHER_STEPS cases below, tests/test_torch_optimizers.py,
    tests/test_torch_dit.py), packed interleaved batches (tests/
    test_torch_interleaved.py), MoE and img_cond with x_cond (tests/
    test_torch_moe.py, test_torch_img_cond.py). Refused, as JAX refuses
    them: an img_cond model without x_cond in the batch, and a cond_label
    model, whose label the JAX step never passes to the DIT (which asserts
    one); an unknown optimizer fails validate()."""
    _, tcfg = configs()
    model = DIT(tcfg.model, compute_dtype=torch.float32)
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch(tcfg.model).items()}
    apply_fn = tts.make_apply_fn(tcfg, model)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="no 'x_cond'"):
        tts.compute_batch_loss(tcfg.override(**{
            "model.img_cond": True, "model.cond_image_vocab_size": 8,
            "model.cond_length": 4}), apply_fn, None, batch, generator=gen)
    with pytest.raises(ValueError, match="cond_label has no train step"):
        tts.compute_batch_loss(tcfg.override(**{
            "model.cond_label": True, "model.time_conditioning": False}),
            apply_fn, None, batch, generator=gen)
    with pytest.raises(ValueError, match="unknown trainer.optimizer"):
        tts.make_optimizer(tcfg.override(**{"trainer.optimizer": "sgd"}))


# ---------------------------------------------------------------------------
# the whole train step
# ---------------------------------------------------------------------------

def run_both(jax_params, backend="xla", accum=1, batch_seed=0, **extra):
    jcfg, tcfg = configs(**{"model.attn_backend": backend,
                            "trainer.grad_accum_steps": accum, **extra})
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    jstate = jts.init_train_state(jcfg, jax_params)
    batch = make_batch(jcfg.model, seed=batch_seed)
    rng = jax.random.PRNGKey(7)
    jnew, jmetrics = jax.jit(jts.make_train_step(jcfg, jmodel))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)

    tcfg = dataclasses.replace(
        tcfg, model=dataclasses.replace(tcfg.model, attn_backend="auto"))
    model = DIT(tcfg.model, compute_dtype=torch.float32)
    state = tts.init_train_state(tcfg, model)
    state.load_state_dict(train_state_from_jax(jax.device_get(jstate)))
    step_fn = tts.make_train_step(tcfg, model)
    state, metrics = step_fn(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        draws=step_draws(rng, 0, accum, jcfg.model))
    return (jnew, jmetrics), (state, metrics)


def compare_states(jnew, jmetrics, state, metrics):
    want = train_state_from_jax(jax.device_get(jnew))
    got = state.state_dict()
    for key in ("step", "adam_count", "schedule_count"):
        assert int(got[key]) == int(want[key]) == 1, key
    for key in ("params", "mu", "nu", "ema_params"):
        assert_tree_close(got[key], want[key], key)
    for name in ("loss", "grad_norm", "txt_loss", "img_loss", "nll_sum",
                 "token_count", "nll_txt_sum", "txt_count", "nll_img_sum",
                 "img_count"):
        np.testing.assert_allclose(
            float(getattr(metrics, name)), float(getattr(jmetrics, name)),
            rtol=RTOL, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_train_step_matches_jax(jax_params, backend):
    (jnew, jm), (state, m) = run_both(jax_params, backend=backend)
    compare_states(jnew, jm, state, m)
    # the update moved the parameters
    before = dit_state_dict_from_jax(jax_params)
    moved = max(float((state.params[k].detach() - before[k]).abs().max())
                for k in before)
    assert moved > 1e-4


def test_train_step_with_grad_accumulation_matches_jax(jax_params):
    (jnew, jm), (state, m) = run_both(jax_params, accum=2, batch_seed=2)
    compare_states(jnew, jm, state, m)


def test_non_finite_loss_skips_the_update(jax_params):
    _, tcfg = configs()
    model = DIT(tcfg.model, compute_dtype=torch.float32)
    model.load_state_dict(dit_state_dict_from_jax(jax_params))
    state = tts.init_train_state(tcfg, model)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    with torch.no_grad():
        model.output_layer.linear.bias[0] = float("nan")
    before["output_layer.linear.bias"][0] = float("nan")
    ema_before = {k: v.clone() for k, v in state.ema_params.items()}
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch(tcfg.model).items()}
    gen = torch.Generator().manual_seed(0)
    state, metrics = tts.make_train_step(tcfg, model)(state, batch,
                                                      generator=gen)
    assert not torch.isfinite(metrics.loss)
    assert int(state.step) == 1
    for k, v in state.params.items():
        assert torch.equal(v, before[k]) or torch.allclose(
            v, before[k], equal_nan=True), k
    assert int(state.opt_state.adam.count) == 0
    assert int(state.opt_state.schedule_count) == 0
    assert not state.opt_state.adam.mu.any()
    # the EMA still moves toward the unchanged parameters
    decay = tcfg.trainer.ema_decay
    k = "blocks.0.attn_qkv.weight"
    torch.testing.assert_close(
        state.ema_params[k],
        ema_before[k] * decay + before[k] * (1 - decay))


def test_low_precision_params_keep_an_fp32_ema(jax_params):
    _, tcfg = configs(**{"trainer.low_precision_params": True})
    model = DIT(tcfg.model, compute_dtype=torch.bfloat16)
    model.load_state_dict(dit_state_dict_from_jax(jax_params))
    state = tts.init_train_state(tcfg, model)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert state.opt_state.adam.mu.dtype == torch.bfloat16
    assert state.ema.dtype == torch.float32
    before = {k: v.detach().clone() for k, v in state.params.items()}
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch(tcfg.model).items()}
    state, metrics = tts.make_train_step(tcfg, model)(
        state, batch, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(metrics.loss) and int(state.step) == 1
    assert any(not torch.equal(v, before[k])
               for k, v in state.params.items())


def test_eval_step_matches_jax(jax_params):
    jcfg, tcfg = configs()
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    jstate = jts.init_train_state(jcfg, jax_params)
    # an EMA that differs from the params, so the step must pick it
    jstate = jstate.replace(ema_params=jax.tree_util.tree_map(
        lambda p: p * 0.5, jstate.params))
    batch = make_batch(jcfg.model, seed=4)
    rng = jax.random.PRNGKey(9)
    want = jts.make_eval_step(jcfg, jmodel)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    model = DIT(tcfg.model, compute_dtype=torch.float32)
    state = tts.init_train_state(tcfg, model)
    state.load_state_dict(train_state_from_jax(jax.device_get(jstate)))
    got = tts.make_eval_step(tcfg, model)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        draws=loss_draws(rng, B, jcfg.model))
    for name in got._fields:
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=RTOL,
                                   atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# the other optimizers, muP, label tokens, dropout and remat: one whole
# step each against JAX's make_train_step
# ---------------------------------------------------------------------------

P_DROP = 0.25
OTHER_STEPS = {
    "lion": {"trainer.optimizer": "lion"},
    "ademamix": {"trainer.optimizer": "ademamix"},
    "adafactor": {"trainer.optimizer": "adafactor"},
    "muon": {"trainer.optimizer": "muon"},
    "adamw_mup": {"model.mup": True, "model.mup_base_width": 64},
    "add_label": {"trainer.add_label": True, "model.add_labels": 4,
                  "trainer.first_token_dropout": 0.5,
                  "trainer.mask_entire_modality": None},
    "dropout": {"model.dropout": P_DROP},
    "remat_dropout": {"model.dropout": P_DROP,
                      "trainer.use_gradient_checkpointing": True,
                      "model.remat_policy": "dots"},
}


@pytest.mark.parametrize("variant", sorted(OTHER_STEPS))
def test_other_train_steps_match_jax(jax_params, variant, monkeypatch):
    """Fresh optimizer states on both sides (JAX's init; the port's from
    the same parameters). The dropout cases substitute one keep mask for
    every dropout of the JAX model (gate_residual's dropout_fn, inside
    this test only) and give the port the same mask for every block."""
    from unidisc_tpu.models import dit as jdit
    jcfg, tcfg = configs(**{"model.attn_backend": "xla",
                            **OTHER_STEPS[variant]})
    params = jax_params
    if variant == "add_label":
        params = random_params(param_tree(jcfg.model, jnp.float32), seed=3)
    batch = make_batch(jcfg.model, seed=5)
    if variant == "add_label":
        batch["label"] = np.asarray([0, 3, 1, 2], np.int32)
    rng = jax.random.PRNGKey(11)
    draws = step_draws(rng, 0, 1, jcfg.model)
    if jcfg.model.dropout > 0:
        keep = np.random.RandomState(8).rand(
            B, L, jcfg.model.hidden_size) >= P_DROP
        orig = jdit.gate_residual

        def substituted(x_skip, out, gate, modality, *, dropout_fn=None):
            fn = None if dropout_fn is None else (
                lambda y: jnp.where(keep, y / (1.0 - P_DROP), 0.0))
            return orig(x_skip, out, gate, modality, dropout_fn=fn)
        monkeypatch.setattr(jdit, "gate_residual", substituted)
        k = torch.from_numpy(keep)
        draws["dropout"] = [(k, k)] * jcfg.model.n_blocks
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32,
                    remat=jcfg.trainer.use_gradient_checkpointing)
    jstate = jts.init_train_state(jcfg, params)
    jnew, jm = jax.jit(jts.make_train_step(jcfg, jmodel))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)

    tcfg = dataclasses.replace(
        tcfg, model=dataclasses.replace(tcfg.model, attn_backend="auto"))
    model = DIT(tcfg.model, compute_dtype=torch.float32,
                remat=tcfg.trainer.use_gradient_checkpointing)
    model.load_state_dict(dit_state_dict_from_jax(params))
    state = tts.init_train_state(tcfg, model)
    state, m = tts.make_train_step(tcfg, model)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        draws=draws)
    assert_tree_close(state.params, dit_state_dict_from_jax(
        jax.device_get(jnew.params)), "params")
    assert_tree_close(state.ema_params, dit_state_dict_from_jax(
        jax.device_get(jnew.ema_params)), "ema")
    for name in ("loss", "grad_norm", "nll_sum", "token_count"):
        np.testing.assert_allclose(float(getattr(m, name)),
                                   float(getattr(jm, name)), rtol=RTOL,
                                   atol=1e-6, err_msg=name)
    before = dit_state_dict_from_jax(params)
    assert max(float((state.params[k].detach() - before[k]).abs().max())
               for k in before) > 1e-5
