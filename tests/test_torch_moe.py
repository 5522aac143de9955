"""The port's MoE (``models/moe.py`` and the MoE paths of the DIT, the train
step, the sampler, int8 quantization, the engine and the optimizers'
shape rules) against the JAX package's.

* ``MoEMLP`` against JAX's at top-1 and top-2 with ample capacity, with
  overflow (capacity factor 1.0 on a skewed router, and on a zero router
  whose exact ties go to expert 0), and the balance auxiliary on uniform
  and skewed routing: fp32 on both sides, atol 1e-5 (summation order);
  the overflowed rows exactly zero on both.
* The MoE DIT's forward and ``return_moe_aux`` at identical weights:
  logits atol 2e-4 / rtol 1e-3 as tests/test_torch_dit.py, the auxiliary
  rtol 1e-5.
* One whole MoE train step against ``make_train_step`` with the JAX draws
  replayed, at tests/test_torch_train_step.py's tolerance.
* The maskgit sampler token for token under injected noise, with CFG
  (batch-wide routing over the doubled rows on both sides).
* ``quantize_model``: the experts and the router stay fp32, the rest
  equals JAX's ``quantize_dit_params``; the int8 MoE DIT against JAX's at
  int8 grain (tests/test_torch_quant.py's bounds).
* A Trainer run dir of a tiny MoE model served by ``build_engine`` in bf16
  and in int8 (quant_fused off; on refuses).
* Muon, Adafactor and muP over the MoE leaves: the routes JAX's, and two
  updates against optax (tests/test_torch_optimizers.py's tolerance).
* On the card (marked ``cuda``): the bf16 experts' products accumulated
  and biased in fp32, against an fp64 reference of the same bf16 operands
  (JAX's ``preferred_element_type=float32``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util
from optax.contrib import MuonDimensionNumbers

from unidisc_tpu.config import Config as JaxConfig
from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.models.moe import MoEMLP as JaxMoE
from unidisc_tpu.ops import quant as jax_quant
from unidisc_tpu.training import train_state as jts
from unidisc_tpu.training.muon import muon_dimension_numbers
from unidisc_tpu.training.mup import mup_multiplier as jax_mup_multiplier
from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.data.synthetic import SyntheticDataLoader
from unidisc_tpu_torch.device import cap_test_threads
from unidisc_tpu_torch.models.dit import DIT
from unidisc_tpu_torch.models.moe import MoEMLP
from unidisc_tpu_torch.models.port import (dit_state_dict_from_jax,
                                           train_state_from_jax)
from unidisc_tpu_torch.ops import quant
from unidisc_tpu_torch.serving.engine import build_engine, restore_run
from unidisc_tpu_torch.training import train_state as tts
from unidisc_tpu_torch.training.layout import ParamLayout
from unidisc_tpu_torch.training.muon import muon_routes
from unidisc_tpu_torch.training.mup import mup_multipliers
from unidisc_tpu_torch.training.trainer import Trainer

import test_torch_dit as tdit
import test_torch_sampler as tsampler
import test_torch_train_step as tstep
from test_torch_interleaved import abstract_random_params
from test_torch_quant import MAX_TOL, MEAN_TOL, ROW_TOL, ROWS_AGREE, TOP1

cap_test_threads()

MOE = {"model.moe_experts": 4, "model.moe_top_k": 2}


# ---------------------------------------------------------------------------
# MoEMLP
# ---------------------------------------------------------------------------

def moe_pair(k, cf, router, seed=0):
    over = {"model.moe_experts": 4, "model.moe_top_k": k,
            "model.moe_capacity_factor": cf}
    jm = JaxConfig.make("tiny", **over).model
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((2, 16, jm.hidden_size)).astype(np.float32)
    if router == "skew":
        # positive inputs: the boosted column wins for every token
        x = np.abs(x) + 0.1
    shapes = jax.eval_shape(JaxMoE(jm, compute_dtype=jnp.float32).init,
                            jax.random.PRNGKey(0), x)["params"]
    params = {}
    for name, v in shapes.items():
        if name == "router":
            kernel = rng.standard_normal(v["kernel"].shape) \
                / np.sqrt(jm.hidden_size)
            if router == "zero":
                kernel = np.zeros_like(kernel)
            elif router == "skew":
                kernel[:, 0] += 0.5
            params[name] = {"kernel": kernel.astype(np.float32)}
        else:
            fan = v.shape[-2] if name.startswith("w") else 10.0
            params[name] = (rng.standard_normal(v.shape)
                            / np.sqrt(fan)).astype(np.float32)
    y, aux = JaxMoE(jm, compute_dtype=jnp.float32).apply({"params": params},
                                                         x)
    mod = MoEMLP(Config.make("tiny", **over).model,
                 compute_dtype=torch.float32)
    mod.load_state_dict({
        "router.weight": torch.from_numpy(params["router"]["kernel"].T
                                          .copy()),
        **{n: torch.from_numpy(params[n]) for n in ("w1", "b1", "w2",
                                                    "b2")}})
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    return (np.asarray(y), float(aux)), (got[0].numpy(), float(got[1]))


@pytest.mark.parametrize("k,cf,router", [
    (1, 8.0, "random"), (2, 8.0, "random"),       # nothing overflows
    (1, 1.0, "skew"), (2, 1.0, "skew"),           # most first choices do
    (1, 1.0, "zero"),                             # exact ties: expert 0
])
def test_moe_mlp_matches_jax(k, cf, router):
    (want, want_aux), (got, got_aux) = moe_pair(k, cf, router)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_aux, want_aux, rtol=1e-5)
    dropped = np.abs(want).sum(-1) == 0
    np.testing.assert_array_equal(np.abs(got).sum(-1) == 0, dropped)
    if cf == 1.0 and k == 1:
        # capacity 8 of 32 tokens, all routed to expert 0: the first 8
        # rows (slot order = token order) go through, the rest are zero
        assert dropped.reshape(-1)[8:].all() and not dropped.reshape(-1)[
            :8].any()
    elif cf == 8.0:
        assert not dropped.any()


def test_moe_aux_flags_skewed_routing():
    """The Switch auxiliary: 1 for a uniform router, about E for one expert
    taking all the mass, equal to JAX's on both."""
    (_, want_u), (_, got_u) = moe_pair(2, 1.25, "zero")
    (_, want_s), (_, got_s) = moe_pair(2, 1.25, "skew")
    np.testing.assert_allclose([got_u, got_s], [want_u, want_s], rtol=1e-5)
    assert abs(got_u - 1.0) < 1e-5 and got_s > 3.5


def test_moe_profile_spans_own_their_backward():
    """profile_train.py's attribution on a CPU profile of one MoEMLP
    forward and backward: each part's record_function span is found once,
    and the backward node of its defining op is matched to it (the
    router's softmax, the dispatch's index_copy, the experts' bmm, the
    combine's index_select); no node is matched to two spans."""
    from torch.profiler import ProfilerActivity, profile

    from unidisc_tpu_torch.profile_train import SPANS, span_events
    mod = MoEMLP(Config.make("tiny", **MOE).model,
                 compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in mod.parameters():
            p.normal_(0.0, 0.1, generator=gen)
    x = torch.randn((2, 16, mod.cfg.hidden_size), generator=gen,
                    requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y, aux = mod(x)
        (y.sum() + aux).backward()
    found = span_events(prof.events())
    assert sorted(found) == sorted(SPANS)
    defining = {"moe_route": "SoftmaxBackward0",
                "moe_dispatch": "IndexCopyBackward0",
                "moe_experts": "BmmBackward0",
                "moe_combine": "IndexSelectBackward0"}
    for span, node in defining.items():
        calls, backward = found[span]
        assert len(calls) == 1, span
        assert any(e.name.endswith(node) for e in backward), span
    matched = [id(e) for _, backward in found.values() for e in backward]
    assert len(matched) == len(set(matched))


# ---------------------------------------------------------------------------
# the MoE DIT
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_dit():
    jcfg, tcfg = tdit.configs(**MOE)
    params = abstract_random_params(jcfg, seed=1)
    return jcfg, tcfg, params


def test_moe_dit_forward_and_aux_match_jax(moe_dit):
    jcfg, tcfg, params = moe_dit
    ids, sigma, modality = tdit.inputs(jcfg.model)
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    want, want_aux = jmodel.apply({"params": params}, ids, sigma,
                                  modality=modality, return_moe_aux=True)
    model = tdit.port_model(tcfg, params)
    assert not hasattr(model.blocks[0], "mlp")
    args = (torch.from_numpy(ids).long(), torch.from_numpy(sigma))
    with torch.no_grad():
        got, aux = model(*args, modality=torch.from_numpy(modality).long(),
                         return_moe_aux=True)
        plain = model(*args, modality=torch.from_numpy(modality).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=tdit.ATOL, rtol=tdit.RTOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    assert torch.equal(plain, got)
    # the sum of the blocks' auxiliaries, each in (0, E]
    assert 0.0 < float(aux) <= 4 * len(model.blocks)
    with pytest.raises(ValueError, match="return_moe_aux"):
        model(*args, modality=torch.from_numpy(modality).long(),
              return_moe_aux=True, return_hidden=True)


def test_return_moe_aux_without_moe_is_zero():
    _, tcfg = tdit.configs()
    model = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    ids, sigma, modality = tdit.inputs(tcfg.model)
    with torch.no_grad():
        _, aux = model(torch.from_numpy(ids).long(), torch.from_numpy(sigma),
                       modality=torch.from_numpy(modality).long(),
                       return_moe_aux=True)
    assert aux.dtype == torch.float32 and float(aux) == 0.0


# ---------------------------------------------------------------------------
# the train step and the sampler
# ---------------------------------------------------------------------------

def test_moe_train_step_matches_jax():
    jcfg, tcfg = tstep.configs(**MOE, **{"trainer.moe_aux_weight": 0.05})
    params = abstract_random_params(jcfg, seed=2)
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    jstate = jts.init_train_state(jcfg, params)
    batch = tstep.make_batch(jcfg.model)
    rng = jax.random.PRNGKey(7)
    jnew, jmetrics = jax.jit(jts.make_train_step(jcfg, jmodel))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)

    model = DIT(tcfg.model, compute_dtype=torch.float32)
    state = tts.init_train_state(tcfg, model)
    state.load_state_dict(train_state_from_jax(jax.device_get(jstate)))
    state, metrics = tts.make_train_step(tcfg, model)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        draws=tstep.step_draws(rng, 0, 1, jcfg.model))
    tstep.compare_states(jnew, jmetrics, state, metrics)
    # the router and the experts moved
    for name in ("blocks.0.moe.router.weight", "blocks.1.moe.w1"):
        before = dit_state_dict_from_jax(jax.device_get(params))[name]
        assert float((state.params[name].detach() - before).abs().max()) \
            > 1e-5, name


def test_moe_aux_enters_the_training_loss_only():
    """The loss with the auxiliary's weight set is the loss without it
    plus weight x the auxiliary; the eval loss carries none."""
    _, tcfg = tstep.configs(**MOE)
    jcfg, _ = tstep.configs(**MOE)
    model = DIT(tcfg.model, compute_dtype=torch.float32)
    model.load_state_dict(dit_state_dict_from_jax(
        abstract_random_params(jcfg, seed=3)))
    apply_fn = tts.make_apply_fn(tcfg, model)
    batch = {k: torch.from_numpy(v)
             for k, v in tstep.make_batch(tcfg.model).items()}
    draws = tstep.loss_draws(jax.random.PRNGKey(1), tstep.B, jcfg.model)
    losses = {}
    with torch.no_grad():
        for w, train in ((0.0, True), (0.5, True), (0.0, False),
                         (0.5, False)):
            cfg = tcfg.override(**{"trainer.moe_aux_weight": w})
            losses[w, train] = float(tts.compute_batch_loss(
                cfg, apply_fn, None, batch, train=train, draws=draws).loss)
    assert losses[0.5, False] == losses[0.0, False]
    # the same draws, so the same forward: the difference is w x the
    # auxiliary summed over the blocks, each in (0, E]
    added = (losses[0.5, True] - losses[0.0, True]) / 0.5
    assert 0.0 < added <= 4 * tcfg.model.n_blocks


def test_moe_maskgit_sampler_matches_jax():
    """With CFG: the routing's capacity is shared by the doubled rows on
    both sides."""
    want, got, _, _ = tsampler.run_both("maskgit", 2.0, **MOE)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    assert got.nfe == int(want.nfe)


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------

def test_quantize_model_keeps_moe_in_floating_point(moe_dit):
    jcfg, tcfg, params = moe_dit
    qparams = jax_quant.quantize_dit_params(params)
    want = dit_state_dict_from_jax(jax.device_get(qparams))
    got = quant.quantize_dit_params(dit_state_dict_from_jax(params))
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name
    for name in ("router.weight", "w1", "b1", "w2", "b2"):
        assert got[f"blocks.0.moe.{name}"].dtype == torch.float32

    qcfg, qmodel = quant.quantize_model(tcfg, tdit.port_model(tcfg, params))
    assert qcfg.model.quant == "int8"
    assert qmodel.blocks[0].moe.w1.dtype == torch.float32
    assert qmodel.blocks[0].attn_qkv.weight_q.dtype == torch.int8
    ids, sigma, modality = tdit.inputs(jcfg.model)
    jq = JaxDIT(JaxConfig.make("tiny", **{
        **tdit.OVERRIDES, **MOE, "model.quant": "int8"}).model,
        compute_dtype=jnp.float32)
    want_logits = np.asarray(jq.apply({"params": qparams}, ids, sigma,
                                      modality=modality))
    with torch.no_grad():
        got_logits = qmodel(torch.from_numpy(ids).long(),
                            torch.from_numpy(sigma),
                            modality=torch.from_numpy(modality).long()
                            ).numpy()
    diff = np.abs(got_logits - want_logits)
    scale = np.abs(want_logits).max()
    assert (diff.max(-1) <= ROW_TOL * scale).mean() >= ROWS_AGREE
    assert diff.max() <= MAX_TOL * scale
    assert diff.mean() <= MEAN_TOL * np.abs(want_logits).mean()
    assert (got_logits.argmax(-1) == want_logits.argmax(-1)).mean() >= TOP1


def test_moe_run_dir_is_served_in_bf16_and_int8(tmp_path):
    over = {"model.dropout": 0.0, **MOE, "model.length": 24,
            "model.txt_length": 8, "model.img_length": 16,
            "model.zero_linear_init": False, "sampling.steps": 4,
            "sampling.predictor": "maskgit", "sampling.cfg": 2.0}
    cfg = Config.make("tiny", **over)
    trainer = Trainer(cfg, str(tmp_path), device="cpu", log_every=100)
    trainer.fit(SyntheticDataLoader(cfg, 2, seed=cfg.seed), max_steps=2)
    trainer.close()
    _, ema, _ = restore_run(str(tmp_path))
    eng = build_engine(checkpoint=str(tmp_path), device="cpu")
    for name, value in eng.model.state_dict().items():
        assert torch.equal(value, ema[name].float()), name
    qeng = build_engine(checkpoint=str(tmp_path), device="cpu",
                        quantize="int8",
                        overrides={"model.quant_backend": "pallas"})
    want_q = quant.quantize_dit_params({k: v.float()
                                        for k, v in ema.items()})
    for name, value in qeng.model.state_dict().items():
        assert torch.equal(value, want_q[name]), name
    for e in (eng, qeng):
        r = e.run_batch([e.prepare(text="a cat"), e.prepare(text="a dog")],
                        seed=1)
        for row in r:
            assert row["nfe"] == 4 and row["image_ids"].shape == (1, 16)
            assert 0 <= row["image_ids"].min() <= row["image_ids"].max() \
                < e.m.image_vocab_size
    with pytest.raises(ValueError, match="quant_fused"):
        build_engine(checkpoint=str(tmp_path), device="cpu",
                     quantize="int8", overrides={"model.quant_fused": True})


# ---------------------------------------------------------------------------
# the optimizers' shape rules over the MoE leaves
# ---------------------------------------------------------------------------

OPT_OVER = {"trainer.warmup_steps": 0, "trainer.lr": 1e-2,
            "trainer.weight_decay": 0.1, "trainer.gradient_clip_val": 1.0,
            "model.mup_base_width": 64}


def port_params(tree):
    return {k: torch.nn.Parameter(v) for k, v in
            dit_state_dict_from_jax(jax.device_get(tree)).items()}


def test_muon_and_mup_route_the_moe_leaves_as_jax(moe_dit):
    _, _, params = moe_dit
    flags = jax.tree_util.tree_map(
        lambda d, p: np.full(np.shape(p), float(d is not None), np.float32),
        muon_dimension_numbers(params), params,
        is_leaf=lambda x: x is None or isinstance(x, MuonDimensionNumbers))
    want_muon = {k: bool(v.flatten()[0]) for k, v in
                 dit_state_dict_from_jax(flags).items()}
    mults = jax.tree_util.tree_map_with_path(
        lambda path, p: np.full(np.shape(p), jax_mup_multiplier(
            path, p, base_width=64, width=128), np.float32), params)
    want_mup = {k: float(v.flatten()[0]) for k, v in
                dit_state_dict_from_jax(mults).items()}
    tp = port_params(params)
    layout = ParamLayout(tp)
    routes = muon_routes(layout)
    got_muon = {n: routes[leaf.key] for leaf in layout.leaves
                for n in leaf.names}
    assert got_muon == want_muon
    # JAX's rule sends the router's kernel to Muon too (its docstring says
    # Adam): the port keeps the rule
    assert got_muon["blocks.0.moe.router.weight"]
    assert got_muon["blocks.1.moe.w2"] and not got_muon["blocks.0.moe.b1"]
    tcfg = Config.make("tiny", **{**tdit.OVERRIDES, **MOE, **OPT_OVER,
                                  "model.mup": True})
    got = tts.flat_views(mup_multipliers(tp, tcfg), tp)
    assert {k: float(v.flatten()[0]) for k, v in got.items()} == want_mup
    flat = traverse_util.flatten_dict(params, sep="/")
    for leaf in layout.leaves:
        assert leaf.shape == np.shape(flat["/".join(leaf.path)]), leaf.key
    assert layout.leaves[[leaf.key for leaf in layout.leaves].index(
        "blocks/moe/w1")].shape == (2, 4, 128, 512)


@pytest.mark.parametrize("optimizer,mup", [("adafactor", False),
                                           ("muon", False),
                                           ("adamw", True)])
def test_two_updates_over_moe_leaves_match_optax(moe_dit, optimizer, mup):
    _, _, params = moe_dit
    over = {**tdit.OVERRIDES, **MOE, **OPT_OVER,
            "trainer.optimizer": optimizer, "model.mup": mup}
    jcfg, tcfg = JaxConfig.make("tiny", **over), Config.make("tiny", **over)
    opt = jts.make_optimizer(jcfg)
    update = jax.jit(opt.update)
    jparams = params
    jstate = opt.init(jparams)
    tp = port_params(jparams)
    flat = tts.flat_parameters(tp)
    topt = tts.make_optimizer(tcfg)
    state = topt.init(flat, tp)
    rng = np.random.RandomState(1)
    for scale in (0.3, 1e-3):
        grads = jax.tree_util.tree_map(lambda v: jnp.asarray(
            rng.standard_normal(np.shape(v)) * scale, jnp.float32), jparams)
        upd, jstate = update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        g = tts.flatten(dit_state_dict_from_jax(jax.device_get(grads))[k]
                        for k in tp)
        topt.apply(flat, g, state, params=tp)
    want = dit_state_dict_from_jax(jax.device_get(jparams))
    for k, p in tp.items():
        w = want[k].numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=f"{optimizer}: {k}")
    if optimizer == "adafactor":
        # the (n_blocks, E, K, N) expert stacks are factored
        assert "v_row/blocks/moe/w1" in state.buffers
        assert tuple(state.buffers["v_row/blocks/moe/w1"].shape) == \
            (2, 4, 128)


@pytest.mark.cuda
def test_bf16_experts_accumulate_and_bias_in_fp32_on_card():
    """On the card the experts' products take bf16 operands and return
    fp32, the bias added before any rounding, as JAX's
    preferred_element_type=float32. The inputs make that visible: each
    first product is 1000 + a small term, and b1 = -1000 cancels the 1000;
    a product rounded to bf16 first (a step of 4 at 1000) would leave an
    error of up to 2 in the pre-activation, where the fp32 product leaves
    ~1e-4. Held to an fp64 reference of the same bf16 operands (rounding
    the GELU output and the result to bf16, as the layer does)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run this file on the card")
    cfg = dataclasses.replace(Config.make("tiny").model, hidden_size=64,
                              mlp_ratio=4, moe_experts=2, moe_top_k=1,
                              moe_capacity_factor=8.0)
    gen = torch.Generator().manual_seed(0)
    s, d, f = 64, 64, 256
    x = torch.rand((1, s, d), generator=gen) * 2 - 1
    x[..., 0] = 1.0
    w1 = torch.randn((2, d, f), generator=gen) * 0.05
    w1[:, 0, :] = 1000.0
    w2 = torch.randn((2, f, d), generator=gen) / 16
    b2 = torch.randn((2, 1, d), generator=gen) * 0.02
    router = torch.randn((2, d), generator=gen)
    mod = MoEMLP(cfg, compute_dtype=torch.bfloat16).cuda()
    with torch.no_grad():
        for name, value in (("w1", w1), ("w2", w2), ("b2", b2),
                            ("router.weight", router)):
            mod.get_parameter(name).copy_(value)
        mod.b1.fill_(-1000.0)
        y, _ = mod(x.cuda().bfloat16())
    # the reference: the same bf16 operands in fp64, top-1 routing (gate 1)
    xb = x.bfloat16().double()[0]
    expert = torch.argmax(x[0] @ router.t(), -1)
    h = torch.einsum("sd,sdf->sf", xb, w1.bfloat16().double()[expert]) \
        - 1000.0
    h = torch.nn.functional.gelu(h, approximate="tanh").bfloat16().double()
    want = torch.einsum("sf,sfd->sd", h, w2.bfloat16().double()[expert]) \
        + b2.double()[expert, 0]
    want = want.bfloat16().float()
    err = (y[0].float().cpu() - want).abs().max().item()
    assert err <= 2e-2 * want.abs().max().item(), err
