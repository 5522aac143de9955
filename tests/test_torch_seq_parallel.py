"""Sequence-, data-, pipeline-, tensor- and expert-parallel training and
sampling of the port on a mesh, against the JAX package on its 8 virtual
CPU devices and against the port's one-rank paths.

The port's side runs once, in one gloo world of 4 CPU ranks
(``tests/torch_mesh_worker.py``, job "seq"):

* the train step (``make_train_step(mesh=)``) two steps from the same
  state, batch and draws on six meshes: seq 4 (the ring, Lc 6 of L 24),
  dcn 2 x fsdp 2 (HSDP: FSDP2 shards over "fsdp", replicates over "dcn"),
  fsdp 2 x seq 2, fsdp 2 x pp 2 (GPipe, 2 microbatches), seq 2 x pp 2
  (the ring inside each stage) and fsdp 2 x tensor 2 (megatron). Loss,
  grad norm, the metric sums, the parameters, the Adam moments and the
  EMA are held to JAX's ``make_train_step`` (``shard_train_step``; the JAX
  draws replayed) on the same mesh for the pipeline and tensor meshes,
  on fsdp 2 x seq 2 for the others, within
  tests/test_torch_train_step.py's tolerance (fp32 both sides, rtol 1e-4
  with a floor of 1e-4 x each tensor's largest magnitude), and to the
  port's one-rank step within the same bound (they differ only in the
  attention's block order and the reductions' summation order; observed
  ~1e-7).
* the MoE step (4 experts, top-2) on fsdp 2 x ep 2 (global routing, each
  rank two experts) the same way, against JAX's MoE step on fsdp 2 x ep 2
  and the port's one-rank MoE step.
* ``spmd_sampler`` over the t2i sampler under injected noise on fsdp 2 x
  seq 2, seq 4, pp 4, fsdp 2 x pp 2 and fsdp 2 x tensor 2: token for
  token JAX's t2i sampler under ``spmd_sampler`` on the fsdp 2 x seq 2
  mesh (JAX's tests/test_spmd_sampling.py holds its pp, fsdp x pp and
  fsdp x tensor meshes to one device), every rank alike; an MoE t2i on
  dcn 2 x ep 2 token for token the port's one-rank MoE t2i (held to JAX in
  tests/test_torch_moe.py).
* the int8 W8A8 t2i sampler (the JAX tree quantized by JAX's
  ``quantize_dit_params`` and carried over) on dcn 2 x tensor 2, dcn 2 x
  pp 2, fsdp 2 x tensor 2 and pp 2 x tensor 2: with the plain products,
  token for token JAX's int8 sampler under ``spmd_sampler`` on the same
  mesh; with the flagship's settings (the int8 kernel's path, the fused
  norm / adaLN prologue, which JAX cannot run at this L) token for token
  the port's one-rank sampler; an int8 MoE on dcn 2 x ep 2 token for
  token JAX's int8 MoE sampler on its dcn 2 x ep 2 mesh.
* ``ops/quant.py::qdot_row_parallel`` at tensor 2 (each rank a K-slice of
  the rows and of the weight): bit for bit the one-rank ``qdot``, with
  rows whose halves differ in amax by 100x, all-zero rows and int32 sums
  past 2^24.
* ``build_engine(mesh=)``: on seq 4, fsdp 2 x seq 2 and pp 2 x tensor 2,
  and in int8 (``quantize="int8"``, the flagship's int8 settings) on
  pp 2 x tensor 2 and fsdp 2 x tensor 2, the one-rank engine's results
  at the same seed (padded to the mesh's granule: the noise is the global
  batch's), a batch of 3 requests rounded up to the granule, and the
  leader / follower replay equal to the SPMD call.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import (assert_tree_close, configs, make_batch,
                                   random_params, step_draws)
from torch_mesh_worker import run_world
from unidisc_tpu.config import MeshConfig as JaxMeshConfig
from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.models.dit import init_dit
from unidisc_tpu.ops.quant import quantize_dit_params as jax_quantize_dit
from unidisc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from unidisc_tpu.parallel.sample import shard_params as jax_shard_params
from unidisc_tpu.parallel.sample import spmd_sampler as jax_spmd_sampler
from unidisc_tpu.sampling.t2i_fast import \
    build_t2i_sampler as jax_build_t2i_sampler
from unidisc_tpu.training import train_state as jts
from unidisc_tpu_torch.config import MeshConfig
from unidisc_tpu_torch.device import cap_test_threads
from unidisc_tpu_torch.models.dit import DIT
from unidisc_tpu_torch.models.port import (dit_state_dict_from_jax,
                                           train_state_from_jax)
from unidisc_tpu_torch.parallel.mesh import MeshLayout
from unidisc_tpu_torch.parallel.sample import (batch_multiple,
                                               validate_mesh)
from unidisc_tpu_torch.serving.engine import build_engine
from unidisc_tpu_torch.training import train_state as tts

cap_test_threads()

STEPS = 2
TRAIN_MESHES = {"seq4": dict(dcn=1, fsdp=1, seq=4),
                "hsdp": dict(dcn=2, fsdp=2, seq=1),
                "fsdp2_seq2": dict(dcn=1, fsdp=2, seq=2),
                "fsdp2_pp2": dict(dcn=1, fsdp=2, pp=2, pp_microbatches=2),
                "seq2_pp2": dict(dcn=1, fsdp=1, seq=2, pp=2,
                                 pp_microbatches=2),
                "fsdp2_tensor2": dict(dcn=1, fsdp=2, tensor=2)}
# the JAX mesh each train mesh is held to: its own for the new axes
JAX_TRAIN_MESH = {"seq4": "fsdp2_seq2", "hsdp": "fsdp2_seq2",
                  "fsdp2_seq2": "fsdp2_seq2", "fsdp2_pp2": "fsdp2_pp2",
                  "seq2_pp2": "seq2_pp2", "fsdp2_tensor2": "fsdp2_tensor2"}
MOE_MESHES = {"fsdp2_ep2": dict(dcn=1, fsdp=2, ep=2)}
MOE_OVER = {"model.moe_experts": 4, "model.moe_top_k": 2}
SAMPLER_MESHES = {"fsdp2_seq2": dict(fsdp=2, seq=2),
                  "seq4": dict(fsdp=1, seq=4),
                  "pp4": dict(fsdp=1, pp=4, pp_microbatches=2),
                  "fsdp2_pp2": dict(fsdp=2, pp=2, pp_microbatches=1),
                  "fsdp2_tensor2": dict(fsdp=2, tensor=2)}
MOE_SAMPLER_MESHES = {"dcn2_ep2": dict(dcn=2, fsdp=1, ep=2)}
# the int8 sampler's meshes: tensor 2, pp 2 (one microbatch a rank), fsdp 2
# x tensor 2, and pp 2 x tensor 2 (two microbatches: the fused path's adaLN
# rows are each microbatch's own)
INT8_MESHES = {"dcn2_tensor2": dict(dcn=2, fsdp=1, tensor=2),
               "dcn2_pp2": dict(dcn=2, fsdp=1, pp=2, pp_microbatches=1),
               "fsdp2_tensor2": dict(fsdp=2, tensor=2),
               "pp2_tensor2": dict(fsdp=1, pp=2, tensor=2,
                                   pp_microbatches=2)}
INT8_PLAIN = {"model.quant_backend": "xla", "model.quant_fused": False}
INT8_FLAGSHIP = {"model.quant_backend": "pallas", "model.quant_fused": True}
# the int8 engines' settings: the flagship's, and the adaLN and head
# initialised non-zero (zero-initialised, every logit is its bias and the
# tokens say nothing of the trunk)
INT8_ENGINE = {**INT8_FLAGSHIP, "model.zero_linear_init": False}
# (spec, quantize, extra overrides) of each engine case
ENGINE_MESHES = [("seq=4", None, {}), ("fsdp=2,seq=2", None, {}),
                 ("pp=2,tensor=2,pp_microbatches=2", None, {}),
                 ("pp=2,tensor=2,pp_microbatches=2", "int8", INT8_ENGINE),
                 ("fsdp=2,tensor=2", "int8", INT8_ENGINE)]
ENGINE_GRANULES = {"seq=4": 1, "fsdp=2,seq=2": 2,
                   "pp=2,tensor=2,pp_microbatches=2": 2, "fsdp=2,tensor=2": 2}
ENGINE_OVER = {"sampling.predictor": "maskgit", "sampling.steps": 4,
               "sampling.cfg": 2.0, "model.text_vocab_size": 300,
               "model.dropout": 0.0}
REQUESTS = [dict(text="a red cube"), dict(text="two cats"), dict(text="x")]
T2I_STEPS = 4


def sampler_case(**extra):
    """The flagship-shaped tiny DIT of tests/test_torch_dit.py (4 blocks,
    for pp 4) with random weights, 2 prompts and the injected noise."""
    from test_torch_dit import B, configs as dit_configs
    jcfg, tcfg = dit_configs(**{"sampling.predictor": "maskgit",
                                "sampling.steps": T2I_STEPS,
                                "sampling.cfg": 2.0, "model.n_blocks": 4,
                                **extra})
    m = jcfg.model
    from test_torch_dit import random_params as dit_random_params
    params = dit_random_params(param_shapes(m), seed=3)
    rng = np.random.RandomState(3)
    txt = rng.randint(0, m.text_vocab_size - 1,
                      (B, m.txt_length)).astype(np.int32)
    injected = {
        "gumbel_tok": rng.gumbel(size=(T2I_STEPS, B, m.img_length,
                                       m.image_vocab_size)).astype(
                                           np.float32),
        "gumbel_conf": rng.gumbel(size=(T2I_STEPS, B, m.img_length)
                                  ).astype(np.float32)}
    return jcfg, tcfg, params, txt, injected


def int8_sampler_case(**extra):
    """sampler_case's model and inputs in int8 W8A8: its float tree
    quantized by JAX's quantize_dit_params."""
    jcfg, tcfg, params, txt, injected = sampler_case(**extra)
    q = {"model.quant": "int8"}
    return (jcfg.override(**q), tcfg.override(**q), jax_quantize_dit(params),
            txt, injected)


def row_parallel_cases():
    """(name, x, x dtype, w_q, w_scale, bias, out dtype) of the row-parallel
    products at tensor 2: attn_out's and mlp.2's shapes of the tiny model
    (K 128 and 512), rows whose K-halves differ in amax by 100x and rows
    all zero; and a K of 3,072 whose int32 sums pass 2^24 on each rank."""
    rng = np.random.RandomState(11)
    cases = []
    for name, m, k, n, dtype, out, bias in (
            ("attn_out_f32", 24, 128, 128, "float32", "float32", False),
            ("mlp2_bf16", 24, 512, 128, "bfloat16", "bfloat16", True),
            ("mlp2_f32_bf16", 24, 512, 128, "float32", "bfloat16", True)):
        x = rng.randn(m, k).astype(np.float32)
        x[::3, :k // 2] *= 100.0
        x[1::3, k // 2:] *= 100.0
        x[5] = 0.0
        w_q = rng.randint(-127, 128, (n, k)).astype(np.int8)
        w_s = (rng.rand(n) / 127 + 1e-3).astype(np.float32)
        b = rng.randn(n).astype(np.float32) if bias else None
        cases.append((name, x, dtype, w_q, w_s, b, out))
    k, n = 3072, 16
    sign = np.where(rng.rand(8, k) < 0.5, -1.0, 1.0)
    x = (sign * rng.uniform(0.9, 1.0, (8, k))).astype(np.float32)
    w_q = (np.repeat(sign[:1], n, 0) * rng.randint(120, 128, (n, k))
           ).astype(np.int8)
    w_s = np.full(n, 1e-4, np.float32)
    cases.append(("deep_f32", x, "float32", w_q, w_s, None, "float32"))
    return cases


def param_shapes(m):
    """init_dit's parameter tree as shapes (jax.eval_shape: the init traced,
    not run); random_params draws every leaf."""
    return jax.eval_shape(
        lambda key: init_dit(key, m, compute_dtype=jnp.float32)[1],
        jax.random.PRNGKey(0))

def train_case(**extra):
    """(JAX config, port config, JAX state, its port state dict, batch,
    rng, draws) of the train-step case."""
    jcfg, tcfg = configs(**extra)
    params = random_params(param_shapes(jcfg.model))
    jstate0 = jts.init_train_state(jcfg, params)
    sd0 = train_state_from_jax(jax.device_get(jstate0))
    batch = make_batch(jcfg.model)
    rng = jax.random.PRNGKey(7)
    draws = [step_draws(rng, i, 1, jcfg.model) for i in range(STEPS)]
    return dict(jcfg=jcfg, tcfg=tcfg, jstate0=jstate0, sd0=sd0,
                batch=batch, rng=rng, draws=draws)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    train, moe = train_case(), train_case(**MOE_OVER)
    sjcfg, stcfg, sparams, txt, injected = sampler_case()
    mjcfg, mtcfg, mparams, _, _ = sampler_case(**MOE_OVER)
    int8 = {key: int8_sampler_case(**extra) for key, extra in (
        ("int8_t2i", INT8_PLAIN), ("int8_fused_t2i", INT8_FLAGSHIP),
        ("moe_int8_t2i", {**INT8_PLAIN, **MOE_OVER}))}
    inputs = {
        "train": {"config": train["tcfg"], "meshes": TRAIN_MESHES,
                  **{k: train[k] for k in ("sd0", "batch", "draws")}},
        "moe": {"config": moe["tcfg"], "meshes": MOE_MESHES,
                **{k: moe[k] for k in ("sd0", "batch", "draws")}},
        "t2i": {"config": stcfg, "sd": dit_state_dict_from_jax(sparams),
                "txt": txt, "injected": injected, "meshes": SAMPLER_MESHES},
        "moe_t2i": {"config": mtcfg, "sd": dit_state_dict_from_jax(mparams),
                    "txt": txt, "injected": injected,
                    "meshes": MOE_SAMPLER_MESHES},
        **{key: {"config": c[1], "sd": dit_state_dict_from_jax(c[2]),
                 "txt": c[3], "injected": c[4],
                 "meshes": MOE_SAMPLER_MESHES if key == "moe_int8_t2i"
                 else INT8_MESHES} for key, c in int8.items()},
        "row_parallel": {"cases": row_parallel_cases()},
        "engine": {"meshes": ENGINE_MESHES, "overrides": ENGINE_OVER,
                   "requests": REQUESTS, "seed": 3}}
    world = run_world("seq", 4, tmp_path_factory.mktemp("seq"),
                      inputs=inputs)
    return dict(train=train, moe=moe, world=world,
                sampler=(sjcfg, stcfg, sparams, txt, injected),
                moe_sampler=(mtcfg, mparams), int8=int8)


def jax_steps(c, spec):
    """JAX's make_train_step on the mesh of `spec` (port mesh fields):
    (state, metrics) after STEPS steps from the case `c`."""
    spec = {"dcn": 1, "tensor": 1, "seq": 1, **spec}
    jcfg = dataclasses.replace(c["jcfg"], mesh=JaxMeshConfig(**spec))
    n = int(np.prod([spec.get(a, 1) for a in ("dcn", "fsdp", "tensor",
                                               "seq", "pp", "ep")]))
    mesh = jax_make_mesh(jcfg.mesh, devices=jax.devices()[:n])
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    step = jts.make_train_step(jcfg, jmodel, mesh=mesh)
    # a fresh copy of the start state: a step donates the state it takes
    jitted, state, data_sh = jts.shard_train_step(
        step, jax.tree_util.tree_map(jnp.array, c["jstate0"]), mesh)
    batch = jax.device_put({k: jnp.asarray(v)
                            for k, v in c["batch"].items()}, data_sh)
    metrics = []
    for _ in range(STEPS):
        state, m = jitted(state, batch, c["rng"])
        metrics.append(m)
    return state, metrics


@pytest.fixture(scope="module")
def jax_mesh_steps(case, jax_spmd_tokens):
    """JAX's steps by the name of the mesh they ran on. The first test
    asks for every JAX reference (these and the sampler's tokens) before
    it reads the world, so they compile while the ranks run."""
    return {name: jax_steps(case["moe" if name in MOE_MESHES else "train"],
                            {**TRAIN_MESHES, **MOE_MESHES}[name])
            for name in sorted(set(JAX_TRAIN_MESH.values())
                               | set(MOE_MESHES))}


def one_rank(c):
    tcfg = c["tcfg"]
    model = DIT(tcfg.model, compute_dtype=torch.float32)
    state = tts.init_train_state(tcfg, model)
    state.load_state_dict(c["sd0"])
    step = tts.make_train_step(tcfg, model)
    batch = {k: torch.from_numpy(v) for k, v in c["batch"].items()}
    metrics = []
    for d in c["draws"]:
        state, m = step(state, batch, draws=d)
        metrics.append(m)
    sd = {k: {n: t.detach() for n, t in v.items()} if isinstance(v, dict)
          else v for k, v in state.state_dict().items()}
    return sd, metrics


@pytest.fixture(scope="module")
def one_rank_steps(case):
    return {key: one_rank(case[key]) for key in ("train", "moe")}


METRICS = ("loss", "grad_norm", "txt_loss", "img_loss", "nll_sum",
           "token_count", "nll_txt_sum", "txt_count", "nll_img_sum",
           "img_count")


ALL_TRAIN = [("train", m) for m in TRAIN_MESHES] + \
    [("moe", m) for m in MOE_MESHES]


@pytest.mark.parametrize("mesh", [m for _, m in ALL_TRAIN])
def test_mesh_train_step_matches_jax_on_its_mesh(case, jax_mesh_steps, mesh):
    key = "moe" if mesh in MOE_MESHES else "train"
    jstate, jmetrics = jax_mesh_steps[JAX_TRAIN_MESH.get(mesh, mesh)]
    got = case["world"][0][key][mesh]
    for i, jm in enumerate(jmetrics):
        for name in METRICS:
            np.testing.assert_allclose(
                got["metrics"][i][name], float(getattr(jm, name)),
                rtol=1e-4, atol=1e-6, err_msg=f"{mesh} step {i}: {name}")
    want = train_state_from_jax(jax.device_get(jstate))
    for k in ("step", "adam_count", "schedule_count"):
        assert int(got["state"][k]) == int(want[k]) == STEPS, k
    for k in ("params", "mu", "nu", "ema_params"):
        assert_tree_close(got["state"][k], want[k], f"{mesh}: {k}")


@pytest.mark.parametrize("mesh", [m for _, m in ALL_TRAIN])
def test_mesh_train_step_matches_the_one_rank_step(case, one_rank_steps,
                                                   mesh):
    key = "moe" if mesh in MOE_MESHES else "train"
    want_sd, want_metrics = one_rank_steps[key]
    for r, rank in enumerate(case["world"]):
        got = rank[key][mesh]["metrics"]
        for i, wm in enumerate(want_metrics):
            for name in METRICS:
                np.testing.assert_allclose(
                    got[i][name], float(getattr(wm, name)), rtol=1e-5,
                    atol=1e-6, err_msg=f"{mesh} rank {r} step {i}: {name}")
    got_sd = case["world"][0][key][mesh]["state"]
    for k in ("params", "mu", "nu", "ema_params"):
        assert_tree_close(got_sd[k], want_sd[k], f"{mesh}: {k}")


@pytest.fixture(scope="module")
def jax_spmd_tokens(case):
    """JAX's t2i sampler under its spmd_sampler on the fsdp 2 x seq 2
    mesh (JAX's tokens are those of every mesh: its test_spmd_sampling
    holds them to one device)."""
    sjcfg, _, sparams, txt, injected = case["sampler"]
    spec = SAMPLER_MESHES["fsdp2_seq2"]
    jcfg = dataclasses.replace(sjcfg, mesh=JaxMeshConfig(
        dcn=1, fsdp=spec["fsdp"], tensor=1, seq=spec["seq"]))
    jmesh = jax_make_mesh(jcfg.mesh, devices=jax.devices()[:4])
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    inj = {k: jnp.asarray(v) for k, v in injected.items()}
    base = jax_build_t2i_sampler(jmodel, jcfg, inject_noise=True)

    def sample(params, rng, txt):
        return base(params, rng, txt, injected=inj)
    return np.asarray(jax_spmd_sampler(sample, jcfg, jmesh)(
        sparams, jax.random.PRNGKey(0), jnp.asarray(txt)).tokens)


@pytest.mark.parametrize("mesh", list(SAMPLER_MESHES))
def test_spmd_t2i_sampler_matches_jax_token_for_token(case, jax_spmd_tokens,
                                                      mesh):
    want = jax_spmd_tokens
    for r, rank in enumerate(case["world"]):
        np.testing.assert_array_equal(rank["t2i"][mesh], want,
                                      err_msg=f"rank {r}")


def jax_int8_tokens(c, spec):
    """JAX's int8 t2i sampler of the case `c` under its spmd_sampler on the
    mesh of `spec` (port mesh fields)."""
    jcfg, _, qparams, txt, injected = c
    spec = {"dcn": 1, "fsdp": 1, "tensor": 1, "seq": 1, **spec}
    jcfg = dataclasses.replace(jcfg, mesh=JaxMeshConfig(**spec))
    n = int(np.prod([spec.get(a, 1) for a in ("dcn", "fsdp", "tensor",
                                               "seq", "pp", "ep")]))
    jmesh = jax_make_mesh(jcfg.mesh, devices=jax.devices()[:n])
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    inj = {k: jnp.asarray(v) for k, v in injected.items()}
    base = jax_build_t2i_sampler(jmodel, jcfg, inject_noise=True)

    def sample(params, rng, txt):
        return base(params, rng, txt, injected=inj)
    return np.asarray(jax_spmd_sampler(sample, jcfg, jmesh)(
        jax_shard_params(qparams, jmesh), jax.random.PRNGKey(0),
        jnp.asarray(txt)).tokens)


INT8_JAX_CASES = [("int8_t2i", m) for m in INT8_MESHES] + \
    [("moe_int8_t2i", m) for m in MOE_SAMPLER_MESHES]


@pytest.mark.parametrize("key,mesh", INT8_JAX_CASES)
def test_int8_spmd_t2i_matches_jax_on_its_mesh(case, key, mesh):
    """The int8 W8A8 sampler on a mesh, token for token JAX's int8 sampler
    on the same mesh, every rank alike."""
    spec = {**INT8_MESHES, **MOE_SAMPLER_MESHES}[mesh]
    want = jax_int8_tokens(case["int8"][key], spec)
    for r, rank in enumerate(case["world"]):
        np.testing.assert_array_equal(rank[key][mesh], want,
                                      err_msg=f"{key} {mesh} rank {r}")


@pytest.fixture(scope="module")
def one_rank_int8_fused(case):
    from unidisc_tpu_torch.sampling.t2i_fast import build_t2i_sampler
    _, tcfg, qparams, txt, injected = case["int8"]["int8_fused_t2i"]
    model = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    model.load_state_dict(dit_state_dict_from_jax(qparams))
    return build_t2i_sampler(model, tcfg, inject_noise=True, device="cpu")(
        torch.from_numpy(txt), injected={
            k: torch.from_numpy(v) for k, v in injected.items()}
    ).tokens.numpy()


@pytest.mark.parametrize("mesh", list(INT8_MESHES))
def test_int8_fused_spmd_t2i_matches_the_one_rank_sampler(
        case, one_rank_int8_fused, mesh):
    """The flagship's int8 settings (fused prologue, the int8 kernel's
    path) on a mesh: token for token the one-rank sampler."""
    for r, rank in enumerate(case["world"]):
        np.testing.assert_array_equal(rank["int8_fused_t2i"][mesh],
                                      one_rank_int8_fused,
                                      err_msg=f"{mesh} rank {r}")


@pytest.mark.parametrize("name", [c[0] for c in row_parallel_cases()])
def test_row_parallel_int8_product_equals_one_rank_qdot(case, name):
    """At tensor 2 a row-parallel product (the row amax reduced over the
    group, the int32 partials summed, one epilogue) is the one-rank qdot
    bit for bit, on every rank."""
    from unidisc_tpu_torch.ops.quant import qdot
    _, x, dtype, w_q, w_s, bias, out = next(
        c for c in row_parallel_cases() if c[0] == name)
    want = qdot(torch.from_numpy(x).to(getattr(torch, dtype)),
                torch.from_numpy(w_q), torch.from_numpy(w_s),
                bias=None if bias is None else torch.from_numpy(bias),
                out_dtype=getattr(torch, out), backend="pallas").float()
    for r, rank in enumerate(case["world"]):
        np.testing.assert_array_equal(rank["row_parallel"][name],
                                      want.numpy(), err_msg=f"rank {r}")


def test_moe_t2i_on_dcn2_ep2_matches_the_one_rank_sampler(case):
    from unidisc_tpu_torch.sampling.t2i_fast import build_t2i_sampler
    mtcfg, mparams = case["moe_sampler"]
    _, _, _, txt, injected = case["sampler"]
    model = DIT(mtcfg.model, compute_dtype=torch.float32).eval()
    model.load_state_dict(dit_state_dict_from_jax(mparams))
    want = build_t2i_sampler(model, mtcfg, inject_noise=True,
                             device="cpu")(
        torch.from_numpy(txt), injected={
            k: torch.from_numpy(v) for k, v in injected.items()}).tokens
    for r, rank in enumerate(case["world"]):
        np.testing.assert_array_equal(rank["moe_t2i"]["dcn2_ep2"],
                                      want.numpy(), err_msg=f"rank {r}")


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["bf16", "int8"])
def test_engine_on_a_mesh(case, quantize):
    extra = INT8_ENGINE if quantize else {}
    one = build_engine(preset="tiny", device="cpu", quantize=quantize,
                       overrides={**ENGINE_OVER, **extra})
    prepared = [one.prepare(**r) for r in REQUESTS]
    specs = [spec for spec, q, _ in ENGINE_MESHES if q == quantize]
    for spec in specs:
        granule = ENGINE_GRANULES[spec]
        # the one-rank engine at the same seed over the mesh's padded batch
        want = one.run_batch(prepared, seed=3, pad_to=-(-len(REQUESTS)
                                                        // granule) * granule)
        for r, rank in enumerate(case["world"]):
            got = rank["engine"][(spec, quantize)]
            assert got["granule"] == granule
            assert len(got["tokens"]) == len(REQUESTS)
            for g, w in zip(got["tokens"], want):
                np.testing.assert_array_equal(g, w["image_ids"],
                                              err_msg=f"{spec} rank {r}")
            assert got["texts"] == [w["text"] for w in want]
    led = case["world"][0]["engine"]
    for spec in specs:
        got = led[(spec, quantize)]
        assert got["refused"]
        for a, b in zip(got["led"], got["tokens"]):
            np.testing.assert_array_equal(a, b)


def test_granule_and_validate_mesh_refusals():
    _, tcfg = configs()
    layout = MeshLayout(sizes={"dcn": 2, "fsdp": 2, "tensor": 1, "seq": 2,
                               "pp": 1, "ep": 1}, dp_size=4, seq_size=2)
    assert batch_multiple(tcfg, layout) == 4
    validate_mesh(tcfg, layout)
    odd = dataclasses.replace(layout, seq_size=5)
    with pytest.raises(ValueError, match="not divisible by seq=5"):
        validate_mesh(tcfg, odd)
    # the pipeline's granule: data-parallel width x microbatches
    pp = dataclasses.replace(layout, sizes={**layout.sizes, "pp": 2})
    assert batch_multiple(tcfg, pp) == 4 * tcfg.mesh.pp_microbatches
    validate_mesh(tcfg, pp)
    with pytest.raises(ValueError, match="n_blocks"):
        validate_mesh(tcfg, dataclasses.replace(
            layout, sizes={**layout.sizes, "pp": 4 * tcfg.model.n_blocks}))
    validate_mesh(tcfg, dataclasses.replace(
        layout, sizes={**layout.sizes, "tensor": 2}))
    # what stays refused names item 9
    with pytest.raises(NotImplementedError, match="item 9"):
        validate_mesh(tcfg, dataclasses.replace(
            layout, sizes={**layout.sizes, "pp": 2, "ep": 2}))
    # an int8 model runs on "pp" and "tensor" (the tests above)
    int8 = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, quant="int8"))
    for axis in ("pp", "tensor"):
        validate_mesh(int8, dataclasses.replace(
            layout, sizes={**layout.sizes, axis: 2}))
    assert MeshConfig().axis_names() == ("dcn", "fsdp", "tensor", "seq",
                                         "pp", "ep")
