"""Sequence- and data-parallel training and sampling of the port on a mesh,
against the JAX package on its 8 virtual CPU devices and against the
port's one-rank paths.

The port's side runs once, in one gloo world of 4 CPU ranks
(``tests/torch_mesh_worker.py``, job "seq"):

* the train step (``make_train_step(mesh=)``) two steps from the same
  state, batch and draws on three meshes: seq 4 (the ring, Lc 6 of L 24),
  dcn 2 x fsdp 2 (HSDP: FSDP2 shards over "fsdp", replicates over "dcn")
  and fsdp 2 x seq 2. Loss, grad norm, the metric sums, the parameters,
  the Adam moments and the EMA are held to JAX's ``make_train_step`` on
  the fsdp 2 x seq 2 mesh (``shard_train_step``; the JAX draws replayed)
  within tests/test_torch_train_step.py's tolerance (fp32 both sides,
  rtol 1e-4 with a floor of 1e-4 x each tensor's largest magnitude), and
  to the port's one-rank step within the same bound (they differ only in
  the attention's block order and the reductions' summation order;
  observed ~1e-7).
* ``spmd_sampler`` over the t2i sampler under injected noise on fsdp 2 x
  seq 2 (dp 2: each rank samples one of the 2 rows) and on seq 4: token
  for token JAX's t2i sampler under ``spmd_sampler`` on the fsdp 2 x seq 2
  mesh, every rank alike.
* ``build_engine(mesh=)``: on seq 4 the one-rank engine's results at the
  same seed; on fsdp 2 x seq 2 a batch of 3 requests rounded up to the
  granule 2, and the leader / follower replay equal to the SPMD call.
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
from unidisc_tpu.parallel.mesh import make_mesh as jax_make_mesh
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
                "fsdp2_seq2": dict(dcn=1, fsdp=2, seq=2)}
SAMPLER_MESHES = {"fsdp2_seq2": dict(fsdp=2, seq=2),
                  "seq4": dict(fsdp=1, seq=4)}
ENGINE_OVER = {"sampling.predictor": "maskgit", "sampling.steps": 4,
               "sampling.cfg": 2.0, "model.text_vocab_size": 300}
REQUESTS = [dict(text="a red cube"), dict(text="two cats"), dict(text="x")]
T2I_STEPS = 4


def sampler_case():
    """The flagship-shaped tiny DIT of tests/test_torch_dit.py with random
    weights, 2 prompts and the injected noise."""
    from test_torch_dit import B, configs as dit_configs
    jcfg, tcfg = dit_configs(**{"sampling.predictor": "maskgit",
                                "sampling.steps": T2I_STEPS,
                                "sampling.cfg": 2.0})
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



def param_shapes(m):
    """init_dit's parameter tree as shapes (jax.eval_shape: the init traced,
    not run); random_params draws every leaf."""
    return jax.eval_shape(
        lambda key: init_dit(key, m, compute_dtype=jnp.float32)[1],
        jax.random.PRNGKey(0))

@pytest.fixture(scope="module")
def case(tmp_path_factory):
    jcfg, tcfg = configs()
    params = random_params(param_shapes(jcfg.model))
    jstate0 = jts.init_train_state(jcfg, params)
    sd0 = train_state_from_jax(jax.device_get(jstate0))
    batch = make_batch(jcfg.model)
    rng = jax.random.PRNGKey(7)
    draws = [step_draws(rng, i, 1, jcfg.model) for i in range(STEPS)]
    sjcfg, stcfg, sparams, txt, injected = sampler_case()
    inputs = {
        "config": tcfg, "meshes": TRAIN_MESHES, "sd0": sd0, "batch": batch,
        "draws": draws,
        "sampler": {"config": stcfg, "sd": dit_state_dict_from_jax(sparams),
                    "txt": txt, "injected": injected,
                    "meshes": SAMPLER_MESHES},
        "engine": {"meshes": ["seq=4", "fsdp=2,seq=2"],
                   "overrides": ENGINE_OVER, "requests": REQUESTS,
                   "seed": 3}}
    world = run_world("seq", 4, tmp_path_factory.mktemp("seq"),
                      inputs=inputs)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, jstate0=jstate0,
                sd0=sd0, batch=batch, rng=rng, draws=draws, world=world,
                sampler=(sjcfg, stcfg, sparams, txt, injected))


@pytest.fixture(scope="module")
def jax_mesh_steps(case):
    """JAX's make_train_step on the fsdp 2 x seq 2 mesh: (state, metrics)
    after STEPS steps."""
    jcfg = case["jcfg"]
    jcfg = dataclasses.replace(jcfg, mesh=JaxMeshConfig(
        dcn=1, fsdp=2, tensor=1, seq=2))
    mesh = jax_make_mesh(jcfg.mesh, devices=jax.devices()[:4])
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    step = jts.make_train_step(jcfg, jmodel, mesh=mesh)
    jitted, state, data_sh = jts.shard_train_step(step, case["jstate0"],
                                                  mesh)
    batch = jax.device_put({k: jnp.asarray(v)
                            for k, v in case["batch"].items()}, data_sh)
    metrics = []
    for _ in range(STEPS):
        state, m = jitted(state, batch, case["rng"])
        metrics.append(m)
    return state, metrics


@pytest.fixture(scope="module")
def one_rank_steps(case):
    tcfg = case["tcfg"]
    model = DIT(tcfg.model, compute_dtype=torch.float32)
    state = tts.init_train_state(tcfg, model)
    state.load_state_dict(case["sd0"])
    step = tts.make_train_step(tcfg, model)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    metrics = []
    for d in case["draws"]:
        state, m = step(state, batch, draws=d)
        metrics.append(m)
    sd = {k: {n: t.detach() for n, t in v.items()} if isinstance(v, dict)
          else v for k, v in state.state_dict().items()}
    return sd, metrics


METRICS = ("loss", "grad_norm", "txt_loss", "img_loss", "nll_sum",
           "token_count", "nll_txt_sum", "txt_count", "nll_img_sum",
           "img_count")


@pytest.mark.parametrize("mesh", list(TRAIN_MESHES))
def test_mesh_train_step_matches_jax_on_its_mesh(case, jax_mesh_steps, mesh):
    jstate, jmetrics = jax_mesh_steps
    got = case["world"][0]["train"][mesh]
    for i, jm in enumerate(jmetrics):
        for name in METRICS:
            np.testing.assert_allclose(
                got["metrics"][i][name], float(getattr(jm, name)),
                rtol=1e-4, atol=1e-6, err_msg=f"{mesh} step {i}: {name}")
    want = train_state_from_jax(jax.device_get(jstate))
    for key in ("step", "adam_count", "schedule_count"):
        assert int(got["state"][key]) == int(want[key]) == STEPS, key
    for key in ("params", "mu", "nu", "ema_params"):
        assert_tree_close(got["state"][key], want[key], f"{mesh}: {key}")


@pytest.mark.parametrize("mesh", list(TRAIN_MESHES))
def test_mesh_train_step_matches_the_one_rank_step(case, one_rank_steps,
                                                   mesh):
    want_sd, want_metrics = one_rank_steps
    for r, rank in enumerate(case["world"]):
        got = rank["train"][mesh]["metrics"]
        for i, wm in enumerate(want_metrics):
            for name in METRICS:
                np.testing.assert_allclose(
                    got[i][name], float(getattr(wm, name)), rtol=1e-5,
                    atol=1e-6, err_msg=f"{mesh} rank {r} step {i}: {name}")
    got_sd = case["world"][0]["train"][mesh]["state"]
    for key in ("params", "mu", "nu", "ema_params"):
        assert_tree_close(got_sd[key], want_sd[key], f"{mesh}: {key}")


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


def test_engine_on_a_mesh(case):
    one = build_engine(preset="tiny", device="cpu", overrides=ENGINE_OVER)
    want = one.run_batch([one.prepare(**r) for r in REQUESTS], seed=3)
    for r, rank in enumerate(case["world"]):
        seq = rank["engine"]["seq=4"]
        assert seq["granule"] == 1
        for got, w in zip(seq["tokens"], want):
            np.testing.assert_array_equal(got, w["image_ids"])
        assert seq["texts"] == [w["text"] for w in want]
        dp = rank["engine"]["fsdp=2,seq=2"]
        assert dp["granule"] == 2 and len(dp["tokens"]) == len(REQUESTS)
        for got, w in zip(dp["tokens"], case["world"][0]["engine"][
                "fsdp=2,seq=2"]["tokens"]):
            np.testing.assert_array_equal(got, w)
    led = case["world"][0]["engine"]
    for spec in ("seq=4", "fsdp=2,seq=2"):
        assert led[spec]["refused"]
        for a, b in zip(led[spec]["led"], led[spec]["tokens"]):
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
    for axis in ("pp", "tensor", "ep"):
        bad = dataclasses.replace(layout, sizes={**layout.sizes, axis: 2})
        with pytest.raises(NotImplementedError, match="item 9"):
            validate_mesh(tcfg, bad)
    assert MeshConfig().axis_names() == ("dcn", "fsdp", "tensor", "seq",
                                         "pp", "ep")
