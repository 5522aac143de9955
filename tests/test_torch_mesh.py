"""The port's mesh layer (``parallel/mesh.py``, ``utils/dist.py``) and FSDP
training on it, against the JAX package.

* ``resolve_mesh_shape`` equals JAX's for sizes with and without -1, and
  refuses what JAX refuses.
* ``param_spec`` equals JAX's PartitionSpec leaf for leaf on every leaf of
  the flagship tree and of a tiny MoE tree (their shapes from
  ``jax.eval_shape`` of ``init_dit``), over fsdp 1, 2, 4, 8 x tensor 1, 2
  x pp 1, 2 x ep 1, 2; the port reads the leaves from its own parameters
  (``training/layout.py``), and ``param_specs`` puts each torch tensor's
  shard on the matching torch dimension.
* One gloo world of 2 CPU ranks (``tests/torch_mesh_worker.py``, job
  "mesh2"): the train step two steps on fsdp 2 (FSDP2) against JAX's
  ``make_train_step`` on an fsdp 2 mesh and the port's one-rank step
  (tests/test_torch_train_step.py's tolerance); ``host_batch_to_global``;
  ``Trainer.fit`` + ``validate`` on fsdp 2 with equal ``param_hash`` and
  validation metrics on both ranks, as tests/test_multihost.py holds JAX's;
  its run dir resumed by a one-rank Trainer with the mesh's parameters;
  and the train CLI on the world (``mesh.fsdp=2``). In the same world:
  ``Trainer.fit`` on pp 2 (each rank holds its stage's block, the run dir
  resumed by a one-rank Trainer bit for bit), the train CLI on tensor 2
  (its ``--print-hashes`` line printed by rank 0 alone), and
  ``build_engine(mesh="fsdp=2")`` equal to the one-rank engine at the
  same seed token for token (each rank draws the global batch's noise
  and keeps its rows).
* ``MeshShards``'s parts: attn_qkv's [q | k | v] head shards taken and
  joined back; what the port still refuses on a mesh names ROADMAP item
  9.
"""

import dataclasses
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import (assert_tree_close, configs, make_batch,
                                   random_params, step_draws)
from torch_mesh_worker import TRAINER_OVER, local_batches, run_world
from unidisc_tpu.config import Config as JaxConfig
from unidisc_tpu.config import MeshConfig as JaxMeshConfig
from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.models.dit import init_dit
from unidisc_tpu.parallel import mesh as jmesh
from unidisc_tpu.training import train_state as jts
from unidisc_tpu_torch.config import FLAGSHIP_TRAIN_OVERRIDES, Config
from unidisc_tpu_torch.config import MeshConfig
from unidisc_tpu_torch.device import cap_test_threads
from unidisc_tpu_torch.models.dit import DIT
from unidisc_tpu_torch.models.port import train_state_from_jax
from unidisc_tpu_torch.parallel import mesh as tmesh
from unidisc_tpu_torch.training import train_state as tts
from unidisc_tpu_torch.training.layout import ParamLayout
from unidisc_tpu_torch.training.trainer import Trainer

cap_test_threads()

STEPS = 2
ENGINE_OVER = {"sampling.predictor": "maskgit", "sampling.steps": 4,
               "sampling.cfg": 2.0, "model.text_vocab_size": 300}
ENGINE_REQUESTS = [dict(text="a red cube"), dict(text="two cats")]
SIZES = [dict(fsdp=f, tensor=t, pp=p, ep=e, dcn=1, seq=1)
         for f, t, p, e in itertools.product((1, 2, 4, 8), (1, 2), (1, 2),
                                             (1, 2))]


def trees():
    """name -> (the JAX Config, the port Config)."""
    moe = {"model.hidden_size": 64, "model.n_heads": 2, "model.n_blocks": 2,
           "model.cond_dim": 32, "model.moe_experts": 4, "model.moe_top_k": 2,
           "model.length": 32, "model.txt_length": 16,
           "model.img_length": 16}
    return {"flagship": (JaxConfig.make("small", **FLAGSHIP_TRAIN_OVERRIDES),
                         Config.make("small", **FLAGSHIP_TRAIN_OVERRIDES)),
            "moe": (JaxConfig.make("tiny", **moe), Config.make("tiny", **moe))}


@pytest.mark.parametrize("tree", ["flagship", "moe"])
def test_param_spec_matches_jax_leaf_for_leaf(tree):
    jcfg, tcfg = trees()[tree]
    shapes = jax.eval_shape(lambda k: init_dit(k, jcfg.model)[1],
                            jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    jleaves = {"/".join(str(getattr(p, "key", p)) for p in path): leaf.shape
               for path, leaf in flat}
    with torch.device("meta"):
        model = DIT(tcfg.model, init=False)
    params = dict(model.named_parameters())
    layout = ParamLayout(params)
    assert {leaf.key: tuple(leaf.shape) for leaf in layout.leaves} == \
        {k: tuple(v) for k, v in jleaves.items()}
    for sizes in SIZES:
        fake = types.SimpleNamespace(shape=sizes)
        for key, shape in jleaves.items():
            want = tuple(jmesh.param_spec(key, shape, fake))
            assert tmesh.param_spec(key, tuple(shape), sizes) == want, \
                (tree, sizes, key)
        specs = tmesh.param_specs(params, sizes)
        for leaf in layout.leaves:
            want = list(jmesh.param_spec(leaf.key, leaf.shape, types.
                                         SimpleNamespace(shape=sizes)))
            want += [None] * (len(leaf.shape) - len(want))
            for name in leaf.names:
                got = list(specs[name])
                if leaf.transposed:
                    got[-2:] = got[-2:][::-1]
                assert got == want[len(want) - len(got):], (sizes, name)


@pytest.mark.parametrize("spec,n", [
    (dict(dcn=1, fsdp=-1), 8), (dict(dcn=2, fsdp=-1, seq=2), 8),
    (dict(dcn=1, fsdp=2, seq=2, pp=2), 8), (dict(dcn=1, fsdp=-1, ep=2), 4),
    (dict(dcn=1, fsdp=3), 8)])
def test_resolve_mesh_shape_matches_jax(spec, n):
    try:
        want = jmesh.resolve_mesh_shape(JaxMeshConfig(**spec), n)
    except ValueError:
        with pytest.raises(ValueError, match="does not cover"):
            tmesh.resolve_mesh_shape(MeshConfig(**spec), n)
        return
    assert tmesh.resolve_mesh_shape(MeshConfig(**spec), n) == want


def test_later_axes_raise_naming_item_9():
    # "tensor", "pp" and "ep" run; what stays refused names item 9
    for axis in ("tensor", "pp", "ep"):
        tmesh.check_ported_axes({"fsdp": 2, axis: 2})
    tmesh.check_ported_axes({"dcn": 2, "fsdp": 2, "seq": 2})
    with pytest.raises(NotImplementedError, match="item 9"):
        tmesh.check_ported_axes({"pp": 2, "ep": 2})
    _, tcfg = configs()
    m = tcfg.model
    for model, sizes in (
            (dataclasses.replace(m, img_cond=True), {"tensor": 2}),
            (dataclasses.replace(m, moe_experts=2), {"pp": 2, "seq": 2})):
        with pytest.raises(NotImplementedError, match="item 9"):
            tmesh.check_mesh_model(model, sizes)
    # img_cond under pp is JAX's own refusal (its Config.validate), which
    # the port's repeats; it is no unported work
    with pytest.raises(ValueError, match="img_cond is not wired"):
        tcfg.override(**{"model.img_cond": True,
                         "model.cond_image_vocab_size": 8,
                         "model.cond_length": 4, "model.qk_norm": False,
                         "model.sandwich_normalization": False,
                         "model.rope_2d": False, "mesh.pp": 2}).validate()
    # int8 W8A8 runs on every axis (tests/test_torch_seq_parallel.py holds
    # it to JAX's int8 sampler on its mesh)
    for sizes in ({"fsdp": 2, "seq": 2}, {"tensor": 2}, {"pp": 2},
                  {"fsdp": 2, "tensor": 2}):
        tmesh.check_mesh_model(dataclasses.replace(m, quant="int8"), sizes)
    tmesh.check_mesh_model(dataclasses.replace(m, quant="int8",
                                               moe_experts=2), {"ep": 2})
    tmesh.check_mesh_model(dataclasses.replace(m, moe_experts=2),
                           {"seq": 2, "ep": 2})
    with pytest.raises(ValueError, match="n_heads"):
        tmesh.check_mesh_model(m, {"tensor": 4})
    with pytest.raises(ValueError, match="moe_experts"):
        tmesh.check_mesh_model(m, {"ep": 2})


def test_mesh_parts_take_and_join():
    rng = np.random.RandomState(0)
    qkv = torch.from_numpy(rng.randn(12, 5).astype(np.float32))
    part = tmesh.Part("tensor", 0, 3)
    shards = [part.take(qkv, r, 2) for r in range(2)]
    # rank r: rows of its heads in each of q, k and v
    np.testing.assert_array_equal(shards[1].numpy(), qkv[[2, 3, 6, 7, 10, 11]]
                                  .numpy())
    np.testing.assert_array_equal(part.join(shards).numpy(), qkv.numpy())
    cols = tmesh.Part("tensor", 1)
    np.testing.assert_array_equal(cols.join([cols.take(qkv, r, 5)
                                             for r in range(5)]).numpy(),
                                  qkv.numpy())



def param_shapes(m):
    """init_dit's parameter tree as shapes (jax.eval_shape: the init traced,
    not run); random_params draws every leaf."""
    return jax.eval_shape(
        lambda key: init_dit(key, m, compute_dtype=jnp.float32)[1],
        jax.random.PRNGKey(0))

@pytest.fixture(scope="module", autouse=True)
def case(tmp_path_factory):
    """The 2-rank world, started before the module's first test: the
    tests compute their JAX references while its ranks run."""
    jcfg, tcfg = configs()
    params = random_params(param_shapes(jcfg.model))
    jstate0 = jts.init_train_state(jcfg, params)
    batch = make_batch(jcfg.model)
    rng = jax.random.PRNGKey(7)
    draws = [step_draws(rng, i, 1, jcfg.model) for i in range(STEPS)]
    tmp = tmp_path_factory.mktemp("mesh2")
    inputs = {"config": tcfg, "sd0": train_state_from_jax(
        jax.device_get(jstate0)), "batch": batch, "draws": draws,
        "dir": str(tmp), "engine": {"overrides": ENGINE_OVER,
                                    "requests": ENGINE_REQUESTS, "seed": 5}}
    world = run_world("mesh2", 2, tmp, inputs=inputs)
    return dict(jcfg=jcfg, tcfg=tcfg, jstate0=jstate0, batch=batch,
                rng=rng, inputs=inputs, world=world, dir=tmp)


def test_fsdp_train_step_matches_jax_and_the_one_rank_step(case):
    jcfg = dataclasses.replace(case["jcfg"], mesh=JaxMeshConfig(
        dcn=1, fsdp=2, tensor=1, seq=1))
    mesh = jmesh.make_mesh(jcfg.mesh, devices=jax.devices()[:2])
    step = jts.make_train_step(jcfg, JaxDIT(jcfg.model,
                                            compute_dtype=jnp.float32),
                               mesh=mesh)
    jitted, jstate, data_sh = jts.shard_train_step(step, case["jstate0"],
                                                   mesh)
    jbatch = jax.device_put({k: jnp.asarray(v)
                             for k, v in case["batch"].items()}, data_sh)
    for _ in range(STEPS):
        jstate, jm = jitted(jstate, jbatch, case["rng"])
    got = case["world"][0]["train"]
    for r in case["world"]:
        np.testing.assert_allclose(r["train"]["metrics"][-1]["loss"],
                                   float(jm.loss), rtol=1e-4)
        np.testing.assert_allclose(r["train"]["metrics"][-1]["grad_norm"],
                                   float(jm.grad_norm), rtol=1e-4)
    want = train_state_from_jax(jax.device_get(jstate))
    for key in ("params", "mu", "nu", "ema_params"):
        assert_tree_close(got["state"][key], want[key], key)
    # the port's one-rank step
    tcfg = case["tcfg"]
    model = DIT(tcfg.model, compute_dtype=torch.float32)
    state = tts.init_train_state(tcfg, model)
    state.load_state_dict(case["inputs"]["sd0"])
    one = tts.make_train_step(tcfg, model)
    tb = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    for d in case["inputs"]["draws"]:
        state, m = one(state, tb, draws=d)
    np.testing.assert_allclose(got["metrics"][-1]["loss"], float(m.loss),
                               rtol=1e-5)
    sd = state.state_dict()
    for key in ("params", "mu", "nu", "ema_params"):
        assert_tree_close(got["state"][key], {
            n: t.detach() for n, t in sd[key].items()}, key)


def test_two_rank_fit_validate_hash_and_resume(case):
    r0, r1 = case["world"]
    # FSDP2 shards the large leaves; the small ones stay whole
    assert r0["sharded"] == r1["sharded"] and r0["sharded"]
    assert "blocks.0.attn_qkv.weight" in r0["sharded"]
    assert "blocks.0.norm1.weight" not in r0["sharded"]
    for r in (r0, r1):
        g = r["global_batch"]
        assert g["input_ids"].shape == (8, 16)
        for k in g:
            np.testing.assert_array_equal(g[k], np.concatenate(
                [local_batches(0, i, 2)[k] for i in range(2)]))
    assert r0["fit_step"] == r1["fit_step"] == 3
    assert r0["param_hash"] == r1["param_hash"]
    assert r0["val"] and r0["val"].keys() == r1["val"].keys()
    for k in r0["val"]:
        assert abs(r0["val"][k] - r1["val"][k]) < 1e-6, k
        assert np.isfinite(r0["val"][k])
    # the run dir resumes on one rank, with the mesh's whole state
    cfg = Config.make("tiny", **TRAINER_OVER).override(**{"mesh.fsdp": 1})
    one = Trainer(cfg, str(case["dir"] / "run"), device="cpu",
                  log_every=100)
    assert one.maybe_restore() == 3
    for key in ("params", "ema_params"):
        got = one.state.state_dict()[key]
        for n, t in r0["final"][key].items():
            torch.testing.assert_close(got[n].detach(), t, rtol=0, atol=0)
    one.close()
    # the train CLI under the world
    assert r0["cli_step"] == r1["cli_step"] == 2
    assert r0["cli_loss"] == r1["cli_loss"] and np.isfinite(r0["cli_loss"])


def test_pp_trainer_holds_its_stage_and_resumes_on_one_rank(case):
    r0, r1 = case["world"]
    # each rank holds its stage's block and every parameter outside them
    for r, rank in enumerate((r0, r1)):
        blocks = {n.split(".")[1] for n in rank["pp_held"]
                  if n.startswith("blocks.")}
        assert blocks == {str(r)}, blocks
        assert "vocab_embed.embedding" in rank["pp_held"]
    assert r0["pp_fit_step"] == r1["pp_fit_step"] == 3
    cfg = Config.make("tiny", **TRAINER_OVER).override(**{"mesh.fsdp": 1})
    one = Trainer(cfg, str(case["dir"] / "run_pp"), device="cpu",
                  log_every=100)
    assert one.maybe_restore() == 3
    got = one.state.state_dict()["params"]
    assert set(got) == set(r0["pp_final"])
    for n, t in r0["pp_final"].items():
        torch.testing.assert_close(got[n].detach(), t, rtol=0, atol=0)
    one.close()
    # the train CLI on tensor 2, with --print-hashes: one line, rank 0's
    assert r0["cli_tensor_step"] == r1["cli_tensor_step"] == 2
    assert r0["cli_tensor_loss"] == r1["cli_tensor_loss"]
    assert np.isfinite(r0["cli_tensor_loss"])
    assert len(r0["cli_tensor_hash_lines"]) == 1
    assert r1["cli_tensor_hash_lines"] == r1["cli_hash_lines"] == []


def test_dp_engine_draws_the_one_rank_engines_noise(case):
    from unidisc_tpu_torch.serving.engine import build_engine
    one = build_engine(preset="tiny", device="cpu", overrides=ENGINE_OVER)
    want = one.run_batch([one.prepare(**r) for r in ENGINE_REQUESTS],
                         seed=5)
    for rank in case["world"]:
        assert len(rank["engine"]) == len(want)
        for got, w in zip(rank["engine"], want):
            np.testing.assert_array_equal(got, w["image_ids"])
