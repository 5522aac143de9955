"""The port's GPipe schedule (``parallel/pipeline.py``) against the JAX
package's (``unidisc_tpu/parallel/pipeline.py``), as JAX's own
tests/test_pipeline.py holds it to the sequential stack.

One gloo world of 4 CPU ranks (``tests/torch_mesh_worker.py``, job
"pipeline") runs ``pipeline_sharded`` over a stack of 8 dense + GELU
layers (2 a stage) whose every layer reads a per-sample bias, so each
stage must index the microbatch operands at its own offset:

* the forward at 1, 2, 4 and 8 microbatches, on every rank, against JAX's
  ``pipeline_sharded`` on a 4-device "pp" mesh and the sequential stack;
* the gradients of a loss every rank computes alike (sum of tanh) at 4
  microbatches: each rank's gradient of its stage's layers and the input's
  gradient on every rank, against ``jax.grad`` through JAX's schedule;
* the batch and layer-count refusals.

fp32 both sides, atol 1e-5 and rtol 1e-5 (JAX's test's tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from torch_mesh_worker import (PIPE_LAYERS, pipe_inputs, pipe_stack,
                               run_world)
from unidisc_tpu.parallel.pipeline import pipeline_sharded
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

WORLD = 4


def jax_stage(params_local, a, mb_args, scale):
    def layer(a, p):
        return jax.nn.gelu(a @ p["w"] + p["b"]
                           + 0.1 * mb_args["bias"]) * scale, None
    a, _ = jax.lax.scan(layer, a, params_local)
    return a


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world("pipeline", WORLD, tmp_path_factory.mktemp("pipe"))


def mesh():
    return Mesh(np.asarray(jax.devices()[:WORLD]).reshape(WORLD), ("pp",))


def as_jax(tree):
    return {k: jnp.asarray(v, jnp.float32) for k, v in tree.items()}


@pytest.mark.parametrize("microbatches", [1, 2, 4, 8])
def test_pipeline_forward_matches_jax(world, microbatches):
    params = as_jax(pipe_stack(0))
    x, bias = (jnp.asarray(a, jnp.float32) for a in pipe_inputs(1))
    want = np.asarray(jax.jit(lambda p, x, b: pipeline_sharded(
        jax_stage, p, x, mesh(), jnp.float32(1.01), mb_args={"bias": b},
        microbatches=microbatches))(params, x, bias))
    seq = np.asarray(jax_stage(params, x, {"bias": bias},
                               jnp.float32(1.01)))
    np.testing.assert_allclose(want, seq, atol=1e-5, rtol=1e-5)
    for r, rank in enumerate(world):
        np.testing.assert_allclose(rank["forward"][microbatches], want,
                                   atol=1e-5, rtol=1e-5,
                                   err_msg=f"rank {r}")


def test_pipeline_gradients_match_jax(world):
    params = as_jax(pipe_stack(2))
    x, bias = (jnp.asarray(a, jnp.float32) for a in pipe_inputs(3))

    def loss(params, x):
        return jnp.sum(jnp.tanh(pipeline_sharded(
            jax_stage, params, x, mesh(), jnp.float32(0.99),
            mb_args={"bias": bias}, microbatches=4)))

    value, (g_p, g_x) = jax.jit(jax.value_and_grad(loss, (0, 1)))(params, x)
    per = PIPE_LAYERS // WORLD
    for r, rank in enumerate(world):
        np.testing.assert_allclose(rank["loss"], float(value), rtol=1e-5)
        for k, g in g_p.items():
            np.testing.assert_allclose(
                rank["grads"][k], np.asarray(g)[r * per:(r + 1) * per],
                atol=1e-5, rtol=1e-5, err_msg=f"rank {r}: {k}")
        np.testing.assert_allclose(rank["dx"], np.asarray(g_x), atol=1e-5,
                                   rtol=1e-5, err_msg=f"rank {r}: x")


def test_pipeline_refusals(world):
    for rank in world:
        assert "not divisible by microbatches" in rank["errors"]["batch"]
        assert "layers not divisible" in rank["errors"]["layers"]
