"""The port's ring attention (``parallel/ring_attention.py``) against the
JAX package's, forward and backward.

The port's side runs once, in one gloo world of 4 CPU ranks
(``tests/torch_mesh_worker.py``, job "ring"): each rank holds its chunk
(Lc 16 of L 64) and runs the plain ring and the flash-kernel ring (on the
CPU, ``flash_attention``'s plain version per block) in six cases: full and
causal, without ids, with a packed batch's ids (documents across the chunk
edges, -1 padding) and with distinct kv ids (rows whose id matches no key).
JAX runs its ``ring_attention`` and ``ring_attention_flash`` under
shard_map on 4 of its 8 virtual CPU devices (Pallas in interpret mode) on
the same inputs. Outputs and the gradients of sum(out * g) agree within
fp32 atol 2e-5 (the two sides sum the blocks in the same order; the
difference is the einsums' summation order). The flash ring's pad rows
are zero, and its backward zeroes their cotangent, in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from torch_mesh_worker import ring_cases, ring_inputs, run_world
from unidisc_tpu.ops.attention import multihead_attention
from unidisc_tpu.parallel import ring_attention as jra
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

ATOL = 2e-5
WORLD = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world("ring", WORLD, tmp_path_factory.mktemp("ring"))


def gathered(world, key, what):
    return np.concatenate([r[key][what] for r in world], axis=1)


@pytest.fixture(scope="module")
def jax_rings():
    """ring -> case -> (out, (dq, dk, dv)) of JAX's per-shard ring under
    shard_map on 4 devices: the six cases of a ring in one jitted
    program."""
    q, k, v, g = (jnp.asarray(x) for x in ring_inputs(0))
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("seq",))
    spec, sspec = P(None, "seq", None, None), P(None, "seq")

    def one(fn, causal, ids):
        def body(q, k, v, *ids):
            kw = {"causal": causal}
            if len(ids) == 2:
                kw["kv_segment_ids"] = ids[1]
            return fn(q, k, v, *ids[:1], **kw)

        def loss(q, k, v):
            o = jax.shard_map(body, mesh=mesh,
                              in_specs=(spec,) * 3 + (sspec,) * len(ids),
                              out_specs=spec, check_vma=False)(q, k, v, *ids)
            return jnp.sum(o * g), o
        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True)(q, k, v)
        return out, grads

    out = {}
    for ring, fn in (("plain", jra.ring_attention),
                     ("flash", jra.ring_attention_flash)):
        def all_cases(q, k, v):
            return {name: one(fn, causal, [jnp.asarray(x) for x in
                                           (qid, kvid) if x is not None])
                    for name, (causal, qid, kvid) in ring_cases().items()}
        out[ring] = jax.tree_util.tree_map(
            np.asarray, jax.jit(all_cases)(q, k, v))
    return out


@pytest.mark.parametrize("ring", ["plain", "flash"])
@pytest.mark.parametrize("case", list(ring_cases()))
def test_ring_matches_jax_forward_and_backward(world, jax_rings, ring,
                                              case):
    causal, qid, kvid = ring_cases()[case]
    want, want_grads = jax_rings[ring][case]
    key = f"{ring}/{case}"
    np.testing.assert_allclose(gathered(world, key, "out"), want, atol=ATOL,
                               rtol=0, err_msg=f"{key}: out")
    for name, w in zip(("dq", "dk", "dv"), want_grads):
        np.testing.assert_allclose(gathered(world, key, name), w,
                                   atol=ATOL, rtol=0,
                                   err_msg=f"{key}: {name}")
    if ring == "flash" and qid is not None:
        # pad rows and rows whose id matches no key: exactly zero
        dead = ~np.isin(qid, kvid if kvid is not None else qid) | (qid < 0)
        out = gathered(world, key, "out")
        assert np.all(out[dead] == 0.0)
        assert np.all(gathered(world, key, "dq")[qid < 0] == 0.0)


def test_sharded_entry_matches_jax(world, jax_rings):
    """ring_attention_sharded (global arrays on every rank, causal) equals
    JAX's plain causal ring on 4 devices (what JAX's ring_attention_sharded
    runs) and one device's causal attention, on every rank; each rank's
    gradient is JAX's on its own chunk (zero elsewhere)."""
    q, k, v, _ = (jnp.asarray(x) for x in ring_inputs(0))
    want, grads = jax_rings["plain"]["causal"]
    np.testing.assert_allclose(want, np.asarray(
        multihead_attention(q, k, v, causal=True, backend="xla")),
        atol=ATOL, rtol=0)
    lc = q.shape[1] // WORLD
    for i, r in enumerate(world):
        np.testing.assert_allclose(r["sharded"]["out"], want, atol=ATOL,
                                   rtol=0)
        for name, w in zip(("dq", "dk", "dv"), grads):
            mine = np.zeros_like(w)
            mine[:, i * lc:(i + 1) * lc] = w[:, i * lc:(i + 1) * lc]
            np.testing.assert_allclose(r["sharded"][name], mine, atol=ATOL,
                                       rtol=0, err_msg=f"rank {i}: {name}")


def test_sharded_entry_refuses_what_jax_refuses(world):
    errors = world[0]["errors"]
    assert "not divisible" in errors["indivisible"]
    assert "requires segment_ids" in errors["kv_without_q"]
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("seq",))
    q, k, v, _ = (jnp.asarray(x) for x in ring_inputs(0))
    with pytest.raises(ValueError, match="not divisible"):
        jra.ring_attention_sharded(q[:, :62], k[:, :62], v[:, :62], mesh)
