"""The port's attention against the JAX package's.

`flash_attention` on CPU tensors runs `attention_reference`, the plain
version of the hand-written CUDA kernel; it is held against the JAX Pallas
`flash_attention`, which runs its TPU kernel in interpret mode on the CPU
(`_small_fwd_kernel` for L <= 640, `_fwd_kernel` above). Both sides
compute in fp32, so they differ only in summation order: atol 2e-5.

The kernel itself is compared with `attention_reference` on the card by
tests/test_torch_flash_cuda.py and by chip_smoke.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.ops import pallas_attention as jax_pa
from unidisc_tpu.ops.attention import multihead_attention as jax_mha
from unidisc_tpu_torch.ops import _build
from unidisc_tpu_torch.ops.attention import multihead_attention
from unidisc_tpu_torch.ops.flash_attention import flash_attention
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

ATOL = 2e-5   # fp32 on both sides: summation order only


def make_qkv(b, lq, lk, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal((b, n, h, d)).astype(np.float32)
                 for n in (lq, lk, lk))


def segments(b, length):
    """Three packed samples per row and a tail of -1 padding rows."""
    segs = np.zeros((b, length), np.int32)
    segs[:, length // 3:2 * length // 3] = 1
    segs[:, 2 * length // 3:] = 2
    segs[0, length - length // 6:] = -1
    return segs


CASES = {
    "plain": dict(lq=128, d=64),
    "unaligned": dict(lq=100, d=64),
    "causal": dict(lq=100, d=64, causal=True),
    "segments": dict(lq=96, d=64, segs=True),
    "causal_segments": dict(lq=96, d=64, segs=True, causal=True),
    "head_dim_128": dict(lq=80, d=128),
    "tiled_long": dict(lq=700, d=64, b=1, h=1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_matches_pallas_interpret(name):
    c = CASES[name]
    b, h, lq, d = c.get("b", 2), c.get("h", 2), c["lq"], c["d"]
    causal = c.get("causal", False)
    q, k, v = make_qkv(b, lq, lq, h, d, seed=len(name))
    seg = segments(b, lq) if c.get("segs") else None
    jseg = (jnp.asarray(seg), jnp.asarray(seg)) if seg is not None else None
    want = np.asarray(jax_pa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        segment_ids=jseg))
    tseg = (torch.from_numpy(seg), torch.from_numpy(seg)) \
        if seg is not None else None
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal,
                          segment_ids=tseg).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)
    if seg is not None:
        # a padding row attends to nothing: its output is exactly zero
        pad = seg < 0
        assert pad.any()
        assert np.all(got[pad] == 0.0)
        assert np.all(want[pad] == 0.0)


@pytest.mark.parametrize("segs", [False, True])
def test_need_lse_matches_pallas_residual(segs):
    b, h, lq, d = 2, 2, 96, 64
    q, k, v = make_qkv(b, lq, lq, h, d, seed=3)
    seg = segments(b, lq) if segs else None
    scale = 1.0 / math.sqrt(d)
    to_bhld = lambda x: jnp.transpose(jnp.asarray(x), (0, 2, 1, 3))
    jseg = (jnp.asarray(seg), jnp.asarray(seg)) if segs else None
    out_j, lse_j = jax_pa._flash_fwd(to_bhld(q), to_bhld(k), to_bhld(v),
                                     jseg, False, scale, need_lse=True)
    tseg = (torch.from_numpy(seg), torch.from_numpy(seg)) if segs else None
    out, lse = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), segment_ids=tseg,
                               need_lse=True)
    assert lse.shape == (b, h, lq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :, :lq, 0],
                               atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(
        out.numpy(), np.transpose(np.asarray(out_j), (0, 2, 1, 3)),
        atol=ATOL, rtol=1e-5)
    if segs:   # a padding row's LSE is defined as 0
        pad = np.broadcast_to((seg < 0)[:, None, :], lse.shape)
        assert np.all(lse.numpy()[pad] == 0.0)


def test_flash_attention_softmax_scale():
    q, k, v = make_qkv(1, 64, 64, 2, 64, seed=5)
    want = np.asarray(jax_pa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), softmax_scale=0.3))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), softmax_scale=0.3).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


def test_cpu_path_launches_no_kernel():
    _build.reset_launch_counts()
    q, k, v = (torch.from_numpy(x) for x in make_qkv(1, 32, 32, 2, 64))
    flash_attention(q, k, v)
    assert _build.launch_counts["flash_fwd"] == 0


@pytest.mark.parametrize("causal", [False, True])
def test_multihead_attention_matches_jax_with_dense_mask(causal):
    b, h, lq, d = 2, 2, 40, 32
    q, k, v = make_qkv(b, lq, lq, h, d, seed=7)
    rng = np.random.RandomState(8)
    mask = rng.rand(b, lq, lq) > 0.3
    mask[0, 5] = False          # a fully masked query row
    want = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), mask=jnp.asarray(mask),
                              causal=causal, backend="xla"))
    got = multihead_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              mask=torch.from_numpy(mask),
                              causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)
    assert np.all(got[0, 5] == 0.0)
