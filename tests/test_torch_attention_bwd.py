"""The port's attention backward against the JAX package's.

`attention_backward_reference` is the plain version of the backward
kernels in `ops/csrc/flash_bwd_dq.cu` and `ops/csrc/flash_bwd_dkv.cu`. It is held against the Pallas
`_flash_bwd` (its `_bwd_dkv_kernel` and `_bwd_dq_kernel` in interpret mode
on the CPU) fed the same O and LSE, and against `jax.grad` of the Pallas
`flash_attention`. The port's autograd Function on CPU tensors is held
against `jax.grad` and against autograd through `attention_reference`.

Tolerance atol 3e-3, rtol 2e-3 against the Pallas backward, as in
tests/test_pallas_attention.py (fp32 on both sides; the Pallas kernels sum
over padded 128-row tiles in another order). Against autograd through the
port's own plain forward, atol 1e-4 (the same fp32 math, one recompute
of P).

The kernels themselves are held against `attention_backward_reference` on
the card by tests/test_torch_flash_cuda.py and chip_smoke.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.ops import pallas_attention as jax_pa
from unidisc_tpu_torch.ops import _build
from unidisc_tpu_torch.ops.flash_attention import (
    attention_backward_reference, attention_reference, bwd_operands,
    flash_attention)
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

ATOL, RTOL = 3e-3, 2e-3

CASES = {
    # name: (B, Lq, Lk, H, D, causal, segments)
    "unaligned_segments_padding": (2, 200, 200, 2, 64, False, True),
    "causal": (2, 128, 128, 2, 64, True, False),
    "multi_tile_128x512": (1, 128, 512, 2, 64, False, False),
    "head_dim_128": (2, 96, 96, 2, 128, False, False),
}


def segments(b, length):
    """Three packed samples per row and a tail of -1 padding rows."""
    segs = np.zeros((b, length), np.int32)
    segs[:, length // 3:2 * length // 3] = 1
    segs[:, 2 * length // 3:] = 2
    segs[0, length - length // 6:] = -1
    return segs


def case_inputs(name):
    b, lq, lk, h, d, causal, segs = CASES[name]
    rng = np.random.RandomState(len(name))
    q = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, lk, h, d)).astype(np.float32)
    g = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    seg = segments(b, lq) if segs else None
    return q, k, v, g, seg, causal


def to_bhld(x):
    return jnp.transpose(jnp.asarray(x), (0, 2, 1, 3))


def from_bhld(x):
    return np.ascontiguousarray(np.transpose(np.asarray(x), (0, 2, 1, 3)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_reference_matches_pallas_backward(name):
    q, k, v, g, seg, causal = case_inputs(name)
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    jseg = (jnp.asarray(seg), jnp.asarray(seg)) if seg is not None else None
    o_j, lse_j = jax_pa._flash_fwd(to_bhld(q), to_bhld(k), to_bhld(v), jseg,
                                   causal, scale, need_lse=True)
    want = jax_pa._flash_bwd(to_bhld(q), to_bhld(k), to_bhld(v), jseg, o_j,
                             lse_j, to_bhld(g), causal, scale)
    lq = q.shape[1]
    tseg = (torch.from_numpy(seg),) * 2 if seg is not None else None
    got = attention_backward_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(from_bhld(o_j)),
        torch.from_numpy(np.array(lse_j)[:, :, :lq, 0].copy()),
        torch.from_numpy(g), segment_ids=tseg, causal=causal,
        softmax_scale=scale)
    for gname, gt, wt in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(gt.numpy(), from_bhld(wt), atol=ATOL,
                                   rtol=RTOL, err_msg=gname)
    if seg is not None:
        pad = seg < 0     # padded rows and keys get no gradient
        for gt in got:
            assert np.all(gt.numpy()[pad] == 0.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_autograd_function_matches_jax_grad(name):
    q, k, v, g, seg, causal = case_inputs(name)
    jseg = (jnp.asarray(seg), jnp.asarray(seg)) if seg is not None else None

    def jloss(q, k, v):
        out = jax_pa.flash_attention(q, k, v, segment_ids=jseg, causal=causal)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tseg = (torch.from_numpy(seg),) * 2 if seg is not None else None
    _build.reset_launch_counts()
    out = flash_attention(tq, tk, tv, segment_ids=tseg, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    assert sum(_build.launch_counts.values()) == 0   # CPU: plain versions
    for gname, gt, wt in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=ATOL,
                                   rtol=RTOL, err_msg=gname)


@pytest.mark.parametrize("causal,segs", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_autograd_function_matches_autograd_of_plain_forward(causal, segs):
    q, k, v, g, _, _ = case_inputs("causal")
    seg = torch.from_numpy(segments(q.shape[0], q.shape[1])) if segs \
        else None
    kw = {"causal": causal, "segment_ids": (seg, seg) if segs else None}
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves, **kw), leaves,
                              torch.from_numpy(g))
    leaves2 = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(attention_reference(*leaves2, **kw), leaves2,
                               torch.from_numpy(g))
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), wt.numpy(), atol=1e-4,
                                   rtol=1e-4)


def test_need_lse_under_grad_returns_a_constant_lse():
    q, k, v, g, _, _ = case_inputs("causal")
    tq = torch.from_numpy(q).requires_grad_()
    out, lse = flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                               need_lse=True)
    assert out.requires_grad and not lse.requires_grad
    _, want = attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), need_lse=True)
    assert torch.equal(lse, want)


# --- how the backward kernels receive their operands (runs on the CPU) -----
#
# Both backward kernels read q, k, v, o and dO through TMA tensor maps,
# which take a contiguous last dimension and no zero stride. bwd_operands
# copies only what the maps cannot describe.

def _views(b=2, l=5, h=4, d=64):
    qkv = torch.zeros((b, l, 3, h, d), dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)       # the DIT's projection views
    o = torch.randn((b, l, h, d)).bfloat16()
    do = torch.randn((b, l, h, d)).bfloat16()
    return q, k, v, o, do


def test_bwd_operands_leave_kernel_ready_views_alone():
    q, k, v, o, do = _views()
    heads_outer = torch.randn((2, 4, 5, 64)).bfloat16().transpose(1, 2)
    out = bwd_operands(q, k, v, o, heads_outer)
    for got, given in zip(out, (q, k, v, o, heads_outer)):
        assert got is given


@pytest.mark.parametrize("which", ["o", "do"])
def test_bwd_operands_copy_a_broadcast_o_or_do(which):
    q, k, v, o, do = _views()
    one_head = {"o": o, "do": do}[which][:, :, :1].expand(2, 5, 4, 64)
    args = [q, k, v, o, do]
    args[3 if which == "o" else 4] = one_head
    out = bwd_operands(*args)
    got = out[3 if which == "o" else 4]
    assert got is not one_head and got.is_contiguous()
    assert torch.equal(got, one_head)
    for i in (0, 1, 2):
        assert out[i] is args[i]


def test_bwd_operands_make_a_strided_do_contiguous():
    q, k, v, o, _ = _views()
    # a gradient whose last dimension is not contiguous, and the expanded
    # scalar that out.sum() hands over
    strided = torch.randn((2, 5, 64, 4)).bfloat16().transpose(2, 3)
    scalar = torch.full((), 0.5, dtype=torch.bfloat16).expand(2, 5, 4, 64)
    for do in (strided, scalar):
        got = bwd_operands(q, k, v, o, do)[4]
        assert got.is_contiguous() and torch.equal(got, do)
