"""Ring attention: exact sequence-parallel attention over a process group
(port of ``unidisc_tpu/parallel/ring_attention.py``).

The sequence is split over the ranks of a group (the mesh's "seq" axis).
Each rank keeps its Q chunk while the K/V chunks travel around the ring,
one ``parallel/comm.py::shift`` to the next rank per step, and folds each
incoming block into its output. The per-shard functions take the group
where JAX takes an ``axis_name``; they are called by every rank of it,
which must agree on the arguments' shapes.

* ``ring_attention``: the plain ring, an fp32 online softmax over each
  block's scores (running max, normalizer, unnormalized output), with
  causal block skipping (a block from a later chunk contributes nothing),
  segment ids that rotate with K/V, distinct ``kv_segment_ids``, and a
  per-row any-valid-key flag that makes a fully-masked row exactly 0. It
  is differentiable: the K/V shifts are one autograd node a step
  (``comm.Shift``), whose backward sends the gradients back.
* ``ring_attention_flash``: each ring block goes through the port's
  ``ops/flash_attention.py::flash_attention(need_lse=True)`` (on a CUDA
  tensor the hand-written ``flash_fwd`` kernel, on a CPU tensor its plain
  version), and the blocks merge by their log-sum-exp. Forward memory per
  step is O(Lc), not the O(Lc^2) scores. Pad rows (segment id < 0) follow
  the kernel: they are zero. Its backward is JAX's rule: zero the pad
  rows' cotangent, then take the plain ring's gradient, recomputed under
  autograd.
* ``ring_attention_sharded``: the global entry; every rank holds the
  global (B, L, H, D), takes its chunk, runs the ring and gathers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

import torch.distributed as dist

from unidisc_tpu_torch.parallel.comm import (GatherReplicated, Shift, Tie,
                                             shift)

MASK_VALUE = -1e30


def _block(q, k, v, scale, mask):
    """One flash block: (m, l, o), o unnormalized. q: (B, Lq, H, D); k/v:
    (B, Lk, H, D); mask broadcastable to (B, H, Lq, Lk) or None."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, MASK_VALUE)
    m = s.amax(-1)                                     # (B, H, Lq)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return m, l, o


def _check_ids(segment_ids, kv_segment_ids):
    if segment_ids is None and kv_segment_ids is not None:
        raise ValueError("kv_segment_ids requires segment_ids (the "
                         "query-side ids): without them the key mask "
                         "would be silently dropped")


def ring_attention(q, k, v, segment_ids=None, *, group,
                   causal: bool = False,
                   softmax_scale: Optional[float] = None,
                   kv_segment_ids=None):
    """Per-shard plain ring. q/k/v: this rank's chunk (B, Lc, H, D);
    returns its output chunk (B, Lc, H, D) in q.dtype. segment_ids: (B,
    Lc) ids of the chunk's tokens (a token attends only within its id;
    the K/V side's ids travel with K/V); kv_segment_ids: distinct K/V-side
    ids (default segment_ids). A row that matches no key anywhere in the
    ring gives exactly zero."""
    _check_ids(segment_ids, kv_segment_ids)
    b, lc, h, d = q.shape
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    dev = q.device
    q_pos = idx * lc + torch.arange(lc, device=dev)
    kv_ids = kv_segment_ids if kv_segment_ids is not None else segment_ids
    m = torch.full((b, h, lc), -math.inf, device=dev)
    l = torch.zeros((b, h, lc), device=dev)
    acc = torch.zeros((b, h, lc, d), device=dev)
    anyv = torch.zeros((b, h, lc), dtype=torch.bool, device=dev)
    k_cur, v_cur, seg_cur = k, v, kv_ids
    for r in range(n):
        src = (idx - r) % n             # the chunk held after r shifts
        if not causal or src <= idx:
            mask = None
            if causal:
                k_pos = src * lc + torch.arange(lc, device=dev)
                mask = (k_pos[None, :] <= q_pos[:, None])[None, None]
            if segment_ids is not None:
                seg_ok = (segment_ids[:, :, None]
                          == seg_cur[:, None, :])[:, None]
                mask = seg_ok if mask is None else (mask & seg_ok)
            bm, bl, bo = _block(q, k_cur, v_cur, scale, mask)
            # with the finite MASK_VALUE a fully-masked row still
            # accumulates l = Lk, so validity is tracked on its own
            bv = torch.ones_like(anyv) if mask is None else \
                torch.broadcast_to(mask.any(-1), bm.shape)
            m_new = torch.maximum(m, bm)
            c1 = torch.exp(m - m_new)
            c2 = torch.exp(bm - m_new)
            l = l * c1 + bl * c2
            acc = acc * c1[..., None] + bo * c2[..., None]
            m, anyv = m_new, anyv | bv
        if r < n - 1:
            k_cur, v_cur = Shift.apply(group, k_cur, v_cur)
            if seg_cur is not None:
                seg_cur, = shift([seg_cur], group)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = torch.where(anyv[..., None], out, 0.0)
    out = out.transpose(1, 2).to(q.dtype)
    if n > 1 and torch.is_grad_enabled():
        # the last shifted K/V stay in the backward graph: a rank that
        # skips the blocks after the diagonal (causal) would otherwise
        # leave its later shifts out, and the ring's backward exchanges
        # must run on every rank alike
        out = Tie.apply(out, k_cur, v_cur)
    return out


def ring_attention_sharded(q, k, v, group, segment_ids=None, *,
                           causal: bool = False,
                           softmax_scale: Optional[float] = None,
                           kv_segment_ids=None):
    """Global entry: q/k/v the GLOBAL (B, L, H, D) on every rank of
    `group`; each rank takes its L-chunk, runs the plain ring and the
    chunks are gathered back. Differentiable for a loss every rank
    computes alike: a rank's gradient covers its own chunk of q, k and v.
    L must be divisible by the group size; segment_ids / kv_segment_ids
    (B, L)."""
    n = dist.get_world_size(group)
    if q.shape[1] % n:
        raise ValueError(f"sequence {q.shape[1]} not divisible by the seq "
                         f"group size {n}")
    _check_ids(segment_ids, kv_segment_ids)
    lc = q.shape[1] // n
    lo = dist.get_rank(group) * lc

    def mine(x):
        return None if x is None else x[:, lo:lo + lc]

    out = ring_attention(mine(q), mine(k), mine(v), mine(segment_ids),
                         group=group, causal=causal,
                         softmax_scale=softmax_scale,
                         kv_segment_ids=mine(kv_segment_ids))
    return GatherReplicated.apply(out, group, 1)


# ---------------------------------------------------------------------------
# The flash-kernel ring
# ---------------------------------------------------------------------------

def _flash_block(q, k, v, qseg, kseg, scale, causal,
                 kv_distinct: bool = False):
    """One ring block through flash_attention with the LSE: (out (B, Lq,
    H, D) fp32 normalized, lse (B, H, Lq) fp32, -inf on rows with no valid
    key). kv_distinct: kseg may differ from qseg, so the diagonal block's
    row r need not see itself."""
    from unidisc_tpu_torch.ops.flash_attention import flash_attention
    segs = None
    if qseg is not None:
        qseg, kseg = qseg.contiguous(), kseg.contiguous()
        segs = (qseg, kseg)
    out, lse = flash_attention(q, k, v, segment_ids=segs, causal=causal,
                               softmax_scale=scale, need_lse=True)
    if qseg is not None:
        # the kernel writes lse 0 on a row with no valid key; merged
        # across blocks such a row must weigh nothing. Validity comes
        # without the (B, Lq, Lk) mask, which the ring exists to avoid
        if causal and not kv_distinct:
            # diagonal block with shared ids: row r sees itself
            valid = qseg >= 0
        elif causal:
            # distinct kv ids: row r is valid iff some key j <= r shares
            # its id, found in row chunks of C (an O(C Lc) tile)
            lc = qseg.shape[1]
            c = min(lc, 512)
            while lc % c:
                c //= 2
            kpos = torch.arange(lc, device=q.device)
            parts = []
            for lo in range(0, lc, c):
                r = lo + torch.arange(c, device=q.device)
                eq = (qseg[:, lo:lo + c, None] == kseg[:, None, :]) \
                    & (kpos[None, None, :] <= r[None, :, None])
                parts.append(eq.any(-1))
            valid = torch.cat(parts, 1) & (qseg >= 0)
        else:
            # membership of each row's id among the block's key ids: a
            # sorted search, O(Lc log Lc) time and O(Lc) memory
            ks = torch.sort(kseg, dim=1).values
            pos = torch.searchsorted(ks, qseg.contiguous())
            found = torch.gather(ks, 1, pos.clamp(max=ks.shape[1] - 1)) \
                == qseg
            valid = found & (qseg >= 0)
        lse = torch.where(valid[:, None, :], lse, -math.inf)
    return out.float(), lse


def _merge(lse_run, out_run, lse_b, out_b):
    """Fold block (lse_b, out_b) into the running pair; lse (B, H, Lq),
    out (B, Lq, H, D)."""
    lse_new = torch.logaddexp(lse_run, lse_b)
    dead = torch.isneginf(lse_new)
    w_old = torch.where(dead, 0.0, torch.exp(lse_run - lse_new))
    w_new = torch.where(dead, 0.0, torch.exp(lse_b - lse_new))
    w_old, w_new = w_old.transpose(1, 2), w_new.transpose(1, 2)
    return lse_new, out_run * w_old[..., None] + out_b * w_new[..., None]


def ring_flash_blocks(n: int, idx: int, causal: bool) -> int:
    """flash_fwd launches of one ring_attention_flash forward on group
    rank idx of n: every block for full attention, the blocks at or before
    the diagonal for causal."""
    return idx + 1 if causal else n


def _ring_flash_impl(q, k, v, qseg, kvseg, group, causal, scale):
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    kv0 = kvseg if kvseg is not None else qseg
    # r = 0 is the diagonal block: the local causal mask applies there
    # only (earlier chunks are fully visible, later ones skipped)
    out, lse = _flash_block(q, k, v, qseg, kv0, scale, causal,
                            kv_distinct=kvseg is not None)
    k_cur, v_cur, seg_cur = k, v, kv0
    for r in range(1, n):
        moved = shift([k_cur, v_cur] + ([seg_cur] if seg_cur is not None
                                        else []), group)
        k_cur, v_cur = moved[:2]
        seg_cur = moved[2] if seg_cur is not None else None
        src = (idx - r) % n
        if causal and src > idx:
            continue
        ob, lb = _flash_block(q, k_cur, v_cur, qseg,
                              seg_cur if qseg is not None else None,
                              scale, causal=False)
        lse, out = _merge(lse, out, lb, ob)
    # rows masked in every block: lse -inf and out 0 already
    return out.to(q.dtype)


class _RingFlash(torch.autograd.Function):
    """The flash ring forward; the backward recomputes the plain ring under
    autograd (JAX's custom_vjp rule, ring_attention.py:320-344)."""

    @staticmethod
    def forward(ctx, q, k, v, qseg, kvseg, group, causal, scale):
        ctx.save_for_backward(q, k, v, qseg, kvseg)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return _ring_flash_impl(q, k, v, qseg, kvseg, group, causal, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, qseg, kvseg = ctx.saved_tensors
        if qseg is not None:
            # the flash forward makes pad rows (id < 0) exactly zero, where
            # the plain ring lets pads attend pads: zero their cotangent so
            # the gradient is that of the forward that ran
            g = g * (qseg >= 0)[:, :, None, None].to(g.dtype)
        with torch.enable_grad():
            qd, kd, vd = (x.detach().requires_grad_() for x in (q, k, v))
            out = ring_attention(qd, kd, vd, qseg, group=ctx.group,
                                 causal=ctx.causal, softmax_scale=ctx.scale,
                                 kv_segment_ids=kvseg)
            dq, dk, dv = torch.autograd.grad(out, (qd, kd, vd), g)
        return dq, dk, dv, None, None, None, None, None


def ring_attention_flash(q, k, v, segment_ids=None, *, group,
                         causal: bool = False,
                         softmax_scale: Optional[float] = None,
                         kv_segment_ids=None):
    """Per-shard flash-kernel ring, the contract of ring_attention with one
    difference: a pad query (segment id < 0) attends to nothing and gives
    zero, where the plain ring lets pads attend pads."""
    _check_ids(segment_ids, kv_segment_ids)
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _RingFlash.apply(q, k, v, segment_ids, kv_segment_ids,
                                group, causal, scale)
    return _ring_flash_impl(q, k, v, segment_ids, kv_segment_ids, group,
                            causal, scale)
