"""Attention through the hand-written Hopper kernels, the port of the JAX
package's Pallas ``flash_attention`` (``unidisc_tpu/ops/pallas_attention.py``):
the forward in ``ops/csrc/flash_fwd.cu``, the backward in
``ops/csrc/flash_bwd_dq.cu`` (dQ, and di = rowsum(O dO)) and
``ops/csrc/flash_bwd_dkv.cu`` (dK, dV).

``flash_attention`` takes (B, L, H, D) tensors. On a CUDA tensor it
launches the kernels (bf16, head_dim 64 or 128) or raises; on a CPU tensor
it runs the plain PyTorch versions with the same masking rules:
``attention_reference`` (which mirrors the JAX oracle ``_xla_reference``)
and ``attention_backward_reference`` (which mirrors ``_flash_bwd``).

When grad is enabled and an input requires grad, the call goes through
``_FlashAttention``, a ``torch.autograd.Function`` (the port of the
``jax.custom_vjp`` ``_flash``): its forward asks the kernel for the LSE
and its backward launches the two backward kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from unidisc_tpu_torch.ops import _build

MASK_VALUE = -1e30
KERNEL = "flash_fwd"
BWD_DQ = "flash_bwd_dq"     # launch-count and source names of the two
BWD_DKV = "flash_bwd_dkv"   # backward kernels
HEAD_DIMS = (64, 128)
BLOCK_M = 64          # query rows per thread block (flash_fwd.cu)
MAX_GRID_Y = 65535


def _mask(lq: int, lk: int, segment_ids, causal: bool, device):
    """Boolean (B or 1, 1, Lq, Lk) mask, or None when nothing is masked."""
    mask = None
    if causal:
        mask = (torch.arange(lk, device=device)[None, :]
                <= torch.arange(lq, device=device)[:, None])[None, None]
    if segment_ids is not None:
        qseg, kseg = segment_ids
        seg = ((qseg[:, :, None] == kseg[:, None, :])
               & (qseg >= 0)[:, :, None])[:, None]
        mask = seg if mask is None else (mask & seg)
    return mask


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, segment_ids: Optional[Tuple] = None,
                        causal: bool = False,
                        softmax_scale: Optional[float] = None,
                        need_lse: bool = False):
    """Plain PyTorch attention with the kernel's masking rules: masked
    scores take -1e30, rows with no allowed key give zero output and LSE 0,
    and the probabilities are cast to v.dtype before P V.

    q: (B, Lq, H, D); k, v: (B, Lk, H, D). Returns out (B, Lq, H, D), and
    with need_lse also lse (B, H, Lq) fp32.
    """
    scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _mask(q.shape[1], k.shape[1], segment_ids, causal, q.device)
    if mask is not None:
        logits = torch.where(mask, logits, MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    valid = None
    if mask is not None:
        valid = mask.any(-1, keepdim=True)
        probs = torch.where(valid, probs, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v).to(q.dtype)
    if not need_lse:
        return out
    lse = torch.logsumexp(logits, dim=-1)
    if valid is not None:
        lse = torch.where(valid[..., 0], lse, 0.0)
    return out, lse


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, o: torch.Tensor,
                                 lse: torch.Tensor, do: torch.Tensor, *,
                                 segment_ids: Optional[Tuple] = None,
                                 causal: bool = False,
                                 softmax_scale: Optional[float] = None):
    """Plain PyTorch attention backward, all in fp32, mirroring the Pallas
    ``_flash_bwd``/``_masked_p``: di = rowsum(O * dO); P = exp(S - LSE)
    recomputed with masked scores at an additive -1e30 (a row with no
    allowed key has LSE 0, so its P is 0); dV = P^T dO;
    dS = P (dO V^T - di) scale; dK = dS^T Q; dQ = dS K.

    q, o, do: (B, Lq, H, D); k, v: (B, Lk, H, D); lse: (B, H, Lq) fp32 from
    the forward. Returns (dq, dk, dv) in the (B, L, H, D) layout and in
    q's dtype.
    """
    scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    mask = _mask(q.shape[1], k.shape[1], segment_ids, causal, q.device)
    if mask is not None:
        s = s + torch.where(mask, 0.0, MASK_VALUE)
    p = torch.exp(s - lse.float()[..., None])
    di = (o.float() * dof).sum(-1).transpose(1, 2)          # (B, H, Lq)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - di[..., None]) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    segment_ids: Optional[Tuple] = None,
                    causal: bool = False,
                    softmax_scale: Optional[float] = None,
                    need_lse: bool = False):
    """Attention forward, (B, L, H, D) layout.

    segment_ids: optional (q_seg (B, Lq), k_seg (B, Lk)) int32; a query
      attends only to keys of its own segment, and a query with a negative
      segment attends to nothing.
    causal: key index <= query index.
    need_lse: also return the (B, H, Lq) fp32 log-sum-exp of the scores
      (never differentiated).

    Under grad (grad enabled and q, k or v requiring it) the call is
    differentiable through the backward kernels.
    """
    scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        qseg, kseg = segment_ids if segment_ids is not None else (None, None)
        out, lse = _FlashAttention.apply(q, k, v, qseg, kseg, causal, scale)
        return (out, lse) if need_lse else out
    return _forward(q, k, v, segment_ids, causal, scale, need_lse)


def _forward(q, k, v, segment_ids, causal, scale, need_lse):
    if q.device.type == "cpu":
        return attention_reference(q, k, v, segment_ids=segment_ids,
                                   causal=causal, softmax_scale=scale,
                                   need_lse=need_lse)
    return _flash_fwd_cuda(q, k, v, segment_ids, causal, scale, need_lse)


class _FlashAttention(torch.autograd.Function):
    """Differentiable attention: the forward kernel with the LSE residual,
    the backward kernels (plain versions on CPU tensors). Replaces the JAX
    package's ``_flash`` custom_vjp (pallas_attention.py:565-583)."""

    @staticmethod
    def forward(ctx, q, k, v, qseg, kseg, causal, scale):
        seg = (qseg, kseg) if qseg is not None else None
        out, lse = _forward(q, k, v, seg, causal, scale, need_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, qseg, kseg)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, qseg, kseg = ctx.saved_tensors
        seg = (qseg, kseg) if qseg is not None else None
        if do.device.type == "cpu":
            dq, dk, dv = attention_backward_reference(
                q, k, v, o, lse, do, segment_ids=seg, causal=ctx.causal,
                softmax_scale=ctx.scale)
        else:
            dq, dk, dv = _flash_bwd_cuda(q, k, v, o, lse, do, seg,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def _layout_ok(x: torch.Tensor) -> bool:
    return (x.ndim == 4 and x.stride(-1) == 1
            and not any(s % 8 for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0)


def _check_operand(name: str, x: torch.Tensor, device) -> None:
    if x.device != device:
        raise ValueError(f"flash_attention: {name} is on {x.device}, "
                         f"q on {device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: {name} must be bfloat16 on "
                        f"CUDA, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"flash_attention: {name} must be (B, L, H, D), "
                         f"got shape {tuple(x.shape)}")
    if not _layout_ok(x):
        raise ValueError(f"flash_attention: {name} needs a contiguous last "
                         f"dimension, strides that are multiples of 8 and "
                         f"16-byte alignment; got strides {x.stride()}")


def _tma_ready(x: torch.Tensor) -> torch.Tensor:
    """x itself, or a contiguous copy where a dimension of size > 1 has
    stride 0 (a broadcast view): the kernels read their operands through
    TMA tensor maps, which take no zero stride."""
    strides = x.stride()
    if 0 in strides and any(st == 0 and n > 1
                            for st, n in zip(strides, x.shape)):
        return x.contiguous()
    return x


def _check_qkv(q, k, v, segment_ids):
    """Check the operands both kernels take; returns the segment ids as
    (q_seg, k_seg), each None when there are none."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q.device)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if k.shape != (b, lk, h, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if lq < 1 or lk < 1 or -(-max(lq, lk) // BLOCK_M) > MAX_GRID_Y:
        raise ValueError(f"flash_attention: unsupported lengths "
                         f"Lq={lq}, Lk={lk}")
    if segment_ids is None:
        return None, None
    qseg, kseg = segment_ids
    for name, s, n in (("q_seg", qseg, lq), ("k_seg", kseg, lk)):
        if (s.device != q.device or s.dtype != torch.int32
                or tuple(s.shape) != (b, n) or not s.is_contiguous()):
            raise ValueError(f"flash_attention: {name} must be a "
                             f"contiguous int32 ({b}, {n}) tensor on "
                             f"{q.device}")
    return qseg, kseg


def _flash_fwd_cuda(q, k, v, segment_ids, causal, scale, need_lse):
    b, lq, h, d = q.shape
    lk = k.shape[1]
    qseg, kseg = _check_qkv(q, k, v, segment_ids)
    q, k, v = _tma_ready(q), _tma_ready(k), _tma_ready(v)
    out = torch.empty((b, lq, h, d), dtype=torch.bfloat16, device=q.device)
    lse = (torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
           if need_lse else None)
    lib = _fwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            qseg.data_ptr() if qseg is not None else None,
            kseg.data_ptr() if kseg is not None else None,
            b, h, lq, lk, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], scale, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: "
                           f"{lib.flash_fwd_error_string(err).decode()}")
    _build.launch_counts[KERNEL] += 1
    return (out, lse) if need_lse else out


def _fwd_library() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.flash_fwd_bf16
    if fn.argtypes is None:
        # every pointer and the stream as c_void_p: ctypes would otherwise
        # pass them as 32-bit ints
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([ptr] * 7 + [i32] * 5 + [i64] * 12
                       + [ctypes.c_float, i32, ptr])
        fn.restype = i32
        lib.flash_fwd_error_string.argtypes = [i32]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


def bwd_operands(q, k, v, o, do):
    """q, k, v, o and dO as the backward kernels read them, all through
    TMA tensor maps: dO copied to a contiguous tensor where its layout does
    not suit the kernels (autograd may hand over a strided or expanded
    gradient), and any broadcast operand copied (``_tma_ready``); every
    other view is passed on as it is."""
    if not _layout_ok(do):
        do = do.contiguous()
    return tuple(_tma_ready(x) for x in (q, k, v, o, do))


def _bwd_library(name: str) -> ctypes.CDLL:
    """The library of one backward kernel, ``flash_bwd_dq`` or
    ``flash_bwd_dkv``; both entry points, ``<name>_bf16``, take (10
    pointers, batch, heads, lq, lk, head_dim, strides, scale, causal,
    stream)."""
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_bf16")
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 10 + [i32] * 5 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i32, ptr]
        fn.restype = i32
        err_fn = getattr(lib, f"{name}_error_string")
        err_fn.argtypes = [i32]
        err_fn.restype = ctypes.c_char_p
    return lib


def _flash_bwd_cuda(q, k, v, o, lse, do, segment_ids, causal, scale):
    """dq, dk, dv from the two backward kernels (dq first: it writes the
    di that the dkv kernel reads)."""
    grads, launch_dq, launch_dkv = bwd_launches(q, k, v, o, lse, do,
                                                segment_ids, causal, scale)
    launch_dq()
    launch_dkv()
    return grads


def bwd_launches(q, k, v, o, lse, do, segment_ids, causal, scale):
    """Check the operands of the backward kernels and allocate their
    outputs. Returns ((dq, dk, dv), launch_dq, launch_dkv): each launch
    function launches one kernel on the current stream, raises if the
    launch fails and adds one to that kernel's launch count. launch_dq must
    run before launch_dkv."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    qseg, kseg = _check_qkv(q, k, v, segment_ids)
    q, k, v, o, do = bwd_operands(q, k, v, o, do)
    for name, x in (("o", o), ("do", do)):
        _check_operand(name, x, q.device)
        if x.shape != q.shape:
            raise ValueError(f"flash_attention backward: {name} has shape "
                             f"{tuple(x.shape)}, q {tuple(q.shape)}")
    if (lse.device != q.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (b, h, lq) or not lse.is_contiguous()):
        raise ValueError(f"flash_attention backward: lse must be a "
                         f"contiguous fp32 ({b}, {h}, {lq}) tensor on "
                         f"{q.device}")
    dev = q.device
    dq = torch.empty((b, lq, h, d), dtype=torch.bfloat16, device=dev)
    dk = torch.empty((b, lk, h, d), dtype=torch.bfloat16, device=dev)
    dv = torch.empty((b, lk, h, d), dtype=torch.bfloat16, device=dev)
    di = torch.empty((b, h, lq), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 24)(*(
        s for x in (q, k, v, o, do, dq, dk, dv) for s in x.stride()[:3]))
    seg_ptrs = (qseg.data_ptr() if qseg is not None else None,
                kseg.data_ptr() if kseg is not None else None)
    tail = (b, h, lq, lk, d, strides, scale, int(causal))
    lib_dq = _bwd_library(BWD_DQ)
    lib_dkv = _bwd_library(BWD_DKV)

    def run(lib, name, ptrs):
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, f"{name}_bf16")(*ptrs, *seg_ptrs, *tail,
                                               stream)
        if err != 0:
            msg = getattr(lib, f"{name}_error_string")(err).decode()
            raise RuntimeError(f"{name} launch failed: {msg}")
        _build.launch_counts[name] += 1

    def launch_dq():
        run(lib_dq, BWD_DQ,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr()))

    def launch_dkv():
        run(lib_dkv, BWD_DKV,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr()))

    return (dq, dk, dv), launch_dq, launch_dkv
