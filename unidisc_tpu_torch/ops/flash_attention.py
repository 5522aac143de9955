"""Attention forward through the hand-written Hopper kernel
(``ops/csrc/flash_fwd.cu``), the port of the JAX package's Pallas
``flash_attention`` (``unidisc_tpu/ops/pallas_attention.py``).

``flash_attention`` takes (B, L, H, D) tensors. On a CUDA tensor it
launches the kernel (bf16, head_dim 64 or 128) or raises; on a CPU tensor
it runs ``attention_reference``, the plain PyTorch version with the same
masking rules, which mirrors the JAX oracle ``_xla_reference``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from unidisc_tpu_torch.ops import _build

MASK_VALUE = -1e30
KERNEL = "flash_fwd"
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
    need_lse: also return the (B, H, Lq) fp32 log-sum-exp of the scores.
    """
    scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return attention_reference(q, k, v, segment_ids=segment_ids,
                                   causal=causal, softmax_scale=scale,
                                   need_lse=need_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _flash_fwd_cuda(q, k, v, segment_ids, causal, scale, need_lse)


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
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3]) \
            or x.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} needs a contiguous last "
                         f"dimension, strides that are multiples of 8 and "
                         f"16-byte alignment; got strides {x.stride()}")


def _flash_fwd_cuda(q, k, v, segment_ids, causal, scale, need_lse):
    b, lq, h, d = q.shape
    lk = k.shape[1]
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q.device)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if k.shape != (b, lk, h, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if lq < 1 or lk < 1 or -(-lq // BLOCK_M) > MAX_GRID_Y:
        raise ValueError(f"flash_attention: unsupported lengths "
                         f"Lq={lq}, Lk={lk}")
    qseg = kseg = None
    if segment_ids is not None:
        qseg, kseg = segment_ids
        for name, s, n in (("q_seg", qseg, lq), ("k_seg", kseg, lk)):
            if (s.device != q.device or s.dtype != torch.int32
                    or tuple(s.shape) != (b, n) or not s.is_contiguous()):
                raise ValueError(f"flash_attention: {name} must be a "
                                 f"contiguous int32 ({b}, {n}) tensor on "
                                 f"{q.device}")

    out = torch.empty((b, lq, h, d), dtype=torch.bfloat16, device=q.device)
    lse = (torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
           if need_lse else None)
    lib = _library()
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


def _library() -> ctypes.CDLL:
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
