"""int8 W8A8 matrix product with the dequantizing epilogue, through the
hand-written Hopper kernel ``ops/csrc/int8_matmul.cu`` (the port of the
JAX package's Pallas ``int8_matmul``, ``unidisc_tpu/ops/int8_matmul.py``).

    out = (x_q @ w_q^T)_int32 * s_row * w_scale_col (+ bias)   -> out_dtype

With ``out_dtype=torch.int32`` the kernel skips its epilogue and writes
the int32 accumulator ``x_q @ w_q^T`` itself (the raw form, counted as
"int8_matmul_int32"): a tensor-parallel rank's partial product of a
row-parallel layer, summed exactly over the group before the one epilogue
(``ops/quant.py::qdot_row_parallel``).

The weight is stored in the port's (N, K) layout, K contiguous: a row
slice (the t2i head's image vocabulary) is itself a contiguous (N', K)
matrix. On a CUDA tensor ``int8_matmul`` launches the kernel or raises; on
a CPU tensor it runs ``int8_matmul_reference``, which mirrors the JAX
oracle ``xla_reference``: the integer product exactly, then the fp32
epilogue in JAX's order, ``(acc * s) * w_scale``, then ``+ bias``, then the
cast.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from unidisc_tpu_torch.ops import _build

KERNEL = "int8_matmul"
RAW_KERNEL = "int8_matmul_int32"   # the launch count of the raw form
BLOCK_M = 128               # output rows per tile (int8_matmul.cu)
BLOCK_NS = (256, 192, 128)  # the tile widths the kernel is built for
# A tile's cost in the wave model of `plan`, in output columns: BLOCK_N for
# its products and stores plus a share that every tile pays whatever its
# width (its A rows, the ring's refill, the epilogue's fixed steps). 32 makes
# the model pick the fastest of the three widths at each of the five
# products of the int8 serve path on an H100 (PERF.md §6).
TILE_OVERHEAD = 32
MAX_TILES = 2 ** 31 - 1
# the C entry's output kinds: fp32 and bf16 take the epilogue, int32 is
# the raw accumulator
OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def int8_matmul_reference(x_q: torch.Tensor, s: torch.Tensor,
                          w_q: torch.Tensor, w_scale: torch.Tensor, *,
                          bias: Optional[torch.Tensor] = None,
                          out_dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """The kernel's plain version. x_q (M, K) int8, s (M, 1) fp32,
    w_q (N, K) int8, w_scale (N,), bias (N,) or None -> (M, N) out_dtype;
    out_dtype int32: the accumulator itself (s, w_scale and bias unread).

    The product is taken in fp64, where every partial sum of int8 x int8
    products is an exact integer (|acc| <= 127^2 K < 2^53), so the result
    is the int32 accumulator whatever the summation order; its cast to fp32
    rounds as JAX's int32 -> fp32 cast does."""
    acc = x_q.double() @ w_q.double().t()
    if out_dtype == torch.int32:
        return acc.to(torch.int32)
    return int8_epilogue(acc.to(torch.int32), s, w_scale, bias=bias,
                         out_dtype=out_dtype)


def int8_epilogue(acc: torch.Tensor, s: torch.Tensor,
                  w_scale: torch.Tensor, *,
                  bias: Optional[torch.Tensor] = None,
                  out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The epilogue in JAX's order: the int32 accumulator (M, N) cast to
    fp32, ``(acc * s) * w_scale``, then ``+ bias``, then the cast to
    out_dtype; each step a PyTorch op that rounds once, so it equals the
    kernel's fused epilogue (which keeps nvcc from contracting any of it)
    on every device."""
    out = acc.float() * s.float().reshape(-1, 1) * w_scale.float()[None, :]
    if bias is not None:
        out = out + bias.float()[None, :]
    return out.to(out_dtype)


def int8_matmul(x_q: torch.Tensor, s: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor, *,
                bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(x_q int8 (M, K), s fp32 (M, 1)) x (w_q int8 (N, K), w_scale (N,))
    -> out_dtype (M, N), the epilogue fused; out_dtype int32: the raw
    accumulator, s and w_scale unread (None will do) and no bias.

    On the card: both int8 operands K-contiguous and 16-byte aligned, any
    M, N and K (a K that is not a multiple of 16, which the TMA tensor
    maps' row strides need, is zero-padded: ``pad_k``)."""
    if x_q.device.type == "cpu":
        return int8_matmul_reference(x_q, s, w_q, w_scale, bias=bias,
                                     out_dtype=out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x_q.device}")
    return _int8_matmul_cuda(x_q, s, w_q, w_scale, bias, out_dtype)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A C pointer argument: the tensor's address, or NULL for None."""
    return None if t is None else t.data_ptr()


def int8_product(backend: str):
    """The int8 product of a ``model.quant_backend``: the kernel wrapper
    for "pallas", its plain version for "xla"."""
    if backend == "pallas":
        return int8_matmul
    if backend == "xla":
        return int8_matmul_reference
    raise ValueError(f"unknown quant_backend {backend!r}")


def plan(m: int, n: int, sms: int) -> Tuple[int, int, int]:
    """The kernel's launch for an (M, N) output on a card of `sms`
    streaming multiprocessors: (block_n, tiles, grid).

    The persistent grid has one block per SM (at most one per tile), and
    an SM that takes ceil(tiles / sms) tiles sets the time. Each width in
    BLOCK_NS is costed as ceil(tiles / sms) x (block_n + TILE_OVERHEAD) and
    the cheapest wins, the widest on a tie: wide tiles read the A rows
    fewer times, narrow ones fill the last wave better."""
    best = None
    for bn in BLOCK_NS:
        tiles = math.ceil(m / BLOCK_M) * math.ceil(n / bn)
        cost = math.ceil(tiles / sms) * (bn + TILE_OVERHEAD)
        if best is None or cost < best[0]:
            best = (cost, bn, tiles)
    _, bn, tiles = best
    return bn, tiles, min(tiles, sms)


def pad_k(x_q: torch.Tensor, w_q: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_q (M, K) and w_q (N, K) with K zero-padded to the next multiple
    of 16; the operands themselves where K is one already. The zeros add
    nothing to the int32 sums, so the product is the same."""
    pad = -x_q.shape[1] % 16
    if pad == 0:
        return x_q, w_q
    return F.pad(x_q, (0, pad)), F.pad(w_q, (0, pad))


def _aligned_rows(x: torch.Tensor) -> bool:
    return x.stride(-1) == 1 and x.stride(0) == x.shape[1] \
        and x.data_ptr() % 16 == 0


def _int8_matmul_cuda(x_q, s, w_q, w_scale, bias, out_dtype, block_n=None):
    """The kernel's launch; block_n (one of BLOCK_NS) overrides plan's
    choice of tile width, for measurement."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_matmul: x_q and w_q must be int8, got "
                        f"{x_q.dtype} and {w_q.dtype}")
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[1]:
        raise ValueError(f"int8_matmul: shapes x_q {tuple(x_q.shape)} and "
                         f"w_q {tuple(w_q.shape)} (N, K) disagree")
    x_q, w_q = pad_k(x_q, w_q)
    m, k = x_q.shape
    n = w_q.shape[0]
    if m < 1 or n < 1 or -(-m // BLOCK_M) * -(-n // min(BLOCK_NS)) \
            > MAX_TILES:
        raise ValueError(f"int8_matmul: unsupported M = {m}, N = {n}")
    if out_dtype not in OUT_KINDS:
        raise TypeError(f"int8_matmul: out_dtype {out_dtype} not in "
                        f"{tuple(OUT_KINDS)}")
    raw = out_dtype == torch.int32
    if raw and bias is not None:
        raise ValueError("int8_matmul: the int32 form takes no bias (it "
                         "writes the accumulator; add the bias after the "
                         "epilogue)")
    dev = x_q.device
    for name, t in (("x_q", x_q), ("w_q", w_q)):
        if t.device != dev:
            raise ValueError(f"int8_matmul: {name} is on {t.device}, x_q "
                             f"on {dev}")
        if not _aligned_rows(t):
            raise ValueError(f"int8_matmul: {name} needs contiguous rows "
                             f"and 16-byte alignment; got strides "
                             f"{t.stride()}")
    # the epilogue reads fp32 vectors (JAX casts w_scale and bias to fp32
    # in its epilogue); these are no-ops for fp32 inputs
    if raw:
        s = w_scale = None
    else:
        s = s.reshape(-1).float().contiguous()
        w_scale = w_scale.float().contiguous()
        if s.numel() != m or w_scale.shape != (n,):
            raise ValueError(f"int8_matmul: s must have {m} and w_scale "
                             f"{n} elements")
    if bias is not None:
        bias = bias.float().contiguous()
        if bias.shape != (n,):
            raise ValueError(f"int8_matmul: bias must be ({n},)")
    for name, t in (("s", s), ("w_scale", w_scale), ("bias", bias)):
        if t is not None and t.device != dev:
            raise ValueError(f"int8_matmul: {name} is on {t.device}, x_q "
                             f"on {dev}")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    lib = _library()
    sms = _sm_count(dev)
    bn, tiles, grid = plan(m, n, sms)
    if block_n is not None:
        if block_n not in BLOCK_NS:
            raise ValueError(f"int8_matmul: block_n {block_n} not in "
                             f"{BLOCK_NS}")
        bn = block_n
        grid = min(sms, -(-m // BLOCK_M) * -(-n // bn))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.int8_matmul(
            x_q.data_ptr(), _ptr(s), w_q.data_ptr(), _ptr(w_scale), _ptr(bias),
            out.data_ptr(), m, n, k, bn, grid, OUT_KINDS[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul launch failed: "
                           f"{lib.int8_matmul_error_string(err).decode()}")
    _build.launch_counts[RAW_KERNEL if raw else KERNEL] += 1
    return out


_sm_counts = {}


def _sm_count(dev: torch.device) -> int:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.int8_matmul.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.int8_matmul.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
        lib.int8_matmul.restype = i32
        lib.int8_matmul_error_string.argtypes = [i32]
        lib.int8_matmul_error_string.restype = ctypes.c_char_p
    return lib
