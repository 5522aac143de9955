"""Fused prologue + dynamic int8 quantization, through the hand-written
Hopper kernel ``ops/csrc/fused_qmm.cu`` (the port of the JAX package's
Pallas ``fused_qmm``, ``unidisc_tpu/ops/fused_qmm.py``), followed by the
int8 product.

``fused_quantize`` computes, per row and in fp32, the prologue (norm and
modality-gated adaLN modulation, or tanh-GELU, or identity) and the
per-row symmetric int8 quantization with ``s = amax * (1/127)`` and
``round(y * (1/s))``: the multiplying form of ``fused_qmm.py:88-94``, which
differs from the dividing form of ``ops/quant.py`` on borderline values.
On a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
``fused_quantize_reference``, which mirrors the JAX ``_prologue`` and
``_quantize`` (including the two-pass variance ``mean((x - mu)^2)``).

``fused_qmm`` adds the product: through the int8 kernel
(``ops/int8_matmul.py``) under ``backend="pallas"``, through its plain
version otherwise.

The same source carries the kernel of ``ops/quant.py::dynamic_quantize``
(``_dynamic_quantize_cuda``, counted as "dynamic_quantize"): the row
kernel with no prologue, in the dividing form; and that quantize split in
two for a tensor-parallel rank's K-slice of a row (``ops/quant.py::
row_amax`` and ``quantize_by_amax``): ``_row_amax_cuda`` ("row_amax")
and ``_quantize_by_amax_cuda`` ("quantize_by_amax"). ``row_plan`` and
``quantize_plan`` choose the row kernel's width, or its generic loop, from
the row's width and the operands' alignment.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from unidisc_tpu_torch.ops import _build
from unidisc_tpu_torch.ops.int8_matmul import _ptr, int8_product

KERNEL = "fused_qmm"
DQ_KERNEL = "dynamic_quantize"
AMAX_KERNEL = "row_amax"
GIVEN_KERNEL = "quantize_by_amax"
# the forms of the C entry row_quantize_div (fused_qmm.cu's Form)
ROW_FORMS = {DQ_KERNEL: 1, AMAX_KERNEL: 2, GIVEN_KERNEL: 3}
MODES = {"none": 0, "adaln_norm": 1, "gelu": 2}
NORM_TYPES = {"layernorm": 0, "rms": 1}
X_DTYPES = (torch.bfloat16, torch.float32)
GELU_C = 0.7978845608028654     # sqrt(2 / pi)
# the row kernel's widths (fused_qmm.cu): a row of 8 or 16 16-byte vectors
# takes that many lanes, one vector each; a row of 32 n vectors takes a
# warp, n vectors a lane, for each n in LANE_VECTORS
VECTOR_BYTES = 16
NARROW_LANES = (8, 16)
LANE_VECTORS = (1, 2, 3, 4, 5, 6, 8, 12, 16)
GENERIC = (32, 0)               # the generic loop: one warp a row


def _prologue(x, mode, norm_type, norm_w, shift, scale, mod):
    """fp32 in and out; shift, scale (M, K) and mod (M, 1) or None."""
    if mode == "adaln_norm":
        if norm_type == "layernorm":
            mu = x.mean(-1, keepdim=True)
            var = (x - mu).square().mean(-1, keepdim=True)
            y = (x - mu) * torch.rsqrt(var + 1e-5)
        elif norm_type == "rms":
            y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6)
        else:
            raise ValueError(norm_type)
        y = y * norm_w
        if shift is not None:
            # modality-gated adaLN: rows with m = 0 (text) pass through
            y = y * (1.0 + scale * mod) + shift * mod
        return y
    if mode == "gelu":
        return 0.5 * x * (1.0 + torch.tanh(GELU_C * (x + 0.044715 * (x * x * x))))
    if mode == "none":
        return x
    raise ValueError(f"unknown fused_qmm mode {mode!r}")


def _quantize(y):
    amax = y.abs().amax(-1, keepdim=True)
    s = torch.where(amax > 0, amax * (1.0 / 127.0), 1.0)
    return torch.round(y * (1.0 / s)).to(torch.int8), s


def fused_quantize_reference(x: torch.Tensor, *, mode: str = "none",
                             norm_type: str = "layernorm",
                             norm_w: Optional[torch.Tensor] = None,
                             shift: Optional[torch.Tensor] = None,
                             scale: Optional[torch.Tensor] = None,
                             modality: Optional[torch.Tensor] = None,
                             rows_per_batch: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: x (M, K) -> (q (M, K) int8, s (M, 1)
    fp32). shift/scale are (B, K), one row per batch element, each row of x
    taking row ``index // rows_per_batch``; modality (M,) gates them (None
    means every row is modulated)."""
    m_rows = x.shape[0]
    sh = sc = mod = None
    if shift is not None:
        batch_of_row = torch.arange(m_rows, device=x.device) \
            // _rows_per_batch(rows_per_batch)
        sh = shift.float()[batch_of_row]
        sc = scale.float()[batch_of_row]
        mod = (torch.ones((m_rows, 1), device=x.device) if modality is None
               else modality.reshape(m_rows, 1).float())
    y = _prologue(x.float(), mode, norm_type,
                  None if norm_w is None else norm_w.float(), sh, sc, mod)
    return _quantize(y)


def _rows_per_batch(rows_per_batch) -> int:
    if rows_per_batch is None or rows_per_batch < 1:
        raise ValueError("fused_qmm: conditioning needs rows_per_batch >= 1")
    return rows_per_batch


def fused_quantize(x: torch.Tensor, *, mode: str = "none",
                   norm_type: str = "layernorm",
                   norm_w: Optional[torch.Tensor] = None,
                   shift: Optional[torch.Tensor] = None,
                   scale: Optional[torch.Tensor] = None,
                   modality: Optional[torch.Tensor] = None,
                   rows_per_batch: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prologue + per-row int8 quantization: x (M, K) bf16 or fp32 ->
    (q (M, K) int8, s (M, 1) fp32). Arguments as in
    ``fused_quantize_reference``."""
    kw = dict(mode=mode, norm_type=norm_type, norm_w=norm_w, shift=shift,
              scale=scale, modality=modality, rows_per_batch=rows_per_batch)
    if mode not in MODES:
        raise ValueError(f"unknown fused_qmm mode {mode!r}")
    if mode == "adaln_norm" and shift is not None:
        # the kernel's contract, held on every device: a layout the card
        # refuses fails on the CPU too
        _check_adaln(x, shift, scale, rows_per_batch)
    if x.device.type == "cpu":
        return fused_quantize_reference(x, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"fused_qmm: unsupported device {x.device}")
    return _fused_quantize_cuda(x, **kw)


def fused_qmm(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, *,
              bias: Optional[torch.Tensor] = None, mode: str = "none",
              norm_type: str = "layernorm",
              norm_w: Optional[torch.Tensor] = None,
              shift: Optional[torch.Tensor] = None,
              scale: Optional[torch.Tensor] = None,
              modality: Optional[torch.Tensor] = None,
              rows_per_batch: Optional[int] = None,
              out_dtype: torch.dtype = torch.bfloat16,
              backend: str = "xla") -> torch.Tensor:
    """prologue -> dynamic int8 -> int8 product with the fused epilogue.

    x: (M, K); w_q (N, K) int8; w_scale (N,) fp32; bias (N,) or None.
    backend "pallas": the product through the int8 kernel; "xla": through
    its plain version."""
    matmul = int8_product(backend)
    y_q, s = fused_quantize(x, mode=mode, norm_type=norm_type, norm_w=norm_w,
                            shift=shift, scale=scale, modality=modality,
                            rows_per_batch=rows_per_batch)
    return matmul(y_q, s, w_q, w_scale, bias=bias, out_dtype=out_dtype)


def row_plan(k: int, itemsize: int, aligned: bool = True
             ) -> Tuple[int, int]:
    """The row kernel's width for rows of `k` elements of `itemsize` bytes:
    (lanes a row, 16-byte vectors a lane), or GENERIC, the generic loop,
    for a row the kernel is not built for or operands that are not
    16-byte aligned."""
    if not aligned or (k * itemsize) % VECTOR_BYTES:
        return GENERIC
    vectors = k * itemsize // VECTOR_BYTES
    if vectors in NARROW_LANES:
        return vectors, 1
    if vectors % 32 == 0 and vectors // 32 in LANE_VECTORS:
        return 32, vectors // 32
    return GENERIC


def _aligned(t: Optional[torch.Tensor]) -> bool:
    """t (None, or a matrix or vector with a contiguous last dimension)
    starts on a 16-byte boundary and each of its rows does too."""
    if t is None:
        return True
    rows_aligned = t.ndim < 2 or (t.stride(0) * t.element_size()) \
        % VECTOR_BYTES == 0
    return t.data_ptr() % VECTOR_BYTES == 0 and rows_aligned


def quantize_plan(x: torch.Tensor, norm_w: Optional[torch.Tensor] = None,
                  shift: Optional[torch.Tensor] = None,
                  scale: Optional[torch.Tensor] = None) -> Tuple[int, int]:
    """``row_plan`` for the operands of one launch: x (M, K) contiguous,
    and the fp32 norm_w and the shift and scale rows the kernel reads."""
    aligned = all(_aligned(t) for t in (x, norm_w, shift, scale))
    return row_plan(x.shape[-1], x.element_size(), aligned)


def _fused_quantize_cuda(x, *, mode, norm_type, norm_w, shift, scale,
                         modality, rows_per_batch):
    if x.dtype not in X_DTYPES:
        raise TypeError(f"fused_qmm: x must be one of {X_DTYPES}, got "
                        f"{x.dtype}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"fused_qmm: x must be a contiguous (M, K) "
                         f"matrix, got shape {tuple(x.shape)} strides "
                         f"{x.stride()}")
    m_rows, k = x.shape
    dev = x.device

    def on_device(name, t):
        if t.device != dev:
            raise ValueError(f"fused_qmm: {name} is on {t.device}, x on "
                             f"{dev}")
        return t

    if norm_type not in NORM_TYPES:
        raise ValueError(f"unknown norm_type {norm_type!r}")
    if mode == "adaln_norm":
        if norm_w is None or norm_w.shape != (k,):
            raise ValueError(f"fused_qmm: adaln_norm needs norm_w ({k},)")
        norm_w = on_device("norm_w", norm_w.float().contiguous())
    else:
        norm_w = None
    cond = mode == "adaln_norm" and shift is not None
    rpb, stride, cond_bf16 = 1, 0, 0
    if cond:
        rpb = _rows_per_batch(rows_per_batch)
        for name, t in (("shift", shift), ("scale", scale)):
            on_device(name, t)
        stride, cond_bf16 = shift.stride(0), int(shift.dtype == torch.bfloat16)
        if modality is not None:
            modality = on_device("modality",
                                 modality.reshape(-1).float().contiguous())
            if modality.numel() != m_rows:
                raise ValueError(f"fused_qmm: modality must have {m_rows} "
                                 f"elements")
    else:
        shift = scale = modality = None
    q = torch.empty((m_rows, k), dtype=torch.int8, device=dev)
    s = torch.empty((m_rows, 1), dtype=torch.float32, device=dev)
    lanes, nv = quantize_plan(x, norm_w, shift, scale)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_qmm(
            x.data_ptr(), ptr(norm_w), ptr(shift), ptr(scale), ptr(modality),
            q.data_ptr(), s.data_ptr(), stride, m_rows, k, rpb, MODES[mode],
            NORM_TYPES[norm_type], lanes, nv, int(x.dtype == torch.bfloat16),
            cond_bf16, stream)
    _check(lib, err, KERNEL)
    _build.launch_counts[KERNEL] += 1
    return q, s


def _check_adaln(x: torch.Tensor, shift: torch.Tensor,
                 scale: Optional[torch.Tensor],
                 rows_per_batch: Optional[int]) -> None:
    """The adaLN rows the row kernel reads: shift and scale (n_batch, K)
    bf16 or fp32 with a contiguous last dimension, one dtype and one
    layout, n_batch = ceil(M / rows_per_batch)."""
    k = x.shape[-1]
    n_batch = -(-(x.numel() // k) // _rows_per_batch(rows_per_batch))
    for name, t in (("shift", shift), ("scale", scale)):
        if (t is None or t.ndim != 2 or t.shape[0] < n_batch
                or t.shape[1] != k or t.stride(1) != 1
                or t.dtype not in X_DTYPES):
            raise ValueError(f"fused_qmm: {name} must be a ({n_batch}, "
                             f"{k}) bf16 or fp32 matrix with a "
                             f"contiguous last dimension")
    if shift.dtype != scale.dtype or shift.stride() != scale.stride():
        raise ValueError("fused_qmm: shift and scale must share dtype "
                         "and strides")


def _check_rows(x: torch.Tensor, name: str) -> None:
    """x: a contiguous bf16 or fp32 (M, K) matrix with M, K >= 1."""
    if x.dtype not in X_DTYPES:
        raise TypeError(f"{name}: x must be one of {X_DTYPES}, got "
                        f"{x.dtype}")
    if x.ndim != 2 or not x.is_contiguous() or min(x.shape) < 1:
        raise ValueError(f"{name}: x must be a contiguous (M, K) matrix "
                         f"with M, K >= 1, got shape {tuple(x.shape)} "
                         f"strides {x.stride()}")


def _row_cuda(x: torch.Tensor, kernel: str,
              amax: Optional[torch.Tensor] = None
              ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The row kernel with no prologue, in the dividing form (the C entry
    ``row_quantize_div``) as `kernel` names it (ROW_FORMS): x (M, K) bf16
    or fp32 with contiguous rows, amax (M, 1) fp32 for GIVEN_KERNEL ->
    (q (M, K) int8, or None for AMAX_KERNEL; s (M, 1) fp32, the scales or
    AMAX_KERNEL's amaxes)."""
    _check_rows(x, kernel)
    m_rows, k = x.shape
    dev = x.device
    if amax is not None:
        amax = amax.reshape(-1).float().contiguous()
        if amax.numel() != m_rows or amax.device != dev:
            raise ValueError(f"{kernel}: amax must have {m_rows} elements "
                             f"on {dev}, got {amax.numel()} on "
                             f"{amax.device}")
    q = None if kernel == AMAX_KERNEL else torch.empty(
        (m_rows, k), dtype=torch.int8, device=dev)
    s = torch.empty((m_rows, 1), dtype=torch.float32, device=dev)
    lanes, nv = quantize_plan(x)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.row_quantize_div(
            x.data_ptr(), _ptr(amax), _ptr(q), s.data_ptr(), m_rows, k,
            lanes, nv, int(x.dtype == torch.bfloat16), ROW_FORMS[kernel],
            stream)
    _check(lib, err, kernel)
    _build.launch_counts[kernel] += 1
    return q, s


def _dynamic_quantize_cuda(x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ops/quant.py::dynamic_quantize`` through the row kernel: x (M, K)
    bf16 or fp32 with contiguous rows -> (q (M, K) int8, s (M, 1) fp32),
    s = amax / 127 and q = round(x / s), as its plain version."""
    return _row_cuda(x, DQ_KERNEL)


def _row_amax_cuda(x: torch.Tensor) -> torch.Tensor:
    """``ops/quant.py::row_amax`` through the row kernel: x (M, K) bf16 or
    fp32 with contiguous rows -> each row's amax(|x|), fp32 (M, 1)."""
    return _row_cuda(x, AMAX_KERNEL)[1]


def _quantize_by_amax_cuda(x: torch.Tensor, amax: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ops/quant.py::quantize_by_amax`` through the row kernel: x (M, K)
    bf16 or fp32 with contiguous rows and amax (M, 1) fp32 -> (q (M, K)
    int8, s (M, 1) fp32), s = amax / 127 and q = round(x / s)."""
    return _row_cuda(x, GIVEN_KERNEL, amax)


def _check(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.fused_qmm_error_string(err).decode()}")


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.fused_qmm.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fused_qmm.argtypes = ([ptr] * 7 + [ctypes.c_longlong]
                                  + [i32] * 9 + [ptr])
        lib.fused_qmm.restype = i32
        lib.row_quantize_div.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
        lib.row_quantize_div.restype = i32
        lib.fused_qmm_error_string.argtypes = [i32]
        lib.fused_qmm_error_string.restype = ctypes.c_char_p
    return lib
