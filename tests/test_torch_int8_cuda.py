"""The hand-written int8 kernels (int8_matmul.cu, fused_qmm.cu) against
their plain versions, on the card. Skips where CUDA is absent. This file
imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_int8_cuda.py

Tolerances: the int8 product is exact and its epilogue keeps the plain
version's roundings (no FMA contraction), so fp32 outputs are bit-equal and
bf16 outputs, one rounding of those, are equal too. The fused quantize
kernel sums each row in another order than PyTorch's reductions: scales
within 1e-6 relative, int8 values within one step on at most 0.1% of the
elements.
"""

import pytest
import torch

from unidisc_tpu_torch.ops import _build
from unidisc_tpu_torch.ops.fused_qmm import (fused_quantize,
                                             fused_quantize_reference)
from unidisc_tpu_torch.ops.int8_matmul import (int8_matmul,
                                               int8_matmul_reference)

SCALE_RTOL, MOVED_SHARE = 1e-6, 1e-3


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run chip_smoke.py or this file "
                    "on the card")


def operands(m, k, n, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=gen, device="cuda")
    xq = torch.randint(-127, 128, (m, k), dtype=torch.int8, **kw)
    s = torch.rand((m, 1), **kw) * 0.2 + 0.01
    wq = torch.randint(-127, 128, (n, k), dtype=torch.int8, **kw)
    ws = torch.rand((n,), **kw) * 0.2 + 0.01
    b = torch.randn((n,), **kw)
    return xq, s, wq, ws, b


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(256, 128, 256), (200, 48, 77),
                                   (1, 3072, 130), (333, 768, 1000)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_int8_matmul_equals_reference_on_card(m, k, n, out_dtype, bias):
    need_card()
    xq, s, wq, ws, b = operands(m, k, n, seed=m + k + n)
    b = b if bias else None
    before = _build.launch_counts["int8_matmul"]
    got = int8_matmul(xq, s, wq, ws, bias=b, out_dtype=out_dtype)
    want = int8_matmul_reference(xq, s, wq, ws, bias=b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert _build.launch_counts["int8_matmul"] == before + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.equal(got, want)


def check_int8(m, k, n, out_dtype, bias, seed, w_rows=None, **kw):
    """int8_matmul against its plain version, equal bit for bit. w_rows
    takes a row slice w_q[v0:] of a taller weight (the t2i head's)."""
    xq, s, wq, ws, b = operands(m, k, n if w_rows is None else w_rows, seed)
    if w_rows is not None:
        v0 = w_rows - n
        wq, ws, b = wq[v0:], ws[v0:], b[v0:]
    b = b if bias else None
    before = _build.launch_counts["int8_matmul"]
    if kw:
        from unidisc_tpu_torch.ops.int8_matmul import _int8_matmul_cuda
        got = _int8_matmul_cuda(xq, s, wq, ws, b, out_dtype, **kw)
    else:
        got = int8_matmul(xq, s, wq, ws, bias=b, out_dtype=out_dtype)
    want = int8_matmul_reference(xq, s, wq, ws, bias=b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert _build.launch_counts["int8_matmul"] == before + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.equal(got, want)


# the five products of the int8 serve path (M 16 rows x 384 tokens; the
# head over 8 x 256 image rows), each with the tile width plan() gives it
PATH_SHAPES = {"attn_qkv": (6144, 768, 2304), "attn_out": (6144, 768, 768),
               "mlp_0": (6144, 768, 3072), "mlp_2": (6144, 3072, 768),
               "head": (2048, 768, 16384)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PATH_SHAPES))
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_int8_matmul_at_the_serve_path_shapes(name, out_dtype, bias):
    need_card()
    m, k, n = PATH_SHAPES[name]
    check_int8(m, k, n, out_dtype, bias, seed=len(name))


# ragged M and N (TMA's zero fill at the tile edges, odd N stored pair by
# pair), K tails past the 128-byte box, a long K
RAGGED = [(1, 128, 136), (127, 256, 8), (6145, 768, 136), (300, 16, 77),
          (129, 48, 300), (64, 3072, 264), (1, 16, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", RAGGED)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_int8_matmul_on_ragged_shapes(m, k, n, out_dtype):
    need_card()
    check_int8(m, k, n, out_dtype, True, seed=m + k + n)


@pytest.mark.cuda
@pytest.mark.parametrize("block_n", [128, 192, 256])
@pytest.mark.parametrize("m,k,n", [(333, 784, 1000), (6144, 768, 768)])
def test_int8_matmul_every_tile_width(block_n, m, k, n):
    # each of the kernel's tile widths, whatever plan() would choose
    need_card()
    check_int8(m, k, n, torch.float32, True, seed=block_n, block_n=block_n)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_int8_matmul_takes_the_heads_row_slice(out_dtype):
    # the t2i head multiplies by w_q[v0:], the image vocabulary's rows of
    # the full (text + image) weight: a contiguous matrix at an offset
    need_card()
    check_int8(2048, 768, 16384, out_dtype, True, seed=3,
               w_rows=16384 + 4099)


@pytest.mark.cuda
def test_int8_matmul_takes_a_row_slice_and_rejects_bad_operands():
    need_card()
    xq, s, wq, ws, b = operands(64, 128, 300, seed=1)
    v0 = 37          # a row slice of the weight, as the t2i head takes
    got = int8_matmul(xq, s, wq[v0 + 3:], ws[v0 + 3:], bias=b[v0 + 3:])
    want = int8_matmul_reference(xq, s, wq[v0 + 3:], ws[v0 + 3:],
                                 bias=b[v0 + 3:])
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_matmul(xq[:, :40], s, wq[:, :40], ws)
    with pytest.raises(TypeError):
        int8_matmul(xq.float(), s, wq, ws)
    with pytest.raises(ValueError):
        int8_matmul(xq, s, wq.t().contiguous().t(), ws)


def quantize_case(mode, norm_type, cond, x_dtype, seed, m=300, k=768,
                  rows_per_batch=100):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=gen, device="cuda")
    x = (torch.randn((m, k), **kw) * 0.7).to(x_dtype)
    args = dict(mode=mode, norm_type=norm_type)
    if mode == "adaln_norm":
        args["norm_w"] = torch.rand((k,), **kw) + 0.5
    if cond:
        # shift and scale as strided bf16 views of one adaLN table, as the
        # DIT hands them over
        table = (torch.randn((m // rows_per_batch, 6 * k), **kw)
                 * 0.2).bfloat16()
        args.update(shift=table[:, :k], scale=table[:, k:2 * k],
                    modality=torch.randint(0, 2, (m,), **kw),
                    rows_per_batch=rows_per_batch)
    return x, args


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ("adaln_norm", "rms", True), ("adaln_norm", "layernorm", True),
    ("adaln_norm", "rms", False), ("gelu", "layernorm", False),
    ("none", "layernorm", False)], ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_fused_quantize_matches_reference_on_card(case, x_dtype):
    need_card()
    x, args = quantize_case(*case, x_dtype, seed=len(str(case)))
    before = _build.launch_counts["fused_qmm"]
    q, s = fused_quantize(x, **args)
    q_ref, s_ref = fused_quantize_reference(x, **args)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_qmm"] == before + 1
    assert q.dtype == torch.int8 and s.shape == (x.shape[0], 1)
    assert ((s - s_ref).abs() <= SCALE_RTOL * s_ref.abs()).all()
    moved = (q.int() - q_ref.int()).abs()
    assert moved.max().item() <= 1
    assert moved.float().mean().item() <= MOVED_SHARE
