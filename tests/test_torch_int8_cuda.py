"""The hand-written int8 kernels (int8_matmul.cu, its int32 form too;
fused_qmm.cu with its two entries, fused_qmm and the dividing form's
dynamic_quantize, row_amax and quantize_by_amax) against their plain
versions, on the card. Skips where CUDA is absent. This file imports no JAX, so it
also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_int8_cuda.py

Tolerances: the int8 product is exact and its epilogue keeps the plain
version's roundings (no FMA contraction), so fp32 outputs are bit-equal and
bf16 outputs, one rounding of those, are equal too. The fused quantize
kernel sums each row in another order than PyTorch's reductions: scales
within 1e-6 relative, int8 values within one step on at most 0.1% of the
elements. dynamic_quantize takes no sum (amax does not depend on the
order) and divides as its plain version does: q and s bit-equal, on the
card and against the plain version on the CPU.
"""

import numpy as np
import pytest
import torch

from unidisc_tpu_torch.ops import _build
from unidisc_tpu_torch.ops.fused_qmm import (GENERIC, fused_quantize,
                                             fused_quantize_reference,
                                             quantize_plan)
from unidisc_tpu_torch.ops.int8_matmul import (int8_matmul,
                                               int8_matmul_reference)
from unidisc_tpu_torch.ops.quant import (dynamic_quantize,
                                         dynamic_quantize_reference)

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
    # a K that is not a multiple of 16 (here strided views) is zero-padded
    assert torch.equal(int8_matmul(xq[:, :40], s, wq[:, :40], ws),
                       int8_matmul_reference(xq[:, :40], s, wq[:, :40], ws))
    with pytest.raises(TypeError):
        int8_matmul(xq.float(), s, wq, ws)
    with pytest.raises(ValueError):
        int8_matmul(xq, s, wq.t().contiguous().t(), ws)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [24, 40, 100])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_int8_matmul_pads_k_that_is_not_a_multiple_of_16(k, out_dtype):
    need_card()
    check_int8(200, k, 77, out_dtype, True, seed=k)


def quantize_case(mode, norm_type, cond, x_dtype, seed, m=300, k=768,
                  rows_per_batch=100, cond_dtype=torch.bfloat16):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=gen, device="cuda")
    x = (torch.randn((m, k), **kw) * 0.7).to(x_dtype)
    args = dict(mode=mode, norm_type=norm_type)
    if mode == "adaln_norm":
        args["norm_w"] = torch.rand((k,), **kw) + 0.5
    if cond:
        # shift and scale as strided views of one adaLN table, as the DIT
        # hands them over
        table = (torch.randn((-(-m // rows_per_batch), 6 * k), **kw)
                 * 0.2).to(cond_dtype)
        args.update(shift=table[:, :k], scale=table[:, k:2 * k],
                    modality=torch.randint(0, 2, (m,), **kw),
                    rows_per_batch=rows_per_batch)
    return x, args


def check_quantize(x, args, plan=None):
    """fused_quantize against its plain version, with one launch; `plan`,
    where given, is the row kernel's width the wrapper must pick."""
    if plan is not None:
        assert quantize_plan(x, args.get("norm_w"), args.get("shift"),
                             args.get("scale")) == plan
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
    check_quantize(x, args)


QUANT_MODES = [("adaln_norm", "rms", True), ("adaln_norm", "layernorm", True),
               ("adaln_norm", "rms", False), ("gelu", "layernorm", False),
               ("none", "layernorm", False)]
# (M, K, rows_per_batch): the serve path's (16 rows x 384 tokens, hidden
# 768); narrow rows held by 8 or 16 lanes (in bf16); ragged K in the
# generic loop; a wide row; rows_per_batch dividing M or not
QUANT_SHAPES = {"main_path": (6144, 768, 384), "narrow_64": (96, 64, 32),
                "narrow_128": (100, 128, 30), "ragged_k_100": (300, 100, 7),
                "ragged_k_770": (130, 770, 7), "wide_3072": (64, 3072, 16)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(QUANT_SHAPES))
@pytest.mark.parametrize("case", QUANT_MODES,
                         ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_fused_quantize_over_the_row_kernels_widths(shape, case, x_dtype):
    need_card()
    m, k, rpb = QUANT_SHAPES[shape]
    x, args = quantize_case(*case, x_dtype, seed=m + k, m=m, k=k,
                            rows_per_batch=rpb)
    check_quantize(x, args, plan=GENERIC if shape.startswith("ragged")
                   else None)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_fused_quantize_takes_fp32_conditioning_rows(x_dtype):
    # an fp32 model hands fp32 adaLN rows over
    need_card()
    x, args = quantize_case("adaln_norm", "layernorm", True, x_dtype, seed=5,
                            m=1000, k=768, rows_per_batch=384,
                            cond_dtype=torch.float32)
    check_quantize(x, args, plan=(32, 3 if x_dtype == torch.bfloat16 else 6))


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["x", "cond"])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_fused_quantize_unaligned_views_take_the_generic_loop(view, x_dtype):
    need_card()
    x, args = quantize_case("adaln_norm", "rms", True, x_dtype, seed=6)
    if view == "x":
        # contiguous, one element into its storage
        moved = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
        x = moved[1:].view_as(x).copy_(x)
    else:
        k = x.shape[1]
        table = torch.zeros((args["shift"].shape[0], 6 * k + 1),
                            dtype=torch.bfloat16, device="cuda")
        table[:, 1:k + 1] = args["shift"]
        table[:, k + 1:2 * k + 1] = args["scale"]
        args.update(shift=table[:, 1:k + 1], scale=table[:, k + 1:2 * k + 1])
    check_quantize(x, args, plan=GENERIC)


def borderline_rows(seed=0, rows=64, k=96):
    """Rows whose amax makes amax / 127 and amax * (1/127) differ by an
    ulp, with values at (j + 1/2) scale (tests/test_torch_quant.py's
    generator, which needs no JAX)."""
    rng = np.random.RandomState(seed)
    inv = np.float32(1.0) / np.float32(127.0)
    out = []
    while len(out) < rows:
        amax = np.float32(rng.uniform(0.5, 4.0))
        s_div = amax / np.float32(127.0)
        if s_div == amax * inv:
            continue
        j = rng.randint(-126, 126, k - 1).astype(np.float32)
        row = ((j + np.float32(0.5)) * s_div).astype(np.float32)
        out.append(np.concatenate([[amax], row]).astype(np.float32))
    x = np.stack(out)
    return x * np.where(rng.rand(*x.shape) < 0.5, -1, 1).astype(np.float32)


def check_dynamic_quantize(x_np, x_dtype):
    """dynamic_quantize on the card against its plain version on the card
    and on the CPU, q and s bit for bit, with one launch."""
    x_cpu = torch.from_numpy(x_np).to(x_dtype)
    x = x_cpu.cuda()
    before = _build.launch_counts["dynamic_quantize"]
    q, s = dynamic_quantize(x)
    q_ref, s_ref = dynamic_quantize_reference(x)
    torch.cuda.synchronize()
    assert _build.launch_counts["dynamic_quantize"] == before + 1
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == x.shape and s.shape == (*x.shape[:-1], 1)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    q_cpu, s_cpu = dynamic_quantize_reference(x_cpu)
    assert torch.equal(q.cpu(), q_cpu) and torch.equal(s.cpu(), s_cpu)


# the serve path's three shapes (attn_out's and mlp.2's inputs at 16 rows x
# 384 tokens, the head's at 8 x 256 image rows), ragged M, and K off the
# row kernel's widths
DQ_SHAPES = [(6144, 768), (6144, 3072), (2048, 768), (1, 768), (127, 768),
             (6145, 768), (64, 24), (64, 100), (64, 770), (64, 4100)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", DQ_SHAPES)
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_dynamic_quantize_equals_its_plain_version_on_card(m, k, x_dtype):
    need_card()
    rng = np.random.RandomState(m + k)
    x = rng.randn(m, k) * rng.uniform(0.01, 8.0, (m, 1))
    check_dynamic_quantize(x.astype(np.float32), x_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zero_rows", "borderline_96",
                                  "borderline_768", "tiny_96", "tiny_768",
                                  "batched"])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_dynamic_quantize_zero_and_borderline_rows_on_card(case, x_dtype):
    need_card()
    rng = np.random.RandomState(7)
    if case == "zero_rows":
        x = (rng.randn(130, 768) * 0.7).astype(np.float32)
        x[::3] = 0.0
        x[1, :] = 0.0
        x[1, 5] = -2.0
    elif case == "batched":       # (B, L, K), as qdot hands it a 3-D input
        x = (rng.randn(4, 96, 768) * 0.7).astype(np.float32)
    else:
        x = borderline_rows(seed=3, rows=96, k=int(case.split("_")[1]))
        if case.startswith("tiny"):
            # scales below 2^-100 (down to subnormal), which the kernel
            # lifts by 2^64 before its fast path
            x = x * np.float32(2.0 ** -120)
    check_dynamic_quantize(x, x_dtype)


# the products and row kernels of the conditioning-frozen serve paths: the
# trunk over the image rows under CFG (16 rows x 256 image tokens = 4096,
# frozen_cond), distilled_stack's step 0 (8 x 384 = 3072, which writes the
# cache and so leaves the fused prologue) and its trunk (8 x 256 = 2048)
FROZEN_ROWS = {"frozen_cond_trunk": (4096, 256),
               "distilled_step0": (3072, None),
               "distilled_trunk": (2048, 256)}
TRUNK_PRODUCTS = {"attn_qkv": (768, 2304, False),
                  "attn_out": (768, 768, False),
                  "mlp_0": (768, 3072, True), "mlp_2": (3072, 768, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("rows", list(FROZEN_ROWS))
@pytest.mark.parametrize("name", list(TRUNK_PRODUCTS))
def test_int8_matmul_at_the_frozen_paths_shapes(rows, name):
    need_card()
    k, n, bias = TRUNK_PRODUCTS[name]
    check_int8(FROZEN_ROWS[rows][0], k, n, torch.bfloat16, bias,
               seed=len(rows) + len(name))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", list(FROZEN_ROWS))
def test_row_kernels_at_the_frozen_paths_shapes(rows):
    need_card()
    m, rows_per_batch = FROZEN_ROWS[rows]
    if rows_per_batch is not None:
        x, args = quantize_case("adaln_norm", "rms", True, torch.bfloat16,
                                seed=m, m=m, k=768,
                                rows_per_batch=rows_per_batch)
        check_quantize(x, args)
    rng = np.random.RandomState(m)
    for k in (768, 3072):
        x = rng.randn(m, k) * rng.uniform(0.01, 8.0, (m, 1))
        check_dynamic_quantize(x.astype(np.float32), torch.bfloat16)


# a tensor rank's row-parallel products (ops/quant.py::qdot_row_parallel):
# the int32 form of int8_matmul, and dynamic_quantize split into row_amax
# and quantize_by_amax, all exact
@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(6144, 384, 768), (6144, 1536, 768),
                                   (200, 48, 77), (1, 40, 130)])
def test_int8_matmul_int32_form_equals_its_plain_version(m, k, n):
    need_card()
    xq, _, wq, _, _ = operands(m, k, n, seed=m + k + n)
    before = _build.launch_counts["int8_matmul_int32"]
    got = int8_matmul(xq, None, wq, None, out_dtype=torch.int32)
    assert _build.launch_counts["int8_matmul_int32"] == before + 1
    want = int8_matmul_reference(xq, None, wq, None, out_dtype=torch.int32)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    with pytest.raises(ValueError, match="no bias"):
        int8_matmul(xq, None, wq, None, bias=torch.zeros(n, device="cuda"),
                    out_dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(6144, 384), (6144, 1536), (130, 96),
                                 (64, 100)])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_row_amax_and_quantize_by_amax_on_card(m, k, x_dtype):
    """A K-slice quantized by the whole row's amax: equal to the plain
    versions, and to dynamic_quantize of the whole row on the slice."""
    from unidisc_tpu_torch.ops.quant import (quantize_by_amax,
                                             quantize_by_amax_reference,
                                             row_amax, row_amax_reference)
    need_card()
    rng = np.random.RandomState(m + k)
    whole = rng.randn(m, 2 * k) * rng.uniform(0.01, 8.0, (m, 1))
    whole[::7] = 0.0
    whole[1::7, :k] = 0.0
    whole = torch.from_numpy(whole.astype(np.float32)).to("cuda", x_dtype)
    x = whole[:, :k].contiguous()
    assert torch.equal(row_amax(x), row_amax_reference(x))
    amax = row_amax(whole)
    q, s = quantize_by_amax(x, amax)
    q_ref, s_ref = quantize_by_amax_reference(x, amax)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    dq, ds = dynamic_quantize(whole)
    assert torch.equal(q, dq[:, :k]) and torch.equal(s, ds)
