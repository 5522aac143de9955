"""The plain version of the port's int8 kernel (ops/int8_matmul.py, which
the wrapper runs on a CPU tensor) against the JAX package's Pallas
int8_matmul in interpret mode, at the shapes that tile for it (those of
tests/test_int8_matmul.py), and against its XLA oracle at shapes that do
not. The integer product is exact on both sides and the fp32 epilogue is
the same sequence of roundings: without a bias the fp32 outputs are equal
bit for bit. With a bias, XLA's CPU compiler contracts the last multiply
and the bias add into one FMA inside a compiled graph (the Pallas kernel
in interpret mode, or the oracle under jit); the port, kernel and plain
version alike, keeps JAX's two roundings, so it equals the oracle run op
by op bit for bit and the compiled graph to within one rounding of the
product (2^-23 of |product| + |out|). bf16 outputs: within one bf16 ulp
(tests/test_int8_matmul.py allows the same).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.ops.int8_matmul import int8_matmul as jax_int8_matmul
from unidisc_tpu.ops.int8_matmul import xla_reference
from unidisc_tpu_torch.ops import _build
from unidisc_tpu_torch.ops.int8_matmul import (int8_matmul,
                                               int8_matmul_reference, pad_k)
from unidisc_tpu_torch.ops.quant import qdot
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

BF16_ULP = 2.0 ** -7      # relative spacing of bf16 (8-bit significand)


def operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    s = (rng.random((m, 1), np.float32) * 0.2 + 0.01).astype(np.float32)
    wq = rng.integers(-127, 128, (n, k)).astype(np.int8)     # (N, K)
    ws = (rng.random((n,), np.float32) * 0.2 + 0.01).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return xq, s, wq, ws, b


def port(xq, s, wq, ws, b, out_dtype):
    t = torch.from_numpy
    return int8_matmul(t(xq), t(s), t(wq), t(ws),
                       bias=None if b is None else t(b),
                       out_dtype=out_dtype).float().numpy()


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("m,k,n,blocks", [
    (256, 128, 256, (128, 128)),
    (384, 256, 512, (128, 256)),
    (512, 128, 128, (512, 128)),
])
def test_fp32_equals_pallas_interpret_bit_for_bit(m, k, n, blocks, bias):
    xq, s, wq, ws, b = operands(m, k, n)
    b = b if bias else None
    want = np.asarray(jax_int8_matmul(
        jnp.asarray(xq), jnp.asarray(s), jnp.asarray(wq.T), jnp.asarray(ws),
        bias=None if b is None else jnp.asarray(b), block_m=blocks[0],
        block_n=blocks[1], out_dtype=jnp.float32))
    before = dict(_build.launch_counts)
    got = port(xq, s, wq, ws, b, torch.float32)
    assert dict(_build.launch_counts) == before   # no kernel on the CPU
    if b is None:
        np.testing.assert_array_equal(got, want)
        return
    oracle = xla_reference(jnp.asarray(xq), jnp.asarray(s),
                           jnp.asarray(wq.T), jnp.asarray(ws),
                           jnp.asarray(b), out_dtype=jnp.float32)
    np.testing.assert_array_equal(got, np.asarray(oracle))
    product = port(xq, s, wq, ws, None, torch.float32)
    assert (np.abs(got - want)
            <= 2.0 ** -23 * (np.abs(product) + np.abs(want))).all()


def test_bf16_within_one_ulp_of_pallas_interpret():
    xq, s, wq, ws, b = operands(256, 128, 256, seed=1)
    want = np.asarray(jax_int8_matmul(
        jnp.asarray(xq), jnp.asarray(s), jnp.asarray(wq.T), jnp.asarray(ws),
        bias=jnp.asarray(b)), np.float32)
    np.testing.assert_allclose(port(xq, s, wq, ws, b, torch.bfloat16), want,
                               rtol=BF16_ULP, atol=0)


@pytest.mark.parametrize("m,k,n", [(40, 96, 56), (3, 16, 7)])
def test_untileable_shapes_equal_the_xla_oracle(m, k, n):
    xq, s, wq, ws, b = operands(m, k, n, seed=2)
    want = xla_reference(jnp.asarray(xq), jnp.asarray(s), jnp.asarray(wq.T),
                         jnp.asarray(ws), jnp.asarray(b),
                         out_dtype=jnp.float32)
    np.testing.assert_array_equal(port(xq, s, wq, ws, b, torch.float32),
                                  np.asarray(want))


def test_qdot_backends_agree_and_track_the_float_product():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(4, 16, 96)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(128, 96)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(128,)).astype(np.float32))
    from unidisc_tpu_torch.ops.quant import quantize_per_channel
    w_q, w_s = quantize_per_channel(w, axis=1)
    y = {be: qdot(x, w_q, w_s, bias=b, out_dtype=torch.float32, backend=be)
         for be in ("xla", "pallas")}
    assert torch.equal(y["xla"], y["pallas"]) and y["xla"].shape == (4, 16, 128)
    ref = x @ w.t() + b
    # W8A8 at these sizes: ~1% of the output scale, as tests/test_quant.py
    assert ((y["xla"] - ref).abs().mean() / ref.abs().mean()) < 0.02
    with pytest.raises(ValueError, match="quant_backend"):
        qdot(x, w_q, w_s, backend="mosaic")


# --- the kernel's launch plan (runs on the CPU) -----------------------------
#
# plan(M, N, sms) picks the tile width and the persistent grid of the
# kernel's launch. The five products of the int8 serve path (M 6144 = 16
# rows x 384 tokens; the head's M 2048 = 8 requests x 256 image rows) on
# the H100's 132 SMs, with the width the wave model gives each.
from unidisc_tpu_torch.ops.int8_matmul import (BLOCK_M, BLOCK_NS,  # noqa: E402
                                               TILE_OVERHEAD, plan)

H100_SMS = 132
PATH_PLANS = {
    # name: (M, N, block_n)
    "attn_qkv": (6144, 2304, 192),     # 576 tiles, 4.36 waves
    "attn_out": (6144, 768, 192),      # 192 tiles, 1.45 waves
    "mlp_0": (6144, 3072, 192),        # 768 tiles, 5.82 waves
    "mlp_2": (6144, 768, 192),         # 192 tiles, 1.45 waves
    "head": (2048, 16384, 256),        # 1,024 tiles, 7.76 waves
}


def ceil_div(a, b):
    return -(-a // b)


@pytest.mark.parametrize("name", sorted(PATH_PLANS))
def test_plan_at_the_serve_path_shapes(name):
    m, n, want_bn = PATH_PLANS[name]
    bn, tiles, grid = plan(m, n, H100_SMS)
    assert bn == want_bn
    assert tiles == ceil_div(m, BLOCK_M) * ceil_div(n, bn)
    assert grid == H100_SMS


@pytest.mark.parametrize("m,n,sms", [(6144, 768, 132), (2048, 16384, 132),
                                     (1, 8, 132), (127, 136, 132),
                                     (6145, 1000, 114), (300, 77, 16)])
def test_plan_takes_the_cheapest_width_and_a_grid_within_the_tiles(m, n,
                                                                    sms):
    bn, tiles, grid = plan(m, n, sms)
    assert bn in BLOCK_NS

    def cost(width):
        t = ceil_div(m, BLOCK_M) * ceil_div(n, width)
        return ceil_div(t, sms) * (width + TILE_OVERHEAD)

    assert cost(bn) == min(cost(w) for w in BLOCK_NS)
    # on a tie the widest width wins: fewer passes over the A rows
    assert bn == max(w for w in BLOCK_NS if cost(w) == cost(bn))
    assert tiles == ceil_div(m, BLOCK_M) * ceil_div(n, bn)
    assert 1 <= grid == min(tiles, sms)


def test_plan_narrows_the_tile_when_the_grid_would_be_short():
    # one tile row: the narrowest width gives the most blocks
    bn, tiles, grid = plan(128, 1024, H100_SMS)
    assert (bn, tiles, grid) == (128, 8, 8)


@pytest.mark.parametrize("k", [24, 100])
def test_pad_k_keeps_the_product(k):
    # the card's wrapper zero-pads K to a multiple of 16 for the kernel's
    # tensor maps; the plain product of the padded operands is the same
    xq, s, wq, ws, b = (torch.from_numpy(a) for a in operands(33, k, 40,
                                                             seed=k))
    xp, wp = pad_k(xq, wq)
    kp = xp.shape[1]
    assert kp % 16 == 0 and k < kp < k + 16 and wp.shape == (40, kp)
    assert torch.equal(xp[:, :k], xq) and not xp[:, k:].any()
    assert torch.equal(wp[:, :k], wq) and not wp[:, k:].any()
    for out_dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(
            int8_matmul_reference(xp, s, wp, ws, bias=b, out_dtype=out_dtype),
            int8_matmul_reference(xq, s, wq, ws, bias=b, out_dtype=out_dtype))
    # a K that is a multiple of 16 passes through untouched
    assert all(a is b for a, b in zip(pad_k(xp, wp), (xp, wp)))
