"""The plain version of the port's fused quantize kernel
(ops/fused_qmm.py, which the wrapper runs on a CPU tensor) against the JAX
package, at the shapes of tests/test_fused_qmm.py (B 2 x L 128 rows,
rows_per_batch % 128 == 0, so the Pallas kernel runs in interpret mode
and not its XLA fallback).

- The prologue and quantization, (q, s), against the JAX ``_prologue`` +
  ``_quantize`` that the Pallas kernel body runs: s within 1e-6 relative,
  q within one int8 step on at most 0.1% of the elements (the fp32 sums
  of the norms are taken in another order, which can move a value that
  sits on a rounding boundary).
- The whole fused product against the Pallas ``fused_qmm`` in interpret
  mode, fp32 out, no bias (the bias add is held in
  test_torch_int8_matmul.py): within 1e-6 relative, from scales that
  differ by an ulp where XLA compiles the kernel body with other roundings
  than it runs the ops one by one, plus one int8 step (127 s max(w_scale))
  for each q element of the row that moved; at most 1% of the rows may
  need a moved element, and none does in these cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.ops import fused_qmm as jax_fused
from unidisc_tpu_torch.config import MODEL_PRESETS
from unidisc_tpu_torch.ops.fused_qmm import (GENERIC, fused_qmm,
                                             fused_quantize, quantize_plan,
                                             row_plan)
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

K, N = 256, 384
B, L = 2, 128
M = B * L
SCALE_RTOL = 1e-6
MOVED_SHARE = 1e-3

CASES = {
    "layernorm_cond": dict(mode="adaln_norm", norm_type="layernorm",
                           cond=True),
    "rms_cond": dict(mode="adaln_norm", norm_type="rms", cond=True),
    "layernorm_no_cond": dict(mode="adaln_norm", norm_type="layernorm",
                              cond=False),
    "gelu": dict(mode="gelu", norm_type="layernorm", cond=False),
    "none": dict(mode="none", norm_type="layernorm", cond=False),
}


def inputs(seed):
    rng = np.random.RandomState(seed)
    return dict(
        x=(rng.randn(M, K) * 0.5).astype(np.float32),
        w_q=rng.randint(-127, 128, (N, K)).astype(np.int8),     # (N, K)
        w_scale=(rng.rand(N) * 0.02 + 0.001).astype(np.float32),
        bias=(rng.randn(N) * 0.1).astype(np.float32),
        norm_w=(rng.rand(K) + 0.5).astype(np.float32),
        shift=(rng.randn(B, K) * 0.2).astype(np.float32),
        scale=(rng.randn(B, K) * 0.2).astype(np.float32),
        modality=rng.randint(0, 2, (M,)).astype(np.int32))


def prologue_args(a, mode, norm_type, cond, to):
    kw = dict(mode=mode, norm_type=norm_type)
    if mode == "adaln_norm":
        kw["norm_w"] = to(a["norm_w"])
    if cond:
        kw.update(shift=to(a["shift"]), scale=to(a["scale"]),
                  modality=to(a["modality"]), rows_per_batch=L)
    return kw


@pytest.mark.parametrize("case", list(CASES))
def test_fused_qmm_matches_jax(case):
    c = CASES[case]
    a = inputs(seed=list(CASES).index(case))
    # bf16 activations, as the DIT hands them over
    x_bf16 = torch.from_numpy(a["x"]).bfloat16()
    jx = jnp.asarray(x_bf16.float().numpy()).astype(jnp.bfloat16)

    # (q, s) against the JAX kernel body's math
    jkw = prologue_args(a, c["mode"], c["norm_type"], c["cond"], jnp.asarray)
    x32 = jx.astype(jnp.float32)
    if c["cond"]:
        y = jax_fused._prologue(
            x32, c["mode"], c["norm_type"], jkw["norm_w"],
            jnp.repeat(jkw["shift"], L, 0), jnp.repeat(jkw["scale"], L, 0),
            jkw["modality"].astype(jnp.float32)[:, None])
    else:
        y = jax_fused._prologue(x32, c["mode"], c["norm_type"],
                                jkw.get("norm_w"), None, None, None)
    want_q, want_s = (np.asarray(t) for t in jax_fused._quantize(y))
    tkw = prologue_args(a, c["mode"], c["norm_type"], c["cond"],
                        torch.from_numpy)
    q, s = fused_quantize(x_bf16, **tkw)
    assert q.dtype == torch.int8 and s.shape == (M, 1)
    np.testing.assert_allclose(s.numpy(), want_s, rtol=SCALE_RTOL, atol=0)
    moved = np.abs(q.numpy().astype(np.int32) - want_q.astype(np.int32))
    assert moved.max() <= 1 and moved.mean() <= MOVED_SHARE

    # the fused product against the Pallas kernel in interpret mode
    want = np.asarray(jax_fused.fused_qmm(
        jx, jnp.asarray(a["w_q"].T), jnp.asarray(a["w_scale"]),
        out_dtype=jnp.float32, block_m=128, block_n=128, **jkw))
    t = torch.from_numpy
    step = 127 * s.numpy() * a["w_scale"].max()          # (M, 1)
    for backend in ("xla", "pallas"):
        got = fused_qmm(x_bf16, t(a["w_q"]), t(a["w_scale"]),
                        out_dtype=torch.float32, backend=backend,
                        **tkw).numpy()
        excess = np.abs(got - want) - SCALE_RTOL * np.abs(want)
        steps = np.ceil(np.maximum(excess, 0) / step).max(-1)
        assert (steps == 0).mean() >= 0.99 and steps.max() <= 2


def test_modality_none_modulates_every_row():
    a = inputs(seed=9)
    t = torch.from_numpy
    kw = dict(mode="adaln_norm", norm_type="rms", norm_w=t(a["norm_w"]),
              shift=t(a["shift"]), scale=t(a["scale"]), rows_per_batch=L)
    q_none = fused_quantize(t(a["x"]), **kw)
    q_ones = fused_quantize(t(a["x"]), modality=torch.ones(M), **kw)
    assert all(torch.equal(u, v) for u, v in zip(q_none, q_ones))
    with pytest.raises(ValueError, match="mode"):
        fused_quantize(t(a["x"]), mode="silu")


def test_adaln_rows_the_kernel_refuses_fail_on_the_cpu_too():
    """The kernel reads each adaLN row as a contiguous vector, one row a
    batch element: a strided last dimension (an all_gather's view along
    it) or too few rows raise on the CPU as on the card."""
    a = inputs(seed=10)
    t = torch.from_numpy
    kw = dict(mode="adaln_norm", norm_type="rms", norm_w=t(a["norm_w"]),
              rows_per_batch=L)
    shift, scale = t(a["shift"]), t(a["scale"])
    strided = shift.t().contiguous().t()
    assert strided.stride(1) != 1
    for bad in (dict(shift=strided, scale=strided),
                dict(shift=shift[:1], scale=scale[:1])):
        with pytest.raises(ValueError, match="contiguous last dimension"):
            fused_quantize(t(a["x"]), **kw, **bad)
    fused_quantize(t(a["x"]), **kw, shift=shift, scale=scale)


# --- the row kernel's width (runs on the CPU) --------------------------------
#
# row_plan / quantize_plan choose the register-resident row kernel of
# fused_qmm.cu, (lanes a row, 16-byte vectors a lane), or its generic loop.


def preset_widths():
    """(K, dtype) of the bf16 rows the presets' int8 blocks quantize: the
    hidden width (attn_qkv, mlp.0, attn_out, the head) and the MLP width
    (mlp.2) where it is at most 4,096."""
    out = set()
    for cfg in MODEL_PRESETS.values():
        out.add(cfg.hidden_size)
        if cfg.mlp_ratio * cfg.hidden_size <= 4096:
            out.add(cfg.mlp_ratio * cfg.hidden_size)
    return sorted(out)


@pytest.mark.parametrize("k", preset_widths())
def test_row_plan_takes_the_row_kernel_at_the_preset_widths(k):
    lanes, nv = row_plan(k, 2)
    assert nv >= 1 and lanes * nv * 8 == k


@pytest.mark.parametrize("k,itemsize,want", [
    (768, 2, (32, 3)), (3072, 2, (32, 12)), (768, 4, (32, 6)),
    (128, 2, (16, 1)), (64, 2, (8, 1)), (128, 4, (32, 1)), (512, 4, (32, 4)),
    (24, 2, GENERIC), (24, 4, GENERIC), (769, 2, GENERIC), (101, 4, GENERIC),
    (770, 2, GENERIC), (4100, 2, GENERIC), (5120, 2, GENERIC),
])
def test_row_plan_widths_and_the_generic_loop(k, itemsize, want):
    assert row_plan(k, itemsize) == want
    assert row_plan(k, itemsize, aligned=False) == GENERIC


def test_quantize_plan_sends_unaligned_views_to_the_generic_loop():
    k, dtype = 768, torch.bfloat16
    x = torch.zeros((6, k), dtype=dtype)
    norm_w = torch.ones(k)
    table = torch.zeros((2, 6 * k), dtype=dtype)
    shift, scale = table[:, :k], table[:, k:2 * k]   # the DIT's views
    assert quantize_plan(x) == (32, 3)
    assert quantize_plan(x, norm_w, shift, scale) == (32, 3)
    # x one element into its storage: contiguous, rows 2 bytes off 16
    x_off = torch.zeros(6 * k + 1, dtype=dtype)[1:].view(6, k)
    assert x_off.is_contiguous() and quantize_plan(x_off) == GENERIC
    # conditioning rows one element off, or rows an odd stride apart
    assert quantize_plan(x, norm_w, table[:, 1:k + 1],
                         table[:, k + 1:2 * k + 1]) == GENERIC
    odd = torch.zeros((2, 6 * k + 1), dtype=dtype)
    assert quantize_plan(x, norm_w, odd[:, :k], odd[:, k:2 * k]) == GENERIC
    assert quantize_plan(x, torch.ones(k + 1)[1:]) == GENERIC
