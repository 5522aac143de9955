#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--out chiprun_out/chip_smoke.json]

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

  1. device: CUDA must be available; print the card's name and power limit.
  2. build: compile every kernel source under unidisc_tpu_torch/ops/csrc
     with nvcc, one process per source, all started together.
  3. kernels: hold each kernel against its plain PyTorch version on the
     card at the main paths' shapes and the other listed shapes, and time
     the kernel, the plain version and one PyTorch library call (ms: CUDA
     events around 20 calls of the Python wrapper; device_ms: the summed
     device time of the kernels those calls launch, from torch.profiler;
     host_us: the wrapper's host time per call): the
     attention forward (flash_fwd), the two attention backward kernels
     (flash_bwd_dq, flash_bwd_dkv), the int8 product (int8_matmul; fp32
     output bit-exact, bf16 within one ulp) at the five products of the
     int8 serve path, the fused quantize kernel (fused_qmm; scales
     within 1e-6 relative, int8 values within one step on at most 0.1% of
     the elements) in each of its modes, and the per-row quantize of the
     int8 path (dynamic_quantize; q and s bit-exact) at its three shapes.
  4. serve path: build the flagship text->image engine at full width with
     random weights from the seed; check full-width logits through the
     kernel against the plain path; check the sampler on the card against
     the CPU on a tiny model; then serve 8 requests through
     InferenceEngine.run_batch with the launch counts set to 0 just
     before and read just after, and check the tokens that come out.
  4b. int8 serve path: the same weights quantized into the engine of
     build_engine(quantize="int8") with FLAGSHIP_INT8_OVERRIDES; check its
     full-width logits against the plain int8 path and the bf16 model,
     the int8 sampler on the card against the CPU on a tiny model, and
     serve 8 requests with the counts of all four serving kernels checked
     exactly.
  5. train path: check one full-width gradient (FLAGSHIP_TRAIN_OVERRIDES,
     batch 32) through the kernels against the plain path; then train the
     flagship for 20 steps through Trainer.fit on one synthetic batch with
     the launch counts set to 0 just before and read just after, check
     that the loss falls, the counts per step, the EMA, and that a
     checkpoint from step 10 gives step 11's loss again.
  6. print the kernels line, the card line and the result line.

The full record is written to --out as JSON. Numbers are measured on the
card this run lands on; the bound uses the H100 SXM's published peaks.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from unidisc_tpu_torch.config import (FLAGSHIP_INT8_OVERRIDES,
                                      FLAGSHIP_OVERRIDES,
                                      FLAGSHIP_TRAIN_OVERRIDES, Config)
from unidisc_tpu_torch.data.synthetic import SyntheticDataLoader
from unidisc_tpu_torch.models.dit import DIT, randomize_
from unidisc_tpu_torch.ops import _build
from unidisc_tpu_torch.ops.flash_attention import (
    attention_backward_reference, attention_reference, bwd_launches,
    flash_attention)
from unidisc_tpu_torch.ops.fused_qmm import (fused_quantize,
                                             fused_quantize_reference)
from unidisc_tpu_torch.ops.int8_matmul import (int8_matmul,
                                               int8_matmul_reference)
from unidisc_tpu_torch.ops.quant import quantize_dit_params, quantize_model
from unidisc_tpu_torch.sampling.t2i_fast import build_t2i_sampler
from unidisc_tpu_torch.serving.engine import build_engine
from unidisc_tpu_torch.training.train_state import (compute_batch_loss,
                                                    make_apply_fn)
from unidisc_tpu_torch.training.trainer import Trainer

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16, published
INT8_OP_PER_S = 1979e12        # H100 SXM dense int8, published
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
OUT_TOL = 2e-2    # bf16 outputs of magnitude ~1 round at 4e-3; the kernel
#                   rounds unnormalised P, the reference normalised P
LSE_TOL = 1e-3    # fp32 on both sides: summation order of Q K^T
BWD_REL_TOL = 2e-2  # max abs error <= 2e-2 x max |grad|: the kernels round
#                     P and dS to bf16 before the second product of each
#                     pair and write bf16 gradients (2^-9 relative each)
BF16_ULP = 2.0 ** -7   # relative spacing of bf16 (8-bit significand)
Q_SCALE_RTOL = 1e-6    # fused_qmm scales: fp32 row sums in another order
Q_MOVED_SHARE = 1e-3   # ... can move a value on a rounding boundary by one
REQUESTS = 8      # batch 8 -> 16 rows under CFG
TRAIN_BATCH = 32
TRAIN_STEPS = 20
CKPT_STEP = 10

KERNELS = {
    "flash_fwd": {
        "route": "cuda",
        "source": "unidisc_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "unidisc_tpu/ops/pallas_attention.py:119",
        "also_replaces": "unidisc_tpu/ops/pallas_attention.py:47",
    },
    "flash_bwd_dq": {
        "route": "cuda",
        "source": "unidisc_tpu_torch/ops/csrc/flash_bwd_dq.cu",
        "replaces": "unidisc_tpu/ops/pallas_attention.py:449",
    },
    "flash_bwd_dkv": {
        "route": "cuda",
        "source": "unidisc_tpu_torch/ops/csrc/flash_bwd_dkv.cu",
        "replaces": "unidisc_tpu/ops/pallas_attention.py:402",
    },
    "int8_matmul": {
        "route": "cuda",
        "source": "unidisc_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "unidisc_tpu/ops/int8_matmul.py:53",
    },
    "fused_qmm": {
        "route": "cuda",
        "source": "unidisc_tpu_torch/ops/csrc/fused_qmm.cu",
        "replaces": "unidisc_tpu/ops/fused_qmm.py:97",
    },
    # the int8 path's per-row activation quantize: no Pallas kernel in the
    # JAX package (XLA fuses it); an entry of the fused_qmm source
    "dynamic_quantize": {
        "route": "cuda",
        "source": "unidisc_tpu_torch/ops/csrc/fused_qmm.cu",
        "replaces": "unidisc_tpu/ops/quant.py:51",
    },
}
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call: the device time of every kernel (and device
    copy) that a call of fn launches, from torch.profiler's CUDA trace of
    `iters` calls. Unlike time_ms, host work between launches is not
    counted, so a kernel faster than its wrapper's host path is still
    timed. The trace can lose an event (19 of 20 launches were seen on the
    card), so each kernel name contributes its mean duration times the
    whole number of launches a call makes of it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name].append(e.time_range.elapsed_us())
    per_call = {name: round(len(times) / iters)
                for name, times in by_name.items()}
    if not by_name or not any(per_call.values()):
        raise RuntimeError(f"torch.profiler recorded no device time in "
                           f"{iters} calls")
    return sum(statistics.fmean(times) * per_call[name]
               for name, times in by_name.items()) / 1e3


def host_us(fn, iters: int = 50, warmup: int = 3) -> float:
    """Host time of one call of fn with the device idle (synchronised
    before and after each call, so a full launch queue never blocks the
    host): the median over `iters` calls, in microseconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def phase_build() -> dict:
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        paths = list(ex.map(_build.build, names))
    for name in names:
        _build.load(name)
    seconds = time.perf_counter() - t0
    print(f"build: {len(names)} kernel source(s) in {seconds:.1f} s")
    for name in names:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "built" in line:
                print(f"  {name}: {line.strip()}")
    return {"seconds": seconds, "libraries": [p.name for p in paths]}


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # name, (B, H, L, D), causal, segments; the first is the serve path's
    # shape (16 rows = batch 8 under CFG, small preset: 12 heads of 64),
    # the second the train path's (batch 32)
    ("main_path", (16, 12, 384, 64), False, False),
    ("train_path", (32, 12, 384, 64), False, False),
    ("extra_large_head_dim", (4, 16, 384, 128), False, False),
    ("long_tiled_range", (2, 12, 1024, 64), False, False),
    ("causal_segments_padding", (2, 8, 512, 128), True, True),
]


def attention_inputs(shape, causal, segs, gen):
    b, h, l, d = shape
    # q, k, v as views of one (B, L, 3, H, D) projection, as the DIT
    # hands them over (v keeps the projection's strides)
    qkv = torch.randn((b, l, 3, h, d), generator=gen, device="cuda",
                      dtype=torch.float32).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    q, k = q.contiguous(), k.contiguous()
    kw = {"causal": causal}
    mask = None
    if segs:
        seg = torch.zeros((b, l), dtype=torch.int32, device="cuda")
        seg[:, l // 3:] = 1
        seg[:, 2 * l // 3:] = 2
        seg[0, l - l // 8:] = -1           # padding rows attend to nothing
        kw["segment_ids"] = (seg, seg)
        mask = ((seg[:, :, None] == seg[:, None, :])
                & (seg >= 0)[:, :, None])[:, None]
    if causal:
        cm = torch.ones((l, l), dtype=torch.bool, device="cuda").tril()
        mask = cm[None, None] if mask is None else (mask & cm)
    return q, k, v, kw, mask


def attention_bound(shape, mask, segs):
    """Least time for the work: bytes of Q, K, V, O (and the segment ids)
    moved once, and 4 D FLOPs per allowed (query, key) pair."""
    b, h, l, d = shape
    nbytes = 4 * b * l * h * d * 2
    if segs:
        nbytes += 2 * b * l * 4
    if mask is not None:
        pairs = int(mask.expand(b, 1, l, l).sum().item()) * h
    else:
        pairs = b * h * l * l
    flops = 4.0 * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def phase_kernels(seed: int) -> list:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for name, shape, causal, segs in ATTN_CASES:
        q, k, v, kw, mask = attention_inputs(shape, causal, segs, gen)
        need_lse = name != "main_path"   # training asks for the LSE
        out = flash_attention(q, k, v, need_lse=need_lse, **kw)
        ref = attention_reference(q, k, v, need_lse=need_lse, **kw)
        torch.cuda.synchronize()
        if need_lse:
            (out, lse), (ref, ref_lse) = out, ref
            lse_err = (lse - ref_lse).abs().max().item()
        else:
            lse_err = None
        err = (out.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out.float()).all().item())
        if segs:
            pad = kw["segment_ids"][0] < 0
            if not bool((out[pad] == 0).all().item()):
                raise AssertionError(f"{name}: padding rows are not zero")
        if not finite or err > OUT_TOL or (lse_err is not None
                                           and lse_err > LSE_TOL):
            raise AssertionError(
                f"flash_fwd disagrees with attention_reference at {name} "
                f"{shape}: max_abs_err {err} (tol {OUT_TOL}), lse_err "
                f"{lse_err} (tol {LSE_TOL}), finite {finite}")
        def kernel():
            return flash_attention(q, k, v, **kw)

        plain_ms = time_ms(lambda: attention_reference(q, k, v, **kw),
                           iters=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        bound_ms, bound_by, nbytes, flops = attention_bound(shape, mask,
                                                            segs)
        row = {"case": name, "shape_bhld": list(shape), "causal": causal,
               "segments": segs, "max_abs_err": err, "tol": OUT_TOL,
               "lse_err": lse_err, "ms": time_ms(kernel),
               "device_ms": device_ms(kernel), "host_us": host_us(kernel),
               "plain_ms": plain_ms, "library_ms": time_ms(library),
               "library_device_ms": device_ms(library),
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "flops": flops}
        rows.append(row)
        print("kernel flash_fwd " + json.dumps(row))
    return rows


BWD_CASES = [
    # the train path's shape (batch 32, small preset) and the forward's
    # other cases
    ("train_path", (32, 12, 384, 64), False, False),
    ("extra_large_head_dim", (4, 16, 384, 128), False, False),
    ("long_tiled_range", (2, 12, 1024, 64), False, False),
    ("causal_segments_padding", (2, 8, 512, 128), True, True),
]


def backward_bounds(shape, mask, segs):
    """Least times of the backward's work: every tensor moved once at the
    HBM rate, or the products' FLOPs over allowed (query, key) pairs at the
    bf16 peak, whichever is longer. Returns the whole backward's bound (q,
    k, v, o, dO, dq, dk, dv, LSE and di; 10 D FLOPs a pair) and each
    kernel's: dq reads q, k, v, o, dO, LSE and writes dq, di (S, dP, dQ:
    6 D a pair); dkv reads q, k, v, dO, LSE, di and writes dk, dv (S, dP,
    dV, dK: 8 D a pair)."""
    b, h, l, d = shape
    act = b * l * h * d * 2
    rows = b * h * l * 4
    seg = 2 * b * l * 4 if segs else 0
    if mask is not None:
        pairs = int(mask.expand(b, 1, l, l).sum().item()) * h
    else:
        pairs = b * h * l * l

    def bound(nbytes, flops_per_pair):
        flops = flops_per_pair * d * pairs
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops}

    return {"backward": bound(8 * act + 2 * rows + seg, 10),
            "flash_bwd_dq": bound(6 * act + 2 * rows + seg, 6),
            "flash_bwd_dkv": bound(6 * act + 2 * rows + seg, 8)}


def sdpa_backward_fn(q, k, v, do, mask):
    """One call of PyTorch's fused attention backward on the same inputs,
    in the (B, H, L, D) layout SDPA uses: FlashAttention-2's backward where
    nothing is masked, the memory-efficient kernel's backward with the
    mask as an additive bias where something is (what
    F.scaled_dot_product_attention dispatches to). The aten ops are called
    directly, so no autograd overhead is timed."""
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    aten = torch.ops.aten
    if mask is None:
        (out, lse, cq, ck, mq, mk, seed, offset,
         _) = aten._scaled_dot_product_flash_attention(qt, kt, vt)
        bwd = aten._scaled_dot_product_flash_attention_backward
        return lambda: bwd(dot, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0,
                           False, seed, offset)
    b, h, l, _ = qt.shape
    bias = torch.zeros(mask.shape, dtype=q.dtype, device=q.device) \
        .masked_fill(~mask, float("-inf")).expand(b, h, l, l)
    out, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
        qt, kt, vt, bias, True)
    bwd = aten._scaled_dot_product_efficient_attention_backward
    return lambda: bwd(dot, qt, kt, vt, bias, out, lse, seed, offset, 0.0,
                       [True, True, True, False])


def phase_bwd_kernels(seed: int) -> list:
    """The two backward kernels against attention_backward_reference,
    computed in fp32 on the card from the same bf16 inputs (and the
    forward kernel's O and LSE)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    rows = []
    for name, shape, causal, segs in BWD_CASES:
        q, k, v, kw, mask = attention_inputs(shape, causal, segs, gen)
        b, h, l, d = shape
        do = torch.randn((b, l, h, d), generator=gen, device="cuda",
                         dtype=torch.float32).to(torch.bfloat16)
        o, lse = flash_attention(q, k, v, need_lse=True, **kw)
        scale = d ** -0.5
        seg_ids = kw.get("segment_ids")
        grads, launch_dq, launch_dkv = bwd_launches(
            q, k, v, o, lse, do, seg_ids, causal, scale)
        launch_dq()
        launch_dkv()
        ref = attention_backward_reference(
            q.float(), k.float(), v.float(), o.float(), lse, do.float(),
            **kw)
        torch.cuda.synchronize()
        errs = {}
        for gname, g, r in zip(("dq", "dk", "dv"), grads, ref):
            err = (g.float() - r).abs().max().item()
            top = r.abs().max().item()
            finite = bool(torch.isfinite(g.float()).all().item())
            errs[gname] = {"max_abs_err": err, "max_abs_ref": top}
            if not finite or err > BWD_REL_TOL * top:
                raise AssertionError(
                    f"flash_bwd disagrees with attention_backward_reference "
                    f"at {name} {shape}: {gname} max_abs_err {err} > "
                    f"{BWD_REL_TOL} x {top} (finite {finite})")
        if segs:
            pad = seg_ids[0] < 0    # padded rows (queries) and keys
            for gname, g in zip(("dq", "dk", "dv"), grads):
                if not bool((g[pad] == 0).all().item()):
                    raise AssertionError(f"{name}: {gname} is not zero on "
                                         f"padded rows / keys")
        bounds = backward_bounds(shape, mask, segs)
        library = sdpa_backward_fn(q, k, v, do, mask)
        row = {"case": name, "shape_bhld": list(shape), "causal": causal,
               "segments": segs, "errors": errs, "rel_tol": BWD_REL_TOL,
               "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
               "ms_dq": time_ms(launch_dq), "ms_dkv": time_ms(launch_dkv),
               "device_ms_dq": device_ms(launch_dq),
               "device_ms_dkv": device_ms(launch_dkv),
               "host_us_dq": host_us(launch_dq),
               "host_us_dkv": host_us(launch_dkv),
               "plain_ms": time_ms(lambda: attention_backward_reference(
                   q, k, v, o, lse, do, **kw), iters=5),
               "library_ms": time_ms(library),
               "library_device_ms": device_ms(library),
               "bounds": bounds}
        row["ms"] = row["ms_dq"] + row["ms_dkv"]
        rows.append(row)
        print("kernel flash_bwd " + json.dumps(row))
        del q, k, v, o, lse, do, grads, ref
    return rows


def int8_gemm_shapes(m) -> list:
    """(name, M, K, N, bias) of the five int8 products of one denoise step
    of the int8 serve path: the four trunk products at 2 x REQUESTS rows
    of the whole sequence (CFG), and the head over the image rows after
    the CFG combine against the image vocabulary."""
    rows = 2 * REQUESTS * m.length
    d, f = m.hidden_size, m.mlp_ratio * m.hidden_size
    return [("attn_qkv", rows, d, 3 * d, False),
            ("attn_out", rows, d, d, False),
            ("mlp_0", rows, d, f, True),
            ("mlp_2", rows, f, d, True),
            ("head", REQUESTS * m.img_length, d, m.image_vocab_size, True)]


def int8_gemm_bound(mm, k, n, bias, out_bytes):
    """Operands (int8 x and w, fp32 scales and bias) read once and the
    output written once at the HBM rate, or 2 M N K int8 operations at
    the int8 peak, whichever is longer."""
    nbytes = mm * k + n * k + 4 * mm + 4 * n * (2 if bias else 1) \
        + mm * n * out_bytes
    ops = 2.0 * mm * n * k
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def library_int8_fn(xq, s, wq, ws, b):
    """torch._int_mm (cuBLASLt int8 x int8 -> int32) with the epilogue in
    torch ops: the library's way to the same function; None where
    _int_mm refuses the shape."""
    def run():
        acc = torch._int_mm(xq, wq.t())
        out = acc.float() * s * ws
        if b is not None:
            out = out + b
        return out.to(torch.bfloat16)
    try:
        run()
    except RuntimeError as err:
        print(f"  torch._int_mm refused {tuple(xq.shape)} x "
              f"{tuple(wq.shape)}: {str(err).splitlines()[0]}")
        return None
    return run


def phase_int8_matmul(m, seed) -> list:
    """int8_matmul against int8_matmul_reference at the serve path's five
    products, with and without a bias, fp32 (bit-exact) and bf16 (within
    one ulp) output; times at the path's own bias setting, bf16 out."""
    # imported here: scripts/*_kernel_times.py load this file's helpers
    # over other trees, whose wrappers may have no plan
    from unidisc_tpu_torch.ops.int8_matmul import plan
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    rows = []
    for name, mm, k, n, path_bias in int8_gemm_shapes(m):
        kw = dict(generator=gen, device="cuda")
        xq = torch.randint(-127, 128, (mm, k), dtype=torch.int8, **kw)
        s = torch.rand((mm, 1), **kw) * 0.02 + 1e-3
        wq = torch.randint(-127, 128, (n, k), dtype=torch.int8, **kw)
        ws = torch.rand((n,), **kw) * 0.02 + 1e-3
        b = torch.randn((n,), **kw)
        errs = {}
        for bias in (False, True):
            for out_dtype in (torch.float32, torch.bfloat16):
                bb = b if bias else None
                got = int8_matmul(xq, s, wq, ws, bias=bb, out_dtype=out_dtype)
                want = int8_matmul_reference(xq, s, wq, ws, bias=bb,
                                             out_dtype=out_dtype)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                label = f"{'bias' if bias else 'no_bias'}_" \
                    f"{'fp32' if out_dtype == torch.float32 else 'bf16'}"
                errs[label] = diff.max().item()
                ok = (bool((diff == 0).all()) if out_dtype == torch.float32
                      else bool((diff <= BF16_ULP
                                 * want.float().abs()).all()))
                if not ok or not bool(torch.isfinite(got.float()).all()):
                    raise AssertionError(
                        f"int8_matmul disagrees with int8_matmul_reference "
                        f"at {name} ({mm}, {k}, {n}) {label}: max abs "
                        f"{errs[label]}")
                del got, want, diff
        bb = b if path_bias else None
        bound_ms, bound_by, nbytes, ops = int8_gemm_bound(mm, k, n,
                                                          path_bias, 2)

        def kernel():
            return int8_matmul(xq, s, wq, ws, bias=bb)

        library = library_int8_fn(xq, s, wq, ws, bb)
        block_n, tiles, grid = plan(mm, n, torch.cuda.get_device_properties(
            0).multi_processor_count)
        row = {"case": name, "shape_mkn": [mm, k, n], "bias": path_bias,
               "plan": {"block_n": block_n, "tiles": tiles, "grid": grid},
               "max_abs_err": max(errs.values()), "errors": errs,
               "ms": time_ms(kernel), "device_ms": device_ms(kernel),
               "host_us": host_us(kernel),
               "plain_ms": time_ms(lambda: int8_matmul_reference(
                   xq, s, wq, ws, bias=bb), iters=5),
               "library_ms": time_ms(library) if library else None,
               "library_device_ms": (device_ms(library) if library
                                     else None),
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "ops": ops}
        rows.append(row)
        print("kernel int8_matmul " + json.dumps(row))
        del xq, wq
    return rows


QUANT_CASES = [
    # name, mode, norm_type, conditioning: the first is the serve path's
    # (the flagship's rms prologue of attn_qkv and mlp.0)
    ("main_path", "adaln_norm", "rms", True),
    ("layernorm_cond", "adaln_norm", "layernorm", True),
    ("gelu", "gelu", "layernorm", False),
    ("none", "none", "layernorm", False),
]
# fp32 operations per element of each mode's passes (the bound's
# operation count; every mode is bound by bytes by a wide margin)
QUANT_OPS_PER_ELEMENT = {"adaln_norm": 14, "gelu": 13, "none": 4}


def phase_fused_qmm(m, seed) -> list:
    """fused_quantize against fused_quantize_reference at the serve path's
    (2 x REQUESTS x L, hidden) bf16 activations, with the adaLN rows as
    strided views of the block's modulation table and the serving
    modality layout (text rows 0, image rows 1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    b, l, k = 2 * REQUESTS, m.length, m.hidden_size
    mm = b * l
    x = (torch.randn((mm, k), generator=gen, device="cuda")).bfloat16()
    norm_w = 1.0 + 0.1 * torch.randn((k,), generator=gen, device="cuda")
    table = (0.2 * torch.randn((b, 6 * k), generator=gen,
                               device="cuda")).bfloat16()
    modality = torch.cat([torch.zeros((b, m.txt_length), dtype=torch.long),
                          torch.ones((b, m.img_length), dtype=torch.long)],
                         1).reshape(-1).float().cuda()
    # the width of the row kernel the wrapper picks (trees before the row
    # kernel have no plan)
    from unidisc_tpu_torch.ops import fused_qmm as fq_module
    plan = getattr(fq_module, "quantize_plan", None)
    rows = []
    for name, mode, norm_type, cond in QUANT_CASES:
        kw = dict(mode=mode, norm_type=norm_type)
        nbytes = mm * k * 2 + mm * k + mm * 4
        if mode == "adaln_norm":
            kw["norm_w"] = norm_w
            nbytes += k * 4
        if cond:
            kw.update(shift=table[:, :k], scale=table[:, k:2 * k],
                      modality=modality, rows_per_batch=l)
            nbytes += 2 * b * k * 2 + mm * 4
        q, s = fused_quantize(x, **kw)
        q_ref, s_ref = fused_quantize_reference(x, **kw)
        torch.cuda.synchronize()
        s_err = ((s - s_ref).abs() / s_ref.abs()).max().item()
        moved = (q.int() - q_ref.int()).abs()
        moved_max = int(moved.max().item())
        moved_share = moved.float().mean().item()
        if (s_err > Q_SCALE_RTOL or moved_max > 1
                or moved_share > Q_MOVED_SHARE):
            raise AssertionError(
                f"fused_qmm disagrees with fused_quantize_reference at "
                f"{name}: scale rel err {s_err} (tol {Q_SCALE_RTOL}), int8 "
                f"max step {moved_max}, share moved {moved_share} (tol "
                f"{Q_MOVED_SHARE})")
        ops = QUANT_OPS_PER_ELEMENT[mode] * mm * k
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOP_PER_S * 1e3
        row = {"case": name, "shape_mk": [mm, k], "mode": mode,
               "norm_type": norm_type, "cond": cond,
               "plan": list(plan(x, kw.get("norm_w"), kw.get("shift"),
                                 kw.get("scale"))) if plan else None,
               "max_abs_err": float(moved_max), "scale_rel_err": s_err,
               "moved_share": moved_share,
               "ms": time_ms(lambda: fused_quantize(x, **kw)),
               "device_ms": device_ms(lambda: fused_quantize(x, **kw)),
               "host_us": host_us(lambda: fused_quantize(x, **kw)),
               "plain_ms": time_ms(lambda: fused_quantize_reference(x, **kw),
                                   iters=5),
               "library_ms": None,      # no single PyTorch call computes it
               "library_device_ms": None,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops}
        rows.append(row)
        print("kernel fused_qmm " + json.dumps(row))
    return rows


def dynamic_quantize_shapes(m) -> list:
    """(name, M, K) of the int8 serve path's per-row quantize calls (qdot):
    the inputs of attn_out and mlp.2 at 2 x REQUESTS rows of the whole
    sequence, and of the image head."""
    rows = 2 * REQUESTS * m.length
    return [("attn_out", rows, m.hidden_size),
            ("mlp_2", rows, m.mlp_ratio * m.hidden_size),
            ("head", REQUESTS * m.img_length, m.hidden_size)]


def dynamic_quantize_input(gen, mm, k) -> torch.Tensor:
    """(mm, k) bf16 rows of random scale, every 64th row zero."""
    x = torch.randn((mm, k), generator=gen, device="cuda") \
        * torch.rand((mm, 1), generator=gen, device="cuda") * 4
    x[::64] = 0.0
    return x.bfloat16()


def phase_dynamic_quantize(m, seed) -> list:
    """dynamic_quantize (the row kernel, dividing form) against
    dynamic_quantize_reference, q and s bit for bit, at the serve path's
    three shapes, bf16 in, every 64th row zero. plain_ms and
    plain_device_ms time the plain version: the eager chain of PyTorch ops
    that the kernel replaces."""
    # imported here: scripts/int8_kernel_times.py loads this file's helpers
    # over other trees, which may have no such kernel
    from unidisc_tpu_torch.ops.quant import (dynamic_quantize,
                                             dynamic_quantize_reference)
    from unidisc_tpu_torch.ops.fused_qmm import quantize_plan
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    rows = []
    for name, mm, k in dynamic_quantize_shapes(m):
        x = dynamic_quantize_input(gen, mm, k)
        q, s = dynamic_quantize(x)
        q_ref, s_ref = dynamic_quantize_reference(x)
        torch.cuda.synchronize()
        q_err = (q.int() - q_ref.int()).abs().max().item()
        s_err = (s - s_ref).abs().max().item()
        if not (torch.equal(q, q_ref) and torch.equal(s, s_ref)):
            raise AssertionError(
                f"dynamic_quantize differs from dynamic_quantize_reference "
                f"at {name} ({mm}, {k}): q max step {q_err}, s max abs "
                f"{s_err}")
        nbytes = mm * k * 2 + mm * k + mm * 4
        ops = QUANT_OPS_PER_ELEMENT["none"] * mm * k
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOP_PER_S * 1e3
        row = {"case": name, "shape_mk": [mm, k],
               "plan": list(quantize_plan(x)),
               "max_abs_err": float(max(q_err, s_err)),
               "ms": time_ms(lambda: dynamic_quantize(x)),
               "device_ms": device_ms(lambda: dynamic_quantize(x)),
               "host_us": host_us(lambda: dynamic_quantize(x)),
               "plain_ms": time_ms(lambda: dynamic_quantize_reference(x)),
               "plain_device_ms": device_ms(
                   lambda: dynamic_quantize_reference(x)),
               "library_ms": None,      # no single PyTorch call computes it
               "library_device_ms": None,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops}
        rows.append(row)
        print("kernel dynamic_quantize " + json.dumps(row))
        del x, q, s, q_ref, s_ref
    return rows


# ---------------------------------------------------------------------------
# serve path
# ---------------------------------------------------------------------------

def forward_inputs(engine, batch, seed):
    m = engine.m
    rng = np.random.RandomState(seed)
    prepared = [engine.prepare(text=f"a photograph of subject {i}")
                for i in range(batch)]
    x = np.stack([p["x0"] for p in prepared]).astype(np.int64)
    img = rng.randint(0, m.image_vocab_size, (batch, m.img_length))
    img = np.where(rng.rand(batch, m.img_length) < 0.5, m.mask_index,
                   img + m.text_vocab_size)
    x[:, m.txt_length:] = img
    modality = np.concatenate([np.zeros((batch, m.txt_length)),
                               np.ones((batch, m.img_length))], 1)
    sigma = rng.uniform(0.05, 3.0, batch).astype(np.float32)
    to = lambda a, dt: torch.from_numpy(a).to("cuda", dt)
    return to(x, torch.long), to(sigma, torch.float32), \
        to(modality.astype(np.int64), torch.long)


def phase_logits(engine, seed) -> dict:
    """Full-width logits through the kernel against the plain attention.

    Truth is the plain path in fp32; the kernel path (bf16) must be as
    close to it as the plain path in bf16 is, within a factor of 2."""
    cfg = engine.config.model
    state = engine.model.state_dict()
    plain = {}
    for dtype, logits in ((torch.bfloat16, cfg.logits_dtype),
                          (torch.float32, "float32")):
        mdl = DIT(dataclasses.replace(cfg, attn_backend="xla",
                                      logits_dtype=logits),
                  compute_dtype=dtype).to("cuda").eval()
        mdl.load_state_dict(state)
        plain[dtype] = mdl
    x, sigma, modality = forward_inputs(engine, 2 * REQUESTS, seed)
    with torch.inference_mode():
        kern = engine.model(x, sigma, modality=modality).float()
        p16 = plain[torch.bfloat16](x, sigma, modality=modality).float()
        p32 = plain[torch.float32](x, sigma, modality=modality).float()
    torch.cuda.synchronize()
    scale = p32.abs().max().item()
    err_kernel = (kern - p32).abs().max().item()
    err_plain16 = (p16 - p32).abs().max().item()
    err_kernel_vs_plain16 = (kern - p16).abs().max().item()
    finite = bool(torch.isfinite(kern).all().item())
    rec = {"shape": list(kern.shape), "logit_scale": scale,
           "max_abs_err_kernel_bf16_vs_plain_fp32": err_kernel,
           "max_abs_err_plain_bf16_vs_plain_fp32": err_plain16,
           "max_abs_err_kernel_bf16_vs_plain_bf16": err_kernel_vs_plain16,
           "finite": finite}
    print("logits " + json.dumps(rec))
    if not finite or err_kernel > 2 * err_plain16 + 1e-3 * scale:
        raise AssertionError(f"full-width logits through the kernel are "
                             f"off: {rec}")
    del plain
    return rec


def phase_int8_logits(engine, qengine, seed) -> dict:
    """Full-width int8 logits through the kernels (int8_matmul, fused_qmm,
    flash_fwd) against the plain int8 path (plain products, unfused, plain
    attention) at the same int8 weights, and against the bf16 model.

    Truth for the kernels is the plain int8 path in fp32; the kernel path
    (bf16) must be as close to it as the plain int8 path in bf16 is,
    within a factor of 2, in mean absolute error (the max moves with the
    few rows whose int8 activations land a step apart). Against the bf16
    model the int8 logits must track it as tests/test_quant.py asks of the
    JAX int8 DIT: cosine > 0.99 and top-1 agreement > 0.9, the latter
    where the bf16 model's best logit leads its second by more than twice
    the mean |int8 - bf16| logit difference. Over every position top-1
    agreement is recorded, not gated: with random weights and bf16 logits
    the median lead of the best logit is one or two bf16 steps, and the
    JAX package's own int8 DIT agrees with its bf16 model on 0.87-0.91 of
    all positions at such weights (scripts/port_int8_top1.py)."""
    cfg = qengine.config.model
    state = qengine.model.state_dict()
    x, sigma, modality = forward_inputs(qengine, 2 * REQUESTS, seed)
    out = {}
    with torch.inference_mode():
        out["kernel"] = qengine.model(x, sigma, modality=modality).float()
        out["bf16_model"] = engine.model(x, sigma, modality=modality).float()
        for label, dtype, logits in (("plain_bf16", torch.bfloat16,
                                      cfg.logits_dtype),
                                     ("plain_fp32", torch.float32,
                                      "float32")):
            mdl = DIT(dataclasses.replace(
                cfg, attn_backend="xla", quant_backend="xla",
                quant_fused=False, logits_dtype=logits),
                compute_dtype=dtype).to("cuda").eval()
            mdl.load_state_dict(state)
            out[label] = mdl(x, sigma, modality=modality).float()
            del mdl
    torch.cuda.synchronize()
    kern, truth = out["kernel"], out["plain_fp32"]
    err_kernel = (kern - truth).abs().mean().item()
    err_plain16 = (out["plain_bf16"] - truth).abs().mean().item()
    ref = out["bf16_model"]
    cos = ((kern.double() * ref.double()).sum()
           / (kern.double().norm() * ref.double().norm())).item()
    agree = kern.argmax(-1) == ref.argmax(-1)
    top1 = agree.float().mean().item()
    mean_diff = (kern - ref).abs().mean().item()
    best2 = ref.topk(2, dim=-1).values
    clear = (best2[..., 0] - best2[..., 1]) > 2 * mean_diff
    top1_clear = agree[clear].float().mean().item()
    lt, v0 = cfg.txt_length, cfg.text_vocab_size
    top1_img = (kern[:, lt:, v0:].argmax(-1) == ref[:, lt:, v0:].argmax(-1)
                ).float().mean().item()
    finite = bool(torch.isfinite(kern).all().item())
    rec = {"shape": list(kern.shape), "logit_scale": truth.abs().max().item(),
           "mean_abs_err_kernel_bf16_vs_plain_fp32": err_kernel,
           "mean_abs_err_plain_bf16_vs_plain_fp32": err_plain16,
           "max_abs_err_kernel_bf16_vs_plain_fp32":
               (kern - truth).abs().max().item(),
           "max_abs_err_plain_bf16_vs_plain_fp32":
               (out["plain_bf16"] - truth).abs().max().item(),
           "cosine_vs_bf16_model": cos, "top1_vs_bf16_model": top1,
           "top1_vs_bf16_model_image_span": top1_img,
           "top1_vs_bf16_model_clear_margin": top1_clear,
           "share_clear_margin": clear.float().mean().item(),
           "mean_abs_diff_vs_bf16_model": mean_diff, "finite": finite}
    print("int8_logits " + json.dumps(rec))
    del out, kern, truth, ref, agree, best2, clear
    if (not finite or err_kernel > 2 * err_plain16 or not cos > 0.99
            or not top1_clear > 0.9):
        raise AssertionError(f"full-width int8 logits through the kernels "
                             f"are off: {rec}")
    return rec


def phase_sampler_cpu_agreement(seed, int8=False) -> dict:
    """The port's sampler on the card against the port on the CPU (which
    tests/test_torch_t2i.py holds token for token to the JAX sampler), on
    a tiny fp32 model with the same injected noise; with `int8`, on the
    model quantized with the flagship's int8 settings (the kernels on the
    card, their plain versions on the CPU)."""
    over = {"model.hidden_size": 128, "model.n_heads": 2,
            "model.n_blocks": 2, "model.cond_dim": 32, "model.length": 24,
            "model.txt_length": 8, "model.img_length": 16,
            "model.text_vocab_size": 24, "model.image_vocab_size": 40,
            "model.time_conditioning": True, "model.qk_norm": True,
            "model.norm_type": "rms", "model.sandwich_normalization": True,
            "model.modality_embed": True, "model.rope_2d": True,
            "model.attn_backend": "xla", "model.dropout": 0.0,
            "sampling.predictor": "maskgit", "sampling.steps": 5,
            "sampling.cfg": 2.0}
    if int8:
        over.update({"model.quant_backend": "pallas",
                     "model.quant_fused": True})
    cfg = Config.make("tiny", **over)
    m = cfg.model
    rng = np.random.RandomState(seed)
    txt = torch.from_numpy(rng.randint(0, m.text_vocab_size - 1, (4, 8)))
    injected = {
        "gumbel_tok": torch.from_numpy(rng.gumbel(
            size=(5, 4, 16, m.image_vocab_size)).astype(np.float32)),
        "gumbel_conf": torch.from_numpy(rng.gumbel(
            size=(5, 4, 16)).astype(np.float32))}
    cpu_model = DIT(m, compute_dtype=torch.float32).eval()
    gpu_model = DIT(m, compute_dtype=torch.float32).to("cuda").eval()
    randomize_(gpu_model, seed)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               gpu_model.state_dict().items()})
    if int8:
        cfg, cpu_model = quantize_model(cfg, cpu_model)
        gpu_model = DIT(cfg.model, compute_dtype=torch.float32) \
            .to("cuda").eval()
        gpu_model.load_state_dict(cpu_model.state_dict())
    toks = {}
    for dev, mdl in (("cpu", cpu_model), ("cuda", gpu_model)):
        sample = build_t2i_sampler(mdl, cfg, inject_noise=True, device=dev)
        toks[dev] = sample(txt, injected=injected).tokens.cpu()
    agree = float((toks["cpu"] == toks["cuda"]).float().mean().item())
    rec = {"token_agreement": agree, "int8": int8}
    print("sampler_cpu_vs_cuda " + json.dumps(rec))
    if agree < 0.95:
        raise AssertionError(f"the sampler on the card disagrees with the "
                             f"CPU: {rec}")
    return rec


def check_results(engine, prompts, results) -> None:
    m = engine.m
    steps = engine.config.sampling.steps
    for p, r in zip(prompts, results):
        ids = r["image_ids"]
        if ids.shape != (1, m.img_length):
            raise AssertionError(f"image_ids shape {ids.shape}")
        if ids.min() < 0 or ids.max() >= m.image_vocab_size:
            raise AssertionError("image token outside the image codebook "
                                 "(a mask or text token was left)")
        if r["text"] != p:
            raise AssertionError(f"text span changed: {r['text']!r}")
        if r["nfe"] not in (steps, steps + 1):
            raise AssertionError(f"nfe {r['nfe']}")


def expected_serve_launches(m, nfe) -> dict:
    """Kernel launches of one served batch of `nfe` denoise steps, from the
    code: one trunk pass at the CFG batch a step (each block one attention
    and, in int8, four products, two of them behind a fused prologue, the
    others and the head behind a per-row quantize) and one int8 head
    product a step (t2i_fast applies guidance before the head)."""
    want = {"flash_fwd": m.n_blocks * nfe}
    if m.quant == "int8":
        if m.quant_backend == "pallas":
            want["int8_matmul"] = (4 * m.n_blocks + 1) * nfe
        if m.quant_fused:
            want["fused_qmm"] = 2 * m.n_blocks * nfe
        want["dynamic_quantize"] = ((2 if m.quant_fused else 4)
                                    * m.n_blocks + 1) * nfe
    return want


def phase_serve(engine, label="serve") -> dict:
    m = engine.m
    prompts = [f"a watercolor painting of a lighthouse, variant {i}"
               for i in range(REQUESTS)]
    prepared = [engine.prepare(text=p) for p in prompts]
    if not all(p["fastpath"] for p in prepared):
        raise AssertionError("requests did not take the t2i fast path")

    # the counted run: counts to 0 just before, read just after
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    results = engine.run_batch(prepared, seed=0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    check_results(engine, prompts, results)
    nfe = results[0]["nfe"]
    want = expected_serve_launches(m, nfe)
    if launches != want:
        raise AssertionError(f"{label}: the main path launched {launches}; "
                             f"expected {want} (n_blocks {m.n_blocks}, NFE "
                             f"{nfe})")

    # steady state: the same batch again, timed on the host
    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = engine.run_batch(prepared, seed=i + 1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check_results(engine, prompts, again)
    gen_tokens = REQUESTS * m.img_length
    rec = {"requests": REQUESTS, "rows_under_cfg": 2 * REQUESTS,
           "nfe": nfe, "launches": launches, "expected_launches": want,
           "first_batch_s": first_s,
           "first_batch_tok_per_s": gen_tokens / first_s,
           "steady_batch_s": times,
           "steady_tok_per_s": gen_tokens / min(times),
           "distinct_images": len({r["image_ids"].tobytes()
                                   for r in results})}
    print(f"{label} " + json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# train path
# ---------------------------------------------------------------------------

def train_config(**extra) -> Config:
    """The flagship training configuration with a 2-step warmup, so the LR
    is non-zero from the second step."""
    return Config.make("small", **{**FLAGSHIP_TRAIN_OVERRIDES,
                                   "trainer.warmup_steps": 2,
                                   **extra}).validate()


def fixed_draws(cfg, batch, seed, device):
    """Every draw of one compute_batch_loss, made once from a seed, so the
    kernel path and the plain path see the same corruption."""
    gen = torch.Generator().manual_seed(seed)
    b, l = batch, cfg.model.length
    return {"t": torch.rand((b,), generator=gen).to(device),
            "move": torch.rand((b, l), generator=gen).to(device),
            "txt": torch.rand((b, 1), generator=gen).to(device),
            "img": torch.rand((b, 1), generator=gen).to(device)}


def flat_grad(cfg, model, batch, draws) -> torch.Tensor:
    apply_fn = make_apply_fn(cfg, model)
    out = compute_batch_loss(cfg, apply_fn, None, batch, train=True,
                             draws=draws)
    params = [p for _, p in sorted(model.named_parameters())]
    grads = torch.autograd.grad(out.loss, params)
    return torch.cat([g.float().reshape(-1) for g in grads])


def phase_grad_check(cfg, batch_size, seed, device="cuda") -> dict:
    """One compute_batch_loss + backward at full width through the kernels
    (bf16) against the plain path (plain attention, its autograd) in fp32.
    Truth is the plain path in fp32; the kernel path must be as close to
    it as the plain path in bf16 is, within a factor of 2."""
    m = cfg.model
    loader = SyntheticDataLoader(cfg, batch_size, seed=seed)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in next(loader).items()}
    draws = fixed_draws(cfg, batch_size, seed, device)
    state = None
    grads = {}
    for label, backend, dtype in (("kernel_bf16", "auto", torch.bfloat16),
                                  ("plain_bf16", "xla", torch.bfloat16),
                                  ("plain_fp32", "xla", torch.float32)):
        mcfg = dataclasses.replace(cfg, model=dataclasses.replace(
            m, attn_backend=backend))
        model = DIT(mcfg.model, compute_dtype=dtype).to(device)
        if state is None:
            randomize_(model, seed)
            state = model.state_dict()
        else:
            model.load_state_dict(state)
        _build.reset_launch_counts()
        grads[label] = flat_grad(mcfg, model, batch, draws)
        if device == "cuda":
            torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
        if label == "kernel_bf16" and device == "cuda":
            want = {"flash_fwd": m.n_blocks, "flash_bwd_dq": m.n_blocks,
                    "flash_bwd_dkv": m.n_blocks}
            if launches != want:
                raise AssertionError(f"gradient check launched {launches}, "
                                     f"expected {want}")
        del model
    truth = grads["plain_fp32"]
    norm = truth.norm().item()
    rel = {k: (grads[k] - truth).norm().item() / norm
           for k in ("kernel_bf16", "plain_bf16")}
    finite = bool(torch.isfinite(grads["kernel_bf16"]).all().item())
    rec = {"batch": batch_size, "n_grad": truth.numel(), "grad_norm": norm,
           "rel_err_kernel_bf16_vs_plain_fp32": rel["kernel_bf16"],
           "rel_err_plain_bf16_vs_plain_fp32": rel["plain_bf16"],
           "finite": finite}
    print("grad_check " + json.dumps(rec))
    if not finite or rel["kernel_bf16"] > 2 * rel["plain_bf16"]:
        raise AssertionError(f"the full-width gradient through the kernels "
                             f"is off: {rec}")
    return rec


def logged(run_dir) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_train(cfg, batch_size, steps, seed, device="cuda") -> dict:
    """Trainer.fit on one synthetic batch, with the counts set to 0 just
    before and read just after; then a resume from the step-CKPT_STEP
    checkpoint must give the next step's loss again."""
    m = cfg.model
    first = next(SyntheticDataLoader(cfg, batch_size, seed=seed))
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        run_a = os.path.join(root, "a")
        trainer = Trainer(cfg, run_a, device=device, log_every=1,
                          ckpt_every=CKPT_STEP, max_ckpts=2)
        init = {k: v.detach().clone() for k, v in trainer.state.params.items()}
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.fit(itertools.repeat(first), max_steps=steps)
        if device == "cuda":
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
        recs = [r for r in logged(run_a) if "loss" in r]
        losses = [r["loss"] for r in recs]
        step_s = [r["step_s"] for r in recs]
        if len(losses) != steps or not all(map(math.isfinite, losses)):
            raise AssertionError(f"train losses {losses}")
        early, late = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        if not late < early:
            raise AssertionError(f"the loss did not fall: first 5 mean "
                                 f"{early}, last 5 mean {late}: {losses}")
        if device == "cuda":
            want = {name: m.n_blocks * steps for name in TRAIN_KERNELS}
            if launches != want:
                raise AssertionError(f"train path launched {launches}, "
                                     f"expected {want} (12 blocks x "
                                     f"{steps} steps each)")
        ema_moved = max((trainer.state.ema_params[k] - init[k].float())
                        .abs().max().item() for k in init)
        if not ema_moved > 0:
            raise AssertionError("the EMA did not move")
        trainer.close()
        del trainer

        # resume: only the step-CKPT_STEP checkpoint, then one more step
        run_b = os.path.join(root, "b")
        shutil.copytree(os.path.join(run_a, "checkpoints", str(CKPT_STEP)),
                        os.path.join(run_b, "checkpoints", str(CKPT_STEP)))
        resumed = Trainer(cfg, run_b, device=device, log_every=1,
                          ckpt_every=0)
        resumed.fit(itertools.repeat(first), max_steps=CKPT_STEP + 1)
        resumed.close()
        again = [r["loss"] for r in logged(run_b) if "loss" in r]
        want_loss = losses[CKPT_STEP]         # the loss of step CKPT_STEP + 1
        if len(again) != 1 or abs(again[0] - want_loss) > 1e-5 * abs(
                want_loss):
            raise AssertionError(f"resumed step {CKPT_STEP + 1} loss "
                                 f"{again} != {want_loss}")
        del resumed
    finally:
        shutil.rmtree(root, ignore_errors=True)
    steady = step_s[2:]
    median_s = statistics.median(steady)
    rec = {"batch": batch_size, "length": m.length, "steps": steps,
           "losses": losses, "loss_first5_mean": early,
           "loss_last5_mean": late, "launches": launches,
           "expected_launches_per_kernel": m.n_blocks * steps,
           "step_s": step_s, "median_steady_step_s": median_s,
           "train_tok_per_s": batch_size * m.length / median_s,
           "fit_wall_s": wall_s, "peak_memory_bytes": peak,
           "ema_max_change": ema_moved,
           "resumed_step_loss": again[0], "straight_step_loss": want_loss}
    print("train " + json.dumps(rec))
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/chip_smoke.json")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a machine with an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    record["build"] = phase_build()
    record["kernel_cases"] = phase_kernels(args.seed)
    record["bwd_kernel_cases"] = phase_bwd_kernels(args.seed)
    int8_model = Config.make("small", **FLAGSHIP_INT8_OVERRIDES).model
    record["int8_matmul_cases"] = phase_int8_matmul(int8_model, args.seed)
    record["fused_qmm_cases"] = phase_fused_qmm(int8_model, args.seed)
    record["dynamic_quantize_cases"] = phase_dynamic_quantize(int8_model,
                                                              args.seed)

    t0 = time.perf_counter()
    engine = build_engine(preset="small", overrides=FLAGSHIP_OVERRIDES)
    randomize_(engine.model, args.seed)
    record["engine_build_s"] = time.perf_counter() - t0
    record["logits"] = phase_logits(engine, args.seed)
    record["sampler_cpu_vs_cuda"] = phase_sampler_cpu_agreement(args.seed)
    record["serve"] = phase_serve(engine)

    # the int8 engine, its weights the bf16 engine's quantized
    t0 = time.perf_counter()
    qengine = build_engine(preset="small", overrides=FLAGSHIP_INT8_OVERRIDES,
                           quantize="int8")
    qengine.model.load_state_dict(quantize_dit_params(
        engine.model.state_dict()))
    record["int8_engine_build_s"] = time.perf_counter() - t0
    record["int8_logits"] = phase_int8_logits(engine, qengine, args.seed)
    record["int8_sampler_cpu_vs_cuda"] = phase_sampler_cpu_agreement(
        args.seed, int8=True)
    record["serve_int8"] = phase_serve(qengine, "serve_int8")
    print("serve_tok_per_s " + json.dumps({
        "bf16_steady_tok_per_s": record["serve"]["steady_tok_per_s"],
        "int8_steady_tok_per_s": record["serve_int8"]["steady_tok_per_s"]}))
    del engine, qengine
    torch.cuda.empty_cache()

    cfg = train_config()
    record["grad_check"] = phase_grad_check(cfg, TRAIN_BATCH, args.seed)
    torch.cuda.empty_cache()
    record["train"] = phase_train(cfg, TRAIN_BATCH, TRAIN_STEPS, args.seed)

    by_path = {name: {path: record[path]["launches"].get(name, 0)
                      for path in ("serve", "serve_int8", "train")}
               for name in KERNELS}
    fwd = record["kernel_cases"][0]          # the serve path's shape
    bwd = record["bwd_kernel_cases"][0]      # the train path's shape
    qmm = record["int8_matmul_cases"][0]     # attn_qkv of the int8 path
    fq = record["fused_qmm_cases"][0]        # its rms + adaLN prologue
    dq = record["dynamic_quantize_cases"][0]  # attn_out's input
    measured = {
        "flash_fwd": {"max_abs_err": fwd["max_abs_err"], "ms": fwd["ms"],
                      "device_ms": fwd["device_ms"],
                      "host_us": fwd["host_us"],
                      "bound_ms": fwd["bound_ms"],
                      "bound_by": fwd["bound_by"]},
        "flash_bwd_dq": {"max_abs_err": bwd["errors"]["dq"]["max_abs_err"],
                         "ms": bwd["ms_dq"], "device_ms": bwd["device_ms_dq"],
                         "host_us": bwd["host_us_dq"],
                         **bwd["bounds"]["flash_bwd_dq"]},
        "flash_bwd_dkv": {"max_abs_err": max(
            bwd["errors"][g]["max_abs_err"] for g in ("dk", "dv")),
            "ms": bwd["ms_dkv"], "device_ms": bwd["device_ms_dkv"],
            "host_us": bwd["host_us_dkv"],
            **bwd["bounds"]["flash_bwd_dkv"]},
        "int8_matmul": qmm, "fused_qmm": fq, "dynamic_quantize": dq,
    }
    shape_key = {"int8_matmul": "shape_mkn", "fused_qmm": "shape_mk",
                 "dynamic_quantize": "shape_mk"}
    kernels = []
    for name, meta in KERNELS.items():
        case = {"flash_fwd": fwd, "int8_matmul": qmm, "fused_qmm": fq,
                "dynamic_quantize": dq}.get(name, bwd)
        key = shape_key.get(name, "shape_bhld")
        kernels.append({
            "name": name, "route": meta["route"], "source": meta["source"],
            "replaces": meta["replaces"],
            **({"also_replaces": meta["also_replaces"]}
               if "also_replaces" in meta else {}),
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            key: case[key],
            "max_abs_err": measured[name]["max_abs_err"],
            "ms": measured[name]["ms"],
            "device_ms": measured[name]["device_ms"],
            "host_us": measured[name]["host_us"],
            # the plain version and the library call compute the whole
            # backward (both kernels) for flash_bwd_dq and flash_bwd_dkv
            "plain_ms": case["plain_ms"],
            "bound_ms": measured[name]["bound_ms"],
            "bound_by": measured[name]["bound_by"],
            "library_ms": case["library_ms"],
            "library_device_ms": case["library_device_ms"]})
    record["kernels"] = kernels
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)

    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
