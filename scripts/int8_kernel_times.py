#!/usr/bin/env python3
"""Time the port's int8 kernels of one tree on the card: the int8 GEMM
(int8_matmul) at the five products of the int8 serve path, attn_qkv
(6144, 768, 2304), attn_out (6144, 768, 768), mlp_0 (6144, 768, 3072),
mlp_2 (6144, 3072, 768) and the head (2048, 768, 16384), as (M, K, N); and
the two per-row quantizers, fused_qmm in each of chip_smoke.py's
QUANT_CASES at (6144, 768) and dynamic_quantize at (6144, 768),
(6144, 3072) and (2048, 768).

    python3 scripts/int8_kernel_times.py [--root DIR] [--label NAME]
        [--parts gemm,quant]

--root is the repository root whose ``unidisc_tpu_torch`` is timed
(default: this one), e.g. a ``git archive`` of another commit unpacked into
a git-ignored directory; its kernels build into DIR/build. The timers, the
inputs, the bounds and the library yardstick (torch._int_mm with the
epilogue in torch ops) are this repository's ``chip_smoke.py`` helpers, so
two trees run in one call are timed the same way: ms (CUDA events around
20 wrapper calls), device_ms (kernel time from torch.profiler), host_us
(the wrapper's host time per call, device idle), library_device_ms and the
bound. Where the tree's kernel takes a tile width (block_n), each width is
timed as well, beside the one the wrapper's plan chooses. Each product is
first held to int8_matmul_reference (fp32 output, bit for bit). The
quantizers are timed by chip_smoke.py's phase_fused_qmm and
phase_dynamic_quantize, which hold each to its plain version first; in a
tree where dynamic_quantize is still the eager chain of PyTorch ops, that
chain is timed at the same shapes and inputs. Prints the card line and
one JSON line, and writes chiprun_out/int8_kernel_times_<label>.json.

    python3 scripts/int8_kernel_times.py --trace

instead rebuilds the kernel with -DATTN_TRACE (its trace slots are listed
in ops/csrc/int8_matmul.cu) and reports, for the width the plan chooses at
each product, medians over the blocks in microseconds of each of a
block's first tiles: waiting for its first stage, streaming the rest of
its stages, finishing its products, and its epilogue; also the kernel's
span. It writes chiprun_out/int8_phase_trace.json.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from attention_kernel_times import HERE, load_helpers  # noqa: E402


SLOTS = 64


def trace_tiles(im, run, blocks: int) -> dict:
    """One traced launch of `run` (a kernel built with -DATTN_TRACE over
    `blocks` blocks): per-tile phase medians over the blocks, in us."""
    import torch
    lib = im._library()
    lib.attn_trace_set.argtypes = [ctypes.c_void_p]
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    buf = torch.zeros(blocks * SLOTS, dtype=torch.int64, device="cuda")
    lib.attn_trace_set(buf.data_ptr())
    run()
    torch.cuda.synchronize()
    lib.attn_trace_set(None)
    rows = [r for r in buf.view(blocks, SLOTS).cpu().tolist()
            if r[0] and r[62]]

    def med(values):
        return statistics.median(values) / 1e3 if values else None

    start = min(r[0] for r in rows)
    out = {"blocks": len(rows),
           "span_us": (max(r[62] for r in rows) - start) / 1e3,
           "block_us": med([r[62] - r[0] for r in rows]), "tiles": []}
    for n in range(7):
        b = 8 * n
        done = [r for r in rows if r[b + 7]]
        if not done:
            break
        out["tiles"].append({
            "blocks": len(done),
            "wait_first_stage": med([r[b + 2] - r[b + 1] for r in done]),
            "stream_stages": med([r[b + 3] - r[b + 2] for r in done]),
            "finish_products": med([r[b + 4] - r[b + 3] for r in done]),
            "epilogue": med([r[b + 7] - r[b + 4] for r in done])})
    return out


def eager_chain_rows(cs, model, seed) -> list:
    """dynamic_quantize of a tree without its kernel (the eager chain),
    timed as phase_dynamic_quantize times the kernel, on the same
    inputs."""
    import torch
    from unidisc_tpu_torch.ops.quant import dynamic_quantize
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    rows = []
    for name, mm, k in cs.dynamic_quantize_shapes(model):
        x = cs.dynamic_quantize_input(gen, mm, k)
        row = {"case": name, "shape_mk": [mm, k], "eager_chain": True,
               "ms": cs.time_ms(lambda: dynamic_quantize(x)),
               "device_ms": cs.device_ms(lambda: dynamic_quantize(x)),
               "host_us": cs.host_us(lambda: dynamic_quantize(x))}
        rows.append(row)
        print(f"dynamic_quantize {json.dumps(row)}")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="change")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--parts", default="gemm,quant",
                    help="comma-separated: gemm (int8_matmul), quant "
                         "(fused_qmm and dynamic_quantize)")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    root = Path(args.root).resolve()
    cs = load_helpers(root)
    if args.trace:
        cs._build.NVCC_FLAGS.append("-DATTN_TRACE")
    import torch
    if not torch.cuda.is_available():
        print("int8_kernel_times: CUDA is not available", file=sys.stderr)
        return 1
    import unidisc_tpu_torch
    if Path(unidisc_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {unidisc_tpu_torch.__file__}, "
                           f"not the package under {root}")
    im = sys.modules["unidisc_tpu_torch.ops.int8_matmul"]
    widths = getattr(im, "BLOCK_NS", ())
    takes_width = "block_n" in inspect.signature(
        im._int8_matmul_cuda).parameters
    card = cs.card_line()
    print(card)
    model = cs.Config.make("small", **cs.FLAGSHIP_INT8_OVERRIDES).model
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    record = {"label": args.label, "root": str(root), "card": card,
              "sms": sms}
    for name, mm, k, n, bias in (cs.int8_gemm_shapes(model)
                                 if "gemm" in parts else []):
        kw = dict(generator=gen, device="cuda")
        xq = torch.randint(-127, 128, (mm, k), dtype=torch.int8, **kw)
        s = torch.rand((mm, 1), **kw) * 0.02 + 1e-3
        wq = torch.randint(-127, 128, (n, k), dtype=torch.int8, **kw)
        ws = torch.rand((n,), **kw) * 0.02 + 1e-3
        b = torch.randn((n,), **kw) if bias else None
        got = im.int8_matmul(xq, s, wq, ws, bias=b, out_dtype=torch.float32)
        want = im.int8_matmul_reference(xq, s, wq, ws, bias=b,
                                        out_dtype=torch.float32)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: int8_matmul differs from its "
                                 f"plain version")
        if args.trace:
            bn, tiles, grid = im.plan(mm, n, sms)
            record[name] = {"shape_mkn": [mm, k, n], "block_n": bn,
                            "tiles": tiles, **trace_tiles(
                                im, lambda: im.int8_matmul(xq, s, wq, ws,
                                                           bias=b), grid)}
            print(f"{name} {json.dumps(record[name])}")
            continue

        def kernel():
            return im.int8_matmul(xq, s, wq, ws, bias=b)

        bound_ms, bound_by, nbytes, ops = cs.int8_gemm_bound(mm, k, n, bias,
                                                             2)
        library = cs.library_int8_fn(xq, s, wq, ws, b)
        row = {"shape_mkn": [mm, k, n], "bias": bias,
               "ms": cs.time_ms(kernel), "device_ms": cs.device_ms(kernel),
               "host_us": cs.host_us(kernel),
               "library_device_ms": (cs.device_ms(library) if library
                                     else None),
               "bound_ms": bound_ms, "bound_by": bound_by}
        if hasattr(im, "plan"):
            bn, tiles, grid = im.plan(mm, n, sms)
            row["plan"] = {"block_n": bn, "tiles": tiles, "grid": grid,
                           "waves": tiles / sms}
        if takes_width:
            row["device_ms_by_block_n"] = {}
            for bn in widths:
                def forced(bn=bn):
                    return im._int8_matmul_cuda(xq, s, wq, ws, b,
                                                torch.bfloat16, block_n=bn)
                out = im._int8_matmul_cuda(xq, s, wq, ws, b, torch.float32,
                                           block_n=bn)
                if not torch.equal(out, want):
                    raise AssertionError(f"{name}: block_n {bn} differs "
                                         f"from the plain version")
                row["device_ms_by_block_n"][str(bn)] = cs.device_ms(forced)
        record[name] = row
        print(f"{name} {json.dumps(row)}")
        del xq, wq, got, want
    if "quant" in parts and not args.trace:
        record["fused_qmm"] = cs.phase_fused_qmm(model, args.seed)
        quant = sys.modules["unidisc_tpu_torch.ops.quant"]
        record["dynamic_quantize"] = (
            cs.phase_dynamic_quantize(model, args.seed)
            if hasattr(quant, "dynamic_quantize_reference")
            else eager_chain_rows(cs, model, args.seed))
    os.makedirs("chiprun_out", exist_ok=True)
    out = ("chiprun_out/int8_phase_trace.json" if args.trace
           else f"chiprun_out/int8_kernel_times_{args.label}.json")
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
