#!/usr/bin/env python3
"""Where a block of the attention kernels spends its time, on the card:
flash_fwd at the serve path's shape (16, 12, 384, 64), flash_bwd_dq and
flash_bwd_dkv at the train path's (32, 12, 384, 64).

    python3 scripts/attention_phase_trace.py

Builds the kernels once more with -DATTN_TRACE (a separate library; the
trace slots are described in ops/csrc/hopper.cuh), launches each kernel
once with tracing on and reports, as medians over the blocks in
microseconds: the block's lifetime, its prologue (first data landed; for
dq also the di it forms from O and dO before its loop), and for each of
the first six tiles the time waiting for the tile's data, the first
products (S; S and dP; S^T and dP^T), the elementwise phase (softmax; dS;
P^T and dS^T), the second products and the release of the stage; also the
kernel's span and the mean number of blocks in flight. Prints one JSON
line and writes chiprun_out/attention_phase_trace.json.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from unidisc_tpu_torch.ops import _build  # noqa: E402
from unidisc_tpu_torch.ops import flash_attention as fa  # noqa: E402

SLOTS = 64
TILES = 6


def med_us(values):
    return statistics.median(values) / 1e3 if values else None


def summarize(buf: torch.Tensor, blocks: int) -> dict:
    rows = [r for r in buf.view(blocks, SLOTS).cpu().tolist()
            if r[0] and r[62]]
    start = min(r[0] for r in rows)
    span = max(r[62] for r in rows) - start
    life = [r[62] - r[0] for r in rows]
    out = {"blocks": len(rows), "span_us": span / 1e3,
           "block_us": med_us(life), "blocks_in_flight": sum(life) / span,
           "prologue_us": med_us([r[1] - r[0] for r in rows]), "tiles": []}
    if all(r[39] for r in rows):      # dq: di formed before the loop
        out["di_us"] = med_us([r[39] - r[1] for r in rows])
    names = ("wait", "first_products", "elementwise", "second_issue",
             "second_products", "release")
    for k in range(TILES):
        base = 2 + 6 * k
        prev = [(r[39] or r[1]) if k == 0 else r[base - 1] for r in rows]
        marks = [[p] + [r[base + i] for i in range(6)]
                 for r, p in zip(rows, prev)]
        if not all(m[-1] for m in marks):
            break
        out["tiles"].append({n: med_us([m[i + 1] - m[i] for m in marks])
                             for i, n in enumerate(names)})
    last = 2 + 6 * (len(out["tiles"]) - 1) + 5
    out["epilogue_us"] = med_us([r[62] - r[last] for r in rows])
    out["producer_issue_us"] = [med_us([r[40 + k] - r[0] for r in rows
                                        if r[40 + k]]) for k in range(TILES)]
    return out


def trace(lib_name: str, launch, blocks: int) -> dict:
    lib = _build.load(lib_name)
    lib.attn_trace_set.argtypes = [ctypes.c_void_p]
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    buf = torch.zeros(blocks * SLOTS, dtype=torch.int64, device="cuda")
    lib.attn_trace_set(buf.data_ptr())
    launch()
    torch.cuda.synchronize()
    lib.attn_trace_set(None)
    return summarize(buf, blocks)


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_phase_trace: CUDA is not available", file=sys.stderr)
        return 1
    _build.NVCC_FLAGS.append("-DATTN_TRACE")
    gen = torch.Generator(device="cuda").manual_seed(0)
    record = {}
    b, h, l, d = 16, 12, 384, 64
    q, k, v = torch.randn((b, l, 3, h, d), generator=gen,
                          device="cuda").bfloat16().unbind(2)
    record["flash_fwd"] = trace("flash_fwd", lambda: fa.flash_attention(
        q, k, v), b * h * (l // 128))
    b = 32
    q, k, v = torch.randn((b, l, 3, h, d), generator=gen,
                          device="cuda").bfloat16().unbind(2)
    do = torch.randn((b, l, h, d), generator=gen, device="cuda").bfloat16()
    o, lse = fa.flash_attention(q, k, v, need_lse=True)
    _, launch_dq, launch_dkv = fa.bwd_launches(q, k, v, o, lse, do, None,
                                               False, d ** -0.5)
    record["flash_bwd_dq"] = trace("flash_bwd_dq", launch_dq,
                                   b * h * (l // 128))
    record["flash_bwd_dkv"] = trace("flash_bwd_dkv", launch_dkv,
                                    b * h * (l // 128))
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/attention_phase_trace.json", "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
