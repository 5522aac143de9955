"""Where a flagship text->image batch spends its time on the card.

    python -m unidisc_tpu_torch.profile_t2i [--requests 8] [--top 20]
        [--int8] [--frozen] [--out chiprun_out/profile_t2i.json]
        [--rolling t2i|generic]

Builds the flagship engine (``config.FLAGSHIP_OVERRIDES``, random weights
from a seed; with ``--int8`` those weights quantized, served under
``config.FLAGSHIP_INT8_OVERRIDES``; with ``--frozen`` under the
``frozen_cond`` overlay, conditioning-frozen sampling), serves one warm-up
batch, which captures the sampler's CUDA-graph program, then measures:

  * one DIT forward at the CFG batch (2 x requests rows): the time between
    CUDA events around it (device idle gaps included), and the host time
    to enqueue it without waiting; when the two are equal the host, not
    the card, sets the pace;
  * the device operations (kernels, copies, fills) one forward launches,
    counted by ``torch.profiler``;
  * one served batch under ``torch.profiler``, as the engine serves it
    (the captured program's replay) and through the eager sampler: device
    time by kernel name, the device operations per denoise step, and the
    device's busy share of the batch's wall time; and the program's build
    time.

With ``--rolling t2i`` (or ``generic``) it profiles the rolling chunk
program instead (``serving/rolling.py``, ``--requests`` slots all active,
8 denoise steps a chunk): one replay and one eager chunk, as above. Every
profile also sums its device time by kernel class (``KERNEL_CLASSES``:
the keyed-noise hash's int64 operations, GEMMs, the attention kernel,
sorts, the rest).

Needs a CUDA device; prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from unidisc_tpu_torch.config import (FLAGSHIP_INT8_OVERRIDES,
                                      FLAGSHIP_OVERRIDES)
from unidisc_tpu_torch.models.dit import randomize_
from unidisc_tpu_torch.ops.quant import quantize_model
from unidisc_tpu_torch.serving.engine import InferenceEngine, build_engine


def device_events(prof) -> list:
    """The device operations of a torch.profiler run, by name."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def forward_times(engine, rows: int, iters: int = 10) -> dict:
    m = engine.m
    x = torch.full((rows, m.length), m.mask_index, dtype=torch.long,
                   device="cuda")
    x[:, :m.txt_length] = 5
    modality = torch.zeros_like(x)
    modality[:, m.txt_length:] = 1
    sigma = torch.full((rows,), 0.5, device="cuda")
    model = engine.model
    with torch.inference_mode():
        for _ in range(3):
            model.hidden(x, sigma, modality=modality)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            model.hidden(x, sigma, modality=modality)
        end.record()
        enqueue_s = (time.perf_counter() - t0) / iters
        torch.cuda.synchronize()
        wall_s = (time.perf_counter() - t0) / iters
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.hidden(x, sigma, modality=modality)
            torch.cuda.synchronize()
    return {"rows": rows, "event_ms": start.elapsed_time(end) / iters,
            "host_enqueue_ms": enqueue_s * 1e3, "wall_ms": wall_s * 1e3,
            "device_ops": sum(e.count for e in device_events(prof))}


# kernel classes by name, first match wins: torch's int64 elementwise
# kernels (the keyed noise's hash: xor, shifts, masks and products on
# long), the GEMMs (cuBLAS's nvjet and xmma kernels, CUTLASS, the int8
# kernel), the attention kernel, sorts (the maskgit threshold), the rest
KERNEL_CLASSES = (
    ("int64_hash", ("Bitwise", "shift", "<long", "long>", "int64")),
    ("gemm", ("gemm", "Gemm", "nvjet", "cutlass", "int8_matmul",
              "sm90_xmma")),
    ("attention", ("flash_fwd",)),
    ("sort", ("sort", "Sort", "radix", "Radix")),
)


def by_class(rows) -> dict:
    """Device ms of a profile's kernels summed by KERNEL_CLASSES."""
    out = {name: 0.0 for name, _ in KERNEL_CLASSES}
    out["other"] = 0.0
    for r in rows:
        cls = next((name for name, keys in KERNEL_CLASSES
                    if any(k in r["name"] for k in keys)), "other")
        out[cls] += r["device_ms"]
    return out


def profile_batch(run, nfe_of, top: int) -> dict:
    """One batch `run()` under torch.profiler: wall time, device busy time
    and share, device operations per denoise step, kernels by name."""
    from torch.profiler import ProfilerActivity, profile
    run()                                                  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    nfe = nfe_of(out)
    ops = sum(e.count for e in kernels)
    rows = [{"name": e.key[:200], "count": e.count,
             "device_ms": e.self_device_time_total / 1e3,
             "share_of_busy": (e.self_device_time_total / 1e3 / busy_ms)
             if busy_ms else None} for e in kernels]
    rec = {"wall_ms": wall_ms, "nfe": nfe, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms if wall_ms else None,
           "device_ops": ops, "device_ops_per_step": ops / nfe,
           "device_ms_by_class": by_class(rows),
           "kernels": rows[:top], "all_kernels": rows}
    if not busy_ms:
        rec["note"] = ("the profiler recorded no device time: device busy "
                       "share not measured")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--int8", action="store_true",
                    help="serve the int8 W8A8 model")
    ap.add_argument("--frozen", action="store_true",
                    help="conditioning-frozen sampling (frozen_cond)")
    ap.add_argument("--rolling", choices=("t2i", "generic"), default=None,
                    help="profile the rolling chunk program of this kind")
    ap.add_argument("--out", default="chiprun_out/profile_t2i.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_t2i: CUDA is not available", file=sys.stderr)
        return 1

    overrides = FLAGSHIP_INT8_OVERRIDES if args.int8 else FLAGSHIP_OVERRIDES
    engine = build_engine(preset="small", overrides=overrides,
                          experiments=("frozen_cond",) if args.frozen
                          else None)
    randomize_(engine.model, args.seed)
    if args.int8:
        engine = InferenceEngine(*quantize_model(engine.config,
                                                 engine.model))
    prepared = [engine.prepare(text=f"a profile prompt {i}")
                for i in range(args.requests)]
    if args.rolling:
        record = profile_rolling(engine, prepared, args.rolling, args.top)
        return write(record, args.out, "chunk")
    engine.run_batch(prepared, seed=0)        # warm-up: captures the program
    torch.cuda.synchronize()
    sampler = engine._samplers[("t2i", engine.config.sampling.steps)]
    # a tree before the captured programs (scripts/profile_t2i_root.py)
    # serves eager: its "batch" is the eager one
    program = getattr(sampler, "graphs", {}).get(args.requests)
    build_s = program.build_s if program is not None else None

    record = {"device": torch.cuda.get_device_name(0),
              "requests": args.requests, "int8": args.int8,
              "frozen": args.frozen, "captured": program is not None,
              "graph_build_s": build_s,
              "forward": forward_times(engine, 2 * args.requests)}
    txt = torch.from_numpy(np.stack([p["x0"] for p in prepared])[
        :, :engine.m.txt_length])
    record["batch"] = profile_batch(
        lambda: engine.run_batch(prepared, seed=1),
        lambda out: out[0]["nfe"], args.top)
    record["batch_eager"] = profile_batch(
        lambda: sampler(txt, generator=torch.Generator(device="cuda")
                        .manual_seed(1)),
        lambda out: out.nfe, args.top)
    return write(record, args.out, "batch")


def profile_rolling(engine, prepared, kind: str, top: int) -> dict:
    """One replay of the rolling chunk program of `kind` with every slot
    active (slots = the requests), and one eager chunk, profiled."""
    from unidisc_tpu_torch.sampling.graph import CapturedChunk
    from unidisc_tpu_torch.serving.rolling import (build_rolling_sampler,
                                                   build_rolling_t2i)
    m = engine.m
    n = len(prepared)
    build = build_rolling_t2i if kind == "t2i" else build_rolling_sampler
    built = build(engine.model, engine.config, slots=n)
    program = CapturedChunk(built)
    x0 = np.stack([p["x0"] for p in prepared])
    seeds = np.arange(n)
    if kind == "t2i":
        rows = (x0[:, :m.txt_length], seeds)
    else:
        rows = (x0, np.stack([p["unmask"] for p in prepared]),
                engine._layout(n), seeds)
    eager = built.init_state()
    for st in (program.state, eager):
        built.insert_many(st, np.arange(n), *rows)
    record = {"device": torch.cuda.get_device_name(0), "rolling": kind,
              "slots": n, "chunk_steps": built.chunk,
              "int8": engine.m.quant == "int8",
              "graph_build_s": program.build_s,
              "chunk": profile_batch(lambda: program.step_chunk(),
                                     lambda _: built.chunk, top),
              "chunk_eager": profile_batch(
                  lambda: built.step_chunk(eager), lambda _: built.chunk,
                  top)}
    return record


def write(record: dict, out: str, label: str) -> int:
    """Write the record, print the top kernels of `label` and a summary
    line."""
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    for k in record[label]["kernels"]:
        print(f"{k['device_ms']:10.3f} ms {k['count']:6d}x  {k['name']}")
    print(json.dumps({**{k: record[k] for k in ("forward", "graph_build_s")
                         if k in record},
                      **{f"{lab}_{key}": record[lab][key]
                         for lab in (label, f"{label}_eager")
                         for key in ("wall_ms", "device_busy_ms",
                                     "device_busy_share",
                                     "device_ops_per_step",
                                     "device_ms_by_class")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
