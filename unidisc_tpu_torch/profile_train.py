"""Where a flagship train step spends its time on the card.

    python -m unidisc_tpu_torch.profile_train [--batch-size 32] [--steps 3]
        [--top 25] [--set model.moe_experts=8 ...]
        [--out chiprun_out/profile_train.json]

Builds the flagship training configuration (``FLAGSHIP_TRAIN_OVERRIDES``
with a 2-step warmup, then each ``--set`` override) at full width, runs
warm-up steps on one synthetic batch, then measures:

  * steady train steps: the time between CUDA events around them (device
    idle gaps included), the host time to enqueue them without waiting, and
    the peak device memory of a step;
  * ``--steps`` steps under ``torch.profiler``: device time by kernel name,
    launches, and the device's busy share of the steps' wall time, by
    class of kernel name (``CLASSES``: attention, GEMMs, everything
    else), and under MoE by part of the MoE layer (``SPANS``, the
    ``record_function`` spans of ``models/moe.py``): the kernels of each
    span's forward ops and of the backward nodes autograd runs for them.

Needs a CUDA device; prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import torch

from unidisc_tpu_torch.config import FLAGSHIP_TRAIN_OVERRIDES, Config
from unidisc_tpu_torch.data.synthetic import SyntheticDataLoader
from unidisc_tpu_torch.models.dit import DIT
from unidisc_tpu_torch.training.train_state import (init_train_state,
                                                    make_train_step)


# kernel-name classes, the first match wins
CLASSES = (
    ("attention", re.compile(r"flash_")),
    ("gemm", re.compile(r"gemm|sm90_xmma|cutlass|nvjet|s16816|s1688",
                        re.IGNORECASE)),
)
# the MoE layer's parts (models/moe.py)
SPANS = ("moe_route", "moe_dispatch", "moe_experts", "moe_combine")


def kernel_class(name: str) -> str:
    for label, pattern in CLASSES:
        if pattern.search(name):
            return label
    return "other"


def kernel_us(event) -> float:
    """The device time of the kernels `event` and the ops under it
    launched (a span's own device-side annotation, which bears its name,
    left out)."""
    return sum(k.duration for k in event.kernels if k.name != event.name) \
        + sum(kernel_us(c) for c in event.cpu_children)


def span_events(events, spans=SPANS) -> dict:
    """{span: (its calls, the backward nodes of their ops)} for each
    ``record_function`` span in `spans`: a backward node
    (``autograd::engine::evaluate_function``) belongs to the span whose
    call holds the forward op of its sequence number."""
    def under(event):
        for c in event.cpu_children:
            yield c
            yield from under(c)

    out, owner = {}, {}
    for e in events:
        if e.name in spans:
            out.setdefault(e.name, ([], []))[0].append(e)
            for c in under(e):
                if c.sequence_nr >= 0:
                    owner[c.sequence_nr] = e.name
    for e in events:
        if e.name.startswith("autograd::engine::evaluate_function") \
                and e.sequence_nr in owner:
            out[owner[e.sequence_nr]][1].append(e)
    return out


def span_device_ms(events, spans=SPANS) -> dict:
    """{span: {"forward": ms, "backward": ms}}: the kernels of each span's
    calls and of their backward nodes (``span_events``)."""
    return {name: {"forward": sum(map(kernel_us, fwd)) / 1e3,
                   "backward": sum(map(kernel_us, bwd)) / 1e3}
            for name, (fwd, bwd) in span_events(events, spans).items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="a config override after the flagship's")
    ap.add_argument("--out", default="chiprun_out/profile_train.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_train: CUDA is not available", file=sys.stderr)
        return 1

    from unidisc_tpu_torch.train import parse_overrides
    _, extra = parse_overrides(args.set)
    cfg = Config.make("small", **{**FLAGSHIP_TRAIN_OVERRIDES,
                                  "trainer.warmup_steps": 2,
                                  **extra}).validate()
    model = DIT(cfg.model, compute_dtype=torch.bfloat16, init=False)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    model = model.to("cuda")
    state = init_train_state(cfg, model)
    step_fn = make_train_step(cfg, model)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             next(SyntheticDataLoader(cfg, args.batch_size,
                                      seed=args.seed)).items()}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def steps(n):
        for _ in range(n):
            step_fn(state, batch, generator=gen)

    steps(args.warmup)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    steps(args.steps)
    end.record()
    enqueue_s = (time.perf_counter() - t0) / args.steps
    torch.cuda.synchronize()
    wall_s = (time.perf_counter() - t0) / args.steps
    tokens = args.batch_size * cfg.model.length
    record = {"device": torch.cuda.get_device_name(0),
              "overrides": args.set,
              "batch": args.batch_size, "length": cfg.model.length,
              "step": {"event_ms": start.elapsed_time(end) / args.steps,
                       "host_enqueue_ms": enqueue_s * 1e3,
                       "wall_ms": wall_s * 1e3,
                       "train_tok_per_s": tokens / wall_s,
                       "peak_memory_bytes": torch.cuda.max_memory_allocated()}}

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(args.steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    by_class = {}
    for e in kernels:
        label = kernel_class(e.key)
        by_class[label] = by_class.get(label, 0.0) \
            + e.self_device_time_total / 1e3
    record["profiled"] = {
        "steps": args.steps, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "launches": sum(e.count for e in kernels),
        "device_ms_by_class": by_class,
        "device_ms_by_span": span_device_ms(prof.events()),
        "kernels": [{"name": e.key[:120], "count": e.count,
                     "device_ms": e.self_device_time_total / 1e3,
                     "share_of_busy": (e.self_device_time_total / 1e3
                                       / busy_ms) if busy_ms else None}
                    for e in kernels[:args.top]]}
    if not busy_ms:
        record["profiled"]["note"] = ("the profiler recorded no device "
                                      "time: device busy share not measured")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    for k in record["profiled"]["kernels"]:
        print(f"{k['device_ms']:10.3f} ms {k['count']:6d}x  {k['name']}")
    print(json.dumps({"step": record["step"], "profiled_wall_ms": wall_ms,
                      "device_busy_ms": busy_ms, "device_ms_by_class":
                      by_class, "device_ms_by_span":
                      record["profiled"]["device_ms_by_span"],
                      "device_busy_share": record["profiled"][
                          "device_busy_share"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
