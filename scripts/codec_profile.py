#!/usr/bin/env python3
"""Where the VQ-16 codec spends its time and memory on the card.

    python3 scripts/codec_profile.py [--batch 8] [--px 256]
        [--out chiprun_out/codec_profile.json]

The LlamaGen VQ-16 codec (get_codec("llamagen-vq16"), random weights from
its seed 0) decodes and encodes `batch` images of `px` pixels:

  * fp32, TF32 off (as chip_smoke.py runs it): CUDA-event ms of a decode
    and an encode, the device time by kernel of one decode
    (torch.profiler), and each layer's peak memory above what was
    allocated when it started (forward hooks), the largest listed;
  * the same decode with cuDNN's TF32, under bf16 autocast, with the
    decoder's input made contiguous NCHW (the codebook gather leaves it
    in channels_last strides, which the convolutions then keep), and with
    the module's weights in channels_last too: ms, peak memory, and the
    largest pixel difference from the fp32 decode of the same ids.

Prints the card's name and power limit and one JSON line; writes the
record to --out. Needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from unidisc_tpu_torch.tokenizers.image_codecs import get_codec  # noqa: E402


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters=10, warmup=2) -> float:
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


def peak_bytes(fn) -> int:
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def kernel_table(fn, top=15) -> list:
    """Device ms of one call of fn by kernel name (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
            by_name[e.name][1] += 1
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    total = sum(v[0] for v in by_name.values())
    return [{"device_ms_total": total}] + [
        {"kernel": name[:160], "ms": ms, "calls": n}
        for name, (ms, n) in rows[:top]]


def layer_peaks(module, fn, top=8) -> list:
    """Peak memory of each conv and GroupNorm call above the memory
    allocated when it started, its input's shape and whether that input
    is channels_last."""
    rows = []

    def pre(mod, inputs):
        torch.cuda.synchronize()
        mod._start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    def post(mod, inputs, out):
        torch.cuda.synchronize()
        x = inputs[0]
        rows.append({"layer": mod._name, "type": type(mod).__name__,
                     "input": list(x.shape), "channels_last":
                         x.is_contiguous(memory_format=torch.channels_last)
                         and not x.is_contiguous(),
                     "peak_above_start_bytes":
                         torch.cuda.max_memory_allocated() - mod._start})

    hooks = []
    for name, mod in module.named_modules():
        if isinstance(mod, torch.nn.Conv2d) or \
                type(mod).__name__ == "GroupNorm":
            mod._name = name
            hooks.append(mod.register_forward_pre_hook(pre))
            hooks.append(mod.register_forward_hook(post))
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return sorted(rows, key=lambda r: -r["peak_above_start_bytes"])[:top]


@contextlib.contextmanager
def tf32(on: bool):
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--px", type=int, default=256)
    ap.add_argument("--out", default="chiprun_out/codec_profile.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("codec_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    codec = get_codec("llamagen-vq16", image_size=args.px)
    model = codec.module
    grid = args.px // codec.downsample
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, codec.vocab_size, (args.batch, grid * grid),
                        generator=gen, device="cuda")
    images = torch.rand((args.batch, args.px, args.px, 3), generator=gen,
                        device="cuda") * 2 - 1
    rec = {"card": card, "torch": torch.__version__, "batch": args.batch,
           "px": args.px}
    with torch.no_grad(), tf32(False):
        ref = codec.decode(ids)
        rec["fp32"] = {
            "decode_ms": time_ms(lambda: codec.decode(ids)),
            "encode_ms": time_ms(lambda: codec.encode(images)),
            "decode_peak_bytes": peak_bytes(lambda: codec.decode(ids)),
            "encode_peak_bytes": peak_bytes(lambda: codec.encode(images)),
            "decode_kernels": kernel_table(lambda: codec.decode(ids)),
            "decode_layer_peaks": layer_peaks(model,
                                              lambda: codec.decode(ids))}
        variants = {}
        with tf32(True):
            variants["tf32"] = lambda: codec.decode(ids)

            def bf16():
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    return codec.decode(ids)
            variants["bf16_autocast"] = bf16
            for name, fn in list(variants.items()):
                out = fn().float()
                rec[name] = {"decode_ms": time_ms(fn),
                             "decode_peak_bytes": peak_bytes(fn),
                             "max_abs_diff_vs_fp32":
                                 (out - ref).abs().max().item()}

        def nchw_input():
            zq = model.lookup(ids.reshape(-1, grid, grid)).contiguous()
            return model.decoder(model.post_quant_conv(zq))

        out = nchw_input().permute(0, 2, 3, 1)
        rec["fp32_nchw_input"] = {
            "decode_ms": time_ms(nchw_input),
            "decode_peak_bytes": peak_bytes(nchw_input),
            "max_abs_diff_vs_fp32": (out - ref).abs().max().item()}
        model.to(memory_format=torch.channels_last)
        try:
            out = codec.decode(ids)
            rec["fp32_channels_last"] = {
                "decode_ms": time_ms(lambda: codec.decode(ids)),
                "decode_peak_bytes": peak_bytes(lambda: codec.decode(ids)),
                "max_abs_diff_vs_fp32": (out - ref).abs().max().item()}
        finally:
            model.to(memory_format=torch.contiguous_format)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    summary = {k: v for k, v in rec["fp32"].items()
               if not k.startswith("decode_kernels")
               and k != "decode_layer_peaks"}
    print(json.dumps({"fp32": summary, **{
        k: rec[k] for k in ("tf32", "bf16_autocast", "fp32_nchw_input",
                            "fp32_channels_last")},
        "top_kernels": rec["fp32"]["decode_kernels"][:6],
        "top_layer_peaks": rec["fp32"]["decode_layer_peaks"][:4]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
