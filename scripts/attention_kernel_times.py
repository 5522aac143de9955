#!/usr/bin/env python3
"""Time the port's attention kernels of one tree on the card, at the serve
path's shape (16, 12, 384, 64) and the train path's (32, 12, 384, 64).

    python3 scripts/attention_kernel_times.py [--root DIR] [--label NAME]

--root is the repository root whose ``unidisc_tpu_torch`` is timed
(default: this one), e.g. a ``git archive`` of another commit unpacked into
a git-ignored directory; its kernels build into DIR/build. The timers, the
inputs and the bounds are this repository's ``chip_smoke.py`` helpers, so
two trees run in one call are timed the same way: ms (CUDA events around 20
wrapper calls), device_ms (kernel time from torch.profiler), host_us (the
wrapper's host time per call), SDPA and SDPA's whole backward beside
them; and the host time of one TMA tensor-map encode. Prints the card line
and one JSON line, and writes
chiprun_out/attention_kernel_times_<label>.json.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SHAPES = [("serve", (16, 12, 384, 64), False),   # the serve path asks no LSE
          ("train", (32, 12, 384, 64), True)]


def load_helpers(root: Path):
    """chip_smoke.py of this repository, importing ``unidisc_tpu_torch``
    from `root`."""
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def encode_us(q, iters: int = 2000) -> dict:
    """Host time of one cuTensorMapEncodeTiled, the driver call with which
    the TMA kernels describe each operand on every launch (three maps a
    forward, four a dkv launch), for q's rank-4 (D, H, L, B) map as
    flash_fwd.cu builds it; and of cuDriverGetVersion, a driver call that
    does nothing, for the cost of the ctypes call itself."""
    cuda = ctypes.CDLL("libcuda.so.1")
    b, l, h, d = q.shape
    sb, sl, sh, _ = (2 * st for st in q.stride())
    storage = ctypes.create_string_buffer(128 + 64)
    tmap = ctypes.c_void_p((ctypes.addressof(storage) + 63) // 64 * 64)
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    args = (tmap, 9, 4, ctypes.c_void_p(q.data_ptr()),  # 9: bfloat16
            (u64 * 4)(d, h, l, b), (u64 * 3)(sh, sl, sb),
            (u32 * 4)(64, 1, 128, 1), (u32 * 4)(1, 1, 1, 1),
            0, 3, 2, 0)  # no interleave, 128-byte swizzle, L2 128B, zeros
    if cuda.cuTensorMapEncodeTiled(*args) != 0:
        raise RuntimeError("cuTensorMapEncodeTiled refused the map")
    version = ctypes.c_int()

    def per_call_us(fn, *fn_args):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*fn_args)
        return (time.perf_counter() - t0) / iters * 1e6

    return {"encode_us": per_call_us(cuda.cuTensorMapEncodeTiled, *args),
            "ctypes_call_us": per_call_us(cuda.cuDriverGetVersion,
                                          ctypes.byref(version))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="change")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    cs = load_helpers(root)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("attention_kernel_times: CUDA is not available", file=sys.stderr)
        return 1
    import unidisc_tpu_torch
    fa = sys.modules["unidisc_tpu_torch.ops.flash_attention"]
    if Path(unidisc_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {unidisc_tpu_torch.__file__}, "
                           f"not the package under {root}")
    card = cs.card_line()
    print(card)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    record = {"label": args.label, "root": str(root), "card": card}
    for name, shape, need_lse in SHAPES:
        q, k, v, kw, mask = cs.attention_inputs(shape, False, False, gen)
        out = fa.flash_attention(q, k, v, need_lse=need_lse)
        ref = fa.attention_reference(q, k, v, need_lse=need_lse)
        out, ref = (out[0], ref[0]) if need_lse else (out, ref)

        def kernel():
            return fa.flash_attention(q, k, v, need_lse=need_lse)

        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt)

        bound_ms, bound_by, _, _ = cs.attention_bound(shape, None, False)
        record[f"flash_fwd_{name}"] = {
            "shape_bhld": list(shape), "need_lse": need_lse,
            "max_abs_err": (out.float() - ref.float()).abs().max().item(),
            "ms": cs.time_ms(kernel), "device_ms": cs.device_ms(kernel),
            "host_us": cs.host_us(kernel), "sdpa_ms": cs.time_ms(sdpa),
            "sdpa_device_ms": cs.device_ms(sdpa), "bound_ms": bound_ms,
            "bound_by": bound_by}
        if name != "train":
            continue
        b, l, h, d = q.shape
        do = torch.randn((b, l, h, d), generator=gen, device="cuda",
                         dtype=torch.float32).to(torch.bfloat16)
        o, lse = fa.flash_attention(q, k, v, need_lse=True)
        grads, launch_dq, launch_dkv = fa.bwd_launches(
            q, k, v, o, lse, do, None, False, d ** -0.5)
        launch_dq()
        launch_dkv()
        want = fa.attention_backward_reference(
            q.float(), k.float(), v.float(), o.float(), lse, do.float())
        errs = {g: (x.float() - w).abs().max().item() / w.abs().max().item()
                for g, x, w in zip(("dq", "dk", "dv"), grads, want)}
        bounds = cs.backward_bounds(shape, None, False)
        sdpa_bwd = cs.sdpa_backward_fn(q, k, v, do, None)
        for kname, fn in (("flash_bwd_dq", launch_dq),
                          ("flash_bwd_dkv", launch_dkv)):
            record[kname] = {
                "shape_bhld": list(shape), "rel_err": errs,
                "ms": cs.time_ms(fn), "device_ms": cs.device_ms(fn),
                "host_us": cs.host_us(fn),
                "bound_ms": bounds[kname]["bound_ms"],
                "bound_by": bounds[kname]["bound_by"]}
        record["sdpa_backward"] = {
            "ms": cs.time_ms(sdpa_bwd), "device_ms": cs.device_ms(sdpa_bwd),
            "bound_ms": bounds["backward"]["bound_ms"]}
    record["tensor_map_encode"] = encode_us(q)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/attention_kernel_times_{args.label}.json",
              "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
