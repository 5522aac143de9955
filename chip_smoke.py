#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--out chiprun_out/chip_smoke.json]

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

  1. device: CUDA must be available; print the card's name and power limit.
  2. build: compile every kernel source under unidisc_tpu_torch/ops/csrc
     with nvcc, one process per source, all started together.
  3. kernels: hold each kernel against its plain PyTorch version on the
     card at the main path's shapes and the other listed shapes, and time
     the kernel, the plain version and one PyTorch library call.
  4. path: build the flagship text->image engine at full width with random
     weights from the seed; check full-width logits through the kernel
     against the plain path; check the sampler on the card against the
     CPU on a tiny model; then serve 8 requests through
     InferenceEngine.run_batch with the launch counts set to 0 just
     before and read just after, and check the tokens that come out.
  5. print the kernels line, the card line and the result line.

The full record is written to --out as JSON. Numbers are measured on the
card this run lands on; the bound uses the H100 SXM's published peaks.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from unidisc_tpu_torch.config import FLAGSHIP_OVERRIDES, Config
from unidisc_tpu_torch.models.dit import DIT, randomize_
from unidisc_tpu_torch.ops import _build
from unidisc_tpu_torch.ops.flash_attention import (attention_reference,
                                                   flash_attention)
from unidisc_tpu_torch.sampling.t2i_fast import build_t2i_sampler
from unidisc_tpu_torch.serving.engine import build_engine

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16, published
OUT_TOL = 2e-2    # bf16 outputs of magnitude ~1 round at 4e-3; the kernel
#                   rounds unnormalised P, the reference normalised P
LSE_TOL = 1e-3    # fp32 on both sides: summation order of Q K^T
REQUESTS = 8      # batch 8 -> 16 rows under CFG

KERNELS = {
    "flash_fwd": {
        "route": "cuda",
        "source": "unidisc_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "unidisc_tpu/ops/pallas_attention.py:119",
        "also_replaces": "unidisc_tpu/ops/pallas_attention.py:47",
    },
}


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
    # name, (B, H, L, D), causal, segments; the first is the main path's
    # shape (16 rows = batch 8 under CFG, small preset: 12 heads of 64)
    ("main_path", (16, 12, 384, 64), False, False),
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
        need_lse = name != "main_path"
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
        kernel_ms = time_ms(lambda: flash_attention(q, k, v, **kw))
        plain_ms = time_ms(lambda: attention_reference(q, k, v, **kw),
                           iters=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if mask is None:
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt))
        else:
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
        bound_ms, bound_by, nbytes, flops = attention_bound(shape, mask,
                                                            segs)
        row = {"case": name, "shape_bhld": list(shape), "causal": causal,
               "segments": segs, "max_abs_err": err, "tol": OUT_TOL,
               "lse_err": lse_err, "ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes": nbytes, "flops": flops}
        rows.append(row)
        print("kernel flash_fwd " + json.dumps(row))
    return rows


# ---------------------------------------------------------------------------
# path phase
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


def phase_sampler_cpu_agreement(seed) -> dict:
    """The port's sampler on the card against the port on the CPU (which
    tests/test_torch_t2i.py holds token for token to the JAX sampler), on
    a tiny fp32 model with the same injected noise."""
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
    toks = {}
    for dev, mdl in (("cpu", cpu_model), ("cuda", gpu_model)):
        sample = build_t2i_sampler(mdl, cfg, inject_noise=True, device=dev)
        toks[dev] = sample(txt, injected=injected).tokens.cpu()
    agree = float((toks["cpu"] == toks["cuda"]).float().mean().item())
    rec = {"token_agreement": agree}
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


def phase_serve(engine) -> dict:
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
    want = m.n_blocks * nfe        # one sample call
    if launches.get("flash_fwd", 0) != want:
        raise AssertionError(f"flash_fwd launched {launches} times on the "
                             f"main path; expected {want} = n_blocks "
                             f"{m.n_blocks} x NFE {nfe}")

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
           "nfe": nfe, "launches": launches,
           "expected_flash_fwd_launches": want,
           "first_batch_s": first_s,
           "first_batch_tok_per_s": gen_tokens / first_s,
           "steady_batch_s": times,
           "steady_tok_per_s": gen_tokens / min(times),
           "distinct_images": len({r["image_ids"].tobytes()
                                   for r in results})}
    print("serve " + json.dumps(rec))
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

    t0 = time.perf_counter()
    engine = build_engine(preset="small", overrides=FLAGSHIP_OVERRIDES)
    randomize_(engine.model, args.seed)
    record["engine_build_s"] = time.perf_counter() - t0
    record["logits"] = phase_logits(engine, args.seed)
    record["sampler_cpu_vs_cuda"] = phase_sampler_cpu_agreement(args.seed)
    record["serve"] = phase_serve(engine)

    main_case = record["kernel_cases"][0]
    kernels = []
    for name, meta in KERNELS.items():
        kernels.append({
            "name": name, "route": meta["route"], "source": meta["source"],
            "replaces": meta["replaces"],
            "also_replaces": meta["also_replaces"],
            "launches": record["serve"]["launches"].get(name, 0),
            "max_abs_err": main_case["max_abs_err"],
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"]})
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
