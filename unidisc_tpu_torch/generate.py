"""Generation CLI: sample from a run dir that the port's Trainer wrote
(port of ``unidisc_tpu/generate.py``).

Usage:
  python -m unidisc_tpu_torch.generate --ckpt runs/dev --n 16 \\
      --out samples/ [--prompt "a red car"] \\
      [--task gen_image|gen_text|joint|infill] [--steps 64] \\
      [--codec llamagen-vq16 --image-size 256] [--use-ema] \\
      [--quantize int8] [--device cuda|cpu]

Writes one line a sample to ``samples.jsonl`` and, with a codec, each
sample's image as ``sample_NNNN.png``.
"""

from __future__ import annotations

import argparse
import base64
import json
import os


def main(argv=None) -> dict:
    """Returns {"step", "samples", "engine"}: the restored step, the
    number of samples written and the engine that served them."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", required=True, help="run dir")
    parser.add_argument("--out", default="samples")
    parser.add_argument("--n", type=int, default=8)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--prompt", default=None)
    parser.add_argument("--task", default="auto")
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--codec", default=None,
                        help="decode images (e.g. lfq, llamagen-vq16)")
    parser.add_argument("--image-size", type=int, default=256)
    parser.add_argument("--use-ema", action="store_true")
    parser.add_argument("--quantize", default=None, choices=[None, "int8"],
                        help="int8 W8A8 inference")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from unidisc_tpu_torch.device import resolve_device
    from unidisc_tpu_torch.models.dit import DIT
    from unidisc_tpu_torch.serving.engine import InferenceEngine, restore_run
    from unidisc_tpu_torch.tokenizers.text import get_tokenizer

    device = resolve_device(args.device)
    config, weights, step = restore_run(args.ckpt, ema=args.use_ema)
    if args.steps:
        config = config.override(**{"sampling.steps": args.steps})
    model = DIT(config.model, compute_dtype=torch.bfloat16)
    model.load_state_dict(weights)
    print(f"[generate] restored step {step} "
          f"({'EMA' if args.use_ema else 'live'} params)")
    if args.quantize:
        from unidisc_tpu_torch.ops.quant import quantize_model
        config, model = quantize_model(config, model)
        print("[generate] int8 W8A8 inference enabled")

    codec = None
    if args.codec:
        from unidisc_tpu_torch.tokenizers.image_codecs import get_codec
        codec = get_codec(args.codec, image_size=args.image_size,
                          device=device)

    engine = InferenceEngine(config, model, tokenizer=get_tokenizer("byte"),
                             codec=codec, device=device)
    os.makedirs(args.out, exist_ok=True)

    done = 0
    batch_idx = 0
    out = None
    while done < args.n:
        b = min(args.batch, args.n - done)
        out = engine.run(text=args.prompt, task=args.task, batch=b,
                         seed=args.seed + batch_idx)
        with open(f"{args.out}/samples.jsonl", "a") as f:
            for i, text in enumerate(out["texts"][:b]):
                rec = {"index": done + i, "text": text, "nfe": out["nfe"]}
                f.write(json.dumps(rec) + "\n")
        for i, b64 in enumerate(out.get("images_b64", [])[:b]):
            with open(f"{args.out}/sample_{done + i:04d}.png", "wb") as f:
                f.write(base64.b64decode(b64))
        done += b
        batch_idx += 1
    print(f"[generate] wrote {done} samples to {args.out}/ "
          f"(nfe {out['nfe'] if out else 0}/sample)")
    return {"step": step, "samples": done, "engine": engine}


if __name__ == "__main__":
    main()
