"""Evaluation CLI: the metrics battery of a trained run dir (port of
``unidisc_tpu/eval_run.py``).

Val NLL / BPD / PPL per modality, the speed metrics of times.txt, the
token entropy of generations, and, with a codec, FID against a reference
set of images; MAUVE against reference texts; the judge LM's perplexity
and the CLIP score when their assets are there.

Usage:
  python -m unidisc_tpu_torch.eval_run --ckpt runs/dev --data shards/ \\
      [--codec llamagen-vq16 --image-size 256] [--max-batches 16] \\
      [--use-ema] [--fid-ref ref.npy] [--mauve-ref ref.txt] [--clip] \\
      [--assets DIR] [--device cuda|cpu]

The run dir is one the port's Trainer wrote (``serving/engine.py::
restore_run``). Val batches go through ``training/train_state.py::
make_eval_step`` with the draws of ``Trainer.validate`` (its generator
seeds), so val/nll equals the Trainer's on the same batches; generation
runs ``sampling/sampler.py::build_sampler``, on the card as its captured
program. Without an asset, FID runs on the random-conv features and
MAUVE on the bag-of-ngrams features, and the result names which ran. The
flags and the keys of ``eval_results.json`` are the JAX package's;
``--device`` (the card unless ``cpu`` is asked for) is the port's. The DIT
computes in bf16, as the Trainer does.
"""

from __future__ import annotations

import argparse
import json
import time


def val_metrics(config, model, loader, max_batches: int, device,
                draws=None) -> dict:
    """Val NLL / BPD / PPL over up to max_batches loader batches, each
    batch drawn as Trainer.validate draws it (``training/trainer.py::
    validation_sums``), or from ``draws(i, rows)``."""
    import numpy as np
    import torch

    from unidisc_tpu_torch.training.train_state import make_eval_step
    from unidisc_tpu_torch.training.trainer import LN2, validation_sums

    def to_device(batch):
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
                if isinstance(v, np.ndarray)}

    sums = validation_sums(make_eval_step(config, model, use_ema=False),
                           None, loader, max_batches, seed=config.seed,
                           device=device, to_device=to_device, draws=draws)
    if sums is None:
        sums = np.zeros(6)
    nll = sums[0] / max(sums[1], 1)
    return {"val/nll": nll, "val/bpd": nll / LN2,
            "val/ppl": float(np.exp(min(nll, 50))),
            "val/txt_ppl": float(np.exp(min(sums[2] / max(sums[3], 1), 50))),
            "val/img_bpd": sums[4] / max(sums[5], 1) / LN2}


def sample_program(config, model, batch: int, device, injected=None):
    """sample(x0, x0_unmask, modality) -> SampleResult at seed 0 (every
    call the same draws, as the JAX package's PRNGKey(0)): on the card the
    sampler's captured program, else the eager sampler; with `injected`
    noise (the tests' contract) the sampler reads it instead."""
    import torch

    from unidisc_tpu_torch.sampling.graph import captured
    from unidisc_tpu_torch.sampling.sampler import build_sampler

    sampler = build_sampler(model, config, device=device,
                            inject_noise=injected is not None)
    if device.type == "cuda" and sampler.capturable:
        program = captured(sampler, batch)
        return lambda *a: program(*a, seed=0, injected=injected)

    def sample(*a):
        gen = torch.Generator(device=device).manual_seed(0)
        return sampler(*a, generator=gen, injected=injected)
    return sample


def main(argv=None, *, draws=None, injected=None,
         dtype: str = "bfloat16") -> dict:
    """The battery; returns the results written to eval_results.json.
    draws / injected / dtype: the tests' hooks (``val_metrics``'s draws,
    the sampler's injected noise, the DIT's compute dtype: float32 to hold
    the battery to the JAX package's fp32 steps)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--data", default=None,
                        help="token shard dir for val metrics")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--max-batches", type=int, default=16)
    parser.add_argument("--gen-batches", type=int, default=2)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--codec", default=None)
    parser.add_argument("--image-size", type=int, default=256)
    parser.add_argument("--use-ema", action="store_true")
    parser.add_argument("--fid-ref", default=None,
                        help=".npy of reference images (N,H,W,3) for FID")
    parser.add_argument("--mauve-ref", default=None,
                        help="text file of reference texts (one per line)")
    parser.add_argument("--clip", action="store_true",
                        help="CLIP score of generated images vs their "
                             "prompts (needs $UNIDISC_ASSETS)")
    parser.add_argument("--assets", default=None,
                        help="judge-asset dir (overrides $UNIDISC_ASSETS)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from unidisc_tpu_torch.device import resolve_device
    from unidisc_tpu_torch.eval import judges
    from unidisc_tpu_torch.eval.harness import speed_eval, token_entropy
    from unidisc_tpu_torch.models.dit import DIT
    from unidisc_tpu_torch.serving.engine import restore_run

    t0 = time.perf_counter()
    device = resolve_device(args.device)
    config, weights, step = restore_run(args.ckpt, ema=args.use_ema)
    if args.steps:
        config = config.override(**{"sampling.steps": args.steps})
    m = config.model
    model = DIT(m, compute_dtype=getattr(torch, dtype))
    model.load_state_dict(weights)
    model = model.to(device).eval()
    del weights
    results = {"step": int(step)}

    # ---- val metrics -----------------------------------------------------
    if args.data:
        from unidisc_tpu_torch.data.token_shards import (
            TokenShardDataset, WeightedDatasetSampler)
        loader = WeightedDatasetSampler([TokenShardDataset(args.data)],
                                        batch_size=args.batch,
                                        seed=7, shuffle=False)
        results.update(val_metrics(config, model, loader,
                                   args.max_batches, device, draws))

    # ---- generation + speed (times.txt metrics) ---------------------------
    sample = sample_program(config, model, args.batch, device, injected)
    b = args.batch
    x0 = np.zeros((b, m.length), np.int32)
    unmask = np.zeros((b, m.length), bool)
    modality = np.concatenate([np.zeros((b, m.txt_length), np.int32),
                               np.ones((b, m.img_length), np.int32)], -1)
    sargs = (x0, unmask, modality)
    results.update(speed_eval(sample, sargs,
                              iters=max(args.gen_batches, 2),
                              tokens_per_sample=m.length, batch=b))

    toks = sample(*sargs).tokens.cpu().numpy()
    results["gen/token_entropy"] = token_entropy(toks, m.vocab_size)
    txt_share = (toks[:, :m.txt_length] < m.text_vocab_size).mean()
    results["gen/txt_vocab_respected"] = float(txt_share)

    # ---- quality judges (eval/judges.py) ----------------------------------
    gen_imgs = None
    if args.codec and (args.fid_ref or args.clip):
        from unidisc_tpu_torch.tokenizers.image_codecs import get_codec
        codec = get_codec(args.codec, image_size=args.image_size,
                          device=device)
        img_ids = np.clip(toks[:, m.txt_length:] - m.text_vocab_size,
                          0, m.image_vocab_size - 1)
        gen_imgs = codec.decode(img_ids).float().cpu().numpy()

    if args.fid_ref and gen_imgs is not None:
        from unidisc_tpu_torch.eval.fid import FIDMetric
        ref_imgs = np.load(args.fid_ref)
        try:
            feat_fn = judges.inception_features(args.assets, device)
            dim, which = 2048, "inception"
        except FileNotFoundError as e:
            print(f"[eval] FID on the random-conv features: {e}")
            feat_fn = judges.random_conv_features(device=device)
            dim, which = 192, "random_conv(seed7)"
        fid = FIDMetric(feat_fn, dim)
        fid.update_real(ref_imgs)
        fid.update_fake(gen_imgs)
        results[f"fid/{which}"] = fid.compute()

    prompts = None
    if args.mauve_ref or (args.clip and args.codec):
        from unidisc_tpu_torch.tokenizers.text import get_tokenizer
        tokenizer = get_tokenizer()
        prompts = [tokenizer.decode(r[r < m.text_vocab_size - 1])
                   for r in toks[:, :m.txt_length]]

    if args.mauve_ref:
        with open(args.mauve_ref) as f:
            ref_texts = [ln.strip() for ln in f if ln.strip()]
        try:
            nll_fn, feat_fn = judges.judge_lm(args.assets, device=device)
            results["mauve/features"] = "gpt2-large"
        except FileNotFoundError as e:
            print(f"[eval] MAUVE on the bag-of-ngrams features: {e}")
            nll_fn = feat_fn = None
            results["mauve/features"] = "bag_of_ngrams"
        results["mauve/score"] = judges.mauve_score(
            ref_texts, prompts, feature_fn=feat_fn)["mauve"]
        if nll_fn is not None:
            results["gen/judge_ppl"] = float(
                np.exp(np.mean(nll_fn(prompts))))

    if args.clip and args.codec:
        try:
            score = judges.clip_score_fn(args.assets, device=device)
            # codec.decode emits [-1, 1] (as serving.engine.to_uint8)
            imgs = ((np.clip(gen_imgs, -1, 1) + 1) * 127.5).astype(np.uint8)
            results["clip/score"] = float(np.mean(score(imgs, prompts)))
        except FileNotFoundError as e:
            results["clip/score"] = f"skipped ({e})"

    for k, v in results.items():
        print(f"{k}: {v:.6g}" if isinstance(v, float) else f"{k}: {v}")
    with open(f"{args.ckpt}/eval_results.json", "w") as f:
        json.dump(results, f, indent=2, default=float)
    print(f"[eval] wrote {args.ckpt}/eval_results.json in "
          f"{time.perf_counter() - t0:.1f} s on {device}")
    return results


if __name__ == "__main__":
    main()
