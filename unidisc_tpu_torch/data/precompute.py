"""Offline token precompute: images and captions -> token shards (port of
``unidisc_tpu/data/precompute.py``).

Images go through an image codec of ``tokenizers/image_codecs.py`` (on the
card by default), captions through the byte tokenizer, and the packed
[text | image] rows (image ids offset by the text vocabulary) are written
as the shards of ``data/token_shards.py``, the same rows and files as the
JAX package writes for the same samples and codec.

CLI: python -m unidisc_tpu_torch.data.precompute --out DIR --n 1000
[--codec dummy] [--device cpu] (procedural images, for runs with no
dataset on disk).
"""

from __future__ import annotations

import argparse
import os
from typing import Iterator, List, Tuple

import numpy as np

from unidisc_tpu_torch.data.token_shards import write_shard


def precompute_tokens(samples: Iterator[Tuple[str, np.ndarray]],
                      out_dir: str, *, tokenizer, codec, txt_length: int,
                      text_vocab_size: int, batch_size: int = 32,
                      shard_size: int = 4096) -> List[str]:
    """samples yields (caption, image (H, W, 3) in [-1, 1]). Writes shards
    of packed [txt | img] int32 rows, image ids offset by text_vocab_size,
    a shard once it holds shard_size rows or more (whole batches). Returns
    the shard directories."""
    shard_rows, shard_dirs = [], []
    caps, imgs = [], []

    def flush_batch():
        if not caps:
            return
        tok = tokenizer(caps, max_length=txt_length)
        img_ids = codec.encode(np.stack(imgs)).cpu().numpy()
        rows = np.concatenate([tok["input_ids"], img_ids + text_vocab_size],
                              axis=1)
        shard_rows.extend(rows.astype(np.int32))
        caps.clear()
        imgs.clear()

    def flush_shard():
        if not shard_rows:
            return
        d = os.path.join(out_dir, f"shard_{len(shard_dirs):05d}")
        rows = np.stack(shard_rows)
        img_len = rows.shape[1] - txt_length
        modality = np.concatenate([
            np.zeros((rows.shape[0], txt_length), np.int8),
            np.ones((rows.shape[0], img_len), np.int8)], axis=1)
        write_shard(d, rows, modality, codec=codec.name,
                    txt_length=txt_length, text_vocab_size=text_vocab_size)
        shard_dirs.append(d)
        shard_rows.clear()

    for caption, image in samples:
        caps.append(caption)
        imgs.append(image)
        if len(caps) >= batch_size:
            flush_batch()
            if len(shard_rows) >= shard_size:
                flush_shard()
    flush_batch()
    flush_shard()
    return shard_dirs


def procedural_samples(n: int, image_size: int = 64,
                       seed: int = 0) -> Iterator[Tuple[str, np.ndarray]]:
    """Deterministic caption + image pairs (a circle, a square or stripes
    of a random colour), for runs with no dataset on disk."""
    rng = np.random.RandomState(seed)
    shapes = ["circle", "square", "stripe"]
    c = image_size // 2
    yy, xx = np.mgrid[:image_size, :image_size]
    for i in range(n):
        kind = shapes[i % 3]
        color = rng.rand(3) * 2 - 1
        img = np.full((image_size, image_size, 3), -1.0, np.float32)
        if kind == "circle":
            mask = (yy - c) ** 2 + (xx - c) ** 2 < (c // 2) ** 2
        elif kind == "square":
            mask = (abs(yy - c) < c // 2) & (abs(xx - c) < c // 2)
        else:
            mask = (yy // 8) % 2 == 0
        img[mask] = color
        yield f"a {kind} image number {i}", img


def main(argv=None) -> List[str]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True)
    parser.add_argument("--n", type=int, default=256)
    parser.add_argument("--codec", default="dummy")
    parser.add_argument("--image-size", type=int, default=64)
    parser.add_argument("--txt-length", type=int, default=32)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--shard-size", type=int, default=1024)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from unidisc_tpu_torch.tokenizers.image_codecs import get_codec
    from unidisc_tpu_torch.tokenizers.text import get_tokenizer

    tokenizer = get_tokenizer("byte")
    codec = get_codec(args.codec, image_size=args.image_size,
                      device=args.device)
    dirs = precompute_tokens(
        procedural_samples(args.n, args.image_size), args.out,
        tokenizer=tokenizer, codec=codec, txt_length=args.txt_length,
        text_vocab_size=tokenizer.vocab_size + 1,
        batch_size=args.batch_size, shard_size=args.shard_size)
    print(f"[precompute] wrote {len(dirs)} shard(s) to {args.out}")
    return dirs


if __name__ == "__main__":
    main()
