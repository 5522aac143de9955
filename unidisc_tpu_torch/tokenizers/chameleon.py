"""Chameleon / Lumina-style interleaved stream tokenizer (port of
``unidisc_tpu/tokenizers/chameleon.py``).

A stream codec over the unified vocabulary, with any image codec of
``tokenizers/image_codecs.py`` supplying the VQ tokens:

  - variable-aspect crops: ``build_crop_size_list`` / ``var_center_crop``
    (numpy, and a bilinear resize that antialiases when it shrinks, as
    ``jax.image.resize(..., "bilinear")`` does); crops drawn from a numpy
    ``Generator`` with JAX's calls, so the same seed gives the same crops;
  - the stream layout: ``<image_start> <grids:h> <grids:w>``, then the VQ
    tokens row by row, each row closed by ``<new_line>``, then
    ``<image_end>``; image ids offset by the text vocabulary;
  - decode: the stream cut into text ids (an ``<|image|>`` placeholder
    per image) and the images' token grids;
  - batch packing to a fixed length with attention masks.

Everything but the codec's encode is host-side numpy; ``tokenize_t2i_batch``
encodes through the port's ``ImageCodec`` on its device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def build_crop_size_list(patch_size: int = 16, max_grids: int = 576,
                         max_aspect: float = 4.0) -> List[Tuple[int, int]]:
    """Every (h, w) pixel crop whose grid fits the token budget: each
    width in grids with h_grids = max_grids // w_grids, aspect ratio
    within ``max_aspect``; sorted tall to wide."""
    sizes = []
    w = 1
    while w <= max_grids:
        h = max_grids // w
        if max(h / w, w / h) <= max_aspect:
            sizes.append((h * patch_size, w * patch_size))
        w += 1
    return sorted(set(sizes), key=lambda s: (-s[0], s[1]))


def _resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize of an HWC image in fp32, antialiased when it
    shrinks (``jax.image.resize``'s triangle kernel)."""
    x = torch.from_numpy(np.asarray(img, np.float32)).permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(h, w), mode="bilinear",
                        align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0).numpy()


def center_crop_to(img: np.ndarray, crop_hw: Tuple[int, int],
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Halve by area while the image is at least twice the crop, resize
    to cover the crop, then crop (at a draw of `rng`, else centred)."""
    ch, cw = crop_hw
    h, w = img.shape[:2]
    while h >= 2 * ch and w >= 2 * cw:
        img = img.reshape(h // 2, 2, w // 2, 2, -1).mean(axis=(1, 3))
        h, w = img.shape[:2]
    scale = max(ch / h, cw / w)
    nh, nw = round(h * scale), round(w * scale)
    img = _resize_bilinear(img, nh, nw)
    if rng is None:
        top, left = (nh - ch) // 2, (nw - cw) // 2
    else:
        top = int(rng.integers(0, nh - ch + 1))
        left = int(rng.integers(0, nw - cw + 1))
    return img[top:top + ch, left:left + cw]


def var_center_crop(img: np.ndarray, crop_size_list: Sequence[Tuple[int, int]],
                    rng: Optional[np.random.Generator] = None,
                    top_k: int = 1) -> np.ndarray:
    """Crop to the crop size that keeps the most of the image's aspect
    (min(cw/w, ch/h) / max(cw/w, ch/h)), drawn among the best `top_k`."""
    h, w = img.shape[:2]
    rem = [min(cw / w, ch / h) / max(cw / w, ch / h)
           for ch, cw in crop_size_list]
    ranked = sorted(zip(rem, crop_size_list), reverse=True)[:top_k]
    if rng is None or top_k == 1:
        crop = ranked[0][1]
    else:
        crop = ranked[int(rng.integers(0, len(ranked)))][1]
    return center_crop_to(img, crop, rng)


@dataclasses.dataclass(frozen=True)
class ChameleonSpec:
    """Unified-vocab layout of chameleon-style streams.

    [0, text_vocab)                         text ids
    [text_vocab, text_vocab + img_vocab)    image VQ ids (a flat offset)
    then the stream tokens:                 image_start, image_end,
                                            new_line, image_placeholder,
                                            one grid token per count
                                            1..max_grids.
    """

    text_vocab: int
    img_vocab: int
    patch_size: int = 16
    max_grids: int = 64

    @property
    def image_start(self) -> int:
        return self.text_vocab + self.img_vocab

    @property
    def image_end(self) -> int:
        return self.image_start + 1

    @property
    def new_line(self) -> int:
        return self.image_start + 2

    @property
    def image_placeholder(self) -> int:
        """Stands in for a decoded image span in text output."""
        return self.image_start + 3

    def grid_token(self, n: int) -> int:
        """The token of a grid dimension of n patches."""
        if not 1 <= n <= self.max_grids:
            raise ValueError(f"grid count {n} outside [1, {self.max_grids}]")
        return self.image_start + 4 + (n - 1)

    def grid_from_token(self, tok: int) -> int:
        return tok - (self.image_start + 4) + 1

    @property
    def vocab_size(self) -> int:
        return self.image_start + 4 + self.max_grids

    def offset_image_ids(self, vq_ids: np.ndarray) -> np.ndarray:
        return np.asarray(vq_ids, np.int64) + self.text_vocab

    def encode_image_grid(self, vq_grid: np.ndarray) -> np.ndarray:
        """(h_grids, w_grids) raw VQ ids -> ``start, grid(h), grid(w),
        row0..., nl, row1..., nl, ..., end``."""
        hg, wg = vq_grid.shape
        body = np.concatenate(
            [self.offset_image_ids(vq_grid),
             np.full((hg, 1), self.new_line, np.int64)], axis=1).reshape(-1)
        return np.concatenate([
            np.asarray([self.image_start, self.grid_token(hg),
                        self.grid_token(wg)], np.int64),
            body,
            np.asarray([self.image_end], np.int64)])

    def decode_image_span(self, span: np.ndarray) -> np.ndarray:
        """Inverse of encode_image_grid's body (span excludes start and
        end)."""
        hg = self.grid_from_token(int(span[0]))
        wg = self.grid_from_token(int(span[1]))
        body = np.asarray(span[2:], np.int64).reshape(hg, wg + 1)
        if not (body[:, -1] == self.new_line).all():
            raise ValueError("malformed image span: missing new_line column")
        return body[:, :-1] - self.text_vocab

    def image_span_length(self, hg: int, wg: int) -> int:
        return 3 + hg * (wg + 1) + 1


def encode_document(spec: ChameleonSpec, parts: Sequence) -> np.ndarray:
    """Interleave text-id arrays (1D) and raw VQ grids (2D) into one
    stream."""
    chunks = []
    for p in parts:
        p = np.asarray(p)
        if p.ndim == 1:
            chunks.append(p.astype(np.int64))
        elif p.ndim == 2:
            chunks.append(spec.encode_image_grid(p))
        else:
            raise ValueError(f"part with ndim {p.ndim}")
    return (np.concatenate(chunks) if chunks
            else np.zeros((0,), np.int64))


def decode_stream(spec: ChameleonSpec, ids: Sequence[int]
                  ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Stream -> (text ids with placeholders, the raw VQ grids). An
    unterminated image span ends the stream."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    text: List[int] = []
    grids: List[np.ndarray] = []
    i = 0
    starts = (ids == spec.image_start)
    ends = (ids == spec.image_end)
    while i < len(ids):
        if starts[i]:
            close = np.nonzero(ends[i + 1:])[0]
            if close.size == 0:
                break
            j = i + 1 + int(close[0])
            grids.append(spec.decode_image_span(ids[i + 1:j]))
            text.append(spec.image_placeholder)
            i = j + 1
        else:
            text.append(int(ids[i]))
            i += 1
    return np.asarray(text, np.int64), grids


def batch_encode(spec: ChameleonSpec, docs: Sequence[Sequence],
                 length: int, pad_id: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed-length (ids, attention_mask) of variable documents, each
    clipped at ``length``."""
    bs = len(docs)
    out = np.full((bs, length), pad_id, np.int64)
    mask = np.zeros((bs, length), bool)
    for i, parts in enumerate(docs):
        stream = encode_document(spec, parts)
        n = min(len(stream), length)
        out[i, :n] = stream[:n]
        mask[i, :n] = True
    return out, mask


def tokenize_t2i_batch(spec: ChameleonSpec, text_tokenizer, codec,
                       images: np.ndarray, captions: Sequence[str],
                       length: int,
                       crop_size_list: Optional[Sequence] = None,
                       rng: Optional[np.random.Generator] = None,
                       max_caption_chars: int = 200
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Images + captions -> chameleon streams, the images encoded by
    `codec` (an ``ImageCodec``) on its device in one call. Every image is
    cropped with ``var_center_crop`` when a crop list is given, so a batch
    shares one crop size only where its images share their aspect; the
    prompt is "Generate an image of WxH according to the following
    prompt:\\n<caption>"."""
    if crop_size_list is not None:
        images = np.stack([
            var_center_crop(im, crop_size_list, rng) for im in images])
    h, w = images.shape[1:3]
    hg, wg = h // spec.patch_size, w // spec.patch_size
    vq = codec.encode(np.asarray(images, np.float32)).cpu().numpy()
    vq = vq.reshape(len(images), hg, wg)
    docs = []
    for i, cap in enumerate(captions):
        prompt = (f"Generate an image of {w}x{h} according to the "
                  f"following prompt:\n{cap[:max_caption_chars]}")
        txt = np.asarray(
            text_tokenizer.encode(prompt, add_bos=True, add_eos=False),
            np.int64)
        docs.append([txt, vq[i]])
    return batch_encode(spec, docs, length)
