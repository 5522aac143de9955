"""Interleaved image-text document packing (port of
``unidisc_tpu/data/interleaved.py``, pure numpy).

``pack_documents`` packs variable-length documents into fixed-length rows
with per-token ``sample_ids`` (-1 = padding): a document never spans rows,
an image block is never split, an EOS may close each document, and a
document longer than a row is cut at a segment boundary (whole trailing
segments dropped). The packer also writes each token's ``rope_index``
(text: its offset within the sample, counting every token; image: its
raster index within its block, plus the block's row offset in a
multi-resolution table when ``rope_offsets`` is given) and
``img_block_index`` (the count of earlier image blocks in the sample).
The DIT takes these as its packed-batch arguments. ``unpack_rows`` splits
packed rows back into per-sample segments.

The native twin is ``data/native_packer.py``; both give the same arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Segment:
    kind: str          # "text" | "image"
    ids: np.ndarray    # token ids (already offset into the unified vocab)
    grid: int = 0      # image: tokens per side (e.g. 16 for 256 tokens)


@dataclass
class Document:
    segments: List[Segment]

    def __len__(self):
        return sum(len(s.ids) for s in self.segments)


def make_document(text_ids: Sequence[int] = (), image_ids=None,
                  grid: int = 16, interleave=None) -> Document:
    """A text-only, text + image, or explicit [(kind, ids[, grid]), ...]
    document."""
    segs = []
    if interleave is not None:
        for kind, ids, *rest in interleave:
            g = rest[0] if rest else grid
            segs.append(Segment(kind, np.asarray(ids, np.int32), g))
    else:
        if len(text_ids):
            segs.append(Segment("text", np.asarray(text_ids, np.int32)))
        if image_ids is not None:
            segs.append(Segment("image", np.asarray(image_ids, np.int32),
                                grid))
    return Document(segs)


class PackedBatch(dict):
    """dict with input_ids, modality, sample_ids, rope_index,
    img_block_index (B, L) np.int32 and attention_mask (B, L) bool."""


def pack_documents(docs: Sequence[Document], length: int, *,
                   pad_id: int, eos_id: Optional[int] = None,
                   batch_size: Optional[int] = None,
                   rope_offsets: Optional[dict] = None) -> PackedBatch:
    """Greedy first-fit packing of whole documents into rows of `length`
    (module docstring). batch_size pads with empty rows or cuts to that
    many rows."""
    rows: List[List[Tuple[int, Segment]]] = []  # [(sample_id, segment)]
    row_space: List[int] = []
    eos = 1 if eos_id is not None else 0

    sample_counter = 0
    for doc in docs:
        segs = list(doc.segments)
        total = sum(len(s.ids) for s in segs) + eos
        while segs and total > length:
            total -= len(segs.pop().ids)
        if not segs:
            continue
        size = total
        entry = [(sample_counter, s) for s in segs]
        if eos_id is not None:
            entry.append((sample_counter,
                          Segment("text", np.asarray([eos_id], np.int32))))
        for ri in range(len(rows)):
            if row_space[ri] >= size:
                rows[ri].extend(entry)
                row_space[ri] -= size
                break
        else:
            rows.append(entry)
            row_space.append(length - size)
        sample_counter += 1

    if batch_size is not None:
        while len(rows) < batch_size:
            rows.append([])
        rows = rows[:batch_size]

    b = len(rows)
    input_ids = np.full((b, length), pad_id, np.int32)
    modality = np.zeros((b, length), np.int32)
    sample_ids = np.full((b, length), -1, np.int32)
    rope_index = np.zeros((b, length), np.int32)
    img_block_index = np.zeros((b, length), np.int32)
    for ri, row in enumerate(rows):
        pos = 0
        samp_off = {}  # sample id -> tokens of the sample so far
        img_cnt = {}   # sample id -> image blocks so far
        for sid, seg in row:
            n = len(seg.ids)
            sl = slice(pos, pos + n)
            input_ids[ri, sl] = seg.ids
            sample_ids[ri, sl] = sid
            off = samp_off.get(sid, 0)
            if seg.kind == "image":
                modality[ri, sl] = 1
                base = rope_offsets[n] if rope_offsets is not None else 0
                rope_index[ri, sl] = base + np.arange(n)
                cnt = img_cnt.get(sid, 0)
                img_block_index[ri, sl] = cnt
                img_cnt[sid] = cnt + 1
            else:
                rope_index[ri, sl] = np.arange(off, off + n)
            samp_off[sid] = off + n
            pos += n

    return PackedBatch(
        input_ids=input_ids, modality=modality, sample_ids=sample_ids,
        rope_index=rope_index, img_block_index=img_block_index,
        attention_mask=(sample_ids >= 0))


def unpack_rows(batch) -> List[List[dict]]:
    """Packed rows -> per row, one {"sample_id", "segments": [{"kind",
    "ids"}, ...]} per sample, split at modality changes."""
    out = []
    b = batch["input_ids"].shape[0]
    for ri in range(b):
        sids = batch["sample_ids"][ri]
        elements = []
        for sid in np.unique(sids[sids >= 0]):
            sel = sids == sid
            mods = batch["modality"][ri][sel]
            ids = batch["input_ids"][ri][sel]
            cuts = np.flatnonzero(np.diff(mods)) + 1
            parts = np.split(np.arange(len(ids)), cuts)
            segs = [{"kind": "image" if mods[p[0]] else "text",
                     "ids": ids[p]} for p in parts if len(p)]
            elements.append({"sample_id": int(sid), "segments": segs})
        out.append(elements)
    return out
