"""Streaming shard ingestion with exact mid-epoch resume (port of
``unidisc_tpu/data/streaming.py``, pure numpy).

``StreamingShardReader`` reads a directory of shard files one after
another: the shard order is shuffled per epoch from the seed, the shards
are dealt round-robin to the hosts (process_index of process_count), and
rows within a shard come in a seeded permutation. Its state (epoch,
shard_cursor, row_cursor, seed) rides the trainer's checkpoint, and a
restored reader continues the same batch sequence mid-epoch. Batches
equal the JAX package's for the same seed.

Shard formats:
  <dir>/shard-%05d.npz    fixed rows: tokens (N, L) [+ modality]
  <dir>/ishard-%05d.npz   ragged interleaved documents stored flat:
                          tokens (T,), modality (T,), grids (T,) (an image
                          token's grid side, 0 for text), segments (T,)
                          (the segment index of each token) and offsets
                          (D + 1,)

A ragged shard's documents are shuffled (seeded by the epoch and the
shard's name) and packed into rows of ``pack_length`` as the shard is
read (``data/interleaved.py``), by the native packer
(``data/native_packer.py``, the default, as in JAX) or the Python one
(``packer="python"``); the two give the same rows, so one shard serves
any row length.
"""

from __future__ import annotations

import glob
import json
import os
import zlib
from typing import Iterator, List, Optional, Sequence

import numpy as np

from unidisc_tpu_torch.data.interleaved import (Document, Segment,
                                                pack_documents)


def write_stream_shards(directory: str, tokens: np.ndarray,
                        modality: Optional[np.ndarray] = None,
                        rows_per_shard: int = 1024, **meta) -> None:
    """Split fixed-length rows into sequential .npz shards."""
    os.makedirs(directory, exist_ok=True)
    n = tokens.shape[0]
    count = 0
    for s, start in enumerate(range(0, n, rows_per_shard)):
        sl = slice(start, min(start + rows_per_shard, n))
        payload = {"tokens": np.asarray(tokens[sl], np.int32)}
        if modality is not None:
            payload["modality"] = np.asarray(modality[sl], np.int8)
        np.savez(os.path.join(directory, f"shard-{s:05d}.npz"), **payload)
        count += 1
    with open(os.path.join(directory, "stream_meta.json"), "w") as f:
        json.dump({"n": int(n), "shards": count,
                   "length": int(tokens.shape[1]), **meta}, f)


def write_interleaved_shard(directory: str, documents: Sequence[Document],
                            shard_index: int = 0, **meta) -> None:
    """Store ragged documents flat as ``ishard-<shard_index>.npz`` (packing
    happens at stream time) and merge `meta` into stream_meta.json."""
    os.makedirs(directory, exist_ok=True)
    toks, mods, grids, segidx, offsets = [], [], [], [], [0]
    seg_counter = 0
    for doc in documents:
        for seg in doc.segments:
            n = len(seg.ids)
            is_img = seg.kind == "image"
            toks.append(np.asarray(seg.ids, np.int32))
            mods.append(np.full(n, 1 if is_img else 0, np.int8))
            grids.append(np.full(n, seg.grid if is_img else 0, np.int16))
            # an explicit segment index: two adjacent images stay two
            segidx.append(np.full(n, seg_counter, np.int32))
            seg_counter += 1
        offsets.append(offsets[-1] + len(doc))

    def cat(xs, dt):
        return np.concatenate(xs) if xs else np.zeros(0, dt)
    np.savez(os.path.join(directory, f"ishard-{shard_index:05d}.npz"),
             tokens=cat(toks, np.int32), modality=cat(mods, np.int8),
             grids=cat(grids, np.int16), segments=cat(segidx, np.int32),
             offsets=np.asarray(offsets, np.int64))
    mpath = os.path.join(directory, "stream_meta.json")
    prev = {}
    if os.path.exists(mpath):
        with open(mpath) as f:
            prev = json.load(f)
    prev.update({"interleaved": True, **meta})
    with open(mpath, "w") as f:
        json.dump(prev, f)


def docs_from_ishard(path: str) -> List[Document]:
    """The documents of one ragged shard file."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    offsets = arrays["offsets"]
    docs = []
    for di in range(len(offsets) - 1):
        sl = slice(offsets[di], offsets[di + 1])
        toks, mods = arrays["tokens"][sl], arrays["modality"][sl]
        grids = arrays["grids"][sl]
        if "segments" in arrays:
            cuts = np.flatnonzero(np.diff(arrays["segments"][sl])) + 1
        else:   # shards without segment indices: cut at modality changes
            cuts = np.flatnonzero(np.diff(mods.astype(np.int32))) + 1
        segs = []
        for part in np.split(np.arange(len(toks)), cuts):
            if not len(part):
                continue
            is_img = mods[part[0]] == 1
            segs.append(Segment("image" if is_img else "text",
                                np.asarray(toks[part], np.int32),
                                int(grids[part[0]]) if is_img else 0))
        docs.append(Document(segs))
    return docs


class StreamingShardReader:
    """Sequential shard streaming with per-epoch shard shuffling, host
    partitioning, a row shuffle and exact mid-epoch resume, over
    fixed-row or ragged shards (module docstring). (The JAX reader's
    shuffle_buffer argument is unused there and not taken here: the rows
    of a shard come in one seeded permutation.) A ragged directory needs
    pack_length; pad_id, eos_id and rope_offsets go to the packer."""

    def __init__(self, directory: str, *, batch_size: int = 8,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1,
                 pack_length: Optional[int] = None, pad_id: int = 0,
                 eos_id: Optional[int] = None,
                 rope_offsets: Optional[dict] = None,
                 packer: str = "native"):
        fixed = sorted(glob.glob(os.path.join(directory, "shard-*.npz")))
        ragged = sorted(glob.glob(os.path.join(directory, "ishard-*.npz")))
        if not (fixed or ragged):
            raise FileNotFoundError(f"no shard-*.npz or ishard-*.npz under "
                                    f"{directory}")
        if fixed and ragged:
            raise ValueError(f"{directory} mixes shard-* and ishard-* "
                             f"files")
        if packer not in ("native", "python"):
            raise ValueError(f"unknown packer {packer!r}")
        self.paths = fixed or ragged
        self.interleaved = bool(ragged)
        if self.interleaved and pack_length is None:
            raise ValueError("ragged ishard-* shards need pack_length (rows "
                             "are packed as they stream)")
        self.directory = directory
        self.batch_size = batch_size
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.pack_length = pack_length
        self.pad_id, self.eos_id = pad_id, eos_id
        self.rope_offsets = rope_offsets
        self.packer = packer
        # resume counters
        self.epoch = 0
        self.shard_cursor = 0   # position in this epoch's shard order
        self.row_cursor = 0     # rows already taken from the current shard

    def _epoch_shards(self, epoch: int) -> List[str]:
        order = np.random.RandomState(
            (self.seed * 7919 + epoch) % (2 ** 31)).permutation(
                len(self.paths))
        mine = [self.paths[i] for i in order]
        return mine[self.process_index::self.process_count]

    def _load_rows(self, path: str) -> dict:
        if self.interleaved:
            return self._pack(path)
        with np.load(path) as z:
            rows = {"input_ids": np.asarray(z["tokens"], np.int32)}
            if "modality" in z:
                rows["modality"] = np.asarray(z["modality"], np.int32)
        return rows

    def _pack(self, path: str) -> dict:
        """One ragged shard's documents, shuffled by (seed, epoch, the
        shard's name) and packed into rows."""
        docs = docs_from_ishard(path)
        stable = zlib.crc32(os.path.basename(path).encode())
        rs = np.random.RandomState(
            (self.seed + self.epoch * 131 + stable % 1000) % (2 ** 31))
        docs = [docs[i] for i in rs.permutation(len(docs))]
        if self.packer == "native":
            from unidisc_tpu_torch.data.native_packer import \
                pack_documents_native as pack
        else:
            pack = pack_documents
        return dict(pack(docs, self.pack_length, pad_id=self.pad_id,
                         eos_id=self.eos_id, rope_offsets=self.rope_offsets))

    def __iter__(self) -> Iterator[dict]:
        while True:
            shards = self._epoch_shards(self.epoch)
            while self.shard_cursor < len(shards):
                rows = self._load_rows(shards[self.shard_cursor])
                n = rows["input_ids"].shape[0]
                perm = np.random.RandomState(
                    (self.seed * 31 + self.epoch * 7 + self.shard_cursor)
                    % (2 ** 31)).permutation(n)
                while self.row_cursor + self.batch_size <= n:
                    idx = perm[self.row_cursor:
                               self.row_cursor + self.batch_size]
                    self.row_cursor += self.batch_size
                    yield {k: v[idx] for k, v in rows.items()}
                self.row_cursor = 0
                self.shard_cursor += 1
            self.shard_cursor = 0
            self.epoch += 1

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "shard_cursor": self.shard_cursor,
                "row_cursor": self.row_cursor, "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        self.shard_cursor = int(state["shard_cursor"])
        self.row_cursor = int(state["row_cursor"])
        self.seed = int(state["seed"])
