"""Streaming shard ingestion with exact mid-epoch resume (port of
``unidisc_tpu/data/streaming.py``, pure numpy, fixed-row shards).

``StreamingShardReader`` reads a directory of ``shard-%05d.npz`` files
(tokens (N, L) [+ modality]) one after another: the shard order is
shuffled per epoch from the seed, the shards are dealt round-robin to the
hosts (process_index of process_count), and rows within a shard come in a
seeded permutation. Its state (epoch, shard_cursor,
row_cursor, seed) rides the trainer's checkpoint, and a restored reader
continues the same batch sequence mid-epoch. Batches equal the JAX
package's for the same seed.

Ragged interleaved shards (``ishard-*.npz``, packed into rows at stream
time) are not in the port yet: the port trains on no ``sample_ids``
(ROADMAP queue 1, item 6).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Iterator, List, Optional

import numpy as np


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


class StreamingShardReader:
    """Sequential shard streaming with per-epoch shard shuffling, host
    partitioning, a row shuffle and exact mid-epoch resume. (The JAX
    reader's shuffle_buffer argument is unused there and not taken here:
    the rows of a shard come in one seeded permutation.)"""

    def __init__(self, directory: str, *, batch_size: int = 8,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1,
                 pack_length: Optional[int] = None):
        if glob.glob(os.path.join(directory, "ishard-*.npz")) \
                or pack_length is not None:
            raise NotImplementedError(
                "interleaved (ragged ishard-*) streaming is not in the port "
                "yet (ROADMAP queue 1, item 6)")
        self.paths = sorted(glob.glob(os.path.join(directory,
                                                   "shard-*.npz")))
        if not self.paths:
            raise FileNotFoundError(f"no shard-*.npz under {directory}")
        self.directory = directory
        self.batch_size = batch_size
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
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

    @staticmethod
    def _load_rows(path: str) -> dict:
        with np.load(path) as z:
            rows = {"input_ids": np.asarray(z["tokens"], np.int32)}
            if "modality" in z:
                rows["modality"] = np.asarray(z["modality"], np.int32)
        return rows

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
