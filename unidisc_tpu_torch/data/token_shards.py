"""Memory-mapped token shards and weighted multi-dataset sampling (port of
``unidisc_tpu/data/token_shards.py``, pure numpy).

A shard directory holds:
  tokens.npy     (N, L) int32|uint16  memory-mapped token rows
  modality.npy   (N, L) int8          0=text 1=image  (optional)
  meta.json      {"length": L, "n": N, ...}

Batches are numpy dicts, the same as the JAX package's for the same seed,
with the int ``dataset_idx`` of the dataset they came from (the trainer
moves only the arrays to the device).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np


def write_shard(directory: str, tokens: np.ndarray,
                modality: Optional[np.ndarray] = None, **meta) -> None:
    """Write one shard directory."""
    os.makedirs(directory, exist_ok=True)
    tokens = np.ascontiguousarray(tokens)
    np.save(os.path.join(directory, "tokens.npy"), tokens)
    if modality is not None:
        np.save(os.path.join(directory, "modality.npy"),
                modality.astype(np.int8))
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump({"n": int(tokens.shape[0]),
                   "length": int(tokens.shape[1]), **meta}, f)


class TokenShardDataset:
    """Random access over one shard directory through np.memmap."""

    def __init__(self, directory: str):
        self.directory = directory
        with open(os.path.join(directory, "meta.json")) as f:
            self.meta = json.load(f)
        self.tokens = np.load(os.path.join(directory, "tokens.npy"),
                              mmap_mode="r")
        mod_path = os.path.join(directory, "modality.npy")
        self.modality = (np.load(mod_path, mmap_mode="r")
                         if os.path.exists(mod_path) else None)

    def __len__(self):
        return self.tokens.shape[0]

    def get(self, idx: np.ndarray) -> dict:
        out = {"input_ids": np.asarray(self.tokens[idx], np.int32)}
        if self.modality is not None:
            out["modality"] = np.asarray(self.modality[idx], np.int32)
        return out


class WeightedDatasetSampler:
    """Endless batches from several datasets: each step picks a dataset
    with probability proportional to its weight (default: its size) and
    takes the next batch_size rows of that dataset's per-epoch permutation
    (sorted, for sequential reads). The state is (step, seed)."""

    def __init__(self, datasets: Sequence[TokenShardDataset],
                 weights: Optional[Sequence[float]] = None,
                 batch_size: int = 8, seed: int = 0, shuffle: bool = True):
        self.datasets = list(datasets)
        w = np.asarray(weights if weights is not None
                       else [len(d) for d in self.datasets], np.float64)
        self.weights = w / w.sum()
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.step = 0
        self._perms = {}

    def _perm(self, di: int, epoch: int) -> np.ndarray:
        key = (di, epoch)
        if key not in self._perms:
            rng = np.random.RandomState(
                (self.seed * 9176 + di * 131 + epoch) % (2 ** 31))
            n = len(self.datasets[di])
            # one cached permutation: the newest (dataset, epoch)
            self._perms = {key: rng.permutation(n) if self.shuffle
                           else np.arange(n)}
        return self._perms[key]

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        rng = np.random.RandomState((self.seed * 1_000_003 + self.step)
                                    % (2 ** 31))
        self.step += 1
        di = int(rng.choice(len(self.datasets), p=self.weights))
        ds = self.datasets[di]
        n = len(ds)
        start = ((self.step - 1) * self.batch_size) % n
        epoch = ((self.step - 1) * self.batch_size) // n
        perm = self._perm(di, epoch)
        idx = perm[(start + np.arange(self.batch_size)) % n]
        batch = ds.get(np.sort(idx))
        batch["dataset_idx"] = di
        return batch

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        self.step = state["step"]
        self.seed = state["seed"]
        self._perms = {}
