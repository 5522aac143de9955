"""Synthetic token data for smoke runs and measurements (port of
``unidisc_tpu/data/synthetic.py``): deterministic multimodal batches in the
[txt | img] layout, from the same numpy ``RandomState`` stream, so a batch
here equals the JAX package's byte for byte. Batches are numpy arrays; the
trainer moves them to the device.
"""

from __future__ import annotations

import numpy as np

from unidisc_tpu_torch.config import Config


class SyntheticDataLoader:
    """Infinite iterator of {input_ids, modality} int32 numpy batches with
    a checkpointable position."""

    def __init__(self, config: Config, batch_size: int, seed: int = 0,
                 vocab_structured: bool = True):
        self.m = config.model
        self.batch_size = batch_size
        self.seed = seed
        self.step = 0
        self.vocab_structured = vocab_structured
        m = self.m
        self._modality = np.concatenate([
            np.zeros((batch_size, m.txt_length), np.int32),
            np.ones((batch_size, m.img_length), np.int32)], axis=-1)

    def __iter__(self):
        return self

    def __next__(self):
        m = self.m
        rng = np.random.RandomState((self.seed * 1_000_003 + self.step)
                                    % (2 ** 31))
        self.step += 1
        if self.vocab_structured:
            # learnable structure: tokens follow a position-dependent pattern
            base = rng.randint(0, 97, (self.batch_size, 1))
            pos = np.arange(m.length)[None, :]
            txt = (base + pos[:, :m.txt_length]) % (m.text_vocab_size - 1)
            img = m.text_vocab_size + (base + 7 * pos[:, m.txt_length:]
                                       ) % m.image_vocab_size
        else:
            txt = rng.randint(0, m.text_vocab_size - 1,
                              (self.batch_size, m.txt_length))
            img = rng.randint(m.text_vocab_size, m.vocab_size,
                              (self.batch_size, m.img_length))
        ids = np.concatenate([txt, img], axis=-1).astype(np.int32)
        return {"input_ids": ids, "modality": self._modality}

    def state_dict(self):
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, state):
        self.step = state["step"]
        self.seed = state["seed"]
