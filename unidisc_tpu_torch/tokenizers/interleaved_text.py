"""Interleaved document tokenization (port of
``unidisc_tpu/tokenizers/interleaved_text.py``): a prompt with
``<image>`` slots and one VQ-token block per slot -> a ``Document`` for
``data/interleaved.py::pack_documents``."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from unidisc_tpu_torch.data.interleaved import Document, Segment
from unidisc_tpu_torch.tokenizers.text import IMAGE_TOKEN


def tokenize_interleaved(prompt: str, image_token_blocks: Sequence,
                         tokenizer, *, text_vocab_size: int,
                         grid: int = 16) -> Document:
    """Split `prompt` on ``<image>``: each text span is encoded (BOS on the
    first, EOS on the last; empty spans give no segment), and each slot
    takes its block of raw codec ids offset by `text_vocab_size`."""
    parts = prompt.split(IMAGE_TOKEN)
    n_slots = len(parts) - 1
    if n_slots != len(image_token_blocks):
        raise ValueError(f"{n_slots} <image> slots but "
                         f"{len(image_token_blocks)} image blocks")
    segments: List[Segment] = []
    for i, part in enumerate(parts):
        ids = tokenizer.encode(part, add_bos=(i == 0),
                               add_eos=(i == len(parts) - 1))
        if ids:
            segments.append(Segment("text", np.asarray(ids, np.int32)))
        if i < n_slots:
            img = np.asarray(image_token_blocks[i], np.int32).reshape(-1)
            segments.append(Segment("image", img + text_vocab_size,
                                    grid=grid))
    return Document(segments)
