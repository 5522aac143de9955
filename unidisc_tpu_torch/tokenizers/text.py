"""Text tokenizers and decode helpers (port of
``unidisc_tpu/tokenizers/text.py``): the offline byte-level tokenizer,
and HF tokenizers read from a local directory (``tokenizers/hf_text.py``)
with right padding, pad = EOS where the config has no pad token, and
``<image>`` registered as a special token at the next id when the
vocabulary lacks it."""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

IMAGE_TOKEN = "<image>"


class ByteTokenizer:
    """Deterministic byte-level tokenizer.

    Layout: 0 = pad, 1 = bos, 2 = eos, 3 = <image>, 4..259 = bytes.
    vocab_size = 260 (+1 mask appended by the vocab logic downstream).
    """

    pad_token_id = 0
    bos_token_id = 1
    eos_token_id = 2
    image_token_id = 3
    _OFFSET = 4

    def __init__(self):
        self.vocab_size = 256 + self._OFFSET

    def encode(self, text: str, *, add_bos: bool = True,
               add_eos: bool = True) -> List[int]:
        ids: List[int] = [self.bos_token_id] if add_bos else []
        for part in text.split(IMAGE_TOKEN):
            ids.extend(b + self._OFFSET for b in part.encode("utf-8"))
            ids.append(self.image_token_id)
        ids.pop()  # the trailing image token of the final split
        if add_eos:
            ids.append(self.eos_token_id)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out = bytearray()
        for i in ids:
            i = int(i)
            if i == self.image_token_id:
                out.extend(IMAGE_TOKEN.encode())
            elif self._OFFSET <= i < self._OFFSET + 256:
                out.append(i - self._OFFSET)
        return out.decode("utf-8", errors="replace")

    def __call__(self, texts, max_length: int = 128,
                 padding: str = "max_length", truncation: bool = True):
        if isinstance(texts, str):
            texts = [texts]
        rows, mask = [], []
        for t in texts:
            ids = self.encode(t)
            if truncation:
                ids = ids[:max_length]
                if len(ids) == max_length:
                    ids[-1] = self.eos_token_id
            am = [1] * len(ids)
            if padding == "max_length":
                pad = max_length - len(ids)
                ids = ids + [self.pad_token_id] * pad
                am = am + [0] * pad
            rows.append(ids)
            mask.append(am)
        return {"input_ids": np.asarray(rows, np.int32),
                "attention_mask": np.asarray(mask, np.int32)}

    def batch_decode(self, batch) -> List[str]:
        return [self.decode(row) for row in batch]


def get_tokenizer(name: str = "byte"):
    """'byte', or a local HF tokenizer directory (``tokenizer.json`` and
    ``tokenizer_config.json``, e.g. a LLaMA-2 or GPT-2 snapshot): the port
    reads no hub names."""
    if name == "byte":
        return ByteTokenizer()
    if not os.path.isfile(os.path.join(name, "tokenizer.json")):
        raise NotImplementedError(
            f"tokenizer {name!r}: not 'byte' and not a directory with a "
            f"tokenizer.json (hub names are not downloaded)")
    from unidisc_tpu_torch.tokenizers.hf_text import HFTokenizer
    tok = HFTokenizer.from_pretrained(name)    # it pads on the right
    if tok.pad_token is None:
        tok.pad_token = tok.eos_token
    if IMAGE_TOKEN not in tok.get_vocab():
        tok.add_special_tokens({"additional_special_tokens": [IMAGE_TOKEN]})
    return tok


def mask_after_eos(ids: np.ndarray, eos_id: int, pad_id: int) -> np.ndarray:
    """Replace everything after the first EOS with pad."""
    ids = np.asarray(ids)
    is_eos = ids == eos_id
    after = np.cumsum(is_eos, axis=-1) - is_eos.astype(int) > 0
    return np.where(after, pad_id, ids)


def wrapped_batch_decode(tokenizer, ids: np.ndarray, *,
                         cut_at_eos: bool = True) -> List[str]:
    ids = np.asarray(ids)
    if cut_at_eos:
        ids = mask_after_eos(ids, tokenizer.eos_token_id,
                             tokenizer.pad_token_id)
    return tokenizer.batch_decode(ids)
