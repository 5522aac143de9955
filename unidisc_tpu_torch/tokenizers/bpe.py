"""Byte-level BPE of a HuggingFace tokenizer directory, without
``transformers`` or ``tokenizers`` (the card's machine has neither).

One class reads both families the evaluation judges use:

* CLIP (``CLIPTokenizer``: ``vocab.json`` + ``merges.txt`` whose word-final
  pieces end in ``</w>``): whitespace collapsed and lower-cased, split by
  CLIP's pattern (contractions, letter runs, single digits, other runs),
  each piece through GPT-2's pattern and the byte-to-unicode map, merged,
  then ``<|startoftext|> ... <|endoftext|>`` around the ids;
* GPT-2 (``GPT2Tokenizer``): split by GPT-2's pattern, mapped and merged,
  no ids added.

The patterns use Unicode letter and number classes (``\\p{L}``,
``\\p{N}``), which Python's ``re`` lacks: the classes are built once from
``unicodedata``. ``\\s`` is Python's (``str.isspace``), which differs from
the Unicode White_Space property only on U+001C..U+001F.

A piece not in the vocabulary after merging becomes the unknown token
(``<|endoftext|>`` for CLIP); every published CLIP and GPT-2 vocabulary
holds all 256 byte symbols, so this happens only on partial vocabularies.
"""

from __future__ import annotations

import functools
import json
import os
import re
import sys
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible map of the 256 bytes onto printable characters."""
    bs = list(range(ord("!"), ord("~") + 1)) + \
        list(range(ord("¡"), ord("¬") + 1)) + \
        list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.lru_cache(maxsize=None)
def _category_class(prefix: str) -> str:
    """A regex character class body of every code point whose Unicode
    category starts with `prefix` ("L" letters, "N" numbers)."""
    ranges, start, prev = [], None, None
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp)).startswith(prefix):
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            ranges.append((start, prev))
            start = None
    if start is not None:
        ranges.append((start, prev))
    esc = lambda cp: f"\\U{cp:08x}"     # noqa: E731
    return "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}"
                   for a, b in ranges)


@functools.lru_cache(maxsize=None)
def _patterns() -> Tuple[re.Pattern, re.Pattern]:
    letters, numbers = _category_class("L"), _category_class("N")
    gpt2 = re.compile(
        rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{letters}]+| ?[{numbers}]+"
        rf"| ?[^\s{letters}{numbers}]+|\s+(?!\S)|\s+")
    clip = re.compile(
        rf"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        rf"|[{letters}]+|[{numbers}]|[^\s{letters}{numbers}]+",
        re.IGNORECASE)
    return gpt2, clip


class BPETokenizer:
    """The byte-level BPE of one tokenizer directory (module docstring).

    ``tok(texts, padding=..., truncation=..., max_length=...)`` returns
    {"input_ids", "attention_mask"} as int64 numpy arrays, as a HF
    tokenizer's call with ``return_tensors="np"`` does; ``encode(text)``
    one row's ids."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]], *, clip: bool,
                 special: Dict[str, str],
                 model_max_length: Optional[int] = None):
        self.encoder = dict(vocab)
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.clip = clip
        self.byte_map = bytes_to_unicode()
        self.unk_token = special.get("unk_token", "<|endoftext|>")
        self.bos_token = special.get("bos_token", "<|startoftext|>")
        self.eos_token = special.get("eos_token", "<|endoftext|>")
        self.pad_token = special.get("pad_token") or self.eos_token
        self.model_max_length = model_max_length
        self.specials = sorted({t for t in (self.bos_token, self.eos_token,
                                            self.pad_token, self.unk_token)
                                if t in self.encoder}, key=len,
                               reverse=True)
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_pretrained(cls, path: str) -> "BPETokenizer":
        """A HF tokenizer directory: ``vocab.json``, ``merges.txt`` and,
        when present, ``tokenizer_config.json`` / ``special_tokens_map.json``
        (the tokenizer class, its special tokens, model_max_length)."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        conf = {}
        for name in ("special_tokens_map.json", "tokenizer_config.json"):
            p = os.path.join(path, name)
            if os.path.isfile(p):
                with open(p, encoding="utf-8") as f:
                    conf.update(json.load(f))
        special = {}
        for key in ("bos_token", "eos_token", "pad_token", "unk_token"):
            value = conf.get(key)
            if isinstance(value, dict):
                value = value.get("content")
            if value is not None:
                special[key] = value
        cls_name = conf.get("tokenizer_class", "")
        clip = cls_name.startswith("CLIP") if cls_name else any(
            k.endswith("</w>") for k in vocab)
        max_len = conf.get("model_max_length")
        if max_len is not None and max_len > 1e9:   # HF's "no limit"
            max_len = None
        return cls(vocab, merges, clip=clip, special=special,
                   model_max_length=max_len)

    # ------------------------------------------------------------------
    @property
    def pad_token_id(self) -> int:
        return self.encoder[self.pad_token]

    @property
    def eos_token_id(self) -> int:
        return self.encoder[self.eos_token]

    def _bpe(self, piece: str) -> List[str]:
        """The merged symbols of one mapped piece."""
        if piece in self._cache:
            return self._cache[piece]
        word = list(piece)
        if self.clip:
            word[-1] = word[-1] + "</w>"
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[piece] = word
        return word

    def _split_specials(self, text: str) -> List[Tuple[str, bool]]:
        """(span, is_special) pieces of `text`, special tokens taken out
        whole before any other splitting."""
        if not self.specials:
            return [(text, False)]
        pat = "|".join(re.escape(s) for s in self.specials)
        out, pos = [], 0
        for m in re.finditer(pat, text):
            if m.start() > pos:
                out.append((text[pos:m.start()], False))
            out.append((m.group(0), True))
            pos = m.end()
        if pos < len(text):
            out.append((text[pos:], False))
        return out

    def _pieces(self, text: str) -> List[str]:
        gpt2, clip = _patterns()
        if not self.clip:
            return gpt2.findall(text)
        text = " ".join(unicodedata.normalize("NFC", text).split()).lower()
        return [p for q in clip.findall(text) for p in gpt2.findall(q)]

    def tokenize(self, text: str) -> List[int]:
        """The ids of `text`, without the CLIP start and end ids."""
        unk = self.encoder.get(self.unk_token)
        ids = []
        for span, special in self._split_specials(text):
            if special:
                ids.append(self.encoder[span])
                continue
            for piece in self._pieces(span):
                mapped = "".join(self.byte_map[b]
                                 for b in piece.encode("utf-8"))
                for sym in self._bpe(mapped):
                    tid = self.encoder.get(sym, unk)
                    if tid is None:
                        raise KeyError(f"{sym!r} is not in the vocabulary "
                                       f"and it has no unknown token")
                    ids.append(tid)
        return ids

    def encode(self, text: str, max_length: Optional[int] = None,
               truncation: bool = False) -> List[int]:
        """One row: CLIP's ids between its start and end ids; truncated to
        max_length (or model_max_length) keeping those two."""
        ids = self.tokenize(text)
        limit = max_length or self.model_max_length
        added = 2 if self.clip else 0
        if truncation and limit is not None:
            ids = ids[:max(limit - added, 0)]
        if self.clip:
            ids = [self.encoder[self.bos_token]] + ids + \
                [self.encoder[self.eos_token]]
        return ids

    def __call__(self, texts, *, padding="longest", truncation=False,
                 max_length: Optional[int] = None) -> dict:
        """padding: "longest" (True) or "max_length" (False: no padding,
        which needs rows of one length)."""
        if isinstance(texts, str):
            texts = [texts]
        rows = [self.encode(t, max_length, truncation) for t in texts]
        if padding == "max_length":
            width = max_length or self.model_max_length
        else:
            width = max(map(len, rows))
        if not padding and len({len(r) for r in rows}) > 1:
            raise ValueError("rows of different lengths need padding")
        ids = np.full((len(rows), width), self.pad_token_id, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r[:width]
            mask[i, :len(r)] = 1
        return {"input_ids": ids, "attention_mask": mask}
