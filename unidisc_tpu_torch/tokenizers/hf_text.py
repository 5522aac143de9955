"""HuggingFace fast tokenizers read from a local directory's
``tokenizer.json`` and ``tokenizer_config.json``, without
``transformers`` or ``tokenizers`` (the card's machine has neither).

``HFTokenizer.from_pretrained(path)`` gives what ``AutoTokenizer`` gives
for the two families UniDisc uses:

* the LLaMA form (``LlamaTokenizer[Fast]``): a BPE with ``byte_fallback``
  and ``fuse_unk``; normalizer ``Prepend("▁")`` + ``Replace(" ", "▁")``;
  decoder ``Replace("▁", " ")`` / ``ByteFallback`` / ``Fuse`` /
  ``Strip(" ", 1, 0)``; its post-processor rewritten from the config's
  ``add_bos_token`` / ``add_eos_token`` (the ``legacy`` flag changes
  nothing when the tokenizer comes from its ``tokenizer.json``);
* the GPT-2 form (``GPT2Tokenizer[Fast]``): a ``ByteLevel`` pre-tokenizer
  (GPT-2's split pattern and byte map from ``tokenizers/bpe.py``), a
  byte-level BPE, decoder and post-processor: no BOS.

Added tokens are cut out of the text before anything else, each piece
between them normalized, pre-tokenized and merged on its own. Merges
follow the ``tokenizers`` library's order: the lowest-ranked pair first,
the leftmost of equal pairs first, the pairs a merge creates taking part
at once. Special tokens the config names and the vocabulary lacks are
added at the next ids, as ``transformers`` adds them.

A model, normalizer, pre-tokenizer, post-processor, decoder or tokenizer
class this reader does not know raises ``NotImplementedError`` naming it;
nothing falls back to bytes.
"""

from __future__ import annotations

import heapq
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from unidisc_tpu_torch.tokenizers.bpe import _patterns, bytes_to_unicode

_BYTE_TOKEN = re.compile(r"<0x([0-9A-Fa-f]{2})>\Z")
# the tokenizer classes whose behaviour this reader reproduces, with the
# special tokens each class defaults to
_CLASSES = {
    "LlamaTokenizer": dict(unk_token="<unk>", bos_token="<s>",
                           eos_token="</s>"),
    "GPT2Tokenizer": dict(unk_token="<|endoftext|>",
                          bos_token="<|endoftext|>",
                          eos_token="<|endoftext|>"),
}
_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token",
                 "pad_token", "cls_token", "mask_token")


def _unknown(kind: str, name) -> NotImplementedError:
    return NotImplementedError(f"tokenizer.json: {kind} {name!r} is not "
                               f"supported by this reader")


def _content(token) -> Optional[str]:
    return token.get("content") if isinstance(token, dict) else token


class _BPE:
    """The ``tokenizers`` BPE model (no dropout, no subword affixes, no
    ignore_merges)."""

    def __init__(self, spec: dict):
        if spec.get("dropout") not in (None, 0.0):
            raise _unknown("BPE option dropout", spec["dropout"])
        for key in ("continuing_subword_prefix", "end_of_word_suffix",
                    "ignore_merges"):
            if spec.get(key):
                raise _unknown(f"BPE option {key}", spec[key])
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.unk = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk"))
        self.byte_fallback = bool(spec.get("byte_fallback"))
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, merge in enumerate(spec["merges"]):
            a, b = merge.split(" ") if isinstance(merge, str) else merge
            self.merges[(self.vocab[a], self.vocab[b])] = (
                rank, self.vocab[a + b])

    def tokenize(self, word: str) -> List[int]:
        ids: List[int] = []
        last_unk = False
        for ch in word:
            if ch in self.vocab:
                ids.append(self.vocab[ch])
                last_unk = False
                continue
            if self.byte_fallback:
                codes = [f"<0x{b:02X}>" for b in ch.encode("utf-8")]
                if all(c in self.vocab for c in codes):
                    ids.extend(self.vocab[c] for c in codes)
                    last_unk = False
                    continue
            if self.unk is not None:
                if not (self.fuse_unk and last_unk):
                    if self.unk not in self.vocab:
                        raise KeyError(f"the unknown token {self.unk!r} is "
                                       f"not in the vocabulary")
                    ids.append(self.vocab[self.unk])
                last_unk = True
        return self._merge(ids)

    def _merge(self, ids: List[int]) -> List[int]:
        """Word::merge_all of ``tokenizers``: a heap of (rank, position),
        stale entries skipped."""
        n = len(ids)
        sym = list(ids)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = self.merges.get((sym[i], sym[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            m = self.merges.get((sym[pos], sym[right]))
            if m is None or m[1] != new_id:
                continue
            sym[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prev[nxt[pos]] = pos
            if prev[pos] >= 0:
                m = self.merges.get((sym[prev[pos]], sym[pos]))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] < n:
                m = self.merges.get((sym[pos], sym[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [s for s, a in zip(sym, alive) if a]


def _normalizer(spec: Optional[dict]):
    """A str -> str function of a ``tokenizers`` normalizer."""
    if spec is None:
        return lambda s: s
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_normalizer(s) for s in spec["normalizers"]]

        def run(s):
            for step in steps:
                s = step(s)
            return s
        return run
    if kind == "Prepend":
        return lambda s: spec["prepend"] + s if s else s
    if kind == "Replace":
        pattern = spec["pattern"]
        if "String" not in pattern:
            raise _unknown("Replace pattern", pattern)
        return lambda s: s.replace(pattern["String"], spec["content"])
    raise _unknown("normalizer", kind)


def _pre_tokenizer(spec: Optional[dict], add_prefix_space=None):
    """A str -> [str] function of a ``tokenizers`` pre-tokenizer."""
    if spec is None:
        return lambda s: [s] if s else []
    kind = spec["type"]
    if kind != "ByteLevel":
        raise _unknown("pre_tokenizer", kind)
    if not spec.get("use_regex", True):
        raise _unknown("ByteLevel option use_regex", False)
    prefix = spec.get("add_prefix_space", False) \
        if add_prefix_space is None else add_prefix_space
    byte_map = bytes_to_unicode()
    split = _patterns()[0].findall

    def run(s):
        if prefix and not s.startswith(" "):
            s = " " + s
        return ["".join(byte_map[b] for b in piece.encode("utf-8"))
                for piece in split(s) if piece]
    return run


def _decoder(spec: Optional[dict]):
    """A [str] -> [str] function of a ``tokenizers`` decoder."""
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_decoder(s) for s in spec["decoders"]]

        def run(tokens):
            for step in steps:
                tokens = step(tokens)
            return tokens
        return run
    if kind == "Replace":
        pattern = spec["pattern"]
        if "String" not in pattern:
            raise _unknown("Replace pattern", pattern)
        return lambda toks: [t.replace(pattern["String"], spec["content"])
                             for t in toks]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda toks: ["".join(toks)]
    if kind == "Strip":
        return lambda toks: [_strip(t, spec["content"], spec["start"],
                                    spec["stop"]) for t in toks]
    if kind == "ByteLevel":
        return _byte_level_decode
    raise _unknown("decoder", kind)


def _byte_fallback(tokens: List[str]) -> List[str]:
    """Runs of ``<0xNN>`` tokens become their UTF-8 string, or one U+FFFD
    a token where the run is not valid UTF-8."""
    out, pending = [], bytearray()

    def flush():
        if pending:
            try:
                out.append(pending.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" for _ in pending)
            pending.clear()

    for tok in tokens:
        m = _BYTE_TOKEN.match(tok)
        if m:
            pending.append(int(m.group(1), 16))
        else:
            flush()
            out.append(tok)
    flush()
    return out


def _strip(token: str, content: str, start: int, stop: int) -> str:
    lo, hi = 0, len(token)
    while lo < min(start, len(token)) and token[lo] == content:
        lo += 1
    for _ in range(stop):
        if hi > lo and token[hi - 1] == content:
            hi -= 1
        else:
            break
    return token[lo:hi]


def _byte_level_decode(tokens: List[str]) -> List[str]:
    inverse = {c: b for b, c in bytes_to_unicode().items()}
    data = bytearray()
    for tok in tokens:
        if all(c in inverse for c in tok):
            data.extend(inverse[c] for c in tok)
        else:
            data.extend(tok.encode("utf-8"))
    return [data.decode("utf-8", errors="replace")]


def clean_up_tokenization(text: str) -> str:
    """transformers' clean-up of spaces before punctuation and
    contractions."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                 (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                 (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


class HFTokenizer:
    """A fast tokenizer of a local HF directory (module docstring):
    ``encode``, ``decode``, ``batch_decode``, ``__call__``, ``vocab_size``
    (without added tokens), ``len()`` (with them), the special tokens and
    their ids, right padding."""

    padding_side = "right"

    def __init__(self, spec: dict, config: dict):
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise _unknown(key, spec[key])
        cls = config.get("tokenizer_class")
        family = cls[:-4] if cls and cls.endswith("Fast") else cls
        if family not in _CLASSES:
            raise _unknown("tokenizer_class", cls)
        model = spec["model"]
        if model.get("type", "BPE") != "BPE":
            raise _unknown("model", model.get("type"))
        self.model = _BPE(model)
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(
            spec.get("pre_tokenizer"),
            None if family == "LlamaTokenizer"
            else bool(config.get("add_prefix_space", False)))
        self.decoder = _decoder(spec.get("decoder"))
        self.clean_up_tokenization_spaces = bool(
            config.get("clean_up_tokenization_spaces", False))
        self.model_max_length = int(min(config.get("model_max_length",
                                                   1e30), 1e30))
        # added tokens: content -> (id, special)
        self.added: Dict[str, Tuple[int, bool]] = {}
        for tok in spec.get("added_tokens", []):
            self._check_added(tok)
            self.added[tok["content"]] = (tok["id"], bool(tok["special"]))
        specials = dict(_CLASSES[family])
        for key in _SPECIAL_KEYS:
            if key in config:
                specials[key] = _content(config[key])
        for key, value in specials.items():
            setattr(self, key, value)
        # the configured special tokens the vocabulary lacks, in
        # transformers' order (the named ones, then the additional ones)
        for key in _SPECIAL_KEYS:
            if getattr(self, key) is not None:
                self._add(getattr(self, key), special=True)
        self.additional_special_tokens: List[str] = []
        self.add_special_tokens({"additional_special_tokens": [
            _content(t) for t in
            config.get("additional_special_tokens") or []]})
        post = spec.get("post_processor")
        if family == "LlamaTokenizer":
            # LlamaTokenizerFast.update_post_processor
            single = ["bos_token"] * bool(config.get("add_bos_token", True)) \
                + ["A"] + ["eos_token"] * bool(config.get("add_eos_token",
                                                          False))
            self.template = ["A" if t == "A" else self._special_id(t)
                             for t in single]
        elif post is None or post["type"] == "ByteLevel":
            self.template = ["A"]
        else:
            raise _unknown("post_processor", post["type"])
        self._inverse = {i: t for t, i in self.model.vocab.items()}

    def _special_id(self, key: str) -> int:
        token_id = self._id(getattr(self, key))
        if token_id is None:
            raise ValueError(f"the post-processor adds {key}, which the "
                             f"tokenizer does not have")
        return token_id

    @staticmethod
    def _check_added(tok: dict) -> None:
        for flag in ("single_word", "lstrip", "rstrip"):
            if tok.get(flag):
                raise _unknown(f"added token option {flag} of",
                               tok["content"])

    @classmethod
    def from_pretrained(cls, path: str) -> "HFTokenizer":
        with open(os.path.join(path, "tokenizer.json"),
                  encoding="utf-8") as f:
            spec = json.load(f)
        config = {}
        for name in ("special_tokens_map.json", "tokenizer_config.json"):
            p = os.path.join(path, name)
            if os.path.isfile(p):
                with open(p, encoding="utf-8") as f:
                    config.update(json.load(f))
        return cls(spec, config)

    # -------------------------------------------------------------- vocab
    def _add(self, content: str, special: bool) -> None:
        """Add a token as ``tokenizers``' AddedVocabulary does: the model's
        id where the model has it, else the next id."""
        if content in self.added:
            if special and not self.added[content][1]:
                self.added[content] = (self.added[content][0], True)
            return
        if content in self.model.vocab:
            new_id = self.model.vocab[content]
        else:
            base = len(self.model.vocab)
            top = max((i for i, _ in self.added.values()), default=None)
            new_id = base if top is None or top < base else top + 1
        self.added[content] = (new_id, special)

    def add_special_tokens(self, tokens: dict) -> int:
        """``{"additional_special_tokens": [...]}``: the tokens added, as
        specials, at the next ids; returns how many were new."""
        before = len(self)
        for tok in tokens["additional_special_tokens"]:
            if tok not in self.additional_special_tokens:
                self.additional_special_tokens.append(tok)
            self._add(tok, special=True)
        return len(self) - before

    def get_vocab(self) -> Dict[str, int]:
        vocab = dict(self.model.vocab)
        vocab.update({t: i for t, (i, _) in self.added.items()})
        return vocab

    @property
    def vocab_size(self) -> int:
        return len(self.model.vocab)

    def __len__(self) -> int:
        return len(self.get_vocab())

    def _id(self, token: Optional[str]) -> Optional[int]:
        if token is None:
            return None
        if token in self.added:
            return self.added[token][0]
        return self.model.vocab.get(token)

    def __getattr__(self, name):
        # a special token the config does not name is None; its id is
        # bos_token_id, eos_token_id, pad_token_id, ...
        if name in _SPECIAL_KEYS:
            return None
        if name.endswith("_id") and name[:-3] in _SPECIAL_KEYS:
            return self._id(getattr(self, name[:-3]))
        raise AttributeError(name)

    # ------------------------------------------------------------- encode
    def _split_added(self, text: str) -> List[Tuple[str, bool]]:
        """(piece, is_added) of `text`, added tokens matched leftmost,
        longest first."""
        if not self.added:
            return [(text, False)] if text else []
        pat = "|".join(re.escape(t) for t in
                       sorted(self.added, key=len, reverse=True))
        out, pos = [], 0
        for m in re.finditer(pat, text):
            if m.start() > pos:
                out.append((text[pos:m.start()], False))
            out.append((m.group(0), True))
            pos = m.end()
        if pos < len(text):
            out.append((text[pos:], False))
        return out

    def tokenize_ids(self, text: str) -> List[int]:
        """The ids of `text`, without the post-processor's."""
        ids: List[int] = []
        for piece, added in self._split_added(text):
            if added:
                ids.append(self.added[piece][0])
                continue
            for word in self.pre_tokenize(self.normalize(piece)):
                ids.extend(self.model.tokenize(word))
        return ids

    def _with_specials(self, ids: List[int]) -> List[int]:
        out: List[int] = []
        for piece in self.template:
            if piece == "A":
                out.extend(ids)
            else:
                out.append(piece)
        return out

    def _row(self, text: str, add_special_tokens: bool,
             max_length: Optional[int], truncation, padding=False
             ) -> List[int]:
        ids = self.tokenize_ids(text)
        if truncation is None:
            # transformers truncates at a max_length given alone
            truncation = max_length is not None and padding is False
        if truncation:
            limit = max_length if max_length is not None \
                else self.model_max_length
            extra = len(self.template) - 1 if add_special_tokens else 0
            ids = ids[:max(limit - extra, 0)]
        return self._with_specials(ids) if add_special_tokens else ids

    def encode(self, text: str, add_special_tokens: bool = True,
               max_length: Optional[int] = None,
               truncation=None) -> List[int]:
        return self._row(text, add_special_tokens, max_length, truncation)

    def __call__(self, texts, add_special_tokens: bool = True,
                 padding=False, truncation=None,
                 max_length: Optional[int] = None):
        """{"input_ids", "attention_mask"} as lists (one row for a
        string). padding: False / "do_not_pad", True / "longest",
        "max_length"; right padding with pad_token_id."""
        single = isinstance(texts, str)
        rows = [self._row(t, add_special_tokens, max_length, truncation,
                          padding) for t in ([texts] if single else texts)]
        if padding is True or padding == "longest":
            width = max(map(len, rows), default=0)
        elif padding == "max_length":
            width = max_length if max_length is not None \
                else self.model_max_length
        elif padding in (False, None, "do_not_pad"):
            width = None
        else:
            raise ValueError(f"padding {padding!r}")
        masks = [[1] * len(r) for r in rows]
        if width is not None:
            if self.pad_token_id is None:
                raise ValueError("padding needs a pad token")
            for r, m in zip(rows, masks):
                pad = max(width - len(r), 0)
                r.extend([self.pad_token_id] * pad)
                m.extend([0] * pad)
        if single:
            return {"input_ids": rows[0], "attention_mask": masks[0]}
        return {"input_ids": rows, "attention_mask": masks}

    # ------------------------------------------------------------- decode
    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False,
               clean_up_tokenization_spaces: Optional[bool] = None) -> str:
        if isinstance(ids, (int, np.integer)):
            ids = [ids]
        by_id = {i: (t, s) for t, (i, s) in self.added.items()}
        tokens = []
        for i in np.asarray(ids).reshape(-1).tolist():
            if i in by_id:
                if skip_special_tokens and by_id[i][1]:
                    continue
                tokens.append(by_id[i][0])
            elif i in self._inverse:
                tokens.append(self._inverse[i])
        text = "".join(self.decoder(tokens)) if self.decoder \
            else " ".join(tokens)
        if clean_up_tokenization_spaces is None:
            clean_up_tokenization_spaces = self.clean_up_tokenization_spaces
        return clean_up_tokenization(text) if clean_up_tokenization_spaces \
            else text

    def batch_decode(self, batch, skip_special_tokens: bool = False,
                     clean_up_tokenization_spaces: Optional[bool] = None
                     ) -> List[str]:
        return [self.decode(row, skip_special_tokens,
                            clean_up_tokenization_spaces) for row in batch]
