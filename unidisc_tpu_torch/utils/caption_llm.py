"""Caption augmentation for auto-enhance: negative / variant captions
(port of ``unidisc_tpu/utils/caption_llm.py``; numpy only, the same
random streams, so the same captions).

The reference asks an external LLM chain (unidisc/utils/simple_llm.py)
for 12 "incorrect" captions per prompt, half plausible edits and half
broken; the default backend here is a deterministic procedural augmenter
of that specification, with a native AR-model rewriter and a gated
external-API hook, behind the reference's ``get_llm(...) -> fn(prompt) ->
(captions, model_name)`` contract.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

# Small, deliberately mundane word pools (the reference prompt asks for
# "very simple, not exotic" substitutions, simple_llm.py:57).
_COLORS = ["red", "blue", "green", "yellow", "purple", "orange", "black",
           "white", "pink", "brown"]
_OBJECTS = ["dog", "cat", "car", "house", "tree", "boat", "bird", "chair",
            "flower", "mountain", "river", "bicycle", "train", "book"]
_STYLES = ["watercolor painting", "pencil sketch", "photograph",
           "oil painting", "cartoon drawing", "charcoal drawing"]
_TIMES = ["morning", "night", "sunset", "winter", "summer", "rain"]
_PLACES = ["beach", "forest", "city", "desert", "kitchen", "field"]
_NUMBERS = {"one": "two", "two": "three", "three": "four", "a": "two",
            "an": "three", "four": "five", "five": "two"}


def _words(caption: str) -> List[str]:
    return caption.strip().split()


def _swap_from_pool(words: List[str], pool: Sequence[str],
                    rng: np.random.Generator) -> List[str]:
    """Replace a word found in `pool` with a different pool member, or
    inject a pool member before a random word if none is present."""
    words = list(words)
    lowered = [re.sub(r"\W", "", w).lower() for w in words]
    hits = [i for i, w in enumerate(lowered) if w in pool]
    pick = lambda exclude: rng.choice([p for p in pool if p != exclude])
    if hits:
        i = int(rng.choice(hits))
        words[i] = str(pick(lowered[i]))
    elif words:
        i = int(rng.integers(0, len(words)))
        words.insert(i, str(pick(None)))
    return words


# --- plausible-edit operations (reference prompt: "add or remove an object,
# change the desired styling, ... subject, time period, time of day,
# location, culture, camera angle") -------------------------------------

def _edit_color(c, rng):
    return " ".join(_swap_from_pool(_words(c), _COLORS, rng))

def _edit_object(c, rng):
    return " ".join(_swap_from_pool(_words(c), _OBJECTS, rng))

def _edit_count(c, rng):
    words = _words(c)
    for i, w in enumerate(words):
        key = re.sub(r"\W", "", w).lower()
        if key in _NUMBERS:
            words[i] = _NUMBERS[key]
            return " ".join(words)
    return "two " + " ".join(words)

def _edit_style(c, rng):
    return f"{c.rstrip('. ')} as a {rng.choice(_STYLES)}"

def _edit_time(c, rng):
    return " ".join(_swap_from_pool(_words(c), _TIMES, rng)) \
        if any(t in c.lower() for t in _TIMES) \
        else f"{c.rstrip('. ')} at {rng.choice(_TIMES)}"

def _edit_place(c, rng):
    return f"{c.rstrip('. ')} in a {rng.choice(_PLACES)}"


# --- broken operations (reference prompt: "make them broken, have improper
# grammar or just be nonsensical") ---------------------------------------

def _break_shuffle(c, rng):
    w = _words(c)
    rng.shuffle(w)
    return " ".join(w)

def _break_drop(c, rng):
    w = _words(c)
    keep = rng.random(len(w)) > 0.5
    keep[0] = True
    return " ".join(x for x, k in zip(w, keep) if k)

def _break_stutter(c, rng):
    w = _words(c)
    i = int(rng.integers(0, len(w))) if w else 0
    return " ".join(w[:i] + [w[i]] * 3 + w[i + 1:]) if w else c

def _break_reverse(c, rng):
    return " ".join(reversed(_words(c)))

def _break_garble(c, rng):
    w = ["a a" if x.lower() in ("the", "a", "an") else x for x in _words(c)]
    return " ".join(w) + " of of"

def _break_truncate(c, rng):
    return c[:max(3, len(c) * 2 // 3)]


_PLAUSIBLE = [_edit_color, _edit_object, _edit_count, _edit_style,
              _edit_time, _edit_place]
_BROKEN = [_break_shuffle, _break_drop, _break_stutter, _break_reverse,
           _break_garble, _break_truncate]


def procedural_negatives(caption: str, n: int = 12,
                         seed: int = 0) -> List[str]:
    """n incorrect captions: half plausible edits, half broken (the
    reference prompt's 50/50 split, simple_llm.py:57)."""
    rng = np.random.default_rng([seed, len(caption), sum(map(ord, caption))])
    out: List[str] = []
    ops = (_PLAUSIBLE * ((n + 11) // 12))[:(n + 1) // 2] + \
          (_BROKEN * ((n + 11) // 12))[:n - (n + 1) // 2]
    for op in ops:
        cand = op(caption, rng)
        if cand.strip() and cand != caption:
            out.append(cand.strip())
    # Ensure exactly n distinct outputs (pad with seeded re-rolls).
    tries = 0
    while len(set(out)) < n and tries < 8 * n:
        op = (_PLAUSIBLE + _BROKEN)[int(rng.integers(0, 12))]
        cand = op(caption, rng).strip()
        if cand and cand != caption:
            out.append(cand)
        tries += 1
    return list(dict.fromkeys(out))[:n]


def ar_model_negatives(sample_text_fn: Callable, tokenizer,
                       caption: str, n: int = 12, *,
                       prefix: str = "Rewrite the caption incorrectly: "
                       ) -> List[str]:
    """Generate caption variants with the native AR baseline on-device.

    ``sample_text_fn(prompt_ids (B, Lp), n) -> ids (n, L)`` — typically a
    closure over sampling/ar_sampler.decode with the ELM params. The decoded
    continuations are the variants; empty/degenerate rows fall back to the
    procedural augmenter so the contract (n captions) always holds.
    """
    ids = np.asarray(
        tokenizer.encode(prefix + caption, add_bos=True, add_eos=False),
        np.int32)[None]
    gen = np.asarray(sample_text_fn(ids, n))
    out = []
    for row in gen:
        text = tokenizer.decode([int(t) for t in row]).strip()
        if text and text != caption:
            out.append(text)
    if len(out) < n:
        out += procedural_negatives(caption, n - len(out), seed=1)
    return out[:n]


def get_caption_augmenter(kind: str = "procedural", *, sample_text_fn=None,
                          tokenizer=None, n: int = 12, seed: int = 0
                          ) -> Callable[[str], Tuple[List[str], str]]:
    """Factory matching reference get_llm: fn(prompt) -> (captions, name).

    kinds: 'procedural' (default, deterministic, zero-egress), 'ar'
    (on-device AR rewriter), 'api' (external endpoint — gated off here the
    same way torch-only codecs are; the reference's langchain chains,
    simple_llm.py:13-45, need network egress).
    """
    if kind == "procedural":
        return lambda c: (procedural_negatives(c, n, seed), "procedural")
    if kind == "ar":
        if sample_text_fn is None or tokenizer is None:
            raise ValueError("kind='ar' needs sample_text_fn and tokenizer")
        return lambda c: (
            ar_model_negatives(sample_text_fn, tokenizer, c, n), "ar-elm")
    if kind == "api":
        raise NotImplementedError(
            "external caption LLMs (Groq/OpenAI via langchain, reference "
            "simple_llm.py:13-45) need network egress; use "
            "kind='procedural' or kind='ar', or run the reference chain on "
            "a networked host and pass captions in")
    raise ValueError(f"unknown augmenter kind {kind!r}")


def augment_batch(augmenter: Callable, captions: Sequence[str],
                  max_per_caption: int = 10,
                  shuffle_seed: Optional[int] = None) -> List[List[str]]:
    """Per-caption augmentation lists, shuffled and clipped like the
    reference battery (model_eval.py:3763-3770)."""
    out = []
    for i, cap in enumerate(captions):
        caps, _ = augmenter(cap)
        if shuffle_seed is not None:
            rng = np.random.default_rng([shuffle_seed, i])
            caps = list(caps)
            rng.shuffle(caps)
        out.append(caps[:max_per_caption])
    return out
