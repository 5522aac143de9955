"""Inference engine: requests -> conditioned sampling -> decoded results
(port of ``unidisc_tpu/serving/engine.py``).

A batch whose requests all give their text in full and generate their
image takes the span-factored text->image sampler (``sampling/t2i_fast.py``,
with ``sampling.cached_cond`` its conditioning-frozen variant); any other
batch (image->text, infilling, joint generation) takes the generic sampler
of ``sampling.predictor`` (``sampling/sampler.py``). bf16, or int8 W8A8 with
``build_engine(quantize="int8")``.

On the card every sampler runs as its captured CUDA-graph program
(``sampling/graph.py``), one per sampler and batch size, the counterpart
of the JAX engine's ``jax.jit``; ddpm_cache, whose skip reads a device flag
each step, runs eager. On the CPU the samplers run eager. Checkpoints, the
image codec, meshes, rolling and continuous batching and scaffold decoding
are later slices (ROADMAP queue 1, items 3 and 10).
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.device import resolve_device
from unidisc_tpu_torch.sampling.graph import captured

MASK_TOKEN_RE = re.compile(r"<mask(?::(\d+))?>")


def expand_mask_tokens(text: str) -> str:
    """`<mask:5>` -> five `<mask>` markers."""
    return MASK_TOKEN_RE.sub(
        lambda m: "<mask>" * int(m.group(1) or 1), text)


# the JAX engine's options that later slices port, with their ROADMAP
# queue 1 items
_LATER_OPTIONS = {"codec": 3, "mesh": 9, "rolling": 10, "ar_draft": 10,
                  "lookup_ngram": 10}


class InferenceEngine:
    def __init__(self, config: Config, model, *, tokenizer=None,
                 device="cuda", **later):
        for name, value in later.items():
            if name not in _LATER_OPTIONS:
                raise TypeError(f"InferenceEngine got an unexpected "
                                f"argument {name!r}")
            if value:
                raise NotImplementedError(
                    f"InferenceEngine({name}=...) is not in the port yet "
                    f"(ROADMAP queue 1, item {_LATER_OPTIONS[name]})")
        self.device = resolve_device(device)
        self.config = config
        self.m = config.model
        self.model = model.to(self.device).eval()
        if tokenizer is None:
            from unidisc_tpu_torch.tokenizers.text import get_tokenizer
            tokenizer = get_tokenizer("byte")
        self.tokenizer = tokenizer
        self._samplers: Dict[tuple, object] = {}
        # serializes device work and the sampler cache across threads
        self._device_lock = threading.Lock()

    def enable_scaffold(self, *args, **kwargs):
        raise NotImplementedError("scaffold decoding is not in the port yet "
                                  "(ROADMAP queue 1, item 4)")

    @property
    def continuous(self):
        raise NotImplementedError("continuous batching is not in the port "
                                  "yet (ROADMAP queue 1, item 10)")

    def _program(self, sampler, batch: int):
        """`sampler` as the engine runs it, run(*inputs, seed): on the card
        its captured program at `batch` rows (ddpm_cache runs eager), on
        the CPU the eager sampler with a generator seeded per call."""
        if self.device.type == "cuda" and sampler.capturable:
            return captured(sampler, batch)

        def run(*inputs, seed: int):
            gen = torch.Generator(device=self.device).manual_seed(seed)
            return sampler(*inputs, generator=gen)
        return run

    def _t2i_sampler(self, steps: Optional[int] = None, batch: int = 1):
        """The span-factored text->image sampler at `batch` rows."""
        key = ("t2i", steps or self.config.sampling.steps)
        if key not in self._samplers:
            from unidisc_tpu_torch.sampling.t2i_fast import build_t2i_sampler
            s = self.config.sampling
            self._samplers[key] = build_t2i_sampler(
                self.model, self.config, num_steps=key[1],
                cached_cond=s.cached_cond,
                cond_refresh=s.cached_cond_refresh, device=self.device)
        return self._program(self._samplers[key], batch)

    def _sampler(self, steps: Optional[int] = None, batch: int = 1):
        """The generic sampler of sampling.predictor at `batch` rows."""
        key = ("generic", steps or self.config.sampling.steps)
        if key not in self._samplers:
            from unidisc_tpu_torch.sampling.sampler import build_sampler
            self._samplers[key] = build_sampler(
                self.model, self.config, num_steps=key[1],
                device=self.device)
        return self._program(self._samplers[key], batch)

    def _layout(self, batch: int) -> np.ndarray:
        """The [text | image] modality rows (0 text, 1 image)."""
        m = self.m
        return np.concatenate([
            np.zeros((batch, m.txt_length), np.int32),
            np.ones((batch, m.img_length), np.int32)], axis=-1)

    def prepare(self, *, text: Optional[str] = None,
                image_ids: Optional[np.ndarray] = None,
                image_mask: Optional[np.ndarray] = None,
                task: str = "auto") -> dict:
        """Build one request's conditioning row.

        Returns {"task", "x0" (L,), "unmask" (L,), "fastpath" (bool)};
        fastpath means the span-factored t2i sampler applies (text fully
        conditioned, whole image generated)."""
        m = self.m
        if task == "auto":
            if text is not None and image_ids is None:
                task = "gen_image"
            elif image_ids is not None and text is None:
                task = "gen_text"
            elif text is None and image_ids is None:
                task = "joint"
            else:
                task = "infill"

        x0 = np.zeros(m.length, np.int32)
        unmask = np.zeros(m.length, bool)

        if text is not None:
            text = expand_mask_tokens(text)
            parts = text.split("<mask>")
            ids: List[int] = []
            known: List[bool] = []
            for i, part in enumerate(parts):
                enc = self.tokenizer.encode(part, add_bos=(i == 0),
                                            add_eos=False)
                ids.extend(enc)
                known.extend([True] * len(enc))
                if i < len(parts) - 1:
                    ids.append(0)
                    known.append(False)  # masked slot
            ids = ids[:m.txt_length]
            known = known[:m.txt_length]
            x0[:len(ids)] = np.asarray(ids)
            if task in ("gen_image", "infill"):
                unmask[:len(known)] = np.asarray(known)
            if task == "gen_image" and "<mask>" not in text:
                # the prompt is the whole text conditioning: pad the rest
                # of the text span and mark it known
                pad = getattr(self.tokenizer, "pad_token_id", 0)
                x0[len(ids):m.txt_length] = pad
                unmask[:m.txt_length] = True

        if image_ids is not None:
            image_ids = np.asarray(image_ids).reshape(-1)[:m.img_length]
            x0[m.txt_length:m.txt_length + len(image_ids)] = \
                image_ids + (0 if image_ids.max(initial=0) >=
                             m.text_vocab_size else m.text_vocab_size)
            img_known = np.ones(len(image_ids), bool)
            if image_mask is not None:
                img_known &= ~np.asarray(image_mask).reshape(-1)[
                    :len(image_ids)]
            if task in ("gen_text", "infill"):
                unmask[m.txt_length:m.txt_length + len(image_ids)] = \
                    img_known

        fastpath = (task == "gen_image" and
                    bool(unmask[:m.txt_length].all()) and
                    not unmask[m.txt_length:].any() and
                    self.config.sampling.predictor.startswith("maskgit"))
        return {"task": task, "x0": x0, "unmask": unmask,
                "fastpath": fastpath}

    def run_batch(self, prepared: List[dict], *, steps: Optional[int] = None,
                  seed: int = 0, pad_to: Optional[int] = None) -> List[dict]:
        """Run N prepared requests as one device batch. pad_to rounds the
        batch up with duplicate rows."""
        with self._device_lock:
            return self._run_batch_locked(prepared, steps=steps, seed=seed,
                                          pad_to=pad_to)

    def _run_batch_locked(self, prepared, *, steps, seed, pad_to):
        m = self.m
        n = len(prepared)
        if n == 0:
            raise ValueError("run_batch needs at least one request")
        x0 = np.stack([p["x0"] for p in prepared])
        unmask = np.stack([p["unmask"] for p in prepared])
        if pad_to and pad_to > n:
            reps = pad_to - n
            x0 = np.concatenate([x0, np.repeat(x0[-1:], reps, 0)])
            unmask = np.concatenate([unmask, np.repeat(unmask[-1:], reps,
                                                       0)])
        b = x0.shape[0]
        if all(p["fastpath"] for p in prepared):
            sample = self._t2i_sampler(steps, b)
            out = sample(torch.from_numpy(x0[:, :m.txt_length]), seed=seed)
        else:
            sample = self._sampler(steps, b)
            out = sample(x0, unmask, self._layout(b), seed=seed)
        tokens = out.tokens[:n].cpu().numpy()
        return self._decode_rows(prepared, tokens, out.nfe)

    def _decode_rows(self, prepared, tokens, nfe):
        """Token rows -> per-request result dicts (image token ids; pixel
        decoding needs the VQGAN codec, not in the port yet)."""
        m = self.m
        txt_ids = tokens[:, :m.txt_length]
        img_ids = tokens[:, m.txt_length:] - m.text_vocab_size
        from unidisc_tpu_torch.tokenizers.text import wrapped_batch_decode
        texts = wrapped_batch_decode(self.tokenizer, txt_ids)
        return [{"task": p["task"], "text": texts[i], "texts": [texts[i]],
                 "image_ids": img_ids[i:i + 1], "nfe": int(nfe)}
                for i, p in enumerate(prepared)]

    def run(self, *, text: Optional[str] = None,
            image_ids: Optional[np.ndarray] = None,
            image_mask: Optional[np.ndarray] = None,
            task: str = "auto", steps: Optional[int] = None,
            seed: int = 0, batch: int = 1) -> dict:
        """One request; batch > 1 replicates it."""
        p = self.prepare(text=text, image_ids=image_ids,
                         image_mask=image_mask, task=task)
        results = self.run_batch([p] * batch, steps=steps, seed=seed)
        first = dict(results[0])
        first["texts"] = [r["text"] for r in results]
        first["image_ids"] = np.concatenate(
            [r["image_ids"] for r in results], 0)
        return first


def build_engine(*, preset: str = "small", device="cuda",
                 experiments=None, overrides: Optional[dict] = None,
                 steps: Optional[int] = None,
                 quantize: Optional[str] = None) -> InferenceEngine:
    """An engine for a config preset with weights drawn from the config's
    seed (the JAX init's distributions). `overrides` are dotted config
    overrides applied with the preset; `experiments` are overlays applied
    after them, as in the JAX engine. The model computes in bf16;
    ``quantize="int8"`` converts it to int8 W8A8 after the weights are
    drawn (``ops/quant.py::quantize_model``)."""
    from unidisc_tpu_torch.models.dit import DIT
    dev = resolve_device(device)
    over = dict(overrides or {})
    if steps:
        over["sampling.steps"] = steps
    config = Config.make(preset, **over)
    if experiments:
        config = config.apply_experiments(*experiments)
    config.validate()
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize {quantize!r}")
    model = DIT(config.model, compute_dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(config.seed))
    if quantize:
        from unidisc_tpu_torch.ops.quant import quantize_model
        config, model = quantize_model(config, model)
    return InferenceEngine(config, model, device=dev)
