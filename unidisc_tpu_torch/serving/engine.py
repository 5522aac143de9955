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
each step, runs eager. On the CPU the samplers run eager.

With an image codec (``tokenizers/image_codecs.py``) every request but
gen_text also returns its image as a base64 PNG: the codec decodes the
sampler's tokens on the device, and only the uint8 images come to the
host. ``build_engine`` serves random weights from the config's seed, a run
dir that the port's Trainer wrote (``checkpoint=``, its EMA weights) or a
published reference checkpoint (``reference_ckpt=``).

``rolling=N`` serves every request through the rolling batchers
(``serving/rolling.py``: per-row denoise steps, admission into slots that
finish mid-flight, one captured chunk program each on the card);
``enable_scaffold`` / ``build_engine(scaffold=)`` runs the first denoise
steps on this model and the rest on a smaller trunk
(``sampling/scaffold.py``), bypassing rolling and the t2i fast path as in
JAX.

AR models (``trainer.parameterization=ar``, a causal DIT) answer text
completions (``complete_text``) through the continuous batcher
(``serving/continuous.py``, ``engine.continuous``: per-row KV, prefix
caching, one captured decode chunk on the card), with a draft DIT
(``ar_draft``) or prompt lookup (``lookup_ngram``) for speculative rounds.
``build_engine(preset="elm[:270m|450m|1.1b|tiny]")`` serves the OpenELM
baseline (``models/elm.py``) the same way through ``ElmEngine``, in bf16
or int8 W8A8 (``quantize="int8"``), with the int8 KV cache
(``kv_cache="int8"``) and ``speculative="<draft preset>"`` or
``"lookup[:N]"``. ``lora=`` merges a saved adapter
(``training/lora.py``, either package's ``lora_adapter.npz``) into the
weights before any quantization; a LoRA run dir is served as its base plus
its EMA adapter, a host-offload run dir as the EMA gathered from its
chunks.

``run_interleaved`` generates over one interleaved document (given and
generated text spans, given images with optional regions to regenerate,
generated images), laid out as one packed row with its sample ids and
rope indices, through the generic sampler's packed form
(``sampling/sampler.py::PackedSampler``; on the card its captured
program). Under ``model.img_resolutions`` an image's rope indices carry
its block's offset in the combined table.

On a device mesh (``build_engine(mesh="fsdp=2,seq=2")``, one process per
device) every rank makes the same calls: a batch rounds up to the mesh
granule (the data-parallel width, times ``pp_microbatches`` under "pp"),
each data-parallel rank samples its rows, a "seq" group samples
replicated with the ring in the DIT, and "pp" / "tensor" / "ep" ranks hold
only their stage's blocks, their head shards and their experts
(``parallel/mesh.py::shard_model``) and run them as the DIT does on a mesh
(``parallel/sample.py``). A rank keeps its part of the weights whole: no
FSDP. Steps that hold collectives run eager (``capturable`` False): a CUDA
graph cannot hold a gloo collective, and NCCL capture of a mesh sampler is
ROADMAP queue 1, item 9. The server's other ranks replay the leader's
calls (``lead`` / ``follow``). An int8 engine (``quantize="int8"``) runs
on every axis: its model is quantized whole and then laid out, each rank
keeping its part of ``weight_q`` and ``scale`` (``parallel/mesh.py``), and
a tensor rank's int8 products equal the one-rank products bit for bit
(``models/dit.py::DDiTBlock``).

Rolling admission (``rolling=N``) and AR decoding (the continuous
batcher, with ``ar_draft`` or ``lookup_ngram``) run on a mesh led by rank
0 (``lead``; the other ranks ``follow``). Their slots are the global
batch split over the data-parallel ranks: rank r owns slots [r S / dp,
(r + 1) S / dp), S (N, or the continuous batcher's 8) rounded up to the
mesh granule as a batch is (``parallel/sample.py::SlotSplit``). A
request's tokens are the one-rank engine's at the same seeds: the keyed
noise depends on the row's seed and step or position, not on its slot or
rank. As in JAX, whose engine jits these programs outside
``spmd_sampler``, a "seq" group runs the rolling and decode chunks
replicated, without the ring: on dcn / fsdp / seq meshes a chunk holds no
collective and stays one captured program a rank. Rolling on "pp" runs a
chunk's forward as the pipeline (the slots a multiple of the
microbatches), on "tensor" and "ep" each rank's parts, eager. The
leader's batcher workers announce each device op (``_batcher_op``: the
batcher's ``op_*`` by name, with global slot ids and host arrays) under
the device lock before running it; a follower builds the same batchers at
their first op, without a worker, and replays the op on its slots. The
harvest and the drain are gathers over rank 0's data-parallel group.
AR decoding on "tensor", "pp" or "ep", and an MoE AR model on a
data-parallel mesh, raise ``NotImplementedError`` (item 9).
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import json
import math
import numbers
import re
import threading
import types
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.device import resolve_device
from unidisc_tpu_torch.sampling.graph import captured
from unidisc_tpu_torch.utils.png import decode_png, encode_png

MASK_TOKEN_RE = re.compile(r"<mask(?::(\d+))?>")


def expand_mask_tokens(text: str) -> str:
    """`<mask:5>` -> five `<mask>` markers."""
    return MASK_TOKEN_RE.sub(
        lambda m: "<mask>" * int(m.group(1) or 1), text)



class _TextCompletion:
    """The AR text route that InferenceEngine and ElmEngine share: the
    prompt through the tokenizer into the continuous batcher, built at
    first use under a lock of its own (its capture takes the device
    lock).

    On a mesh (InferenceEngine's ``mesh``) the route runs led from rank 0
    (``lead`` / ``follow``)."""

    mesh = None          # the rank's MeshLayout on a mesh
    _leading = False     # this rank leads the mesh (``lead``)

    def _check_led(self, what: str) -> None:
        """On a mesh, `what` runs led from rank 0: its batcher's worker ops
        would otherwise meet no peer."""
        if self.mesh is not None and not self._leading:
            raise RuntimeError(f"{what} on a mesh is led from rank 0: call "
                               f"lead() there and follow() on the other "
                               f"ranks")

    def _continuous_batcher(self):
        raise NotImplementedError

    @property
    def continuous(self):
        """The continuous AR batcher (``serving/continuous.py``): requests
        join and leave one persistent device batch; it shares the engine's
        device lock."""
        with self._continuous_lock:
            if self._continuous is None:
                self._continuous = self._continuous_batcher()
        return self._continuous

    def shutdown(self) -> None:
        """Stop the continuous batcher's worker (its outstanding futures
        fail)."""
        if self._continuous is not None:
            self._continuous.shutdown()

    def _eos(self) -> int:
        eos = getattr(self.tokenizer, "eos_token_id", None)
        return eos if eos is not None else -1

    def complete_text(self, text: str, *, max_new_tokens: int = 64,
                      temperature: float = 0.0, seed: Optional[int] = None,
                      stream_cb=None) -> Future:
        """A text completion through the continuous batcher: a Future of
        {"text", "tokens", "prompt_len"}; stream_cb(new ids) as tokens
        come to the host."""
        self._check_led("AR decoding")
        prompt = self.tokenizer.encode(text or "", add_bos=True,
                                       add_eos=False)[:self.m.length - 2]
        # an id past the embedding table is a device-side assert on the
        # card: refuse it here
        if max(prompt, default=0) >= self.vocab_size:
            raise ValueError(f"the tokenizer's ids reach {max(prompt)}; the "
                             f"model has {self.vocab_size}")
        fut = self.continuous.submit(
            prompt, max_new_tokens=max_new_tokens, temperature=temperature,
            seed=seed, stream_cb=stream_cb)
        out: Future = Future()

        def done(f):
            try:
                res = f.result()
                res["text"] = self.tokenizer.decode(res["tokens"])
                out.set_result(res)
            except Exception as e:  # noqa: BLE001 — hand it to the caller
                out.set_exception(e)
        fut.add_done_callback(done)
        return out


def check_call(steps, seed) -> None:
    """A request's steps (None, or 0 for the config's) and seed, checked
    before a leader sends the call to its followers."""
    if steps is not None and (not isinstance(steps, numbers.Integral)
                              or steps < 0):
        raise ValueError(f"steps must be a non-negative int, got {steps!r}")
    if not isinstance(seed, numbers.Integral):
        raise ValueError(f"seed must be an int, got {seed!r}")


class InferenceEngine(_TextCompletion):
    def __init__(self, config: Config, model, *, tokenizer=None,
                 codec=None, device="cuda", rolling: int = 0,
                 ar_draft=None, gamma: int = 4,
                 lookup_ngram: Optional[int] = None, mesh=None):
        self.device = resolve_device(device)
        self.config = config
        self.m = config.model
        self.model = model.to(self.device).eval()
        # mesh: a DeviceMesh (module docstring)
        self.mesh = None
        self._batch_multiple = 1
        if mesh is not None:
            from unidisc_tpu_torch.parallel.mesh import MeshLayout
            from unidisc_tpu_torch.parallel.sample import (batch_multiple,
                                                           check_ar_mesh,
                                                           validate_mesh)
            from unidisc_tpu_torch.parallel.mesh import shard_model
            self.mesh = MeshLayout.of(mesh)
            validate_mesh(config, self.mesh)
            check_ar_mesh(config, self.mesh.sizes)
            shard_model(self.model, self.mesh)
            self._batch_multiple = batch_multiple(config, self.mesh)
        self._leading = self._following = False
        if tokenizer is None:
            from unidisc_tpu_torch.tokenizers.text import get_tokenizer
            tokenizer = get_tokenizer("byte")
        self.tokenizer = tokenizer
        # an ImageCodec for pixel I/O, on the engine's device; every image
        # id the model can emit must have a code (on the card an id past
        # the codebook is a device-side assert, not an error)
        if codec is not None and codec.vocab_size < self.m.image_vocab_size:
            raise ValueError(f"codec {codec.name!r} has {codec.vocab_size} "
                             f"codes; the model emits "
                             f"{self.m.image_vocab_size} image ids")
        self.codec = codec.to(self.device) if codec is not None else None
        self._samplers: Dict[tuple, object] = {}
        # serializes device work and the sampler cache across threads: HTTP
        # handler threads and the batchers' workers all reach the device,
        # and a CUDA graph capture must see no CUDA call from another thread
        self._device_lock = threading.Lock()
        # rolling > 0: requests go through the rolling batchers with that
        # many slots, built at first use under _rolling_lock
        self._rolling_slots = rolling
        self._rolling: Dict[str, object] = {}
        self._rolling_lock = threading.Lock()
        self._scaffold = None    # (small model, split) once enabled
        # the AR route: a draft DIT (ar_draft) or prompt lookup
        # (lookup_ngram) turns the continuous batcher's steps into
        # speculative rounds of `gamma` proposals
        if ar_draft is not None and lookup_ngram:
            raise ValueError("ar_draft and lookup_ngram are exclusive")
        self._ar_draft = None if ar_draft is None \
            else ar_draft.to(self.device).eval()
        self.vocab_size = self.m.vocab_size
        self._gamma, self._lookup_ngram = gamma, lookup_ngram
        self._continuous = None
        self._continuous_lock = threading.Lock()

    def enable_scaffold(self, model_small, split: int):
        """Scaffold decoding (``sampling/scaffold.py``): denoise steps [0,
        split) run this engine's model, the rest `model_small`, which must
        share the vocabulary and the length. Turns off the span-factored
        t2i path and rolling admission for later requests (both as in JAX:
        rolling rows sit at different steps, and the t2i path runs the main
        model only) and drops the built samplers."""
        if self.config.trainer.parameterization == "ar":
            raise ValueError("scaffold decoding schedules diffusion denoise "
                             "steps; it does not apply to AR models")
        model_small = model_small.to(self.device).eval()
        with self._device_lock:
            self._scaffold = (model_small, split)
            self._samplers.clear()

    def _continuous_batcher(self):
        if self.config.trainer.parameterization != "ar":
            raise ValueError("continuous batching needs an AR model "
                             "(trainer.parameterization=ar)")
        from unidisc_tpu_torch.sampling.ar_sampler import (
            init_kv_cache_for, make_apply_token)
        from unidisc_tpu_torch.serving.continuous import ContinuousBatcher
        kw = self._batcher_kw("continuous")
        if self._ar_draft is not None:
            apply_token = make_apply_token(self._ar_draft)
            d_cfg, dev = self._ar_draft.cfg, self.device
            kw.update(draft=(lambda tok, mod, kv, ci: apply_token(
                tok, kv, ci, mod), lambda b, n: init_kv_cache_for(
                    d_cfg, b, n, device=dev)), gamma=self._gamma)
        elif self._lookup_ngram:
            kw.update(lookup_ngram=self._lookup_ngram, gamma=self._gamma)
        lock = kw.pop("dispatch_lock")
        return ContinuousBatcher(self.model, self.config, slots=8, chunk=8,
                                 eos_id=self._eos(), device_lock=lock, **kw)

    def _batcher_kw(self, route: str) -> dict:
        """The mesh arguments of a batcher of `route`: its layout, the
        announcement of its ops to the followers, and on a follower no
        worker (and a lock of its own: the follower replays under the
        device lock already)."""
        kw = dict(dispatch_lock=self._device_lock)
        if self.mesh is not None:
            kw.update(mesh=self.mesh, announce=lambda op, args: self._announce(
                "_batcher_op", dict(route=route, op=op, kw=args)))
            if self._following:
                kw.update(dispatch_lock=None, worker=False)
        return kw

    def _batcher_op(self, route: str, op: str, kw: dict):
        """A follower's replay of one of the leader's batcher ops: the
        batcher of `route` ("continuous", "rolling:t2i" or
        "rolling:generic"), built at its first op, runs op_<op>(**kw) on
        this rank's slots. An op it has not raises (and the rank exits,
        ``follow``)."""
        if route == "continuous":
            batcher = self.continuous
        else:
            kind = route.partition(":")[2]
            if kind not in ("t2i", "generic"):
                raise ValueError(f"unknown batcher route {route!r}")
            batcher = self._rolling_batcher(kind)
        return getattr(batcher, "op_" + op)(**kw)

    def _interleaved_sampler(self, steps: Optional[int] = None):
        """The packed generic sampler of interleaved documents, one row."""
        key = ("interleaved", steps or self.config.sampling.steps)
        if key not in self._samplers:
            from unidisc_tpu_torch.sampling.sampler import build_sampler
            self._samplers[key] = build_sampler(
                self.model, self.config, num_steps=key[1],
                device=self.device, packed=True)
        return self._program(self._samplers[key], self._batch_multiple)

    def interleaved_row(self, segments: List[dict]) -> dict:
        """One document's packed row: {"row": x0, unmask, modality,
        sample_ids and rope_index (L,), "spans": [(kind, start, end,
        grid)]} (the layout of ``run_interleaved``)."""
        m = self.m
        length = m.length
        row = {"x0": np.zeros(length, np.int32),
               "unmask": np.zeros(length, bool),
               "modality": np.zeros(length, np.int32),
               "sample_ids": np.full(length, -1, np.int32),
               "rope_index": np.zeros(length, np.int32)}
        from unidisc_tpu_torch.models.rotary import rope_offsets
        offsets = rope_offsets(m)
        spans = []
        pos = txt_pos = 0
        for seg in segments:
            if seg["kind"] == "text":
                if seg.get("generate"):
                    n = int(seg["generate"])
                    ids, known = np.zeros(n, np.int32), np.zeros(n, bool)
                else:
                    # given text is whole conditioning; a generate slot
                    # holds free text
                    ids = np.asarray(self.tokenizer.encode(
                        seg["text"], add_bos=(pos == 0), add_eos=False),
                        np.int32)
                    known = np.ones(len(ids), bool)
                rope = np.arange(txt_pos, txt_pos + len(ids))
                txt_pos += len(ids)
                grid = 0
            elif seg["kind"] == "image":
                if seg.get("generate"):
                    grid = int(seg.get("grid", math.isqrt(m.img_length)))
                    ids = np.zeros(grid * grid, np.int32)
                    known = np.zeros(grid * grid, bool)
                else:
                    raw = np.asarray(seg["ids"], np.int32).reshape(-1)
                    grid = math.isqrt(len(raw))
                    ids = raw + (0 if raw.max(initial=0) >=
                                 m.text_vocab_size else m.text_vocab_size)
                    known = np.ones(len(ids), bool)
                    if seg.get("pixel_mask") is not None:
                        pm = np.asarray(seg["pixel_mask"])
                        known &= ~downscale_bool_mask(
                            pm, pm.shape[0] // grid).reshape(-1)
                rope = np.arange(len(ids))   # raster, per image
                if offsets is not None:
                    if len(ids) not in offsets:
                        raise ValueError(
                            f"an image of {len(ids)} tokens; "
                            f"model.img_resolutions has "
                            f"{tuple(m.img_resolutions)}")
                    rope = rope + offsets[len(ids)]
            else:
                raise ValueError(f"unknown segment kind {seg['kind']!r}")
            n = len(ids)
            if pos + n > length:
                raise ValueError(f"the document exceeds model.length "
                                 f"{length}")
            sl = slice(pos, pos + n)
            row["x0"][sl], row["unmask"][sl] = ids, known
            row["modality"][sl] = int(seg["kind"] == "image")
            row["rope_index"][sl] = rope
            spans.append((seg["kind"], pos, pos + n, grid))
            pos += n
        row["sample_ids"][:pos] = 0   # one document a row
        return {"row": row, "spans": spans}

    def run_interleaved(self, segments: List[dict], *,
                        steps: Optional[int] = None, seed: int = 0) -> dict:
        """Generate over one interleaved document. segments, in order:
        {"kind": "text", "text": str} (given), {"kind": "text", "generate":
        N} (N tokens to generate), {"kind": "image", "ids": (G*G,),
        "pixel_mask": optional (H, W[, C]) bool} (given; the mask, pooled
        to the token grid, marks the region to regenerate) and {"kind":
        "image", "generate": True, "grid": G}. Returns {"segments" (text
        decoded; image ids, their grid, and a PNG where the grid is the
        codec's), "tokens" (L,), "nfe"}."""
        # the call is checked (and the row built) before the followers
        # see it
        check_call(steps, seed)
        doc = self.interleaved_row(segments)
        with self._device_lock:
            kw = dict(doc=doc, steps=steps, seed=seed)
            self._announce("_run_interleaved_locked", kw)
            return self._run_interleaved_locked(**kw)

    def _run_interleaved_locked(self, doc, *, steps, seed):
        m = self.m
        row = doc["row"]
        sample = self._interleaved_sampler(steps)
        # a mesh granule > 1 takes the single document tiled across rows
        reps = self._batch_multiple
        out = sample(*(np.repeat(row[k][None], reps, 0)
                       for k in ("x0", "unmask", "modality", "sample_ids",
                                 "rope_index")), seed=seed)
        host = out.tokens[0].cpu().numpy()
        from unidisc_tpu_torch.tokenizers.text import wrapped_batch_decode
        codec_grid = None if self.codec is None \
            else self.codec.image_size // self.codec.downsample
        result = []
        for kind, start, end, grid in doc["spans"]:
            if kind == "text":
                result.append({"kind": "text", "text": wrapped_batch_decode(
                    self.tokenizer, host[None, start:end])[0]})
                continue
            ids = np.clip(host[start:end] - m.text_vocab_size, 0,
                          m.image_vocab_size - 1)
            seg = {"kind": "image", "ids": ids, "grid": grid}
            if grid == codec_grid:   # another grid: ids only
                img = self.codec.decode(torch.from_numpy(ids)[None])
                seg["image_b64"] = encode_image_b64(
                    to_uint8(img)[0].cpu().numpy())
            result.append(seg)
        return {"segments": result, "tokens": host, "nfe": int(out.nfe)}

    def _program(self, sampler, batch: int):
        """`sampler` as the engine runs it, run(*inputs, seed): on the card
        its captured program at `batch` rows (ddpm_cache runs eager), on
        the CPU the eager sampler with a generator seeded per call. On a
        mesh the program runs the rank's rows of a `batch`-row call
        (``parallel/sample.py::spmd_sampler``); eager where its steps hold
        collectives (the ring, the pipeline, the tensor-parallel sums, an
        MoE layer's global routing), which a CUDA graph over a gloo group
        cannot hold (several ranks on one card) and which wait for an
        NCCL host with a card per rank (ROADMAP queue 1, item 9)."""
        local, rows = batch, contextlib.nullcontext()
        if self.mesh is not None:
            from unidisc_tpu_torch.parallel.sample import has_collectives
            from unidisc_tpu_torch.sampling.sampler import global_rows
            if has_collectives(self.config, self.mesh):
                sampler.capturable = False
            local = batch // self.mesh.dp_size
            # the program's draws are those of the global batch, as the
            # eager sampler's under spmd_sampler: captured in the same
            # context, the graph draws them at the global shape
            rows = global_rows(self.mesh.dp_rank, self.mesh.dp_size)
        if self.device.type == "cuda" and sampler.capturable:
            with rows:
                run = captured(sampler, local)
        else:
            def run(*inputs, seed: int):
                gen = torch.Generator(device=self.device).manual_seed(seed)
                return sampler(*inputs, generator=gen)
        if self.mesh is not None:
            from unidisc_tpu_torch.parallel.sample import spmd_sampler
            run = spmd_sampler(run, self.config, self.mesh)
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
        """The generic sampler of sampling.predictor at `batch` rows; with
        scaffold decoding, its scaffold form over both trunks."""
        key = ("generic", steps or self.config.sampling.steps)
        if key not in self._samplers:
            if self._scaffold is not None:
                from unidisc_tpu_torch.sampling.scaffold import \
                    build_scaffold_sampler
                small, split = self._scaffold
                # the boundary of the config's step count, as the JAX
                # engine builds its scaffold forward
                self._samplers[key] = build_scaffold_sampler(
                    self.model, small, self.config, split=split,
                    num_steps=key[1], device=self.device,
                    boundary_steps=self.config.sampling.steps)
            else:
                from unidisc_tpu_torch.sampling.sampler import build_sampler
                self._samplers[key] = build_sampler(
                    self.model, self.config, num_steps=key[1],
                    device=self.device)
        return self._program(self._samplers[key], batch)

    def _rolling_batcher(self, kind: str):
        """The rolling batcher of `kind` ("generic" or "t2i"), one each at
        the config's maximum step count (per-request step counts ride the
        rows); built once, under a lock of its own (its capture takes the
        device lock)."""
        with self._rolling_lock:
            if kind not in self._rolling:
                from unidisc_tpu_torch.serving.rolling import (
                    RollingDiffusionBatcher, RollingT2IBatcher)
                cls = RollingT2IBatcher if kind == "t2i" \
                    else RollingDiffusionBatcher
                self._rolling[kind] = cls(
                    self.model, self.config, slots=self._rolling_slots,
                    device=self.device, **self._batcher_kw(f"rolling:{kind}"))
        return self._rolling[kind]

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
        batch up with duplicate rows. With rolling slots (and no scaffold)
        the rows go through the rolling batchers instead."""
        if not prepared:
            raise ValueError("run_batch needs at least one request")
        check_call(steps, seed)
        if self._rolling_slots and self._scaffold is None:
            return self._run_batch_rolling(prepared, steps=steps, seed=seed)
        with self._device_lock:
            kw = dict(prepared=prepared, steps=steps, seed=seed,
                      pad_to=pad_to)
            self._announce("_run_batch_locked", kw)
            return self._run_batch_locked(**kw)

    # a mesh served from one rank: the leader (rank 0, which takes the
    # requests) sends each device call to the other ranks, which replay it
    def lead(self) -> None:
        """Make this rank the leader: every later run_batch and
        run_interleaved, and every device op of the batchers' workers, is
        broadcast to the followers first."""
        self._leading = True

    def _announce(self, name: str, kw: dict) -> None:
        if self._leading:
            import torch.distributed as dist
            dist.broadcast_object_list([(name, kw)], src=0)

    def follow(self) -> None:
        """Replay the leader's calls until it stops (``stop_followers``).
        The leader checks a request before it sends it, so a call that
        raises here failed in a collective or on this rank: it propagates
        and the rank exits (torchrun then tears the world down), where a
        rank that went on would pair its next collective with the wrong
        one of the leader's."""
        import torch.distributed as dist
        self._following = True
        while True:
            msg = [None]
            dist.broadcast_object_list(msg, src=0)
            if msg[0] is None:
                return
            name, kw = msg[0]
            with self._device_lock:
                getattr(self, name)(**kw)

    def stop_followers(self) -> None:
        """End the followers' ``follow``; after the batchers' workers have
        stopped (``shutdown``), or a late op would meet no follower."""
        if self._leading:
            import torch.distributed as dist
            with self._device_lock:
                dist.broadcast_object_list([None], src=0)
                self._leading = False

    def shutdown(self) -> None:
        """Stop the rolling batchers' and the continuous batcher's workers
        (their outstanding futures fail), then the followers."""
        for batcher in list(self._rolling.values()):
            batcher.shutdown()
        super().shutdown()
        self.stop_followers()

    def _run_batch_locked(self, prepared, *, steps, seed, pad_to):
        m = self.m
        n = len(prepared)
        x0 = np.stack([p["x0"] for p in prepared])
        unmask = np.stack([p["unmask"] for p in prepared])
        if pad_to and pad_to > n:
            reps = pad_to - n
            x0 = np.concatenate([x0, np.repeat(x0[-1:], reps, 0)])
            unmask = np.concatenate([unmask, np.repeat(unmask[-1:], reps,
                                                       0)])
        mult = self._batch_multiple
        if x0.shape[0] % mult:
            # the mesh granule (the data-parallel width): round up with
            # duplicate rows, dropped again after sampling
            reps = mult - x0.shape[0] % mult
            x0 = np.concatenate([x0, np.repeat(x0[-1:], reps, 0)])
            unmask = np.concatenate([unmask, np.repeat(unmask[-1:], reps,
                                                       0)])
        b = x0.shape[0]
        if all(p["fastpath"] for p in prepared) and self._scaffold is None:
            sample = self._t2i_sampler(steps, b)
            out = sample(torch.from_numpy(x0[:, :m.txt_length]), seed=seed)
        else:
            sample = self._sampler(steps, b)
            out = sample(x0, unmask, self._layout(b), seed=seed)
        tokens = out.tokens[:n]
        images = self._decode_images(prepared, tokens)
        return self._decode_rows(prepared, tokens.cpu().numpy(), out.nfe,
                                 images)

    def _run_batch_rolling(self, prepared, *, steps, seed):
        """Each request into the rolling batcher of its kind, with the row
        seed of the JAX engine; the images decoded under the device lock."""
        m = self.m
        self._check_led("rolling admission")
        fastpath = all(p["fastpath"] for p in prepared) and \
            self.config.sampling.maskgit_dilation in (None, 0, 1)
        batcher = self._rolling_batcher("t2i" if fastpath else "generic")
        req_steps = min(steps or self.config.sampling.steps,
                        batcher.built.steps)
        mod_row = None if fastpath else self._layout(1)[0]
        futs = []
        for i, p in enumerate(prepared):
            row_seed = (seed * 0x9E3779B1 + i) & 0x7FFFFFFF
            if fastpath:
                futs.append(batcher.submit(p["x0"][:m.txt_length],
                                           seed=row_seed, steps=req_steps))
            else:
                futs.append(batcher.submit(p["x0"], p["unmask"], mod_row,
                                           seed=row_seed, steps=req_steps))
        tokens = np.stack([f.result(timeout=600) for f in futs])
        with self._device_lock:
            images = self._decode_images(
                prepared, torch.from_numpy(tokens).to(self.device))
        return self._decode_rows(prepared, tokens,
                                 req_steps + batcher.built.extra, images)

    def _decode_images(self, prepared, tokens: torch.Tensor):
        """The rows' images as uint8 (n, H, W, 3) on the host, decoded by
        the codec on the device from the sampler's tokens; None without a
        codec or when every request is gen_text."""
        if self.codec is None or all(p["task"] == "gen_text"
                                     for p in prepared):
            return None
        m = self.m
        # clamp out-of-codebook ids (text leakage below, label tokens
        # above), as the JAX engine does
        ids = (tokens[:, m.txt_length:] - m.text_vocab_size).clamp(
            0, m.image_vocab_size - 1)
        return to_uint8(self.codec.decode(ids)).cpu().numpy()

    def _decode_rows(self, prepared, tokens, nfe, images=None):
        """Token rows (and decoded images) -> per-request result dicts."""
        m = self.m
        txt_ids = tokens[:, :m.txt_length]
        img_ids = tokens[:, m.txt_length:] - m.text_vocab_size
        from unidisc_tpu_torch.tokenizers.text import wrapped_batch_decode
        texts = wrapped_batch_decode(self.tokenizer, txt_ids)
        results = []
        for i, p in enumerate(prepared):
            r = {"task": p["task"], "text": texts[i], "texts": [texts[i]],
                 "image_ids": img_ids[i:i + 1], "nfe": int(nfe)}
            if images is not None and p["task"] != "gen_text":
                r["images_b64"] = [encode_image_b64(images[i])]
            results.append(r)
        return results

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
        if "images_b64" in first:
            first["images_b64"] = [r["images_b64"][0] for r in results]
        return first



def apply_lora(model, path: str) -> None:
    """Merge the adapter saved at `path` into `model`'s weights in place
    (``training/lora.py``: base + (alpha / rank) B A)."""
    from unidisc_tpu_torch.training.lora import load_lora, merge_lora
    adapter, alpha, rank = load_lora(path)
    sd = model.state_dict()
    dev = next(model.parameters()).device
    merged = merge_lora(sd, {k: v.to(dev) for k, v in adapter.items()},
                        alpha=alpha, rank=rank)
    model.load_state_dict(merged)


class ElmEngine(_TextCompletion):
    """Serves the OpenELM baseline (``models/elm.py``) through the
    continuous batcher: the surface of the server's AR text route
    (``config.trainer.parameterization == "ar"``, ``tokenizer``, ``codec``
    None, ``complete_text``). `model` is on `device` in eval mode; `draft`
    a smaller OpenELM of its vocabulary for speculative rounds, or
    `lookup_ngram` for prompt lookup."""

    def __init__(self, elm_cfg, model, *, tokenizer=None,
                 kv_cache: Optional[str] = None, slots: int = 8,
                 chunk: int = 8, draft=None, gamma: int = 4,
                 lookup_ngram: Optional[int] = None, device="cuda"):
        if kv_cache not in (None, "bf16", "int8"):
            raise ValueError(f"unknown kv_cache {kv_cache!r}")
        self.device = resolve_device(device)
        self.elm_cfg = elm_cfg
        self.model = model.to(self.device).eval()
        self.codec = None
        self._draft = None if draft is None else draft.to(self.device).eval()
        self._gamma, self._lookup_ngram = gamma, lookup_ngram
        # the config fields the server's routing reads
        self.config = types.SimpleNamespace(
            trainer=types.SimpleNamespace(parameterization="ar"),
            sampling=types.SimpleNamespace(steps=0),
            model=types.SimpleNamespace(length=elm_cfg.max_length))
        self.m = self.config.model
        self.vocab_size = elm_cfg.total_vocab
        if tokenizer is None:
            from unidisc_tpu_torch.tokenizers.text import get_tokenizer
            tokenizer = get_tokenizer("byte")
        self.tokenizer = tokenizer
        self._kv_cache = kv_cache
        self._slots, self._chunk = slots, chunk
        self._device_lock = threading.Lock()
        self._continuous = None
        self._continuous_lock = threading.Lock()

    def _continuous_batcher(self):
        from unidisc_tpu_torch.serving.continuous import \
            elm_continuous_batcher
        return elm_continuous_batcher(
            self.model, slots=self._slots, chunk=self._chunk,
            eos_id=self._eos(), quant_cache=self._kv_cache == "int8",
            draft=self._draft, gamma=self._gamma,
            lookup_ngram=self._lookup_ngram, device_lock=self._device_lock)


def elm_model(cfg, seed: int, quantize: Optional[str] = None,
              device="cuda", lora: Optional[str] = None):
    """An OpenELM of `cfg` with random weights drawn from `seed` (the JAX
    init's distributions) on `device` (so a card draws its own numbers,
    in a fraction of the CPU's time), computing in bf16: its projections
    stored in bf16, or with quantize="int8" converted from the fp32
    weights by ``quantize_elm_params``; a LoRA adapter file merged into
    the fp32 weights first."""
    from unidisc_tpu_torch.models.elm import OpenELM
    from unidisc_tpu_torch.ops.quant import quantize_elm_params
    dev = resolve_device(device)
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize {quantize!r}")
    src = OpenELM(cfg, compute_dtype=torch.float32, init_seed=None).to(dev)
    src.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    if lora:
        apply_lora(src, lora)
    state = src.state_dict()
    if quantize == "int8":
        cfg = dataclasses.replace(cfg, quant="int8")
        state = quantize_elm_params(state)
    model = OpenELM(cfg, compute_dtype=torch.bfloat16,
                    init_seed=None).to(dev)
    model.load_state_dict(state)
    return model.eval()


def build_elm_engine(*, preset: str = "270m",
                     quantize: Optional[str] = None,
                     kv_cache: Optional[str] = None,
                     speculative: Optional[str] = None, gamma: int = 4,
                     lora: Optional[str] = None, tokenizer=None,
                     device="cuda") -> ElmEngine:
    """The OpenELM serving engine of `preset` ("tiny", "270m", "450m",
    "1.1b"), random weights from seed 0: quantize="int8" serves int8 W8A8,
    kv_cache="int8" the int8 KV cache; speculative="<preset>" decodes with
    a draft of that preset (seed 1, forced onto the target's vocabulary
    and length), "lookup[:N]" with prompt lookup (N-grams, default 2).
    lora: an adapter file (``lora_adapter.npz``, OpenELM's qkv_proj
    targets) merged into the weights before any quantization."""
    from unidisc_tpu_torch.models.elm import ELM_PRESETS
    dev = resolve_device(device)
    cfg = ELM_PRESETS[preset]
    model = elm_model(cfg, 0, quantize, dev, lora=lora)
    draft, lookup_ngram = None, None
    if speculative == "lookup" or (speculative or "").startswith("lookup:"):
        _, _, n = speculative.partition(":")
        lookup_ngram = int(n) if n else 2
    elif speculative:
        d_cfg = dataclasses.replace(
            ELM_PRESETS[speculative], vocab_size=cfg.vocab_size,
            extra_tokens=cfg.extra_tokens, max_length=cfg.max_length)
        draft = elm_model(d_cfg, 1, None, dev)
    return ElmEngine(cfg, model, tokenizer=tokenizer, kv_cache=kv_cache,
                     draft=draft, gamma=gamma, lookup_ngram=lookup_ngram,
                     device=dev)


def restore_run(run_dir: str, *, ema: bool = True):
    """(config snapshot, DIT weights, step) of the latest checkpoint of a
    run dir that the port's Trainer wrote: its EMA weights, or with
    ``ema=False`` the live ones."""
    from unidisc_tpu_torch.training.checkpoint import CheckpointManager
    mgr = CheckpointManager(f"{run_dir}/checkpoints")
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {run_dir}")
    meta = mgr.read_meta(step)
    snap = Config.from_json(json.dumps(meta["config"]))
    state = mgr.read_state(step)
    if snap.trainer.host_offload_optimizer:
        # the chunked host state: the EMA (or the fp32 master) gathered
        from unidisc_tpu_torch.training.offload import gather_state_dict
        return snap, gather_state_dict(state, "emas" if ema
                                       else "masters"), step
    if snap.model.lora_rank > 0:
        # the adapter's checkpoint: the frozen base rebuilt as the Trainer
        # had it (the recorded base run's EMA, else the seed's init), plus
        # the adapter
        from unidisc_tpu_torch.models.dit import DIT
        from unidisc_tpu_torch.training.lora import merge_lora
        from unidisc_tpu_torch.training.trainer import restore_base_params
        model = DIT(snap.model, compute_dtype=torch.float32)
        model.reset_parameters(torch.Generator().manual_seed(snap.seed))
        base = model.state_dict()
        if meta.get("lora_base_checkpoint"):
            base.update(restore_base_params(meta["lora_base_checkpoint"],
                                            expect_like=base))
        weights = merge_lora(base, state["ema_params" if ema else "params"],
                             alpha=snap.model.lora_alpha,
                             rank=snap.model.lora_rank)
        return snap, weights, step
    return snap, state["ema_params" if ema else "params"], step


def build_engine(*, preset: str = "small", checkpoint: Optional[str] = None,
                 reference_ckpt: Optional[str] = None,
                 codec_name: Optional[str] = None, device="cuda",
                 lora: Optional[str] = None,
                 experiments=None, overrides: Optional[dict] = None,
                 steps: Optional[int] = None,
                 quantize: Optional[str] = None,
                 kv_cache: Optional[str] = None,
                 rolling: int = 0,
                 scaffold: Optional[str] = None,
                 scaffold_split: int = 8,
                 speculative: Optional[str] = None,
                 spec_gamma: int = 4,
                 mesh: Optional[str] = None):
    """An engine for a config preset, as the JAX ``build_engine``:

    * weights: drawn from the config's seed (the JAX init's
      distributions); or ``checkpoint``, a run dir of the port's Trainer,
      whose EMA weights are served under its config snapshot; or
      ``reference_ckpt``, a published reference checkpoint
      (``model.safetensors`` or ``.pt``), whose shapes set the
      architecture (``models/port.py::infer_dit_overrides``);
    * ``overrides`` (dotted config keys) and ``experiments`` (overlays)
      beat the snapshot; the module is built from the final config;
    * the model computes in bf16; ``quantize="int8"`` converts it to int8
      W8A8 after the weights are loaded;
    * ``codec_name`` adds an image codec sized to the model's image grid
      (sqrt(img_length) x the codec's downsample), so results carry PNGs;
    * ``rolling=N`` serves through the rolling batchers with N slots;
    * ``scaffold="preset[=run_dir]"`` with ``scaffold_split=K`` runs denoise
      steps [0, K) on the main model and the rest on a trunk of that
      preset, forced onto the main model's vocabulary and length: random
      weights from its seed, or a port run dir's EMA weights; int8 too
      when ``quantize`` is;
    * ``kv_cache="int8"`` sets ``model.kv_cache_dtype``;
    * AR models (``trainer.parameterization=ar``): ``speculative=
      "preset[=run_dir]"`` decodes with a causal draft DIT of that preset
      (its io contract the main model's; random weights from its seed + 1,
      or a port run dir's EMA weights, which a served run dir requires),
      ``"lookup[:N]"`` with prompt lookup; ``spec_gamma`` proposals a
      round;
    * ``preset="elm[:size]"``: the OpenELM baseline, ``build_elm_engine``
      (size 270m by default);
    * ``lora``: an adapter file merged into the weights before any
      quantization. A LoRA run dir (``checkpoint=``) serves its base plus
      its EMA adapter, a host-offload run dir its gathered EMA.
    * an MoE model serves in bf16, and in int8 with ``model.quant_fused``
      off (the experts and the router stay in floating point). Its routing
      is batch-wide (capacity is shared by every row of a forward, the
      CFG rows included), so a request's tokens depend on the other rows
      of its batch. ``img_cond`` and ``cond_label`` models are refused: no
      request carries an x_cond or a label.
    * ``mesh="fsdp=2,seq=2"`` (``parse_mesh_spec``) serves SPMD over the
      ranks of a process group (one process per device, started by
      torchrun, ``utils/dist.py::initialize``): every rank builds the same
      engine and makes the same calls (the server's followers replay the
      leader's, ``serving/server.py``). With ``rolling=N`` or an AR model
      the engine is led from rank 0 (``lead`` / ``follow``): the slots
      (N, rounded up to the mesh granule) are split over the
      data-parallel ranks and "seq" runs them replicated, as in JAX
      (module docstring). What the mesh cannot run raises
      NotImplementedError naming ROADMAP queue 1, item 9 before the world
      is joined (``parallel/mesh.py::check_mesh_model``), and so does AR
      decoding on "tensor", "pp" or "ep" or of an MoE model on a
      data-parallel mesh (``parallel/sample.py::check_ar_mesh``). With
      ``quantize="int8"`` the model is quantized on one rank, whole, and
      then laid out on the mesh (``InferenceEngine``)."""
    if preset == "elm" or preset.startswith("elm:"):
        if checkpoint or reference_ckpt:
            raise ValueError("the OpenELM route takes no checkpoint (serve "
                             "a DIT-AR run dir for checkpointed AR serving)")
        return build_elm_engine(
            preset=preset.partition(":")[2] or "270m", quantize=quantize,
            kv_cache=kv_cache, speculative=speculative, gamma=spec_gamma,
            lora=lora, device=device)
    if checkpoint is not None and reference_ckpt is not None:
        raise ValueError("reference_ckpt loads reference weights and "
                         "checkpoint loads a run dir: pass one")
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize {quantize!r}")
    from unidisc_tpu_torch.models.dit import DIT
    dev = resolve_device(device)
    over = dict(overrides or {})
    if steps:
        over["sampling.steps"] = steps
    if kv_cache:
        over["model.kv_cache_dtype"] = kv_cache
    weights = None
    if reference_ckpt:
        from unidisc_tpu_torch.models.port import (infer_dit_overrides,
                                                   read_reference_state_dict,
                                                   reference_dit_state_dict)
        ref = read_reference_state_dict(reference_ckpt)
        over = {**infer_dit_overrides(ref), **over}
        weights = reference_dit_state_dict(ref)
    if checkpoint:
        config, weights, _ = restore_run(checkpoint)
        if experiments:
            config = config.apply_experiments(*experiments)
        if over:
            config = config.override(**over)
    else:
        config = Config.make(preset, **over)
        if experiments:
            config = config.apply_experiments(*experiments)
    live_mesh = None
    if mesh:
        from unidisc_tpu_torch.parallel.mesh import check_mesh_model
        from unidisc_tpu_torch.parallel.sample import check_ar_mesh
        # what the mesh cannot run is refused before the world is joined
        check_mesh_model(dataclasses.replace(config.model, quant="int8")
                         if quantize else config.model,
                         mesh_spec_sizes(mesh))
        check_ar_mesh(config, mesh_spec_sizes(mesh))
        live_mesh, mesh_kw = parse_mesh_spec(mesh, dev)
        config = config.override(**{f"mesh.{k}": v
                                    for k, v in mesh_kw.items()})
        if config.mesh.pp > 1:
            # validate() refuses pp with dropout > 0 (a training rule);
            # an engine runs in eval mode, where dropout does nothing
            config = config.override(**{"model.dropout": 0.0})
        if scaffold:
            raise ValueError("scaffold decoding on a mesh is not in the "
                             "port (nor in the JAX engine)")
    config.validate()
    if config.model.img_cond:
        raise ValueError(
            "model.img_cond=True checkpoint cannot be served: the engine "
            "supplies no x_cond conditioning stream (use the sampling API "
            "with an explicit x_cond, or serve a non-img_cond model)")
    if config.model.cond_label:
        raise ValueError(
            "model.cond_label=True checkpoint cannot be served: no sampler "
            "of the engine passes the class label the model needs")
    model = DIT(config.model, compute_dtype=torch.bfloat16, init=False)
    if weights is None:
        model.reset_parameters(torch.Generator().manual_seed(config.seed))
    else:
        model.load_state_dict(weights)
    if lora:
        apply_lora(model, lora)
    if quantize:
        # whole, before the engine lays the model out on the mesh: a
        # shard's per-channel scales would be maxima over its slice
        from unidisc_tpu_torch.ops.quant import quantize_model
        config, model = quantize_model(config, model)
        config.validate()    # e.g. quant_fused with MoE
    codec = None
    if codec_name:
        from unidisc_tpu_torch.tokenizers.image_codecs import (
            codec_downsample, get_codec)
        grid = math.isqrt(config.model.img_length)
        codec = get_codec(codec_name, device=dev,
                          image_size=grid * codec_downsample(codec_name))
    ar_draft, lookup_ngram = None, None
    if speculative:
        if config.trainer.parameterization != "ar":
            raise ValueError("speculative decoding needs an AR model "
                             "(trainer.parameterization=ar, or the elm "
                             "route); use scaffold for diffusion models")
        if speculative == "lookup" or speculative.startswith("lookup:"):
            _, _, n = speculative.partition(":")
            lookup_ngram = int(n) if n else 2
        else:
            ar_draft = draft_model(config, speculative,
                                   served_run=bool(checkpoint))
    engine = InferenceEngine(config, model, codec=codec, device=dev,
                             rolling=rolling, ar_draft=ar_draft,
                             gamma=spec_gamma, lookup_ngram=lookup_ngram,
                             mesh=live_mesh)
    if scaffold:
        engine.enable_scaffold(scaffold_model(config, scaffold, quantize),
                               scaffold_split)
    return engine


def mesh_spec_sizes(spec: str) -> Dict[str, int]:
    """"pp=2,tensor=2" -> {"pp": 2, "tensor": 2, "fsdp": 1}: the fields of
    a mesh spec (the axes, and ``pp_microbatches``); "fsdp" defaults to
    1."""
    kw = {}
    for part in spec.split(","):
        k, _, v = part.strip().partition("=")
        if k not in ("dcn", "fsdp", "tensor", "seq", "pp", "ep",
                     "pp_microbatches"):
            raise ValueError(f"unknown mesh axis {k!r}")
        kw[k] = int(v)
    kw.setdefault("fsdp", 1)
    return kw


def parse_mesh_spec(spec: str, device="cuda"):
    """"fsdp=2,seq=2" -> (a DeviceMesh over the process group's ranks, or
    None when the mesh is one device; the axis sizes). Unnamed axes
    default to 1; one may be -1 (all remaining ranks). A process group is
    joined from torchrun's environment when none is up."""
    from unidisc_tpu_torch.config import MeshConfig
    from unidisc_tpu_torch.parallel.mesh import (check_ported_axes,
                                                 make_mesh,
                                                 resolve_mesh_shape)
    from unidisc_tpu_torch.utils import dist as udist
    kw = mesh_spec_sizes(spec)
    check_ported_axes(kw)
    cfg = MeshConfig(**kw)
    udist.initialize(device=str(device))
    world = udist.world_size()
    resolve_mesh_shape(cfg, world)
    return (make_mesh(cfg) if world > 1 else None), kw


def scaffold_model(config: Config, spec: str, quantize: Optional[str] = None):
    """The scaffold trunk of ``build_engine(scaffold="preset[=run_dir]")``:
    the preset forced onto the main model's io contract, random weights
    from its seed or the run dir's EMA weights, int8 with `quantize`."""
    from unidisc_tpu_torch.models.dit import DIT
    preset, _, run_dir = spec.partition("=")
    m = config.model
    s_cfg = Config.make(preset).override(**{
        "model.length": m.length, "model.txt_length": m.txt_length,
        "model.img_length": m.img_length,
        "model.text_vocab_size": m.text_vocab_size,
        "model.image_vocab_size": m.image_vocab_size,
        "model.force_argmax_valid_indices": m.force_argmax_valid_indices,
        "model.dropout": 0.0})
    small = DIT(s_cfg.model, compute_dtype=torch.bfloat16)
    if run_dir:
        _, weights, _ = restore_run(run_dir)
        small.load_state_dict(weights)
    else:
        small.reset_parameters(torch.Generator().manual_seed(s_cfg.seed))
    if quantize:
        from unidisc_tpu_torch.ops.quant import quantize_model
        _, small = quantize_model(s_cfg, small)
    return small.eval()


def draft_model(config: Config, spec: str, served_run: bool = False):
    """The draft DIT of ``build_engine(speculative="preset[=run_dir]")``:
    the preset forced onto the main model's io contract, causal, without
    time conditioning; random weights from its seed + 1, or the run dir's
    EMA weights. A served run dir needs a trained draft: a random one
    accepts almost nothing, and every round would then cost gamma + 1
    draft forwards to advance one token."""
    from unidisc_tpu_torch.models.dit import DIT
    preset, _, run_dir = spec.partition("=")
    if served_run and not run_dir:
        raise ValueError("speculative decoding of a run dir needs a trained "
                         "draft: speculative='preset=run_dir'")
    m = config.model
    d_cfg = Config.make(preset).override(**{
        "model.length": m.length, "model.txt_length": m.txt_length,
        "model.img_length": m.img_length,
        "model.text_vocab_size": m.text_vocab_size,
        "model.image_vocab_size": m.image_vocab_size,
        "model.full_attention": False, "model.time_conditioning": False,
        "model.dropout": 0.0})
    draft = DIT(d_cfg.model, compute_dtype=torch.bfloat16)
    if run_dir:
        _, weights, _ = restore_run(run_dir)
        draft.load_state_dict(weights)
    else:
        draft.reset_parameters(torch.Generator().manual_seed(d_cfg.seed + 1))
    return draft.eval()


def downscale_bool_mask(mask: np.ndarray, d: int) -> np.ndarray:
    """Pixel-space edit mask (H, W[, C]) -> token-grid mask by any-pooling
    over d x d cells."""
    mask = np.asarray(mask)
    if mask.ndim == 3:
        mask = mask.any(-1)
    h, w = mask.shape
    if h % d or w % d:
        raise ValueError(f"mask {h}x{w} not divisible by {d}")
    return mask.reshape(h // d, d, w // d, d).any(axis=(1, 3))


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """Images in [-1, 1] -> uint8 as the JAX engine writes them:
    clip((x + 1) * 127.5, 0, 255), truncated."""
    return ((images + 1) * 127.5).clamp(0, 255).to(torch.uint8)


def encode_image_b64(img: np.ndarray) -> str:
    """An image (H, W, 3), float in [-1, 1] or uint8 -> base64 PNG."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip((arr + 1) * 127.5, 0, 255).astype(np.uint8)
    return base64.b64encode(encode_png(arr)).decode()


def decode_image_b64(data: str) -> np.ndarray:
    """base64 PNG -> float32 (H, W, 3) in [-1, 1]."""
    img = decode_png(base64.b64decode(data))
    return img.astype(np.float32) / 127.5 - 1.0
