"""Masked-diffusion samplers (port of ``unidisc_tpu/sampling/sampler.py``).

``build_sampler`` builds the generic sampler of one predictor, the
counterpart of the JAX package's one-``lax.scan``-per-predictor design:

  * ddpm          reverse step of the absorbing process, Gumbel-argmax on
                  log q(x_s | x_t);
  * ddpm_cache    ddpm that reuses log p(x0) while x is unchanged, skipping
                  the forward (the MDLM caching trick);
  * maskgit       confidence top-k: reveal the schedule's count of the most
                  confident Gumbel-argmax predictions;
  * maskgit_nucleus  maskgit whose token pick is top-p (``nucleus_sample``);
  * first_hitting reveal the schedule's count of uniformly random masked
                  positions.

Classifier-free guidance is (1 + w) logit_c - w logit_u with the
time-annealed w(t) (``guidance_weight``) and the unconditional branch
formed by re-masking the conditioning tokens; the per-modality vocabulary
restriction (``force_argmax_valid_indices``) goes through
``diffusion/subs.py::subs_parameterization``.

Everything the host knows before a sample starts (the timesteps, dt, the
guidance weight at each step, the unmasking schedule from each request's
count of masked tokens) is computed host-side in numpy float32, with the
same float32 operations as the JAX package, and uploaded once; no denoise
step reads a device tensor, so ``sampling/graph.py`` can capture the loop
in one CUDA graph. The exception is ddpm_cache, whose skip is a device
flag: it reads one flag a step and is not captured. The noise-removal pass
after the loop reads the device once.

An img_cond model samples through ``ConditionedModel(model, x_cond)``, a
forward closure over its conditioning image; a captured program holds
x_cond as a static buffer. A MoE model's routing inside the loop reads no
device value (its capacity comes from the static shapes).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.device import resolve_device
from unidisc_tpu_torch.diffusion.noise import get_noise
from unidisc_tpu_torch.diffusion.subs import subs_parameterization
from unidisc_tpu_torch.models.moe import stacked_batches

PREDICTORS = ("ddpm", "ddpm_cache", "maskgit", "maskgit_nucleus",
              "first_hitting")


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in float32, value for value:
    start * (1 - s) + stop * s with s = i / (num - 1), and the end point
    exact."""
    start32, stop32 = np.float32(start), np.float32(stop)
    if num == 1:
        return np.asarray([start32], np.float32)
    div = num - 1
    step = np.arange(div, dtype=np.float32) / np.float32(div)
    out = start32 * (np.float32(1) - step) + stop32 * step
    return np.concatenate([out, [stop32]]).astype(np.float32)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


_ROWS = threading.local()


@contextlib.contextmanager
def global_rows(rank: int, size: int):
    """The samplers' draws inside the context are those of the global
    batch: each is made at `size` x its rows (dim 0) and this rank keeps
    rows [rank x b, (rank + 1) x b). A data-parallel rank sampling its b
    rows of a size x b batch so draws the numbers one rank draws for the
    whole batch (``parallel/sample.py::spmd_sampler``)."""
    prev = getattr(_ROWS, "value", None)
    _ROWS.value = (rank, size) if size > 1 else None
    try:
        yield
    finally:
        _ROWS.value = prev


def _draw(fill, shape, device) -> torch.Tensor:
    """`fill` (an in-place sampler of a tensor) at `shape`, or at the
    global batch's shape with this rank's rows kept (``global_rows``)."""
    rows = getattr(_ROWS, "value", None)
    if rows is None:
        return fill(torch.empty(shape, device=device))
    rank, size = rows
    b = shape[0]
    full = fill(torch.empty((size * b,) + tuple(shape[1:]), device=device))
    return full[rank * b:(rank + 1) * b]


def exponential(shape, generator: Optional[torch.Generator],
                device) -> torch.Tensor:
    """Exp(1) noise, fp32, from `generator` (the device's default
    generator when None)."""
    return _draw(lambda t: t.exponential_(generator=generator), shape,
                 device)


def _uniform(shape, generator: Optional[torch.Generator],
            device) -> torch.Tensor:
    """U[0, 1) noise, fp32, from `generator`."""
    return _draw(lambda t: t.uniform_(generator=generator), shape, device)


def gumbel(shape, generator: Optional[torch.Generator],
           device) -> torch.Tensor:
    """Standard Gumbel noise, -log(E) with E ~ Exp(1), fp32, from
    `generator` (the device's default generator when None)."""
    return -torch.log(exponential(shape, generator, device))


def cfg_forward(fn, x, x_uncond, sigma, modality=None, **kw):
    """fn(x, sigma, modality=, **kw), the model's forward (or ``hidden``);
    under CFG (x_uncond given) one forward over the conditional rows x and
    the unconditional rows x_uncond stacked ([x; x_uncond], sigma and
    modality doubled alike). Every doubled forward of the samplers goes
    through here, and here alone the MoE layers learn that the rows are
    two stacked copies of the batch (``models/moe.py::stacked_batches``),
    which they read on a data-parallel mesh."""
    if x_uncond is None:
        return fn(x, sigma, modality=modality, **kw)
    mm = None if modality is None else torch.cat([modality, modality], 0)
    with stacked_batches(2):
        return fn(torch.cat([x, x_uncond], 0), torch.cat([sigma, sigma], 0),
                  modality=mm, **kw)


class ConditionedModel(torch.nn.Module):
    """`model` sampling under the conditioning image x_cond (B, Lc): the
    forward closure over x_cond through which an img_cond model samples,
    as in the JAX package (every forward and ``hidden`` call gets
    ``x_cond=``; other attributes are the model's). x_cond is copied to a
    buffer on the model's device, so a captured sampler program reads it
    at a fixed address: ``set_condition`` copies a new condition in for
    the next replay."""

    def __init__(self, model, x_cond):
        super().__init__()
        self.model = model
        dev = next(model.parameters()).device
        self.register_buffer("x_cond", torch.as_tensor(x_cond).to(
            dev, torch.long, copy=True), persistent=False)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(super().__getattr__("model"), name)

    @torch.no_grad()
    def set_condition(self, x_cond) -> None:
        self.x_cond.copy_(torch.as_tensor(x_cond))

    def forward(self, *args, **kw):
        return self.model(*args, x_cond=self.x_cond, **kw)

    def hidden(self, *args, **kw):
        return self.model.hidden(*args, x_cond=self.x_cond, **kw)


def check_model_device(model, dev: torch.device) -> None:
    p = next(model.parameters())
    if p.device.type != dev.type or (dev.index is not None
                                     and p.device.index != dev.index):
        raise ValueError(f"the model's parameters are on {p.device}, the "
                         f"sampler runs on {dev}; move the model first")


def sample_categorical(probs: torch.Tensor,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """Gumbel-trick categorical sampling in the reference's probs / Exp(1)
    argmax form: argmax(probs / (E + 1e-10)), E ~ Exp(1) fp32."""
    exp = exponential(probs.shape, generator, probs.device) + 1e-10
    return torch.argmax(probs / exp, dim=-1)


def nucleus_sample(probs: torch.Tensor, top_p: float,
                   temperature: float = 1.0, *,
                   exp_noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Top-p (nucleus) sampling, token for token with the JAX package's:
    probs divided by the temperature without a new softmax; the kept set
    is the largest prefix of the (stably) sorted probabilities with
    cumulative mass <= top_p, plus the top token; the draw is
    argmax(filtered / E) in sorted space, so injected exponential noise
    `exp_noise` (E, of probs' shape) lands on the same lanes."""
    scaled = probs / temperature
    order = torch.argsort(-scaled, dim=-1, stable=True)
    sorted_probs = torch.gather(scaled, -1, order)
    keep = torch.cumsum(sorted_probs, dim=-1) <= top_p
    keep[..., 0] = True
    filtered = torch.where(keep, sorted_probs, 0.0)
    filtered = filtered / torch.clamp(filtered.sum(-1, keepdim=True),
                                      min=1e-30)
    if exp_noise is None:
        exp_noise = exponential(filtered.shape, generator,
                                filtered.device) + 1e-10
    j = torch.argmax(filtered / exp_noise, dim=-1)
    return torch.gather(order, -1, j[..., None])[..., 0]


def adaptive_schedule(num_masked, steps: int,
                      mode: str = "arccos") -> np.ndarray:
    """Per-sample unmasking schedule: how many tokens to reveal at each
    step. num_masked: (B,) ints. Returns (B, steps) int32."""
    num = np.asarray(num_masked).astype(np.float32)
    r = linspace_f32(1.0, 0.0, steps)
    one = np.float32(1)
    if mode == "root":
        val = one - np.sqrt(r)
    elif mode == "linear":
        val = one - r
    elif mode == "square":
        val = one - r ** 2
    elif mode == "cosine":
        val = np.cos(r * np.float32(np.pi * 0.5))
    elif mode == "arccos":
        val = np.arccos(r) / np.float32(np.pi * 0.5)
    else:
        raise ValueError(mode)
    frac = val / val.sum(dtype=np.float32)
    sche = np.round(frac[None, :] * num[:, None]).astype(np.float32)
    sche = np.where(sche == 0, one, sche)
    remainder = num - sche[:, :-1].sum(-1, dtype=np.float32) - sche[:, -1]
    sche[:, -1] = np.maximum(sche[:, -1] + remainder, np.float32(0))
    return sche.astype(np.int32)


def confidence_threshold(conf: torch.Tensor,
                         num_unmask: torch.Tensor) -> torch.Tensor:
    """Per-row k-th largest confidence for a per-row k (B,); rows with
    k <= 0 get +inf (nothing selected). Returns (B, 1)."""
    sorted_desc = torch.sort(conf, dim=-1, descending=True).values
    idx = torch.clamp(num_unmask - 1, 0, conf.shape[-1] - 1).long()
    thresh = torch.gather(sorted_desc, -1, idx[:, None])
    return torch.where((num_unmask <= 0)[:, None], float("inf"), thresh)


class SampleResult(NamedTuple):
    tokens: torch.Tensor   # (B, L) final tokens
    nfe: int               # number of model forward evaluations


def guidance_weight(s, t) -> Optional[np.ndarray]:
    """Time-annealed CFG weight w(t), host-side.

    s: SamplingConfig (cfg / cfg_min_timestep / cfg_max_timestep);
    t: (B,) float32 timesteps. cfg == -1 is the sweep mode: per-sample
    weights linspace(0, 10, B). Returns (B,) float32, or None when CFG is
    off.
    """
    w = s.cfg
    if w is None:
        return None
    t = np.asarray(t, np.float32)
    w = linspace_f32(0.0, 10.0, t.shape[0]) if w == -1 else np.float32(w)
    lo, hi = s.cfg_min_timestep, s.cfg_max_timestep
    if lo is not None and hi is not None:
        wt = w * ((t - np.float32(hi)) / np.float32(lo - hi))
    else:
        wt = w * (np.float32(1) - t)
    wt = np.asarray(wt, np.float32)
    if lo is not None:
        wt = np.where(t > np.float32(lo), wt, np.float32(0))
    if hi is not None:
        wt = np.where(t < np.float32(hi), wt, np.float32(0))
    return wt.astype(np.float32)


def guidance_weight_t(s, t: torch.Tensor) -> Optional[torch.Tensor]:
    """``guidance_weight`` on a device tensor: the rolling samplers' rows
    sit at different steps, so each row's weight is computed from its own
    t inside the captured loop. t: (B,) float32. The window's divisor is
    a tensor: PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, which JAX and the CPU do not."""
    w = s.cfg
    if w is None:
        return None
    if w == -1:
        w = torch.from_numpy(linspace_f32(0.0, 10.0, t.shape[0])).to(
            t.device)
    lo, hi = s.cfg_min_timestep, s.cfg_max_timestep
    if lo is not None and hi is not None:
        span = torch.tensor(np.float32(lo - hi), device=t.device)
        wt = w * ((t - np.float32(hi)) / span)
    else:
        wt = w * (1 - t)
    if lo is not None:
        wt = torch.where(t > np.float32(lo), wt, 0.0)
    if hi is not None:
        wt = torch.where(t < np.float32(hi), wt, 0.0)
    return wt.float()


class Sampler:
    """The generic sampler of one predictor (``build_sampler``).

    Called as ``sample(x0, x0_unmask, modality=None, *, generator=None,
    injected=None)``. ``prepare``, ``denoise`` and ``finish`` are the three
    parts of that call: the upload of the inputs (with the schedule), the
    denoise loop (device work only unless ddpm_cache, what
    ``sampling/graph.py`` captures) and the noise-removal pass."""

    def __init__(self, model, config: Config, num_steps, inject_noise,
                 device):
        self.device = resolve_device(device)
        check_model_device(model, self.device)
        s = config.sampling
        if s.predictor not in PREDICTORS:
            raise ValueError(f"unknown predictor {s.predictor}")
        self.model, self.config = model, config
        self.predictor = s.predictor
        self.capturable = s.predictor != "ddpm_cache"
        self.steps = num_steps or s.steps
        self.inject_noise = inject_noise
        self.noise = get_noise(config.noise)
        self.use_cfg = s.cfg is not None
        self._plans: Dict[int, dict] = {}
        self.graphs: Dict[int, object] = {}   # sampling/graph.py's cache

    @property
    def _noise_keys(self) -> tuple:
        """The injected noise this predictor reads."""
        return {"maskgit": ("exp", "gumbel"),
                "maskgit_nucleus": ("exp", "gumbel"),
                "first_hitting": ("exp", "uniform")}.get(self.predictor,
                                                         ("exp",))

    @property
    def _masks_by_schedule(self) -> bool:
        return self.predictor in ("maskgit", "maskgit_nucleus",
                                  "first_hitting")

    def plan(self, b: int) -> dict:
        """The host-known per-step values of a batch of b rows, on the
        device, built once per batch size: the timesteps t (steps + 1, B)
        (the last row sampling_eps, for the noise-removal pass), t - dt
        (steps, B) and the guidance weights (steps + 1, B)."""
        if b not in self._plans:
            s = self.config.sampling
            eps = np.float32(s.sampling_eps)
            timesteps = linspace_f32(1.0, s.sampling_eps, self.steps + 1)
            t_host = np.repeat(timesteps[:, None], b, axis=1)
            dt = np.float32((1.0 - s.sampling_eps) / self.steps)
            t_host[self.steps] = eps
            plan = {"t": upload(t_host, self.device),
                    "t_s": upload(t_host[:-1] - dt, self.device), "w": None}
            if self.use_cfg:
                plan["w"] = upload(np.stack([guidance_weight(s, row)
                                             for row in t_host]),
                                   self.device)
            self._plans[b] = plan
        return self._plans[b]

    def prepare(self, x0, x0_unmask, modality=None, injected=None) -> dict:
        """The inputs of one call as device tensors: "x0" (B, L) long,
        "unmask" (B, L) bool, "modality" (B, L) long when given, the
        schedule (B, steps) for the schedule-driven predictors (from each
        row's count of masked tokens, on the host) and the injected
        noise."""
        if (injected is not None) != self.inject_noise:
            raise ValueError("pass `injected` exactly when the sampler was "
                             "built with inject_noise=True")
        m, s = self.config.model, self.config.sampling
        dev = self.device
        x0_host = np.asarray(torch.as_tensor(x0).cpu(), np.int64)
        unmask_host = np.asarray(torch.as_tensor(x0_unmask).cpu(), bool)
        inputs = {"x0": upload(x0_host, dev),
                  "unmask": upload(unmask_host, dev)}
        if modality is not None:
            inputs["modality"] = torch.as_tensor(modality).to(dev,
                                                              torch.long)
        if self._masks_by_schedule:
            masked = np.where(unmask_host, x0_host, m.mask_index) \
                == m.mask_index
            inputs["schedule"] = upload(adaptive_schedule(
                masked.sum(-1), self.steps, s.maskgit_mode), dev)
        if self.inject_noise:
            for key, value in injected.items():
                if key not in ("exp", "gumbel", "uniform"):
                    raise ValueError(f"unknown injected noise {key!r}")
                if key in self._noise_keys:
                    inputs[key] = torch.as_tensor(value).to(dev,
                                                            torch.float32)
        return inputs

    def _example_args(self, b: int) -> tuple:
        """(x0, x0_unmask, modality, injected) of the right shapes for a
        batch of b rows: text then image rows over model.length (the
        flagship layout's modality), the text masked."""
        m = self.config.model
        modality = np.repeat(
            (np.arange(m.length) >= m.txt_length).astype(np.int64)[None],
            b, 0)
        injected = None
        if self.inject_noise:
            shape = (self.steps, b, m.length)
            injected = {"exp": np.ones(shape + (m.vocab_size,), np.float32),
                        "gumbel": np.zeros(shape, np.float32),
                        "uniform": np.full(shape, 0.5, np.float32)}
            injected = {k: injected[k] for k in self._noise_keys}
        return (np.zeros((b, m.length), np.int64), modality == 1, modality,
                injected)

    def example_inputs(self, b: int) -> dict:
        """Inputs of the right shapes for a batch of b rows, for a capture's
        warm-up."""
        x0, unmask, modality, injected = self._example_args(b)
        return self.prepare(x0, unmask, modality, injected=injected)

    def _model_kwargs(self, inputs, reps: int) -> dict:
        """Extra keyword arguments of the model's forward, for a forward of
        `reps` copies of the batch (2 under CFG)."""
        return {}

    def _noise(self, inputs, key, i):
        return inputs[key][i] if key in inputs else None

    def _model_at(self, i: int):
        """The model that runs the forward of step i (a host int; i ==
        steps is the noise-removal pass)."""
        return self.model

    def _log_p(self, x, i, p, inputs, normalize=True):
        """log p(x0 | x) at step i with CFG and the vocabulary restriction;
        with normalize=False the masked unnormalized logits."""
        m = self.config.model
        t = p["t"][i]
        sigma = self.noise.total(t)
        model = self._model_at(i)
        modality = inputs.get("modality")
        modal_kw = dict(modality=modality,
                        text_vocab_size=m.text_vocab_size) \
            if m.force_argmax_valid_indices and modality is not None else {}
        if self.use_cfg:
            x_uncond = torch.where(inputs["unmask"], m.mask_index, x)
            logits = cfg_forward(model, x, x_uncond, sigma,
                                 modality=modality,
                                 **self._model_kwargs(inputs, 2))
            logit_c, logit_u = logits.chunk(2, dim=0)
            w = p["w"][i][:, None, None]
            combined = (1 + w) * logit_c - w * logit_u
            return subs_parameterization(combined, None, m.mask_index,
                                         normalize=normalize, **modal_kw)
        logits = model(x, sigma, modality=modality,
                       **self._model_kwargs(inputs, 1))
        return subs_parameterization(logits, x, m.mask_index,
                                     normalize=normalize, **modal_kw)

    def _scores(self, log_p, i, p):
        """log q(x_s | x_t) of the reverse step: log p(x0) + log(mc_t -
        mc_s), the mask token log(mc_s); mc = 1 - exp(-sigma), in fp32."""
        mask_index = self.config.model.mask_index
        mc_t = (1 - torch.exp(-self.noise.total(p["t"][i])))[:, None, None]
        mc_s = (1 - torch.exp(-self.noise.total(p["t_s"][i])))[:, None,
                                                                 None]
        ids = torch.arange(log_p.shape[-1], device=log_p.device)
        return torch.where(ids == mask_index, torch.log(mc_s),
                           log_p + torch.log(mc_t - mc_s))

    def _select(self, scores, exp_noise, generator):
        """Gumbel-argmax: argmax(scores - log E) with injected E, else
        argmax(scores + G), G drawn in the scores' dtype."""
        if exp_noise is not None:
            return torch.argmax(scores - torch.log(exp_noise), dim=-1)
        g = gumbel(scores.shape, generator, scores.device).to(scores.dtype)
        return torch.argmax(scores + g, dim=-1)

    def _maskgit_step(self, x, i, p, inputs, generator):
        s = self.config.sampling
        copy = x != self.config.model.mask_index
        num = torch.minimum(inputs["schedule"][:, i], (~copy).sum(-1))
        nucleus = self.predictor == "maskgit_nucleus" and s.top_p is not None
        raw = self._log_p(x, i, p, inputs, normalize=nucleus)
        exp_noise = self._noise(inputs, "exp", i)
        if nucleus:
            pred = nucleus_sample(torch.exp(raw), s.top_p, s.temperature,
                                  exp_noise=exp_noise, generator=generator)
            lse = torch.zeros(raw.shape[:-1], dtype=raw.dtype,
                              device=raw.device)
        else:
            pred = self._select(raw, exp_noise, generator)
            lse = torch.logsumexp(raw, dim=-1)
        conf = torch.gather(raw, -1, pred[..., None])[..., 0] - lse
        conf = torch.clamp(conf, min=_LOG_1E_30)
        g = self._noise(inputs, "gumbel", i)
        if g is None:
            g = gumbel(pred.shape, generator, x.device)
        conf = conf + s.maskgit_r_temp * g * p["t"][i][:, None]
        conf = torch.where(copy, float("-inf"), conf)
        thresh = confidence_threshold(conf, num)
        return torch.where(conf >= thresh, pred, x)

    def _first_hitting_step(self, x, i, p, inputs, generator):
        copy = x != self.config.model.mask_index
        num = torch.minimum(inputs["schedule"][:, i], (~copy).sum(-1))
        log_p = self._log_p(x, i, p, inputs)
        pred = self._select(log_p, self._noise(inputs, "exp", i), generator)
        uniform = self._noise(inputs, "uniform", i)
        if uniform is None:
            uniform = _uniform(x.shape, generator, x.device)
        randv = torch.where(copy, -1.0, uniform)
        thresh = confidence_threshold(randv, num)
        return torch.where(randv >= thresh, pred, x)

    def denoise(self, inputs, generator=None):
        """The denoise loop: (x (B, L), state). state holds "nfe", the
        forwards the loop ran (a host int)."""
        mask_index = self.config.model.mask_index
        x0, unmask = inputs["x0"], inputs["unmask"]
        p = self.plan(x0.shape[0])
        x = torch.where(unmask, x0, mask_index)
        nfe = 0
        log_p, valid = None, False
        for i in range(self.steps):
            if self.predictor in ("ddpm", "ddpm_cache"):
                if not valid:
                    log_p = self._log_p(x, i, p, inputs)
                    nfe += 1
                new = self._select(self._scores(log_p, i, p),
                                   self._noise(inputs, "exp", i), generator)
                x_next = torch.where(x != mask_index, x, new)
            elif self.predictor == "first_hitting":
                x_next = self._first_hitting_step(x, i, p, inputs, generator)
                nfe += 1
            else:
                x_next = self._maskgit_step(x, i, p, inputs, generator)
                nfe += 1
            x_next = torch.where(unmask, x0, x_next)
            if self.predictor == "ddpm_cache":
                # the MDLM caching trick: log p stays valid while x is
                # unchanged; one device flag read a step
                valid = bool((x_next == x).all())
            x = x_next
        return x, {"nfe": nfe}

    def finish(self, x, state, inputs) -> SampleResult:
        """Noise removal: remaining masks take argmax p(x0) at
        sampling_eps (one device read, and one forward where a mask is
        left); then the conditioning is clamped."""
        nfe = state["nfe"]
        if self.config.sampling.noise_removal:
            mask_index = self.config.model.mask_index
            if bool((x == mask_index).any()):
                p = self.plan(x.shape[0])
                log_p = self._log_p(x, self.steps, p, inputs)
                x = torch.where(x == mask_index, torch.argmax(log_p, -1), x)
                nfe += 1
            x = torch.where(inputs["unmask"], inputs["x0"], x)
        return SampleResult(tokens=x, nfe=nfe)

    @torch.inference_mode()
    def __call__(self, x0, x0_unmask, modality=None, *packed,
                 generator: Optional[torch.Generator] = None,
                 injected=None) -> SampleResult:
        """packed: a PackedSampler's sample_ids and rope_index."""
        inputs = self.prepare(x0, x0_unmask, modality, *packed,
                              injected=injected)
        x, state = self.denoise(inputs, generator)
        return self.finish(x, state, inputs)


class PackedSampler(Sampler):
    """The generic sampler over packed rows (interleaved documents): each
    call also takes sample_ids and rope_index (B, L), uploaded with the
    other inputs (a captured program's static inputs) and tiled over the
    CFG-doubled rows of every forward, as the JAX engine's interleaved
    sampler does. Called as ``sample(x0, x0_unmask, modality, sample_ids,
    rope_index, *, generator=None, injected=None)``."""

    def prepare(self, x0, x0_unmask, modality=None, sample_ids=None,
                rope_index=None, injected=None) -> dict:
        if modality is None or sample_ids is None or rope_index is None:
            raise ValueError("a packed sampler takes modality, sample_ids "
                             "and rope_index")
        inputs = super().prepare(x0, x0_unmask, modality, injected)
        dev = self.device
        inputs["sample_ids"] = torch.as_tensor(sample_ids).to(dev,
                                                              torch.int32)
        inputs["rope_index"] = torch.as_tensor(rope_index).to(dev,
                                                              torch.long)
        return inputs

    def example_inputs(self, b: int) -> dict:
        x0, unmask, modality, injected = self._example_args(b)
        zeros = np.zeros(x0.shape, np.int64)
        return self.prepare(x0, unmask, modality, zeros, zeros,
                            injected=injected)

    def _model_kwargs(self, inputs, reps: int) -> dict:
        return {k: inputs[k].repeat(reps, 1)
                for k in ("sample_ids", "rope_index")}



# maskgit's confidence floor, log(1e-30) in fp32
_LOG_1E_30 = float(np.log(np.float32(1e-30)))


def build_sampler(model, config: Config, num_steps: Optional[int] = None,
                  inject_noise: bool = False, device="cuda",
                  packed: bool = False) -> Sampler:
    """The generic sampler of ``config.sampling.predictor``:
    sample(x0 (B, L), x0_unmask (B, L) bool, modality (B, L) 0/1 or None,
    *, generator=None, injected=None) -> SampleResult. x0 holds the given
    tokens where x0_unmask is True; every other position is generated.

    inject_noise=True: `sample` takes an `injected` dict of pre-drawn noise
    instead of drawing from `generator`, the JAX package's contract, so the
    two can be held token for token: "exp" (steps, B, L, V) exponential
    draws (the token pick of ddpm, maskgit and first_hitting, and the
    nucleus draw in sorted space), "gumbel" (steps, B, L) maskgit's
    confidence noise, "uniform" (steps, B, L) first_hitting's position
    draw; a key the predictor reads and the dict leaves out is drawn from
    `generator`, one it does not read is ignored.

    packed=True: the ``PackedSampler`` of interleaved documents, which
    also takes each row's sample_ids and rope_index.

    The model must already be on `device` and in eval mode.
    """
    cls = PackedSampler if packed else Sampler
    return cls(model, config, num_steps, inject_noise, device)
