"""Attention-caching sampling (port of ``unidisc_tpu/sampling/caching.py``).

Maskgit sampling where most denoise steps run the forward over only part
of the [text | image] row against a KV cache:

  * a full step runs the whole row, rewriting every layer's K/V and the
    cached p(x0) of every position (one NFE);
  * a partial step, with ``recompute="txt"``, runs only the first
    ``txt_length`` rows at cache index 0 (their K/V overwrite the cache's
    text region; the queries attend over the whole cache, the image part
    stale) and takes the image p(x0) from the cache; ``recompute="img"``
    runs only the image rows at cache index ``txt_length`` (the mirror
    mode for text->image, the text K/V frozen between refreshes).

Step i is full when ``i % txt_to_img_ratio == 0`` (ratio <= 0: only step
0). The choice is a function of the step index, so the loop holds each
step's branch on the host and ``sampling/graph.py`` captures the whole
loop, the final full pass included, as one program; no step reads the
device. A partial step unmasks only positions of its part: the count of
tokens to reveal is clamped to the eligible positions, so a step with none
reveals nothing. The KV cache is the model's (``init_kv_cache_for``:
bf16, or int8 under ``model.kv_cache_dtype="int8"``) and is written in
place. The NFE is JAX's: full passes (the final one included) plus the
partial passes weighted by their share of the row, rounded down.

Noise: the token pick is argmax(p / (E + 1e-10)) with E ~ Exp(1) and the
confidence noise a standard Gumbel, drawn from the generator, or injected
(``inject_noise=True``: "exp" (steps, B, L, V) and "gumbel" (steps, B,
L)), which is how the tests give both packages the same draws.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.device import resolve_device
from unidisc_tpu_torch.diffusion.noise import get_noise
from unidisc_tpu_torch.diffusion.subs import subs_parameterization
from unidisc_tpu_torch.sampling.ar_sampler import init_kv_cache_for
from unidisc_tpu_torch.sampling.sampler import (SampleResult,
                                                adaptive_schedule,
                                                cfg_forward,
                                                check_model_device,
                                                confidence_threshold,
                                                exponential, gumbel,
                                                linspace_f32, upload)


class CachingSampler:
    """``build_caching_sampler``'s sampler: called as ``sample(x0,
    x0_unmask, modality, *, generator=None, injected=None)``, with the
    prepare / denoise / finish parts that ``sampling/graph.py`` captures."""

    def __init__(self, model, config: Config, txt_to_img_ratio: int,
                 num_steps, recompute: str, inject_noise: bool,
                 return_trajectory: bool, device):
        if recompute not in ("txt", "img"):
            raise ValueError(f"recompute must be 'txt' or 'img', got "
                             f"{recompute!r}")
        if not config.model.full_attention:
            raise ValueError("the caching sampler needs "
                             "model.full_attention")
        self.device = resolve_device(device)
        check_model_device(model, self.device)
        self.model, self.config = model, config
        self.ratio = txt_to_img_ratio
        self.steps = num_steps or config.sampling.steps
        self.recompute = recompute
        self.inject_noise = inject_noise
        self.return_trajectory = return_trajectory
        self.noise = get_noise(config.noise)
        self.use_cfg = config.sampling.cfg is not None
        self.capturable = True
        self.graphs: Dict[int, object] = {}   # sampling/graph.py's cache

    def is_full(self, i: int) -> bool:
        """Whether step i refreshes the whole row."""
        return i % self.ratio == 0 if self.ratio > 0 else i == 0

    def nfe(self) -> int:
        m = self.config.model
        full = sum(self.is_full(i) for i in range(self.steps))
        part = m.length - m.txt_length if self.recompute == "img" \
            else m.txt_length
        return full + 1 + ((self.steps - full) * part) // m.length

    def prepare(self, x0, x0_unmask, modality, injected=None) -> dict:
        """The inputs as device tensors: x0, unmask, modality, the
        schedule (B, steps) from each row's count of masked tokens (on the
        host), and the injected noise."""
        if (injected is not None) != self.inject_noise:
            raise ValueError("pass `injected` exactly when the sampler was "
                             "built with inject_noise=True")
        m, s = self.config.model, self.config.sampling
        dev = self.device
        x0_host = np.asarray(torch.as_tensor(x0).cpu(), np.int64)
        unmask_host = np.asarray(torch.as_tensor(x0_unmask).cpu(), bool)
        masked = np.where(unmask_host, x0_host, m.mask_index) == m.mask_index
        inputs = {"x0": upload(x0_host, dev),
                  "unmask": upload(unmask_host, dev),
                  "modality": torch.as_tensor(modality).to(dev, torch.long),
                  "schedule": upload(adaptive_schedule(
                      masked.sum(-1), self.steps, s.maskgit_mode), dev)}
        if self.inject_noise:
            for key in ("exp", "gumbel"):
                inputs[key] = torch.as_tensor(injected[key]).to(
                    dev, torch.float32)
        return inputs

    def example_inputs(self, b: int) -> dict:
        """Inputs of the right shapes for a capture's warm-up: the text
        given, the image generated."""
        m = self.config.model
        modality = np.concatenate([np.zeros((b, m.txt_length), np.int64),
                                   np.ones((b, m.img_length), np.int64)], 1)
        injected = None
        if self.inject_noise:
            shape = (self.steps, b, m.length)
            injected = {"exp": np.ones(shape + (m.vocab_size,), np.float32),
                        "gumbel": np.zeros(shape, np.float32)}
        return self.prepare(np.zeros((b, m.length), np.int64),
                            modality == 0, modality, injected)

    def _p(self, x, unmask, modality, t, kv, start: int):
        """p(x0) (fp32) of the rows x from position `start`, their forward
        writing the cache at `start`; with CFG the unconditional rows
        (conditioning re-masked) run in the same forward."""
        m, s = self.config.model, self.config.sampling
        x_uncond = torch.where(unmask, m.mask_index, x) if self.use_cfg \
            else None
        logits, _ = cfg_forward(self.model, x, x_uncond, self.noise.total(t),
                                modality=modality, kv_cache=kv,
                                cache_index=start)
        logits = logits.float()
        kw = dict(modality=modality, text_vocab_size=m.text_vocab_size) \
            if m.force_argmax_valid_indices else {}
        if self.use_cfg:
            lc, lu = logits.chunk(2, dim=0)
            w = (s.cfg * (1 - t))[:, None, None]
            return torch.exp(subs_parameterization(
                (1 + w) * lc - w * lu, None, m.mask_index, **kw))
        return torch.exp(subs_parameterization(logits, x, m.mask_index,
                                               **kw))

    def _step_p(self, i, x, t, kv, p_cache, inputs):
        """p(x0) of the whole row at step i: a full forward, or the
        partial one with the other part from the cache."""
        lt = self.config.model.txt_length
        unmask, modality = inputs["unmask"], inputs["modality"]
        if i == self.steps or self.is_full(i):
            return self._p(x, unmask, modality, t, kv, 0)
        if self.recompute == "txt":
            p = self._p(x[:, :lt], unmask[:, :lt], modality[:, :lt], t, kv,
                        0)
            return torch.cat([p, p_cache[:, lt:]], 1)
        p = self._p(x[:, lt:], unmask[:, lt:], modality[:, lt:], t, kv, lt)
        return torch.cat([p_cache[:, :lt], p], 1)

    def denoise(self, inputs, generator=None):
        """The loop and the final full pass: (x (B, L), state)."""
        m, s = self.config.model, self.config.sampling
        dev = self.device
        x0, unmask = inputs["x0"], inputs["unmask"]
        b, length = x0.shape
        mask = m.mask_index
        x = torch.where(unmask, x0, mask)
        timesteps = linspace_f32(1.0, s.sampling_eps, self.steps + 1)
        kv = init_kv_cache_for(m, 2 * b if self.use_cfg else b, length,
                               device=dev)
        p_cache = None
        part = torch.arange(length, device=dev) >= m.txt_length
        if self.recompute == "txt":
            part = ~part
        traj = []
        for i in range(self.steps):
            t = torch.full((b,), float(timesteps[i]), device=dev)
            p = self._step_p(i, x, t, kv, p_cache, inputs)
            copy = x != mask
            eligible = ~copy if self.is_full(i) else (~copy & part[None])
            num = torch.minimum(inputs["schedule"][:, i], eligible.sum(-1))
            if "exp" in inputs:
                pred = torch.argmax(p / (inputs["exp"][i] + 1e-10), dim=-1)
                g = inputs["gumbel"][i]
            else:
                e = exponential(p.shape, generator, dev)
                pred = torch.argmax(p / (e + 1e-10), dim=-1)
                g = gumbel(pred.shape, generator, dev)
            conf = torch.gather(p, -1, pred[..., None])[..., 0]
            conf = torch.log(torch.clamp(conf, min=1e-30)) \
                + s.maskgit_r_temp * g * t[:, None]
            conf = torch.where(eligible, conf, float("-inf"))
            thresh = confidence_threshold(conf, num)
            sel = (conf >= thresh) & torch.isfinite(conf)
            x_next = torch.where(sel, pred, x)
            x_next = torch.where(copy, x, x_next)
            x = torch.where(unmask, x0, x_next)
            p_cache = p
            if self.return_trajectory:
                traj.append(x)
        t = torch.full((b,), float(np.float32(s.sampling_eps)), device=dev)
        p = self._step_p(self.steps, x, t, kv, p_cache, inputs)
        x = torch.where(x == mask, torch.argmax(p, -1), x)
        x = torch.where(unmask, x0, x)
        state = {"nfe": self.nfe()}
        if self.return_trajectory:
            state["trajectory"] = torch.stack(traj)
        return x, state

    def finish(self, x, state, inputs) -> SampleResult:
        return SampleResult(tokens=x, nfe=state["nfe"])

    @torch.inference_mode()
    def __call__(self, x0, x0_unmask, modality, *,
                 generator: Optional[torch.Generator] = None,
                 injected=None):
        inputs = self.prepare(x0, x0_unmask, modality, injected)
        x, state = self.denoise(inputs, generator)
        out = self.finish(x, state, inputs)
        if self.return_trajectory:
            return out, state["trajectory"]
        return out


def build_caching_sampler(model, config: Config, *,
                          txt_to_img_ratio: int = 4,
                          num_steps: Optional[int] = None,
                          return_trajectory: bool = False,
                          recompute: str = "txt",
                          inject_noise: bool = False,
                          device="cuda") -> CachingSampler:
    """The attention-caching maskgit sampler (module docstring):
    sample(x0 (B, L), x0_unmask (B, L) bool, modality (B, L), *,
    generator=None, injected=None) -> SampleResult; with
    return_trajectory, (SampleResult, (steps, B, L) tokens after each
    step) (eager only). The model must be a full-attention DIT on
    `device` in eval mode."""
    return CachingSampler(model, config, txt_to_img_ratio, num_steps,
                          recompute, inject_noise, return_trajectory,
                          device)
