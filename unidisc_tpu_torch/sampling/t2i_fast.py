"""Text->image sampler with the span-factored vocab head (port of
``unidisc_tpu/sampling/t2i_fast.py``).

The text span is fixed conditioning and the image span is generated, so
the trunk runs without its vocab head (``DIT.hidden``) and the final
layer is applied only over the image rows and only against the image
slice of the vocabulary. Maskgit confidence updates run on the image span.

With ``cached_cond`` the text rows' K/V are cached (conditioning-frozen
sampling): ``cond_refresh=0`` builds the cache in one full pass at step 0
and runs every later step over the image rows alone against the read-only
text K/V (an int8 cache dequantized once); ``cond_refresh=r > 0`` rebuilds
the cache every r steps and otherwise runs the image rows against it.

The denoise loop makes no host round trip: timesteps, guidance weights
and the unmasking schedule are known on the host before the loop and are
uploaded once per batch size, and a step whose guidance weight is zero for
every row skips the unconditional pass by a host decision (as do the
cache refreshes), so ``sampling/graph.py`` can capture the loop whole in
one CUDA graph. The one check for leftover mask tokens after the loop
reads the device once per sample.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.device import resolve_device
from unidisc_tpu_torch.diffusion.noise import get_noise
from unidisc_tpu_torch.models.dit import QLinear, silu, timestep_features
from unidisc_tpu_torch.ops.quant import qdot
from unidisc_tpu_torch.sampling.ar_sampler import init_kv_cache_for
from unidisc_tpu_torch.sampling.sampler import (SampleResult,
                                                adaptive_schedule,
                                                cfg_forward,
                                                check_model_device,
                                                confidence_threshold,
                                                gumbel, guidance_weight,
                                                linspace_f32, upload)


def _head_pre(model, hidden_img, c, cfg: Config,
              compute_dtype=torch.bfloat16):
    """Norm and adaLN modulation of the final layer, everything before the
    linear: the fp32 weight-only norm rounded to `compute_dtype`, then the
    modulation in `compute_dtype` (bf16 by default, also for an fp32
    model, as in the JAX package)."""
    out = model.output_layer
    x32 = hidden_img.float()
    if cfg.model.norm_type == "rms":
        y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + 1e-6)
    else:
        mean = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, unbiased=False)
        y = (x32 - mean) * torch.rsqrt(var + 1e-5)
    y = (y * out.norm_final.weight.float()).to(compute_dtype)
    if cfg.model.time_conditioning:
        ada = out.adaLN_modulation
        cond = (c.to(compute_dtype) @ ada.weight.to(compute_dtype).t()
                + ada.bias.to(compute_dtype))
        shift, scale = cond[:, None, :].chunk(2, dim=-1)
        y = y * (1 + scale) + shift   # image rows are always modulated
    return y


def _head_linear(model, y, cfg: Config, v0: int):
    """The final linear restricted to the image vocabulary (rows v0:). An
    int8 head slices the rows of its (N, K) weight, which stay contiguous,
    and their scales and bias, and goes through ``qdot``."""
    lin = model.output_layer.linear
    dt = torch.bfloat16 if cfg.model.logits_dtype == "bfloat16" \
        else torch.float32
    if isinstance(lin, QLinear):
        return qdot(y, lin.weight_q[v0:], lin.scale[v0:],
                    bias=lin.bias[v0:], out_dtype=dt,
                    backend=cfg.model.quant_backend)
    return y.to(dt) @ lin.weight[v0:].to(dt).t() + lin.bias[v0:].to(dt)


def _img_head(model, hidden_img, c, cfg: Config, v0: int,
              compute_dtype=torch.bfloat16):
    return _head_linear(model, _head_pre(model, hidden_img, c, cfg,
                                         compute_dtype), cfg, v0)


def _sigma_cond(model, sigma, time_conditioning: bool = True,
                compute_dtype=torch.bfloat16):
    """The timestep conditioning vector c: the fp32 timestep MLP, rounded
    to `compute_dtype`, then silu."""
    if not time_conditioning:
        return None
    mlp = model.sigma_map.mlp
    h = F.linear(timestep_features(sigma), mlp[0].weight.float(),
                 mlp[0].bias.float())
    h = F.silu(h)
    h = F.linear(h, mlp[2].weight.float(), mlp[2].bias.float())
    return silu(h.to(compute_dtype))


def img_log_weights_fn(model, config: Config) -> Callable:
    """(x (B, L), t (B,) fp32, modality (B, L), w (B,) or None) ->
    image-span log-weights (B, Li, img_vocab) fp32.

    `w` is the guidance weight on the device, or None for a step whose
    weight is zero for every row (or with CFG off): then only the
    conditional pass runs."""
    m = config.model
    noise = get_noise(config.noise)
    lt = m.txt_length
    v0 = m.text_vocab_size
    mask_index = m.mask_index

    def cond_only(x, sigma, modality):
        hidden = model.hidden(x, sigma, modality=modality)
        c = _sigma_cond(model, sigma, m.time_conditioning)
        return _img_head(model, hidden[:, lt:], c, config, v0)

    def img_log_weights(x, t, modality, w=None):
        sigma = noise.total(t)
        if w is None:
            return cond_only(x, sigma, modality).float()
        x_uncond = x.clone()
        x_uncond[:, :lt] = mask_index
        hidden = cfg_forward(model.hidden, x, x_uncond, sigma,
                             modality=modality)
        c = _sigma_cond(model, torch.cat([sigma, sigma], 0),
                        m.time_conditioning)
        # the head's linear is linear: combine the normalised and
        # modulated halves before it, one (B, Li, V) product instead of two
        y = _head_pre(model, hidden[:, lt:], c, config)
        yc, yu = y.chunk(2, dim=0)
        w = w[:, None, None].to(y.dtype)
        return _head_linear(model, (1 + w) * yc - w * yu, config,
                            v0).float()

    return img_log_weights


def img_log_weights_cached_fn(model, config: Config):
    """The conditioning-frozen variant of ``img_log_weights_fn``: the text
    rows are fixed conditioning, so their K/V are cached, and a step runs
    the trunk over the image rows alone against them. Under CFG the cache
    holds 2B rows, the conditional ones and those of the re-masked text,
    and the image rows of the two halves are the same input.

    Returns (cache_full, cache_step, frozen_txt_kv, frozen_step):
      cache_full(x, t, modality, kv, w) -> (raw, kv): a full forward that
        writes the whole cache (in place);
      cache_step(x, t, modality, kv, w) -> (raw, kv): the image rows,
        writing the cache's image region and reading all of it;
      frozen_txt_kv(kv) -> (fk, fv): the read-only text prefix, each
        (n_blocks, BB, Lt, H, D), an int8 cache dequantized to bf16 once;
      frozen_step(x, t, modality, frozen, w) -> raw: the image rows
        against the frozen prefix, writing nothing.
    raw is the (B, Li, img_vocab) fp32 CFG-combined log-weights; w is the
    (B,) guidance weight on the device (ignored with CFG off)."""
    m = config.model
    noise = get_noise(config.noise)
    lt = m.txt_length
    v0 = m.text_vocab_size
    mask_index = m.mask_index
    use_cfg = config.sampling.cfg is not None

    def head(hidden_img, sigma, w):
        c = _sigma_cond(model, sigma, m.time_conditioning)
        y = _head_pre(model, hidden_img, c, config)
        if use_cfg:
            yc, yu = y.chunk(2, dim=0)
            w = w[:, None, None].to(y.dtype)
            y = (1 + w) * yc - w * yu
        return _head_linear(model, y, config, v0).float()

    def doubled(sigma):
        return torch.cat([sigma, sigma], 0) if use_cfg else sigma

    def cache_full(x, t, modality, kv, w):
        sigma = noise.total(t)
        x_uncond = None
        if use_cfg:
            x_uncond = x.clone()
            x_uncond[:, :lt] = mask_index
        hidden, kv = cfg_forward(model.hidden, x, x_uncond, sigma,
                                 modality=modality, kv_cache=kv,
                                 cache_index=0)
        return head(hidden[:, lt:], doubled(sigma), w), kv

    def image_rows(x, t, modality, **kw):
        # the image rows of the two halves are the same input
        xi, sigma = x[:, lt:], noise.total(t)
        return cfg_forward(model.hidden, xi, xi if use_cfg else None, sigma,
                           modality=modality[:, lt:], cache_index=lt,
                           **kw), doubled(sigma)

    def cache_step(x, t, modality, kv, w):
        (hidden, kv), ss = image_rows(x, t, modality, kv_cache=kv)
        return head(hidden, ss, w), kv

    def frozen_txt_kv(kv):
        if len(kv) == 4:
            ckq, cks, cvq, cvs = kv
            return ((ckq[:, :, :lt].float() * cks[:, :, :lt]).bfloat16(),
                    (cvq[:, :, :lt].float() * cvs[:, :, :lt]).bfloat16())
        ck, cv = kv
        return ck[:, :, :lt], cv[:, :, :lt]

    def frozen_step(x, t, modality, frozen, w):
        hidden, ss = image_rows(x, t, modality, frozen_kv=frozen)
        return head(hidden, ss, w)

    return cache_full, cache_step, frozen_txt_kv, frozen_step


class T2ISampler:
    """The built text->image sampler (``build_t2i_sampler``).

    Called as ``sample(txt_tokens, *, generator=None, modality=None,
    injected=None)``. ``prepare``, ``denoise`` and ``finish`` are the three
    parts of that call: the upload of the inputs, the denoise loop (device
    work only, what ``sampling/graph.py`` captures) and the noise-removal
    pass after it."""

    capturable = True

    def __init__(self, model, config: Config, num_steps, return_trajectory,
                 inject_noise, cached_cond, cond_refresh, device):
        self.device = resolve_device(device)
        check_model_device(model, self.device)
        if cond_refresh < 0:
            raise ValueError(f"cond_refresh {cond_refresh} < 0")
        self.model, self.config = model, config
        m, s = config.model, config.sampling
        self.steps = num_steps or s.steps
        self.return_trajectory = return_trajectory
        self.inject_noise = inject_noise
        self.cached_cond, self.cond_refresh = cached_cond, cond_refresh
        self.use_cfg = s.cfg is not None
        if cached_cond:
            (self._cache_full, self._cache_step, self._frozen_txt_kv,
             self._frozen_step) = img_log_weights_cached_fn(model, config)
        else:
            self._weights = img_log_weights_fn(model, config)
        li = m.img_length
        self._group_of_pos = None
        self._n_groups = 1
        dilation = s.maskgit_dilation
        if dilation and dilation > 1:
            side = int(round(li ** 0.5))
            if side * side != li:
                raise ValueError(f"maskgit_dilation needs a square image "
                                 f"grid; img_length={li} is not a perfect "
                                 f"square")
            rr, cc = np.meshgrid(np.arange(side), np.arange(side),
                                 indexing="ij")
            self._group_of_pos = torch.from_numpy(
                ((rr % dilation) * dilation + (cc % dilation)).reshape(-1)
            ).to(self.device)
            self._n_groups = dilation * dilation
        self._plans: Dict[int, dict] = {}
        self.graphs: Dict[int, object] = {}   # sampling/graph.py's cache

    @property
    def frozen(self) -> bool:
        return self.cached_cond and self.cond_refresh == 0

    def plan(self, b: int) -> dict:
        """The host-known per-step values of a batch of b rows, on the
        device, built once per batch size: the schedule (B, steps), the
        timesteps (steps + 1, B) (the last row sampling_eps, for the
        noise-removal pass), the guidance weights (steps + 1, B) and which
        steps need the unconditional pass."""
        if b not in self._plans:
            s = self.config.sampling
            steps = self.steps
            timesteps = linspace_f32(1.0, s.sampling_eps, steps + 1)
            t_host = np.repeat(timesteps[:, None], b, axis=1)
            plan = {"schedule": upload(adaptive_schedule(
                        np.full((b,), self.config.model.img_length), steps,
                        s.maskgit_mode), self.device),
                    "t": upload(t_host, self.device), "w": None,
                    "guided": [False] * (steps + 1)}
            if self.use_cfg:
                w_host = np.stack([guidance_weight(s, t_host[i])
                                   for i in range(steps + 1)])
                plan["w"] = upload(w_host, self.device)
                plan["guided"] = [bool(np.any(w != 0)) for w in w_host]
            self._plans[b] = plan
        return self._plans[b]

    def prepare(self, txt_tokens, modality=None, injected=None) -> dict:
        """The inputs of one call as device tensors: "txt" (B, Lt),
        "modality" (B, L) and, with inject_noise, "gumbel_tok" and
        "gumbel_conf"."""
        if (injected is not None) != self.inject_noise:
            raise ValueError("pass `injected` exactly when the sampler was "
                             "built with inject_noise=True")
        m = self.config.model
        dev = self.device
        txt = torch.as_tensor(txt_tokens).to(dev, torch.long)
        b = txt.shape[0]
        if modality is None:
            modality = torch.cat([
                torch.zeros((b, m.txt_length), dtype=torch.long, device=dev),
                torch.ones((b, m.img_length), dtype=torch.long, device=dev)],
                -1)
        inputs = {"txt": txt,
                  "modality": torch.as_tensor(modality).to(dev, torch.long)}
        if self.inject_noise:
            for key in ("gumbel_tok", "gumbel_conf"):
                inputs[key] = torch.as_tensor(injected[key]).to(
                    dev, torch.float32)
        return inputs

    def example_inputs(self, b: int) -> dict:
        """Inputs of the right shapes for a batch of b rows, for a capture's
        warm-up."""
        m = self.config.model
        injected = None
        if self.inject_noise:
            injected = {"gumbel_tok": torch.zeros(
                            (self.steps, b, m.img_length,
                             m.image_vocab_size)),
                        "gumbel_conf": torch.zeros(
                            (self.steps, b, m.img_length))}
        return self.prepare(torch.zeros((b, m.txt_length),
                                        dtype=torch.long),
                            injected=injected)

    def _update(self, x, raw, i, p, inputs, generator):
        """One maskgit confidence update from the image-span
        log-weights at step i (a host int)."""
        m, s = self.config.model, self.config.sampling
        lt, mask_index = m.txt_length, m.mask_index
        t = p["t"][i]
        g = inputs["gumbel_tok"][i].to(raw.dtype) if self.inject_noise \
            else gumbel(raw.shape, generator, self.device).to(raw.dtype)
        pred_local = torch.argmax(raw + g, dim=-1)             # (B, Li)
        lse = torch.logsumexp(raw, dim=-1)
        conf = torch.gather(raw, -1, pred_local[..., None])[..., 0] - lse
        img = x[:, lt:]
        eligible = img == mask_index
        if (self._group_of_pos is not None
                and i < self.steps - self._n_groups):
            # rotate through the dilated groups; the last n_groups steps
            # are unrestricted so stragglers always finish
            eligible = eligible & (self._group_of_pos[None, :]
                                   == i % self._n_groups)
        num = torch.minimum(p["schedule"][:, i], eligible.sum(-1))
        gc = inputs["gumbel_conf"][i] if self.inject_noise \
            else gumbel(conf.shape, generator, self.device)
        conf = conf + s.maskgit_r_temp * gc * t[:, None]
        conf = torch.where(eligible, conf, float("-inf"))
        thresh = confidence_threshold(conf, num)
        img_next = torch.where((conf >= thresh) & eligible,
                               pred_local + m.text_vocab_size, img)
        return torch.cat([x[:, :lt], img_next], -1)

    def _raw(self, i, x, p, modality, state):
        """The image-span log-weights at step i (i == steps: the
        noise-removal pass, at sampling_eps): (raw, state)."""
        t = p["t"][i]
        w = p["w"][i] if self.use_cfg else None
        if not self.cached_cond:
            return self._weights(x, t, modality,
                                 w if p["guided"][i] else None), state
        if self.frozen:
            return self._frozen_step(x, t, modality, state, w), state
        if i < self.steps and i % self.cond_refresh == 0:
            return self._cache_full(x, t, modality, state, w)
        return self._cache_step(x, t, modality, state, w)

    def denoise(self, inputs, generator=None):
        """The denoise loop: (x (B, L), state). state holds "cache", what
        the noise-removal pass reads (the frozen text K/V, the cache, or
        None), and "traj", the token state after each step when the
        sampler returns its trajectory."""
        m = self.config.model
        txt, modality = inputs["txt"], inputs["modality"]
        b = txt.shape[0]
        p = self.plan(b)
        x = torch.cat([txt, torch.full((b, m.img_length), m.mask_index,
                                       dtype=torch.long, device=txt.device)],
                      -1)
        state = None
        if self.cached_cond:
            state = init_kv_cache_for(m, 2 * b if self.use_cfg else b,
                                      m.length, device=txt.device)
        traj = []
        first = 0
        if self.frozen:
            # the one full pass sees the initial state: it builds the
            # cache and runs step 0's update; later steps read the text
            # K/V only
            raw0, kv = self._cache_full(x, p["t"][0], modality, state,
                                        p["w"][0] if self.use_cfg else None)
            state = self._frozen_txt_kv(kv)
            del kv
            x = self._update(x, raw0, 0, p, inputs, generator)
            traj.append(x)
            first = 1
        for i in range(first, self.steps):
            raw, state = self._raw(i, x, p, modality, state)
            x = self._update(x, raw, i, p, inputs, generator)
            traj.append(x)
        return x, {"cache": state,
                   "traj": traj if self.return_trajectory else []}

    def finish(self, x, state, inputs) -> SampleResult:
        """Noise removal: the arccos schedule unmasks everything, so this
        pass runs only in the degenerate all-clamped case. Reads the
        device once."""
        m = self.config.model
        lt = m.txt_length
        any_left = bool((x[:, lt:] == m.mask_index).any())
        if any_left:
            p = self.plan(x.shape[0])
            raw, _ = self._raw(self.steps, x, p, inputs["modality"],
                               state["cache"])
            img = x[:, lt:]
            img = torch.where(img == m.mask_index,
                              torch.argmax(raw, -1) + m.text_vocab_size, img)
            x = torch.cat([x[:, :lt], img], -1)
        return SampleResult(tokens=x, nfe=self.steps + int(any_left))

    @torch.inference_mode()
    def __call__(self, txt_tokens, *, generator: Optional[torch.Generator]
                 = None, modality=None, injected=None):
        inputs = self.prepare(txt_tokens, modality, injected)
        x, state = self.denoise(inputs, generator)
        result = self.finish(x, state, inputs)
        if self.return_trajectory:
            return result, torch.stack(state["traj"])
        return result


def build_t2i_sampler(model, config: Config,
                      num_steps: Optional[int] = None,
                      return_trajectory: bool = False,
                      inject_noise: bool = False,
                      cached_cond: bool = False,
                      cond_refresh: int = 0,
                      device="cuda") -> T2ISampler:
    """sample(txt_tokens (B, txt_len), *, generator=None, modality=None,
    injected=None) -> SampleResult over the full [txt | img] sequence.

    return_trajectory=True also returns the (steps, B, L) token state
    after every denoise step.

    inject_noise=True: `sample` takes an `injected` dict instead of drawing
    from `generator`: "gumbel_tok" (steps, B, Li, img_vocab) token-pick
    Gumbel noise and "gumbel_conf" (steps, B, Li) confidence noise, the
    same contract as the JAX sampler, so the two can be held token for
    token.

    cached_cond=True: conditioning-frozen sampling (module docstring);
    cond_refresh=1 rebuilds the cache every step, which gives the tokens of
    cached_cond=False.

    The model must already be on `device` and in eval mode.
    """
    return T2ISampler(model, config, num_steps, return_trajectory,
                      inject_noise, cached_cond, cond_refresh, device)
