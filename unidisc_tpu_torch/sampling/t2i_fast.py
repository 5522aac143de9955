"""Text->image sampler with the span-factored vocab head (port of
``unidisc_tpu/sampling/t2i_fast.py``).

The text span is fixed conditioning and the image span is generated, so
the trunk runs without its vocab head (``DIT.hidden``) and the final
layer is applied only over the image rows and only against the image
slice of the vocabulary. Maskgit confidence updates run on the image span.

The denoise loop makes no host round trip: timesteps, guidance weights
and the unmasking schedule are known on the host before the loop and are
uploaded once, and a step whose guidance weight is zero for every row
skips the unconditional pass by a host decision. The one check for
leftover mask tokens after the loop reads the device once per sample.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.device import resolve_device
from unidisc_tpu_torch.diffusion.noise import get_noise
from unidisc_tpu_torch.models.dit import QLinear, silu, timestep_features
from unidisc_tpu_torch.ops.quant import qdot
from unidisc_tpu_torch.sampling.sampler import (SampleResult,
                                                adaptive_schedule,
                                                confidence_threshold,
                                                guidance_weight,
                                                linspace_f32)


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
        xx = torch.cat([x, x_uncond], 0)
        ss = torch.cat([sigma, sigma], 0)
        mm = torch.cat([modality, modality], 0)
        hidden = model.hidden(xx, ss, modality=mm)
        c = _sigma_cond(model, ss, m.time_conditioning)
        # the head's linear is linear: combine the normalised and
        # modulated halves before it, one (B, Li, V) product instead of two
        y = _head_pre(model, hidden[:, lt:], c, config)
        yc, yu = y.chunk(2, dim=0)
        w = w[:, None, None].to(y.dtype)
        return _head_linear(model, (1 + w) * yc - w * yu, config,
                            v0).float()

    return img_log_weights


def _check_model_device(model, dev: torch.device) -> None:
    p = next(model.parameters())
    if p.device.type != dev.type or (dev.index is not None
                                     and p.device.index != dev.index):
        raise ValueError(f"the model's parameters are on {p.device}, the "
                         f"sampler runs on {dev}; move the model first")


def build_t2i_sampler(model, config: Config,
                      num_steps: Optional[int] = None,
                      return_trajectory: bool = False,
                      inject_noise: bool = False,
                      cached_cond: bool = False,
                      cond_refresh: int = 0,
                      device="cuda") -> Callable:
    """sample(txt_tokens (B, txt_len), *, generator=None, modality=None,
    injected=None) -> SampleResult over the full [txt | img] sequence.

    return_trajectory=True also returns the (steps, B, L) token state
    after every denoise step.

    inject_noise=True: `sample` takes an `injected` dict instead of drawing
    from `generator`: "gumbel_tok" (steps, B, Li, img_vocab) token-pick
    Gumbel noise and "gumbel_conf" (steps, B, Li) confidence noise, the
    same contract as the JAX sampler, so the two can be held token for
    token.

    The model must already be on `device` and in eval mode.
    """
    if cached_cond or cond_refresh:
        raise NotImplementedError(
            "cached_cond (conditioning-frozen sampling) is not in the port "
            "yet (ROADMAP queue 1, item 3)")
    dev = resolve_device(device)
    _check_model_device(model, dev)
    m = config.model
    s = config.sampling
    steps = num_steps or s.steps
    lt, li = m.txt_length, m.img_length
    v0 = m.text_vocab_size
    mask_index = m.mask_index
    img_log_weights = img_log_weights_fn(model, config)

    dilation = s.maskgit_dilation
    group_of_pos = None
    n_groups = 1
    if dilation and dilation > 1:
        side = int(round(li ** 0.5))
        if side * side != li:
            raise ValueError(f"maskgit_dilation needs a square image grid; "
                             f"img_length={li} is not a perfect square")
        rr, cc = np.meshgrid(np.arange(side), np.arange(side),
                             indexing="ij")
        group_of_pos = torch.from_numpy(
            ((rr % dilation) * dilation + (cc % dilation)).reshape(-1)
        ).to(dev)
        n_groups = dilation * dilation

    def gumbel(shape, generator):
        e = torch.empty(shape, device=dev).exponential_(generator=generator)
        return -torch.log(e)

    @torch.inference_mode()
    def sample(txt_tokens, *, generator: Optional[torch.Generator] = None,
               modality=None, injected=None):
        if (injected is not None) != inject_noise:
            raise ValueError("pass `injected` exactly when the sampler was "
                             "built with inject_noise=True")
        txt = torch.as_tensor(txt_tokens).to(dev, torch.long)
        b = txt.shape[0]
        if modality is None:
            modality = torch.cat([
                torch.zeros((b, lt), dtype=torch.long, device=dev),
                torch.ones((b, li), dtype=torch.long, device=dev)], -1)
        else:
            modality = torch.as_tensor(modality).to(dev, torch.long)
        x = torch.cat([txt, torch.full((b, li), mask_index,
                                       dtype=torch.long, device=dev)], -1)
        if inject_noise:
            g_tok = torch.as_tensor(injected["gumbel_tok"]).to(dev)
            g_conf = torch.as_tensor(injected["gumbel_conf"]).to(dev)

        # host-known per-step values, uploaded once
        schedule = torch.from_numpy(
            adaptive_schedule(np.full((b,), li), steps, s.maskgit_mode)
        ).to(dev)
        timesteps = linspace_f32(1.0, s.sampling_eps, steps + 1)
        t_host = np.repeat(timesteps[:, None], b, axis=1)  # (steps+1, B)
        t_all = torch.from_numpy(t_host).to(dev)
        t_eps = torch.full((b,), s.sampling_eps, dtype=torch.float32,
                           device=dev)
        w_dev, guided = None, [False] * steps
        if s.cfg is not None:
            w_host = np.stack([guidance_weight(s, t_host[i])
                               for i in range(steps)]
                              + [guidance_weight(s, np.full((b,), s.sampling_eps,
                                                         np.float32))])
            guided = [bool(np.any(w_host[i] != 0)) for i in range(steps + 1)]
            w_dev = torch.from_numpy(w_host).to(dev)

        def weights(i, x, t):
            return img_log_weights(x, t, modality,
                                   w_dev[i] if guided[i] else None)

        def update(x, raw, t, i):
            g = g_tok[i].to(raw.dtype) if inject_noise \
                else gumbel(raw.shape, generator).to(raw.dtype)
            pred_local = torch.argmax(raw + g, dim=-1)             # (B, Li)
            lse = torch.logsumexp(raw, dim=-1)
            conf = torch.gather(raw, -1, pred_local[..., None])[..., 0] - lse
            img = x[:, lt:]
            eligible = img == mask_index
            if group_of_pos is not None and i < steps - n_groups:
                # rotate through the dilated groups; the last n_groups
                # steps are unrestricted so stragglers always finish
                eligible = eligible & (group_of_pos[None, :]
                                       == i % n_groups)
            num = torch.minimum(schedule[:, i], eligible.sum(-1))
            gc = g_conf[i] if inject_noise else gumbel(conf.shape, generator)
            conf = conf + s.maskgit_r_temp * gc * t[:, None]
            conf = torch.where(eligible, conf, float("-inf"))
            thresh = confidence_threshold(conf, num)
            img_next = torch.where((conf >= thresh) & eligible,
                                   pred_local + v0, img)
            return torch.cat([x[:, :lt], img_next], -1)

        traj = []
        for i in range(steps):
            t = t_all[i]
            x = update(x, weights(i, x, t), t, i)
            if return_trajectory:
                traj.append(x)

        # noise removal: the arccos schedule unmasks everything, so this
        # pass runs only in the degenerate all-clamped case
        any_left = bool((x[:, lt:] == mask_index).any())
        if any_left:
            raw = weights(steps, x, t_eps)
            img = x[:, lt:]
            img = torch.where(img == mask_index,
                              torch.argmax(raw, -1) + v0, img)
            x = torch.cat([x[:, :lt], img], -1)
        result = SampleResult(tokens=x, nfe=steps + int(any_left))
        if return_trajectory:
            return result, torch.stack(traj)
        return result

    return sample

