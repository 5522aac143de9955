"""Evaluation harness: generation battery, speed eval, quality metrics
(port of ``unidisc_tpu/eval/harness.py``).

Judges are pluggable callables; the NLL / likelihood scoring runs on the
model's device. The JAX package's ``lax.scan`` over timesteps is a loop,
and its ``jax.random`` draws come from a ``torch.Generator``, or, for the
tests that hold these functions to the JAX package, from ``draws``: one
``diffusion/forward_process.py`` draws dict a timestep (the "move"
uniforms of q_xt), the JAX package's numbers replayed.

apply_fn(params, x, sigma, modality) -> logits, as in the JAX package;
``model_apply_fn`` makes one of a port DIT (params None: its own
weights).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.diffusion.forward_process import (Draws,
                                                         draw_uniform, q_xt)
from unidisc_tpu_torch.diffusion.noise import get_noise
from unidisc_tpu_torch.diffusion.subs import subs_log_p_at

LN2 = float(np.log(2.0))


def model_apply_fn(config: Config, model) -> Callable:
    """apply_fn(params, x, sigma, modality) of a port DIT in eval mode."""
    from unidisc_tpu_torch.training.train_state import make_apply_fn
    fn = make_apply_fn(config, model)
    return lambda p, x, sigma, modality: fn(p, x, sigma, modality, False)


# ---------------------------------------------------------------------------
# Speed eval (reference: model_eval.py:983-1014; warmup excluded)
# ---------------------------------------------------------------------------

def speed_eval(sample_fn, args, *, iters: int = 5, warmup: int = 1,
               tokens_per_sample: int, batch: int) -> Dict[str, float]:
    """Times a sampler (on the card its captured program). Each timed call
    ends with the tokens read to the host, so the clock stops when the
    device has finished, not when the launches have been queued."""
    nfe = 0
    for _ in range(warmup):
        out = sample_fn(*args)
        out.tokens.cpu()
    lat: List[float] = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = sample_fn(*args)
        out.tokens.cpu()
        lat.append(time.perf_counter() - t0)
        nfe = int(out.nfe)
    lat.sort()
    p50 = lat[len(lat) // 2]
    return {
        "p50_latency_s": p50,
        "avg_time_per_sample": sum(lat) / len(lat) / batch,
        "avg_time_per_token": sum(lat) / len(lat) / (batch *
                                                     tokens_per_sample),
        "tokens_per_sec": batch * tokens_per_sample * len(lat) / sum(lat),
        "avg_nfe_cnt": float(nfe),
    }


# ---------------------------------------------------------------------------
# Quality metrics
# ---------------------------------------------------------------------------

def token_entropy(token_ids: np.ndarray, vocab_size: int) -> float:
    """Empirical unigram entropy of generations (reference entropy metric,
    model_eval.py:1590-1733)."""
    counts = np.bincount(np.asarray(token_ids).reshape(-1),
                         minlength=vocab_size).astype(np.float64)
    p = counts / counts.sum()
    p = p[p > 0]
    return float(-(p * np.log(p)).sum())


@torch.no_grad()
def generative_perplexity(judge_logits_fn: Callable, token_ids,
                          *, eos_id: Optional[int] = None) -> float:
    """PPL of generated sequences under a judge LM
    (judge_logits_fn(ids (B, L)) -> logits (B, L, V), causal)."""
    ids = torch.as_tensor(np.asarray(token_ids)).long()
    logits = judge_logits_fn(ids)
    logp = torch.log_softmax(logits[:, :-1].float(), -1)
    tgt = ids[:, 1:].to(logp.device)
    nll = -logp.gather(-1, tgt[..., None]).squeeze(-1)
    mask = torch.ones_like(tgt, dtype=torch.bool) if eos_id is None \
        else tgt != eos_id
    ppl = torch.exp((nll * mask).sum() / mask.sum().clamp(min=1))
    return float(ppl)


# ---------------------------------------------------------------------------
# Model likelihood scoring (zero-shot classification)
# ---------------------------------------------------------------------------

def _log_p_at(config: Config, logits, xt, x0, modality):
    m = config.model
    return subs_log_p_at(
        logits.float(), xt, x0, m.mask_index,
        modality=modality if m.force_argmax_valid_indices else None,
        text_vocab_size=m.text_vocab_size)


def _step_draws(draws, i) -> Draws:
    return None if draws is None else draws[i]


@torch.no_grad()
def sequence_nll(config: Config, apply_fn, params, batch,
                 generator: Optional[torch.Generator] = None,
                 *, n_timesteps: int = 8,
                 draws: Optional[Sequence[Draws]] = None) -> torch.Tensor:
    """Monte-Carlo NELBO estimate of -log p(x) per sequence on the
    deterministic t-grid linspace(0.08, 0.92, n_timesteps); the model's own
    likelihood score for zero-shot matching. draws: one q_xt draws dict a
    timestep, else `generator`."""
    m = config.model
    noise = get_noise(config.noise)
    x0 = torch.as_tensor(batch["input_ids"]).long()
    modality = batch.get("modality")
    if modality is not None:
        modality = torch.as_tensor(modality).to(x0.device)
    b = x0.shape[0]
    ts = np.linspace(0.08, 0.92, n_timesteps, dtype=np.float32)
    total = torch.zeros(b, device=x0.device)
    for i, t in enumerate(ts):
        tt = torch.full((b,), float(t), device=x0.device)
        sigma = noise.total(tt)
        dsigma = noise.rate(tt)
        mc = 1 - torch.exp(-sigma)
        corr = q_xt(x0, mc, m.mask_index, modality=modality,
                    draws=_step_draws(draws, i), generator=generator)
        logits = apply_fn(params, corr.xt, sigma, modality)
        tok = _log_p_at(config, logits, corr.xt, x0, modality)
        w = (dsigma / torch.expm1(sigma))[:, None]
        total = total + (-tok * w * corr.move_indices).sum(-1)
    return total / n_timesteps


@torch.no_grad()
def zero_shot_similarity(config: Config, apply_fn, params, batch,
                         generator: Optional[torch.Generator] = None,
                         *, n_timesteps: Optional[int] = None,
                         txt_cond: bool = True,
                         cfg_w: Optional[float] = None,
                         force_cfg_value: bool = False,
                         do_unconditional: bool = False,
                         unweighed: bool = False,
                         pad_id: int = 0,
                         draws: Optional[Sequence[Draws]] = None
                         ) -> torch.Tensor:
    """The reference's zero-shot similarity scorer (get_similarity,
    model_eval.py:268-340), as the JAX package computes it: per timestep
    on the interior grid linspace(0, 1, steps+2)[1:-1], corrupt with
    q_xt, clamp the conditioning span (skipped when do_unconditional),
    optionally CFG-combine raw logits with w = cfg*(1-t), SUBS log-probs
    gathered at x0, pad and conditioned positions zeroed, weighted by
    dsigma/expm1(sigma) (unless unweighed), normalized per row by the
    non-pad count, averaged over timesteps. Returns (B,) NLL-like scores
    (lower = more likely pairing).

    As in the reference, the non-CFG path applies the SUBS carry-over
    against the clamped input and the CFG path against the unclamped xt.
    """
    m = config.model
    noise = get_noise(config.noise)
    x0 = torch.as_tensor(batch["input_ids"]).long()
    dev = x0.device
    modality = batch.get("modality")
    if modality is not None:
        modality = torch.as_tensor(modality).to(dev)
    b, length = x0.shape
    steps = n_timesteps or config.sampling.steps
    times = np.linspace(0.0, 1.0, steps + 2, dtype=np.float32)[1:-1]

    pos = torch.arange(length, device=dev)[None, :]
    cond_mask = (pos < m.txt_length) if txt_cond else (pos >= m.txt_length)
    cond_mask = cond_mask.expand(b, length)
    pad_mask = x0 == pad_id
    total = torch.zeros(b, device=dev)
    for i in range(steps):
        t = torch.full((b,), float(times[i]), device=dev)
        sigma = noise.total(t)
        dsigma = noise.rate(t)
        mc = 1 - torch.exp(-sigma)
        xt = q_xt(x0, mc, m.mask_index, modality=modality,
                  draws=_step_draws(draws, i), generator=generator).xt
        cond = xt if do_unconditional else torch.where(cond_mask, x0, xt)
        # the reference passes no conditioning here, which runs only for
        # untimed models; a time-conditioned model gets the real sigma
        sig_in = sigma if m.time_conditioning else None
        if cfg_w is not None:
            uncond = torch.where(cond_mask, m.mask_index, xt)
            logit_c = apply_fn(params, cond, sig_in, modality).float()
            logit_u = apply_fn(params, uncond, sig_in, modality).float()
            w = cfg_w if force_cfg_value else (cfg_w * (1 - t))[:, None,
                                                                None]
            tok = _log_p_at(config, (1 + w) * logit_c - w * logit_u, xt,
                            x0, modality)
        else:
            tok = _log_p_at(config, apply_fn(params, cond, sig_in,
                                             modality), cond, x0, modality)
        tok = torch.where(pad_mask, 0.0, tok)
        if not do_unconditional:
            tok = torch.where(cond_mask, 0.0, tok)
        w_std = 1.0 if unweighed else (dsigma / torch.expm1(sigma))[:, None]
        total = total + (-tok * w_std).sum(-1) / (~pad_mask).sum(-1)
    return total / steps


def zero_shot_accuracy(config: Config, apply_fn, params, seed: int,
                       pair_batches: List[dict], *,
                       scorer: str = "similarity", device="cpu",
                       **scorer_kw) -> float:
    """Image-text matching: for each item, candidate 0 is the true pairing;
    accuracy = fraction where the model assigns it the lowest NLL
    (reference: winoground / datacomp zero-shot evals). scorer:
    "similarity" (zero_shot_similarity) or "nelbo" (sequence_nll). Every
    candidate is scored under the same noise (a generator reseeded with
    `seed` on `device`, or the same injected ``draws``), as the JAX
    package scores them all under one key."""
    correct = 0
    total = 0
    for batch_set in pair_batches:
        nlls = []
        for cand in batch_set["candidates"]:
            gen = torch.Generator(device=device).manual_seed(seed)
            if scorer == "similarity":
                score = zero_shot_similarity(config, apply_fn, params,
                                             cand, gen, **scorer_kw)
            else:
                score = sequence_nll(config, apply_fn, params, cand, gen,
                                     draws=scorer_kw.get("draws"))
            nlls.append(score.cpu().numpy())
        nlls = np.stack(nlls, 1)  # (B, n_candidates)
        correct += (nlls.argmin(1) == 0).sum()
        total += nlls.shape[0]
    return correct / max(total, 1)


# ---------------------------------------------------------------------------
# Generation battery
# ---------------------------------------------------------------------------

def generation_battery(engine, *, seeds=(0, 1), steps: Optional[int] = None
                       ) -> Dict[str, dict]:
    """Uncond / cond generation sweep (reference:
    on_validation_epoch_end generation loop model_eval.py:886-1162)."""
    out = {}
    for seed in seeds:
        out[f"joint_{seed}"] = engine.run(task="joint", seed=seed,
                                          steps=steps)
        out[f"gen_image_{seed}"] = engine.run(text="sample prompt",
                                              seed=seed, steps=steps)
    return {k: {"nfe": v["nfe"], "text": v["text"][:50]}
            for k, v in out.items()}


# ---------------------------------------------------------------------------
# Masked-infill battery (reference: sample_masking model_eval.py:1836)
# ---------------------------------------------------------------------------

def mask_text_region(move: torch.Tensor, x: torch.Tensor, txt_length: int,
                     eos_id: int, u_d: torch.Tensor, u_s: torch.Tensor
                     ) -> torch.Tensor:
    """The text span's mask replaced by one contiguous region a row,
    bounded by the first EOS (JAX forward_process.mask_text_region):
    max_valid = first EOS (or txt_length, at least 2); length
    d = lo + u_d (hi - lo + 1) with lo = max_valid // 3, hi = max_valid - 1,
    clipped to [1, hi]; start = u_s (max_valid - d + 1)."""
    txt = x[:, :txt_length]
    is_eos = txt == eos_id
    first = torch.where(is_eos.any(-1), is_eos.int().argmax(-1),
                        txt_length).clamp(min=2)
    lo, hi = first // 3, first - 1
    d = (lo + u_d * (hi - lo + 1)).to(torch.int32)
    d = torch.minimum(d.clamp(min=1), hi)
    start = (u_s * (first - d + 1)).to(torch.int32)
    pos = torch.arange(txt_length, device=x.device)[None]
    out = move.clone()
    out[:, :txt_length] = (pos >= start[:, None]) & \
        (pos < (start + d)[:, None])
    return out


def mask_image_square(move: torch.Tensor, img_start: int, img_length: int,
                      d: torch.Tensor, u_i: torch.Tensor, u_j: torch.Tensor
                      ) -> torch.Tensor:
    """The image span's mask replaced by a square of side d (in
    [side // 2, side - 2]) at row u_i (side - d + 1), column
    u_j (side - d + 1) (JAX forward_process.mask_image_square)."""
    b = move.shape[0]
    side = int(round(img_length ** 0.5))
    assert side * side == img_length, "img_length must be a square"
    d = d.reshape(b, 1, 1).to(torch.int32)
    i0 = (u_i.reshape(b, 1, 1) * (side - d + 1)).to(torch.int32)
    j0 = (u_j.reshape(b, 1, 1) * (side - d + 1)).to(torch.int32)
    rows = torch.arange(side, device=move.device).reshape(1, side, 1)
    cols = torch.arange(side, device=move.device).reshape(1, 1, side)
    sq = (rows >= i0) & (rows < i0 + d) & (cols >= j0) & (cols < j0 + d)
    out = move.clone()
    out[:, img_start:img_start + img_length] = sq.reshape(b, img_length)
    return out


def infill_battery(sample_fn, batch: dict, config: Config,
                   generator: Optional[torch.Generator] = None,
                   *, txt_mask_rate: float = 0.5,
                   square_image_mask: bool = True,
                   text_region_mask: bool = True,
                   eos_id: Optional[int] = None,
                   draws: Draws = None) -> dict:
    """Regenerate masked regions of real data: a random contiguous text
    region (bounded by the first EOS) + a random square of the image grid,
    as the reference's sample_masking battery. Returns original /
    conditioning-mask / regenerated token arrays.

    sample_fn(x0, x0_unmask, modality) -> SampleResult (a sampler with its
    own noise). draws: "move" (B, L) and "img_move" (B, L) uniforms,
    "region_d" / "region_start" (B,) uniforms, "square_d" (B,) ints,
    "square_i" / "square_j" (B,) uniforms; a missing one comes from
    `generator`."""
    m = config.model
    x0 = torch.as_tensor(batch["input_ids"]).long()
    modality = torch.as_tensor(batch["modality"]).to(x0.device)
    b, dev = x0.shape[0], x0.device

    def u(name, shape):
        return draw_uniform(draws, name, shape, generator, dev)

    move = (u("move", tuple(x0.shape)) < txt_mask_rate) & (modality == 0)
    if text_region_mask:
        move = mask_text_region(
            move, x0, m.txt_length,
            m.text_vocab_size - 2 if eos_id is None else eos_id,
            u("region_d", (b,)), u("region_start", (b,)))
    if square_image_mask:
        side = int(round(m.img_length ** 0.5))
        if draws is not None and "square_d" in draws:
            d = draws["square_d"].to(dev)
        else:
            d = torch.randint(side // 2, side - 1, (b,), generator=generator,
                              device=dev)
        move = mask_image_square(move, m.txt_length, m.img_length, d,
                                 u("square_i", (b,)), u("square_j", (b,)))
    else:
        move = move | (u("img_move", tuple(x0.shape)) < 0.5) \
            & (modality == 1)
    x0_unmask = ~move

    out = sample_fn(x0, x0_unmask, modality)
    tokens = out.tokens.cpu().numpy()
    x0_h, move_h = x0.cpu().numpy(), move.cpu().numpy()
    recon_match = float((tokens == x0_h)[move_h].mean())
    return {
        "original": x0_h,
        "masked": np.where(move_h, -1, x0_h),
        "regenerated": tokens,
        "mask": move_h,
        "nfe": int(out.nfe),
        # fraction of masked tokens regenerated to the original value --
        # a cheap reconstruction-fidelity signal (not a quality metric)
        "masked_token_match": recon_match,
    }
