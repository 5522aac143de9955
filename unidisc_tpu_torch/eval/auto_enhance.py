"""Auto-enhance: zero-shot editing by partial re-masking + reward re-ranking
(port of ``unidisc_tpu/eval/auto_enhance.py``).

The reference's editing loop (model_eval.py:3729-3970): gaussian-mean
partial masking rates txt ~ N(0.85, 0.24) / img ~ N(0.95, 0.024), N
candidate regenerations, reward scoring, best-of re-ranking with the
original kept as a candidate. As the JAX package regenerates all K
candidates in one vmapped program, the port stacks them into one sampler
call of K x B rows (on the card one captured program at that batch).

Noise: a ``torch.Generator``, or ``draws`` (the tests replay the JAX
package's numbers): partial_remask's "txt_rate" / "img_rate" (B, 1)
standard normals and "txt_move" (B, Lt) / "img_move" (B, Li) uniforms.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.diffusion.forward_process import Draws, draw_uniform


def partial_remask(batch_size: int, txt_length: int, img_length: int,
                   generator: Optional[torch.Generator] = None, *,
                   mean_txt: float = 0.85, std_txt: float = 0.2 / 0.8416,
                   mean_img: float = 0.95, std_img: float = 0.04 / 1.645,
                   device="cpu", draws: Draws = None) -> torch.Tensor:
    """Per-row masking rates and the boolean re-mask maps (reference:
    model_eval.py:3809-3838). Returns x0_unmask (True = keep)."""
    def normal(name):
        if draws is not None and name in draws:
            return draws[name].to(device, torch.float32)
        return torch.randn((batch_size, 1), generator=generator,
                           device=device)

    t_txt = (mean_txt + std_txt * normal("txt_rate")).clamp(max=1.0)
    t_img = (mean_img + std_img * normal("img_rate")).clamp(max=1.0)
    move_txt = draw_uniform(draws, "txt_move", (batch_size, txt_length),
                            generator, device) < t_txt
    move_img = draw_uniform(draws, "img_move", (batch_size, img_length),
                            generator, device) < t_img
    return ~torch.cat([move_txt, move_img], dim=-1)


def _best_of(tokens, base_reward, cand_tokens, cand_rewards):
    """The original and the K candidates: per row the highest reward
    (the first on a tie). Returns (best (B, L), rewards (K + 1, B))."""
    all_tokens = torch.cat([tokens[None], cand_tokens], 0)
    all_rewards = torch.cat([base_reward[None], cand_rewards], 0)
    best = all_rewards.argmax(0)                       # (B,)
    idx = best[None, :, None].expand(1, *tokens.shape)
    return all_tokens.gather(0, idx)[0], all_rewards


def _rewards(reward_fn, tokens) -> torch.Tensor:
    """reward_fn's scores as a float64 CPU tensor."""
    r = reward_fn(tokens)
    if torch.is_tensor(r):
        r = r.detach().cpu()
    return torch.as_tensor(np.asarray(r, np.float64))


def build_auto_enhance(sample_fn: Callable, config: Config,
                       reward_fn: Callable, *, n_candidates: int = 4,
                       use_low_masking: bool = False) -> Callable:
    """enhance(tokens (B, L), modality (B, L), generator=None, draws=None)
    -> (best_tokens (B, L), rewards (K + 1, B)).

    sample_fn(x0, x0_unmask, modality) -> SampleResult, called once on
    the K x B candidate rows (candidate-major). reward_fn(tokens (N, L)) ->
    (N,) scores: model likelihood, CLIP, aesthetic, or any weighted
    combination. draws: one partial_remask draws dict a candidate."""
    m = config.model
    img_kw = {}
    if use_low_masking:
        img_kw = dict(mean_img=0.75, std_img=0.04 / 1.645)

    def enhance(tokens, modality, generator=None,
                draws: Optional[Sequence[Draws]] = None):
        tokens = torch.as_tensor(tokens).long()
        modality = torch.as_tensor(modality).to(tokens.device)
        b, k = tokens.shape[0], n_candidates
        base_reward = _rewards(reward_fn, tokens)
        keep = torch.cat([partial_remask(
            b, m.txt_length, m.img_length, generator, device=tokens.device,
            draws=None if draws is None else draws[c], **img_kw)
            for c in range(k)])                        # (K B, L)
        out = sample_fn(tokens.repeat(k, 1), keep, modality.repeat(k, 1))
        cand = out.tokens.to(tokens.device)
        cand_rewards = _rewards(reward_fn, cand).reshape(k, b)
        return _best_of(tokens.cpu(), base_reward,
                        cand.cpu().reshape(k, b, -1), cand_rewards)

    return enhance


def build_caption_enhance(sample_fn: Callable, config: Config,
                          reward_fn: Callable, tokenizer, augmenter,
                          *, max_augmentations: int = 10) -> Callable:
    """Caption-augmented enhance: regenerate the image span under caption
    variants and keep the best-scoring candidate (reference
    model_eval.py:3755-3800: decode the captions, augment each, tokenize
    each variant into the text span, regenerate, score). The augmenter
    comes from utils/caption_llm.get_caption_augmenter; the K variant
    regenerations run as one sampler call of K x B rows.

    Returns enhance(tokens, modality) -> (best_tokens (B, L),
    rewards (K + 1, B), variant_captions list[list[str]])."""
    from unidisc_tpu_torch.utils.caption_llm import augment_batch

    m = config.model

    def enhance(tokens, modality):
        tokens = torch.as_tensor(tokens).long()
        modality = torch.as_tensor(modality).to(tokens.device)
        b = tokens.shape[0]
        captions = tokenizer.batch_decode(
            tokens[:, :m.txt_length].cpu().numpy())
        variants = augment_batch(augmenter, captions,
                                 max_per_caption=max_augmentations,
                                 shuffle_seed=0)
        k = min(len(v) for v in variants)
        txt = np.stack([
            tokenizer([v[j] for v in variants],
                      max_length=m.txt_length)["input_ids"]
            for j in range(k)])                        # (K, B, Lt)
        variant_tokens = torch.cat([
            torch.as_tensor(txt).long().to(tokens.device),
            tokens[None, :, m.txt_length:].expand(k, b, m.img_length)],
            -1).reshape(k * b, -1)
        # keep the (new) text span, regenerate the whole image span
        keep = torch.cat([
            torch.ones((k * b, m.txt_length), dtype=torch.bool),
            torch.zeros((k * b, m.img_length), dtype=torch.bool)],
            -1).to(tokens.device)
        out = sample_fn(variant_tokens, keep, modality.repeat(k, 1))
        cand = out.tokens.to(tokens.device)
        cand_rewards = _rewards(reward_fn, cand).reshape(k, b)
        best, rewards = _best_of(tokens.cpu(), _rewards(reward_fn, tokens),
                                 cand.cpu().reshape(k, b, -1), cand_rewards)
        return best, rewards, variants

    return enhance


def model_likelihood_reward(config: Config, apply_fn, params=None,
                            seed: int = 0, device="cpu",
                            draws=None) -> Callable:
    """Reward = negative NELBO estimate (higher = more likely under the
    model), 4 timesteps, every call under the same noise; the default
    judge when external reward models are offline."""
    from unidisc_tpu_torch.eval.harness import sequence_nll

    def reward(tokens) -> np.ndarray:
        tokens = torch.as_tensor(tokens).long().to(device)
        b = tokens.shape[0]
        modality = torch.cat([
            torch.zeros((b, config.model.txt_length), dtype=torch.long),
            torch.ones((b, config.model.img_length), dtype=torch.long)],
            -1).to(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return -sequence_nll(config, apply_fn, params,
                             {"input_ids": tokens, "modality": modality},
                             gen, n_timesteps=4,
                             draws=draws).cpu().numpy()
    return reward
