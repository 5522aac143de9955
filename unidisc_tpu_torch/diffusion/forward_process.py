"""Forward (corruption) process for absorbing-state masked diffusion (port
of ``unidisc_tpu/diffusion/forward_process.py``).

Random draws are injectable: every function takes its uniforms (and, in
uniform mode, its random tokens) as tensors in ``draws``, or draws the
missing ones from the ``torch.Generator`` it is given. The names:

  "t"        (B,)   uniform for sample_t
  "move"     (B, L) uniform: a token is masked where it is < move_chance
  "txt"      (B, 1) uniform: mask the whole text span (entire-modality)
  "img"      (B, 1) uniform: mask the whole image span (entire-modality)
  "block"    (B, L) uniform for interleaved_block_mask
  "drop"     (B,)   uniform for first_token_dropout
  "txt_rand" (B, L) int tokens in [0, text_vocab_size - 1)  (uniform mode)
  "img_rand" (B, L) int tokens in [text_vocab_size, vocab)  (uniform mode)
  "rand"     (B, L) int tokens in [0, vocab)  (uniform mode without the
                    modality split)

and, in the train step (``training/train_state.py``):

  "joint"    (B,)    uniform: joint AR+NAR rows (JAX fold_in(rng, 11))
  "flip"     (B,)    uniform: rand_flip_ar_prob's row flip (fold_in(rng, 13))
  "inpaint"  (B, 2L) uniform: ar_inpainting's mask of the doubled rows
                     (JAX draws it from the mask key itself, not through
                     q_xt's split); its rate draws "t" (the t key)
  "ar_drop"  (B,)    uniform: rand_ar_modality_dropout (fold_in(rng, 17))

The JAX package derives these from one PRNG key; the tests replay that
derivation and hand both packages the same numbers.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import torch

Draws = Optional[Mapping[str, torch.Tensor]]


def draw_uniform(draws: Draws, name: str, shape, generator, device):
    if draws is not None and name in draws:
        u = draws[name]
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"draw {name!r} has shape {tuple(u.shape)}, "
                             f"expected {tuple(shape)}")
        return u.to(device=device, dtype=torch.float32)
    return torch.rand(shape, generator=generator, device=device)


def _randint(draws: Draws, name: str, low: int, high: int, shape,
             generator, device):
    if draws is not None and name in draws:
        return draws[name].to(device=device, dtype=torch.long)
    return torch.randint(low, high, shape, generator=generator,
                         device=device)


def sample_t(batch_size: int, *, antithetic: bool = True,
             sampling_eps: float = 1e-3,
             force_timestep: Optional[float] = None,
             draws: Draws = None,
             generator: Optional[torch.Generator] = None,
             device=None) -> torch.Tensor:
    """Diffusion times t in [eps, 1], optionally antithetic across the
    batch; force_timestep pins the pre-eps uniform."""
    eps_t = draw_uniform(draws, "t", (batch_size,), generator, device)
    if antithetic:
        offset = torch.arange(batch_size, dtype=torch.float32,
                              device=eps_t.device) / batch_size
        eps_t = torch.remainder(eps_t / batch_size + offset, 1.0)
    if force_timestep is not None:
        eps_t = torch.full_like(eps_t, force_timestep)
    return (1 - sampling_eps) * eps_t + sampling_eps


class CorruptionResult(NamedTuple):
    xt: torch.Tensor            # (B, L) corrupted tokens
    move_indices: torch.Tensor  # (B, L) bool, True where corrupted
    batch_ignore: torch.Tensor  # (B,) bool: rows excluded from metrics


def q_xt(x: torch.Tensor,
         move_chance: torch.Tensor,
         mask_index: int,
         *,
         modality: Optional[torch.Tensor] = None,
         mask_entire_modality: Optional[float] = None,
         allow_move_mask: Optional[torch.Tensor] = None,
         multimodal: bool = True,
         sample_ids: Optional[torch.Tensor] = None,
         protect_first: bool = False,
         first_token_dropout: Optional[float] = None,
         diffusion_mode: str = "absorbing",
         text_vocab_size: Optional[int] = None,
         vocab_size: Optional[int] = None,
         draws: Draws = None,
         generator: Optional[torch.Generator] = None) -> CorruptionResult:
    """Corrupt x -> xt: each token independently with move_chance.

    x: (B, L) tokens; move_chance: (B,) or (B, 1).
    mask_entire_modality: probability of masking a whole modality (CFG
      training). multimodal=True replaces a fired row's random masking by
      the modality mask; False ORs it on top and never fires the image mask
      of a text-only row. With sample_ids (interleaved batches) whole
      blocks are masked instead (interleaved_block_mask).
    protect_first / first_token_dropout: label-as-token conditioning.
    diffusion_mode "uniform": corrupt to random in-vocab tokens.
    """
    b = x.shape[0]
    dev = x.device
    move_chance = move_chance.reshape(b, 1)
    move_indices = draw_uniform(draws, "move", tuple(x.shape), generator,
                                dev) < move_chance
    batch_ignore = torch.zeros((b,), dtype=torch.bool, device=dev)

    if mask_entire_modality is not None and sample_ids is not None:
        if modality is None:
            raise ValueError("mask_entire_modality requires modality")
        u = draw_uniform(draws, "block", tuple(x.shape), generator, dev)
        fired, row_fired = interleaved_block_mask(
            modality, sample_ids, mask_entire_modality, u=u)
        move_indices = move_indices | fired
        batch_ignore = row_fired
    elif mask_entire_modality is not None:
        if modality is None:
            raise ValueError("mask_entire_modality requires modality")
        half = mask_entire_modality / 2
        should_mask_txt = draw_uniform(draws, "txt", (b, 1), generator,
                                       dev) < half
        should_mask_img = draw_uniform(draws, "img", (b, 1), generator,
                                       dev) < half
        both = should_mask_txt & should_mask_img
        should_mask_txt = should_mask_txt & ~both
        should_mask_img = should_mask_img & ~both
        txt_sl = modality == 0
        img_sl = modality == 1
        if multimodal:
            move_indices = torch.where(should_mask_txt, txt_sl, move_indices)
            move_indices = torch.where(should_mask_img, img_sl, move_indices)
        else:
            all_txt = txt_sl.all(dim=-1, keepdim=True)
            should_mask_img = should_mask_img & ~all_txt
            move_indices = move_indices | (should_mask_txt & txt_sl)
            move_indices = move_indices | (should_mask_img & img_sl)
        batch_ignore = (should_mask_txt | should_mask_img).squeeze(-1)

    if protect_first:
        move_indices = move_indices.clone()
        move_indices[:, 0] = False
    if first_token_dropout is not None:
        dropped = draw_uniform(draws, "drop", (b,), generator,
                               dev) < first_token_dropout
        move_indices = move_indices.clone()
        move_indices[:, 0] = move_indices[:, 0] | dropped
        batch_ignore = batch_ignore | dropped

    if allow_move_mask is not None:
        move_indices = move_indices & allow_move_mask

    if diffusion_mode == "uniform":
        if vocab_size is None:
            raise ValueError("uniform mode needs vocab_size")
        shape = tuple(x.shape)
        if modality is not None and text_vocab_size is not None:
            txt_rand = _randint(draws, "txt_rand", 0, text_vocab_size - 1,
                                shape, generator, dev)
            img_rand = _randint(draws, "img_rand", text_vocab_size,
                                vocab_size, shape, generator, dev)
            random_tokens = torch.where(modality == 0, txt_rand, img_rand)
        else:
            random_tokens = _randint(draws, "rand", 0, vocab_size, shape,
                                     generator, dev)
            random_tokens = torch.where(random_tokens == mask_index,
                                        random_tokens + 1, random_tokens)
        xt = torch.where(move_indices, random_tokens.to(x.dtype), x)
    elif diffusion_mode == "absorbing":
        xt = torch.where(move_indices, torch.full_like(x, mask_index), x)
    else:
        raise ValueError(f"unknown diffusion_mode {diffusion_mode!r}")
    return CorruptionResult(xt=xt, move_indices=move_indices,
                            batch_ignore=batch_ignore)


def interleaved_block_mask(modality: torch.Tensor, sample_ids: torch.Tensor,
                           mask_prob: float, *, u: torch.Tensor,
                           max_samples: int = 16):
    """Entire-block masking for interleaved batches.

    Blocks are contiguous runs of constant (modality, sample_id). A block
    with more than 4 tokens and sample_id >= 0 is masked whole with
    probability mask_prob * 2 * (k + 1) / K, k its ordinal within its
    sample and K the sample's count of such blocks; the uniform u (B, L) at
    the block's first position decides.

    Returns (block_move (B, L) bool, row_fired (B,) bool).
    """
    b, l = modality.shape
    dev = modality.device
    pos = torch.arange(l, device=dev)
    change = torch.cat([
        torch.ones((b, 1), dtype=torch.bool, device=dev),
        (modality[:, 1:] != modality[:, :-1])
        | (sample_ids[:, 1:] != sample_ids[:, :-1])], dim=1)
    block_id = torch.cumsum(change.long(), dim=1) - 1              # (B, L)
    sizes = torch.zeros((b, l), dtype=torch.long, device=dev)
    sizes.scatter_add_(1, block_id, torch.ones_like(block_id))
    size_per_pos = sizes.gather(1, block_id)
    valid = (sample_ids >= 0) & (size_per_pos > 4)
    starts = change & valid

    sid = sample_ids.long().clamp(0, max_samples - 1)
    onehot = (torch.nn.functional.one_hot(sid, max_samples)
              * starts[..., None].long())                           # (B, L, S)
    cum = torch.cumsum(onehot, dim=1)
    total = cum[:, -1, :]                                           # (B, S)
    k_at = cum.gather(2, sid[..., None]).squeeze(-1) - 1
    total_at = total.gather(1, sid)
    block_prob = (k_at + 1).float() / total_at.clamp(min=1).float()

    fired_at_start = starts & (u < mask_prob * 2.0 * block_prob)
    start_pos = torch.cummax(torch.where(change, pos, -1), dim=1).values
    fired = fired_at_start.gather(1, start_pos) & valid
    return fired, fired_at_start.any(dim=1)
