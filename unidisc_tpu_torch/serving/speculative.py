"""Speculative decoding for the AR serving path (port of
``unidisc_tpu/serving/speculative.py``).

A draft model proposes `gamma` tokens, the target scores them all in one
chunked cached forward, and the longest valid prefix is accepted, with
the target's correction (or a bonus token) after it: the Leviathan et al.
rejection rule, so the output distribution is the target's, and under
greedy decoding the tokens are plain greedy's, token for token. Prompt
lookup (``lookup_proposals``) proposes the continuation of the latest
earlier occurrence of the last n-gram instead of a draft model.

``accept_window`` is the accept/correct core that the whole-batch
decoders here and the continuous batcher's rounds
(``serving/continuous.py``) share. Per-row positions ride the models'
(B,) ``cache_index`` path, so rows accept different counts a round; K/V
of rejected positions is never rolled back, since each later write starts
at the row's committed position and covers them before a query can read
them.

Noise is the port's keyed noise (``serving/rolling.py``): a pure function
of (row seed, absolute position, tag), the tag one per draw site (1 the
draft's token, 2 the accept uniform, 3 the residual's Gumbel, 4 the bonus
token), so a row's tokens do not depend on its neighbours. Parity with
JAX holds under greedy decoding and under injected ``u`` / Gumbel noise.

The whole-batch decoders run eager: each round ends with one host read,
whether every row is done (JAX's ``while_loop`` condition).

apply_fn contract: apply_fn(tok (B, l), kv, cache_index (B,)) -> (logits
(B, l, V), kv), the cache written in place; cache_factory(batch, length)
-> a fresh cache.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from unidisc_tpu_torch.serving.rolling import keyed_gumbel, keyed_uniform

TAG_DRAFT, TAG_ACCEPT, TAG_RESIDUAL, TAG_BONUS = 1, 2, 3, 4


class SpecResult(NamedTuple):
    tokens: torch.Tensor    # (B, L) the whole buffer: prompt + generated
    emitted: torch.Tensor   # (B,) generated counts (EOS included)
    rounds: int             # rounds run
    accepted: int           # accepted draft tokens, all rows
    drafted: int            # draft tokens offered, all rows


def spec_gumbel(seed: torch.Tensor, pos: torch.Tensor, tag: int,
                n: int) -> torch.Tensor:
    """Gumbel noise (..., n) for seeds and absolute positions of one shape
    (...), a pure function of (seed, position, tag)."""
    shape = pos.shape
    seed = seed.expand(shape).reshape(-1)
    return keyed_gumbel(seed, pos.reshape(-1), tag, n).view(*shape, n)


def spec_uniform(seed: torch.Tensor, pos: torch.Tensor,
                 tag: int) -> torch.Tensor:
    """Uniforms in (0, 1) of pos's shape, keyed as ``spec_gumbel``."""
    shape = pos.shape
    seed = seed.expand(shape).reshape(-1)
    return keyed_uniform(seed, pos.reshape(-1), tag, 1).view(shape)


def accept_window(drafted, lp_d, lg_t, lp_t, *, stoch, u=None, g_corr=None,
                  bonus=None):
    """The Leviathan accept/correct core.

    drafted (B, gamma) proposals; lp_d (B, gamma, V) draft log-probs;
    lg_t (B, gamma + 1, V) target logits; lp_t their log-probs (both
    temperature-scaled and vocabulary-restricted). stoch: False (greedy:
    exact match), True (rejection sampling) or a (B,) bool tensor per row.
    Stochastic use needs u (B, gamma) uniforms for the accept rule, g_corr
    (B, gamma, V) Gumbel noise for the residual draw and bonus (B,) a
    token for the all-accepted slot.

    Returns (win (B, gamma + 1), n (B,)): win[:, :n] the accepted drafts,
    win[:, n] the target's correction or bonus; n the accepted count."""
    gamma = drafted.shape[1]
    targets = torch.argmax(lg_t, -1)

    def stochastic_parts():
        take = lambda lp, d: lp.gather(-1, d[..., None])[..., 0]
        match = torch.log(u) < (take(lp_t[:, :gamma], drafted)
                                - take(lp_d, drafted))
        p_res = torch.clamp(torch.exp(lp_t[:, :gamma]) - torch.exp(lp_d),
                            min=0.0)
        log_res = torch.log(torch.clamp(p_res, min=1e-38))
        corr = torch.argmax(log_res + g_corr, -1)
        return match, torch.cat([corr, bonus[:, None]], 1)

    greedy_match = drafted == targets[:, :gamma]
    if stoch is False:
        match, out_win = greedy_match, targets
    elif stoch is True:
        match, out_win = stochastic_parts()
    else:
        match_s, out_s = stochastic_parts()
        match = torch.where(stoch[:, None], match_s, greedy_match)
        out_win = torch.where(stoch[:, None], out_s, targets)
    n = torch.cumprod(match.long(), -1).sum(-1)
    idx = torch.arange(gamma + 1, device=drafted.device)[None, :]
    win = torch.where(idx < n[:, None], F.pad(drafted, (0, 1)), out_win)
    return win, n


def lookup_proposals(x, pos, *, gamma: int, ngram: int):
    """Draft-free proposals by prompt lookup: for each row, the `gamma`
    tokens that followed the latest earlier occurrence of its last
    `ngram` committed tokens; rows with no usable match propose their last
    token repeated (greedy verification accepts only true continuations).

    x (B, L) long buffer, pos (B,) index of the last committed token.
    Returns (drafted (B, gamma) long, found (B,) bool)."""
    B, L = x.shape
    dev = x.device
    windows = torch.stack([x[:, k:L - ngram + 1 + k] for k in range(ngram)],
                          -1)
    start = (pos - ngram + 1).clamp(0, L - ngram)
    key = x.gather(1, start[:, None] + torch.arange(ngram, device=dev))
    match = (windows == key[:, None, :]).all(-1)      # (B, L - ngram + 1)
    j = torch.arange(L - ngram + 1, device=dev)[None, :]
    # a usable match has its whole continuation committed, which also
    # puts it strictly before the key's own occurrence
    usable = match & (j <= (pos - ngram - gamma + 1)[:, None]) \
        & ((pos - ngram + 1) >= 0)[:, None]
    found = usable.any(-1)
    j_star = torch.argmax(torch.where(usable, j, -1), -1)
    cont_start = (j_star + ngram).clamp(0, L - gamma)
    cont = x.gather(1, cont_start[:, None] + torch.arange(gamma, device=dev))
    cur = x.gather(1, pos[:, None])
    drafted = torch.where(found[:, None], cont, cur.expand(B, gamma))
    return drafted, found


class _WholeBatch:
    """What the two whole-batch decoders share: the buffer, the prefill,
    the window write with its EOS and budget cuts, and the loop."""

    def __init__(self, apply_target, cache_factory_t, gamma, eos_id,
                 max_length):
        if gamma < 1:
            raise ValueError("gamma must be >= 1")
        self.apply_t, self.factory_t = apply_target, cache_factory_t
        self.gamma, self.eos_id, self.max_length = gamma, eos_id, max_length

    def _buffer(self, prompts, max_new):
        B, Lp = prompts.shape
        L = Lp + max_new + self.gamma + 1
        if self.max_length is not None and L > self.max_length:
            raise ValueError(
                f"prompt {Lp} + max_new {max_new} + gamma+1 "
                f"{self.gamma + 1} = {L} exceeds the models' max_length "
                f"{self.max_length}: rotary positions past the table would "
                f"clamp silently")
        x = torch.zeros((B, L), dtype=torch.long, device=prompts.device)
        x[:, :Lp] = prompts
        return x, L

    def _advance(self, x, pos, emitted, finished, win, n, max_new, L):
        """Write the window at pos + 1 (junk past the advance sits where the
        next rounds write first), in place on x; returns (pos, emitted,
        finished, adv)."""
        gamma, eos = self.gamma, self.eos_id
        dev = x.device
        idx = torch.arange(gamma + 1, device=dev)[None, :]
        adv = torch.minimum(n + 1, (max_new - emitted).clamp(min=0))
        if eos >= 0:
            is_eos = (win == eos) & (idx <= n[:, None])
            first = torch.argmax(is_eos.long(), -1)
            adv = torch.where(is_eos.any(-1), torch.minimum(adv, first + 1),
                              adv)
        adv = torch.where(finished, 0, adv)
        start = torch.clamp(pos + 1, max=L - (gamma + 1))
        win_idx = start[:, None] + idx
        keep = torch.where(finished[:, None], x.gather(1, win_idx), win)
        x.scatter_(1, win_idx, keep)
        emitted = emitted + adv
        new_fin = finished | (emitted >= max_new)
        if eos >= 0:
            last = win.gather(1, (adv - 1).clamp(0, gamma)[:, None])[:, 0]
            new_fin = new_fin | ((last == eos) & (adv > 0))
        return pos + adv, emitted, new_fin, adv

    @torch.no_grad()
    def decode(self, prompts, plen, seeds, max_new: int) -> SpecResult:
        """prompts (B, Lp) right-padded, plen (B,), seeds (B,) long tensors
        on the models' device."""
        prompts, plen, seeds = (t.long() for t in (prompts, plen, seeds))
        x, L = self._buffer(prompts, max_new)
        B = x.shape[0]
        zero = torch.zeros((B,), dtype=torch.long, device=x.device)
        self._prefill(prompts, zero, B, L)
        pos, emitted = plen - 1, zero.clone()
        finished = torch.zeros((B,), dtype=torch.bool, device=x.device)
        rounds = accepted = drafted = 0
        while not bool((finished | (emitted >= max_new)).all()):
            win, n = self._round(x, pos, seeds)
            live = ~finished
            pos, emitted, new_fin, adv = self._advance(
                x, pos, emitted, finished, win, n, max_new, L)
            rounds += 1
            accepted += int(torch.where(live, torch.minimum(n, adv),
                                        0).sum())
            drafted += int(live.sum()) * self.gamma
            finished = new_fin
        return SpecResult(tokens=x, emitted=emitted, rounds=rounds,
                          accepted=accepted, drafted=drafted)


class SpecDecoder(_WholeBatch):
    """``build_spec_decoder``'s decoder."""

    def __init__(self, apply_target, cache_factory_t, apply_draft,
                 cache_factory_d, gamma, temperature, eos_id, max_length):
        super().__init__(apply_target, cache_factory_t, gamma, eos_id,
                         max_length)
        self.apply_d, self.factory_d = apply_draft, cache_factory_d
        self.greedy = temperature <= 0.0
        self.inv_t = 0.0 if self.greedy else 1.0 / temperature

    def _prefill(self, prompts, zero, B, L):
        self.kv_t, self.kv_d = self.factory_t(B, L), self.factory_d(B, L)
        self.apply_t(prompts, self.kv_t, zero)
        self.apply_d(prompts, self.kv_d, zero)

    def _sample(self, logits, seeds, pos, tag):
        if self.greedy:
            return torch.argmax(logits, -1)
        g = spec_gumbel(seeds, pos, tag, logits.shape[-1])
        return torch.argmax(logits * self.inv_t + g, -1)

    def _round(self, x, pos, seeds):
        gamma = self.gamma
        scale = 1.0 if self.greedy else self.inv_t
        cur = x.gather(1, pos[:, None])[:, 0]
        tok, toks, lps = cur, [], []
        # gamma + 1 draft steps: the last feeds d_gamma, so the draft cache
        # has no hole at the bonus position when every draft is accepted
        for i in range(gamma + 1):
            logits, _ = self.apply_d(tok[:, None], self.kv_d, pos + i)
            lg = logits[:, 0].float()
            tok = self._sample(lg, seeds, pos + i + 1, TAG_DRAFT)
            toks.append(tok)
            lps.append(torch.log_softmax(lg * scale, -1))
        drafted = torch.stack(toks[:gamma], 1)
        lp_d = torch.stack(lps[:gamma], 1)
        chunk = torch.cat([cur[:, None], drafted], 1)
        logits_t, _ = self.apply_t(chunk, self.kv_t, pos)
        lg_t = logits_t.float()
        lp_t = torch.log_softmax(lg_t * scale, -1)
        if self.greedy:
            return accept_window(drafted, lp_d, lg_t, lp_t, stoch=False)
        nxt = pos[:, None] + torch.arange(gamma, device=x.device) + 1
        s2 = seeds[:, None]
        return accept_window(
            drafted, lp_d, lg_t, lp_t, stoch=True,
            u=spec_uniform(s2, nxt, TAG_ACCEPT),
            g_corr=spec_gumbel(s2, nxt, TAG_RESIDUAL, lp_t.shape[-1]),
            bonus=self._sample(lg_t[:, gamma], seeds, pos + gamma + 1,
                               TAG_BONUS))


class LookupDecoder(_WholeBatch):
    """``build_lookup_decoder``'s decoder (greedy)."""

    def __init__(self, apply_target, cache_factory_t, gamma, ngram, eos_id,
                 max_length):
        super().__init__(apply_target, cache_factory_t, gamma, eos_id,
                         max_length)
        if ngram < 1:
            raise ValueError("ngram must be >= 1")
        self.ngram = ngram

    def _prefill(self, prompts, zero, B, L):
        self.kv_t = self.factory_t(B, L)
        self.apply_t(prompts, self.kv_t, zero)

    def _round(self, x, pos, seeds):
        cur = x.gather(1, pos[:, None])
        drafted, _ = lookup_proposals(x, pos, gamma=self.gamma,
                                      ngram=self.ngram)
        logits_t, _ = self.apply_t(torch.cat([cur, drafted], 1), self.kv_t,
                                   pos)
        return accept_window(drafted, None, logits_t.float(), None,
                             stoch=False)


def build_spec_decoder(apply_target: Callable, cache_factory_t: Callable,
                       apply_draft: Callable, cache_factory_d: Callable, *,
                       gamma: int = 4, temperature: float = 0.0,
                       eos_id: int = -1,
                       max_length: Optional[int] = None) -> Callable:
    """decode(prompts (B, Lp), plen (B,), seeds (B,), max_new) ->
    SpecResult: prefill of both models, then draft-verify rounds until
    every row has its budget or its EOS. Prompts are right-padded; pad
    positions poison only cache slots rewritten before they are read.
    max_length: the models' rotary table, which the buffer may not pass."""
    return SpecDecoder(apply_target, cache_factory_t, apply_draft,
                       cache_factory_d, gamma, temperature, eos_id,
                       max_length).decode


def build_lookup_decoder(apply_target: Callable, cache_factory_t: Callable,
                         *, gamma: int = 8, ngram: int = 2,
                         eos_id: int = -1,
                         max_length: Optional[int] = None) -> Callable:
    """The draft-free decoder: proposals from ``lookup_proposals``, one
    target forward over gamma + 1 tokens a round, greedy (the output is
    plain greedy's). decode(prompts, plen, seeds, max_new) -> SpecResult;
    seeds are taken for the shared signature and unused."""
    return LookupDecoder(apply_target, cache_factory_t, gamma, ngram, eos_id,
                         max_length).decode


# ---------------------------------------------------------------------------
# OpenELM wiring
# ---------------------------------------------------------------------------

def elm_apply(model) -> Callable:
    """An OpenELM (``models/elm.py``) as apply_fn."""
    def apply_fn(tok, kv, cache_index):
        return model(tok, kv_cache=kv, cache_index=cache_index)
    return apply_fn


def elm_cache_factory(model, kv_dtype=torch.bfloat16,
                      quant: bool = False) -> Callable:
    from unidisc_tpu_torch.models.elm import init_elm_cache
    dev = model.token_embeddings.device
    return lambda b, L: init_elm_cache(model.cfg, b, L, dtype=kv_dtype,
                                       quant=quant, device=dev)


def _check_vocab(target_cfg, draft_cfg):
    if draft_cfg.total_vocab != target_cfg.total_vocab:
        raise ValueError("the draft and the target must share the "
                         "vocabulary")


def elm_spec_decoder(target, draft, *, gamma: int = 4,
                     temperature: float = 0.0, eos_id: int = -1,
                     kv_dtype=torch.bfloat16) -> Callable:
    """The speculative decoder over two OpenELM models of one vocabulary:
    decode(prompts, plen, seeds, max_new)."""
    _check_vocab(target.cfg, draft.cfg)
    return build_spec_decoder(
        elm_apply(target), elm_cache_factory(target, kv_dtype),
        elm_apply(draft), elm_cache_factory(draft, kv_dtype), gamma=gamma,
        temperature=temperature, eos_id=eos_id,
        max_length=min(target.cfg.max_length, draft.cfg.max_length))


def elm_lookup_decoder(target, *, gamma: int = 8, ngram: int = 2,
                       eos_id: int = -1,
                       kv_dtype=torch.bfloat16) -> Callable:
    """The prompt-lookup decoder over one OpenELM model."""
    return build_lookup_decoder(elm_apply(target),
                                elm_cache_factory(target, kv_dtype),
                                gamma=gamma, ngram=ngram, eos_id=eos_id,
                                max_length=target.cfg.max_length)


def speculative_decode(target, draft, prompts, *, max_new_tokens: int = 64,
                       gamma: int = 4, temperature: float = 0.0,
                       eos_id: int = -1, seed: int = 0):
    """One call: right-pads `prompts` (lists of ids), decodes with the
    draft, returns (the generated ids of each prompt, SpecResult). Row i
    takes seed + i."""
    plen = np.asarray([len(p) for p in prompts], np.int64)
    buf = np.zeros((len(prompts), max(int(plen.max()), 1)), np.int64)
    for i, p in enumerate(prompts):
        buf[i, :len(p)] = p
    dev = target.token_embeddings.device
    decode = elm_spec_decoder(target, draft, gamma=gamma,
                              temperature=temperature, eos_id=eos_id)
    res = decode(torch.from_numpy(buf).to(dev),
                 torch.from_numpy(plen).to(dev),
                 torch.arange(seed, seed + len(prompts), device=dev),
                 max_new_tokens)
    toks, em = res.tokens.cpu().numpy(), res.emitted.cpu().numpy()
    return [toks[i, plen[i]:plen[i] + em[i]].tolist()
            for i in range(len(prompts))], res
