"""AR continuous batching (port of ``unidisc_tpu/serving/continuous.py``):
a persistent decode batch on the device that requests join and leave
without restarting decode.

  * The whole decode state lives on the device (``DecodeState``: tokens,
    modalities, the KV cache, per-row positions, activity, stop bounds,
    temperatures and seeds) and is only mutated in place.
  * Rows advance at their own cache positions (the models' (B,)
    ``cache_index``), so a row that joined late decodes beside one far
    ahead in one forward.
  * Admission (``insert_many``) prefills a group of prompts in one
    multi-token causal pass at a bucketed length, samples each first
    token from its last prompt logit and writes the rows into their slots;
    with prefix caching (``insert_prefix``) a prompt that shares a prefix
    with a slot's resident prompt copies that slot's K/V and prefills only
    its suffix. Admission runs eager, between chunks.
  * ``step_chunk`` advances every active row `chunk` tokens (or, with a
    draft model or prompt lookup, ceil(chunk / (gamma + 1)) speculative
    rounds, ``serving/speculative.py``), with no host read. On the card it
    is one captured CUDA graph a batcher (``sampling/graph.py::
    CapturedChunk``); between chunks the host reads (pos, active, x) in one
    transfer.

Finished rows deactivate and their slots are reused; stale K/V above a
new prompt is never attended, because a query sees only keys at or below
its own position, each written before it is read.

Noise is the port's keyed noise (``serving/rolling.py``): the draw for the
token written at position p is a pure function of (row seed, p, tag), so a
seeded request reproduces whatever shares the batch. Parity with JAX holds
under greedy decoding.

On a device mesh (``mesh=``, dcn / fsdp / seq only: ``parallel/sample.py::
check_ar_mesh``) the S slots are the global batch split over the
data-parallel ranks (``SlotSplit``): a rank's decoder holds its slots' rows
and KV cache (a draft model's too), admits only the prompts of its slots
and decodes them outside the "seq" ring, as JAX jits the decode chunk
outside ``spmd_sampler``, so the chunk holds no collective and stays one
captured program a rank. The front end runs on the leader: its device ops
(``op_*``) are announced before they run and replayed by the other ranks'
batchers; the drain is a gather of (pos, active, x) to rank 0, and a
prefix-cache donor is taken only from a slot of the same rank (lossless
either way; the hit rate may fall).
"""

from __future__ import annotations

import queue
import threading
import time as _time
from concurrent.futures import Future
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.device import resolve_device
from unidisc_tpu_torch.diffusion.subs import (NEG_INFINITY,
                                              restrict_modality_logits)
from unidisc_tpu_torch.parallel.sample import SlotSplit
from unidisc_tpu_torch.sampling.ar_sampler import init_kv_cache_for
from unidisc_tpu_torch.serving.rolling import keyed_gumbel
from unidisc_tpu_torch.serving.speculative import (TAG_ACCEPT, TAG_BONUS,
                                                   TAG_DRAFT, TAG_RESIDUAL,
                                                   accept_window,
                                                   lookup_proposals,
                                                   spec_gumbel,
                                                   spec_uniform)

TAG_STEP = 0   # the keyed-noise tag of plain decode steps and first tokens


class DecodeState(NamedTuple):
    """The continuous-batching state on the device (S slots, length L)."""
    x: torch.Tensor        # (S, L) long prompt + generated tokens
    mod: torch.Tensor      # (S, L) long per-position modality
    kv: object             # the target's cache (the model family's layout)
    pos: torch.Tensor      # (S,) long next K/V write position; x[s, pos[s]]
    #                        is the latest token whose K/V is not written
    active: torch.Tensor   # (S,) bool
    stop: torch.Tensor     # (S,) long absolute position bound
    temp: torch.Tensor     # (S,) fp32 temperature (<= 0: greedy)
    seed: torch.Tensor     # (S,) long sampling seed
    stats: torch.Tensor    # (4,) long, speculative rounds: live row-rounds,
    #                        accepted drafts, drafts offered, tokens advanced
    dkv: object = ()       # the draft model's cache, with draft rounds


def _leaves(tree) -> list:
    """The tensors of a cache (a tensor, or nested tuples and lists)."""
    if torch.is_tensor(tree):
        return [tree]
    return [t for sub in tree for t in _leaves(sub)]


def sample_rows(logits, temp, g):
    """Per-row Gumbel-argmax at the row's temperature; temp <= 0 greedy."""
    greedy = torch.argmax(logits, -1)
    noisy = torch.argmax(logits / temp.clamp(min=1e-6)[:, None] + g, -1)
    return torch.where(temp > 0, noisy, greedy)


class ContinuousDecoder:
    """The state machine of ``build_continuous_decoder``."""

    def __init__(self, apply_fn, cache_factory, restrict_fn, length, slots,
                 chunk, eos_id, cache_batch_axis, draft, gamma,
                 lookup_ngram, device, split):
        if draft is not None and lookup_ngram:
            raise ValueError("draft-model and prompt-lookup speculation are "
                             "exclusive")
        self.apply_fn, self.cache_factory = apply_fn, cache_factory
        self.restrict = restrict_fn
        # slots: this rank's rows of the split's global slots
        self.split = split
        self.L, self.slots, self.chunk = length, split.local, chunk
        self.eos_id, self.axis = eos_id, cache_batch_axis
        self.draft, self.gamma, self.lookup_ngram = draft, gamma, lookup_ngram
        self.device = resolve_device(device)
        self.speculative = draft is not None or bool(lookup_ngram)
        # a round writes a (gamma + 1) window at pos + 1: the stop cap keeps
        # an active row's window inside the buffer
        self.stop_cap = length - (gamma + 1) if self.speculative else length
        self.rounds = max(1, -(-chunk // (gamma + 1)))
        # the most a chunk advances a row (the host's upper estimate)
        self.max_advance = self.rounds * (gamma + 1) if self.speculative \
            else chunk

    def init_state(self) -> DecodeState:
        S, L, dev = self.slots, self.L, self.device
        z = lambda *shape: torch.zeros(shape, dtype=torch.long, device=dev)
        return DecodeState(
            x=z(S, L), mod=z(S, L), kv=self.cache_factory(S, L), pos=z(S),
            active=torch.zeros((S,), dtype=torch.bool, device=dev),
            stop=z(S), temp=torch.ones((S,), device=dev), seed=z(S),
            stats=z(4),
            dkv=self.draft[1](S, L) if self.draft is not None else ())

    # -- cache rows ---------------------------------------------------------
    def _rows(self, rows, n: int) -> tuple:
        """The index of cache rows `rows` (a long tensor or an int),
        positions [0, n)."""
        return (slice(None),) * self.axis + (rows, slice(0, n))

    def _copy_rows(self, dst, src, rows, n: int) -> None:
        """Positions [0, n) of src's rows into dst's rows `rows`."""
        for d, s in zip(_leaves(dst), _leaves(src)):
            d[self._rows(rows, n)] = s[self._rows(
                slice(None) if torch.is_tensor(rows) else 0, n)].to(d.dtype)

    # -- admission ------------------------------------------------------------
    def _first_tokens(self, last, nxt, mod_next, temps, seeds):
        last = self.restrict(last.float(), mod_next)
        g = keyed_gumbel(seeds, nxt, TAG_STEP, last.shape[-1])
        return sample_rows(last, temps, g)

    def _write_rows(self, state, slots_v, x_rows, mod_rows, plens, tok0,
                    max_news, temps, seeds) -> None:
        stop_v = torch.clamp(plens + max_news, max=self.stop_cap)
        # a row is born done when its first token is EOS or it cannot
        # advance past it (max_new <= 1, or a prompt at the stop cap)
        done = (tok0 == self.eos_id) | (plens + 1 >= stop_v)
        for name, value in (("x", x_rows), ("mod", mod_rows),
                            ("pos", plens), ("active", ~done),
                            ("stop", stop_v), ("temp", temps),
                            ("seed", seeds)):
            dst = getattr(state, name)
            dst.index_copy_(0, slots_v, value.to(dst.dtype))

    @torch.no_grad()
    def insert_many(self, state: DecodeState, slots_v, prompts, mod_rows,
                    plens, max_news, temps, seeds) -> DecodeState:
        """Admit k prompts in one prefill, in place: slots_v (k,) global
        slot ids, prompts (k, bucket) right-padded, mod_rows (k, L), plens,
        max_news (k,), temps (k,) fp32, seeds (k,). Host arrays or tensors.
        On a mesh a rank prefills only the prompts of its slots."""
        dev, L = self.device, self.L
        local = self.split.own(slots_v)
        keep = np.flatnonzero(local < self.slots)
        if keep.size == 0:
            return state
        t = lambda a, dt=torch.long: torch.as_tensor(
            np.asarray(torch.as_tensor(a).cpu())[keep]).to(dev, dt)
        slots_v, prompts, mod_rows = t(local), t(prompts), t(mod_rows)
        plens, max_news, seeds = t(plens), t(max_news), t(seeds)
        temps = t(temps, torch.float32)
        k, bucket = prompts.shape
        zero = torch.zeros((k,), dtype=torch.long, device=dev)
        # the prefill's cache is `bucket` long: its queries see only keys
        # below the bucket, and positions past it are written before read
        kv = self.cache_factory(k, bucket)
        logits, _ = self.apply_fn(prompts, mod_rows[:, :bucket], kv, zero)
        last = logits[torch.arange(k, device=dev), plens - 1]
        nxt = plens.clamp(max=L - 1)
        tok0 = self._first_tokens(last, nxt, mod_rows.gather(
            1, nxt[:, None])[:, 0], temps, seeds)
        self._copy_rows(state.kv, kv, slots_v, bucket)
        if self.draft is not None:
            dkv = self.draft[1](k, bucket)
            self.draft[0](prompts, mod_rows[:, :bucket], dkv, zero)
            self._copy_rows(state.dkv, dkv, slots_v, bucket)
        x_rows = F.pad(prompts, (0, L - bucket))
        x_rows.scatter_(1, nxt[:, None], tok0[:, None])
        self._write_rows(state, slots_v, x_rows, mod_rows, plens, tok0,
                         max_news, temps, seeds)
        return state

    @torch.no_grad()
    def insert_prefix(self, state: DecodeState, slot: int, src_slot: int,
                      prompt, mod_row, shared: int, bucket_suffix: int,
                      max_new: int, temperature: float,
                      seed: int) -> DecodeState:
        """Admit one prompt reusing positions [0, shared) of `src_slot`'s
        resident K/V: the donor's rows are copied and only the suffix
        prompt[shared:] (padded to `bucket_suffix`) is prefilled, at
        cache index `shared`, attending the copied keys. The tokens are
        those of a full prefill. prompt (plen,), mod_row (L,): host
        arrays; shared <= plen - 1. `slot` and `src_slot` are global ids of
        one rank's slots; the other ranks do nothing."""
        dev, L = self.device, self.L
        if self.split.owner(slot) != self.split.owner(src_slot):
            raise ValueError(f"a prefix donor {src_slot} of another rank "
                             f"than slot {slot}'s")
        own = self.split.own([slot, src_slot])
        if own[0] == self.slots:
            return state
        slot, src_slot = int(own[0]), int(own[1])
        prompt = np.asarray(prompt, np.int64)
        plen = len(prompt)
        n = shared + bucket_suffix
        if not 0 < shared < plen or n > L:
            raise ValueError(f"prefix {shared} of a {plen}-token prompt "
                             f"with a {bucket_suffix}-token suffix bucket")
        suffix = np.zeros(bucket_suffix, np.int64)
        suffix[:plen - shared] = prompt[shared:]
        mod_row = torch.as_tensor(np.asarray(mod_row, np.int64)).to(dev)
        suffix = torch.from_numpy(suffix).to(dev)[None]
        ci = torch.full((1,), shared, dtype=torch.long, device=dev)

        def prefill(apply_fn, factory, cache):
            row = factory(1, n)
            for d, s in zip(_leaves(row), _leaves(cache)):
                d[self._rows(0, shared)] = s[self._rows(src_slot, shared)]
            logits, _ = apply_fn(suffix, mod_row[None, shared:n], row, ci)
            self._copy_rows(cache, row, slot, n)
            return logits

        logits = prefill(self.apply_fn, self.cache_factory, state.kv)
        if self.draft is not None:
            prefill(self.draft[0], self.draft[1], state.dkv)
        nxt = torch.full((1,), min(plen, L - 1), dtype=torch.long,
                         device=dev)
        temps = torch.full((1,), temperature, device=dev)
        seeds = torch.full((1,), seed, dtype=torch.long, device=dev)
        tok0 = self._first_tokens(logits[:, plen - shared - 1], nxt,
                                  mod_row[nxt], temps, seeds)
        x_row = torch.zeros((1, L), dtype=torch.long, device=dev)
        x_row[0, :plen] = torch.from_numpy(prompt).to(dev)
        x_row[0, nxt] = tok0
        self._write_rows(
            state, torch.full((1,), slot, dtype=torch.long, device=dev),
            x_row, mod_row[None], torch.full((1,), plen, dtype=torch.long,
                                             device=dev), tok0,
            torch.full((1,), max_new, dtype=torch.long, device=dev), temps,
            seeds)
        return state

    # -- decode -----------------------------------------------------------
    def _step(self, st: DecodeState) -> None:
        L = self.L
        tok = st.x.gather(1, st.pos[:, None])
        logits, _ = self.apply_fn(tok, st.mod.gather(1, st.pos[:, None]),
                                  st.kv, st.pos)
        nxt = (st.pos + 1).clamp(max=L - 1)
        logits = self.restrict(logits[:, 0].float(),
                               st.mod.gather(1, nxt[:, None])[:, 0])
        g = keyed_gumbel(st.seed, nxt, TAG_STEP, logits.shape[-1])
        new = sample_rows(logits, st.temp, g)
        old = st.x.gather(1, nxt[:, None])[:, 0]
        st.x.scatter_(1, nxt[:, None], torch.where(st.active, new,
                                                   old)[:, None])
        active = st.active & (nxt + 1 < st.stop)
        if self.eos_id >= 0:
            active = active & (new != self.eos_id)
        st.pos.copy_(torch.where(st.active, nxt, st.pos))
        st.active.copy_(active)

    def _sample_rows(self, st, logits, positions, tag):
        g = keyed_gumbel(st.seed, positions, tag, logits.shape[-1])
        return sample_rows(logits, st.temp, g)

    def _spec_round(self, st: DecodeState) -> None:
        """A draft-verify round: gamma + 1 draft steps (the last keeps the
        draft cache whole at the bonus position), then the verify."""
        L, gamma = self.L, self.gamma
        draft_apply = self.draft[0]
        inv_t = 1.0 / st.temp.clamp(min=1e-6)
        tok = st.x.gather(1, st.pos[:, None])[:, 0]
        toks, lps = [], []
        for i in range(gamma + 1):
            p_i = (st.pos + i).clamp(max=L - 1)
            lg, _ = draft_apply(tok[:, None], st.mod.gather(1, p_i[:, None]),
                                st.dkv, p_i)
            nx = (st.pos + i + 1).clamp(max=L - 1)
            lg = self.restrict(lg[:, 0].float(),
                               st.mod.gather(1, nx[:, None])[:, 0])
            tok = self._sample_rows(st, lg, nx, TAG_DRAFT)
            toks.append(tok)
            lps.append(torch.log_softmax(lg * inv_t[:, None], -1))
        self._verify_and_advance(st, torch.stack(toks[:gamma], 1),
                                 torch.stack(lps[:gamma], 1))

    def _lookup_round(self, st: DecodeState) -> None:
        """A draft-free round: the proposals of ``lookup_proposals``, as a
        delta draft distribution (log 1 at the proposal), under which the
        shared rule accepts with probability p_t(proposal)."""
        drafted, _ = lookup_proposals(st.x, st.pos, gamma=self.gamma,
                                      ngram=self.lookup_ngram)
        self._verify_and_advance(st, drafted, None)

    def _verify_and_advance(self, st: DecodeState, drafted, lp_d) -> None:
        L, gamma, S = self.L, self.gamma, self.slots
        dev = st.x.device
        inv_t = 1.0 / st.temp.clamp(min=1e-6)
        cur = st.x.gather(1, st.pos[:, None])
        idx = torch.arange(gamma + 1, device=dev)[None, :]
        p_mat = (st.pos[:, None] + idx).clamp(max=L - 1)
        lg_t, _ = self.apply_fn(torch.cat([cur, drafted], 1),
                                st.mod.gather(1, p_mat), st.kv, st.pos)
        V = lg_t.shape[-1]
        nxt_mat = (p_mat + 1).clamp(max=L - 1)
        lg_t = self.restrict(lg_t.float().reshape(-1, V),
                             st.mod.gather(1, nxt_mat).reshape(-1)
                             ).reshape(S, gamma + 1, V)
        lp_t = torch.log_softmax(lg_t * inv_t[:, None, None], -1)
        if lp_d is None:
            ids = torch.arange(V, device=dev)
            lp_d = torch.where(ids == drafted[..., None], 0.0, -1e30)
        seed2 = st.seed[:, None]
        win, n = accept_window(
            drafted, lp_d, lg_t, lp_t, stoch=st.temp > 0,
            u=spec_uniform(seed2, nxt_mat[:, :gamma], TAG_ACCEPT),
            g_corr=spec_gumbel(seed2, nxt_mat[:, :gamma], TAG_RESIDUAL, V),
            bonus=self._sample_rows(st, lg_t[:, gamma], nxt_mat[:, gamma],
                                    TAG_BONUS))
        # advance: accepted + 1, cut by the stop bound and the first EOS
        adv = torch.minimum(n + 1, (st.stop - 1 - st.pos).clamp(min=0))
        if self.eos_id >= 0:
            is_eos = (win == self.eos_id) & (idx <= n[:, None])
            adv = torch.where(
                is_eos.any(-1),
                torch.minimum(adv, torch.argmax(is_eos.long(), -1) + 1), adv)
        adv = torch.where(st.active, adv, 0)
        # write the window at pos + 1; rows that do not advance keep theirs
        # (their window start could clamp below pos + 1)
        win_idx = (st.pos + 1).clamp(max=L - (gamma + 1))[:, None] + idx
        keep = torch.where((st.active & (adv > 0))[:, None], win,
                           st.x.gather(1, win_idx))
        st.x.scatter_(1, win_idx, keep)
        new_pos = st.pos + adv
        active = st.active & (new_pos + 1 < st.stop)
        if self.eos_id >= 0:
            last = win.gather(1, (adv - 1).clamp(0, gamma)[:, None])[:, 0]
            active = active & ~((adv > 0) & (last == self.eos_id))
        st.stats.add_(torch.stack([
            st.active.sum(), torch.where(st.active, torch.minimum(n, adv),
                                         0).sum(),
            st.active.sum() * gamma, adv.sum()]))
        st.pos.copy_(new_pos)
        st.active.copy_(active)

    @torch.no_grad()
    def step_chunk(self, state: DecodeState, injected=None) -> DecodeState:
        """`chunk` decode steps (or the speculative rounds of a chunk) on
        every active row, in place, with no host read; inactive rows keep
        their tokens and positions."""
        if self.draft is not None:
            step = self._spec_round
        elif self.lookup_ngram:
            step = self._lookup_round
        else:
            step = self._step
        for _ in range(self.rounds if self.speculative else self.chunk):
            step(state)
        return state

    @torch.no_grad()
    def reset(self, state: DecodeState) -> None:
        """Every row inactive, in place."""
        state.active.zero_()


def build_continuous_decoder(model, config: Optional[Config], *,
                             slots: int = 8, chunk: int = 8,
                             eos_id: int = -1, apply_fn=None,
                             cache_factory=None, restrict_fn=None,
                             length: Optional[int] = None,
                             cache_batch_axis: int = 1, draft=None,
                             gamma: int = 4,
                             lookup_ngram: Optional[int] = None,
                             device=None, mesh=None) -> ContinuousDecoder:
    """The continuous decoding state machine:

      init_state() -> DecodeState of `slots` empty rows;
      insert_many(state, slots_v, prompts, mod_rows, plens, max_news,
        temps, seeds) and insert_prefix(...): admission, in place;
      step_chunk(state): `chunk` tokens on every active row, in place.

    The defaults serve a causal DIT (`model`, `config`) at sigma 0; other
    AR models plug in with apply_fn(tok (B, l), mod_tok (B, l), kv,
    cache_index (B,)) -> (logits, kv), cache_factory(batch, length) -> a
    cache, restrict_fn(logits, mod_next) -> logits, `length` and the
    cache's batch axis (``elm_continuous_batcher``).

    draft=(draft_apply_fn, draft_cache_factory): each chunk runs
    draft-verify rounds of `gamma` proposals (``serving/speculative.py``);
    lookup_ngram=N: prompt-lookup rounds instead. Greedy rows stay plain
    greedy's tokens; stochastic rows use the rejection rule under their
    own keyed noise, which differs from the plain steps' noise.

    mesh: the rank's MeshLayout (a DIT with its config only): `slots` is
    the global count, rounded up to the granule, and the decoder holds
    this rank's (module docstring)."""
    if mesh is not None and config is None:
        raise ValueError("a mesh decoder serves a DIT: pass its config")
    if config is not None:
        m = config.model
        if m.full_attention:
            raise ValueError("continuous batching needs a causal model")
        length = length or m.length
        if device is None:
            device = next(model.parameters()).device
    elif None in (length, apply_fn, cache_factory, restrict_fn, device):
        raise ValueError("without a config, pass length, apply_fn, "
                         "cache_factory, restrict_fn and device")
    if apply_fn is None:
        def apply_fn(tok, mod_tok, kv, cache_index):
            sigma = torch.zeros((tok.shape[0],), device=tok.device)
            return model(tok, sigma, modality=mod_tok, kv_cache=kv,
                         cache_index=cache_index)
    if cache_factory is None:
        def cache_factory(batch, n):
            return init_kv_cache_for(m, batch, n, device=device)
    if restrict_fn is None:
        def restrict_fn(logits, mod_next):
            ids = torch.arange(logits.shape[-1], device=logits.device)
            logits = logits + torch.where(ids == m.mask_index, NEG_INFINITY,
                                          0.0)
            if m.force_argmax_valid_indices:
                logits = restrict_modality_logits(logits, mod_next,
                                                  m.text_vocab_size)
            return logits
    return ContinuousDecoder(apply_fn, cache_factory, restrict_fn, length,
                             slots, chunk, eos_id, cache_batch_axis, draft,
                             gamma, lookup_ngram, device,
                             SlotSplit(slots, config, mesh))


def _bucket(n: int, lo: int = 32) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class ContinuousBatcher:
    """Thread-safe front end: submit() returns a Future; a worker thread
    admits pending requests into free slots and advances the device batch
    a chunk at a time. On the card the chunk is the captured program over
    the batcher's state, built here under `device_lock` (the engine's: a
    capture must see no CUDA call from another thread); every device call
    of the worker holds it too.

    The device work is five ops, ``op_insert`` (a group's prefill),
    ``op_prefix`` (a prefix-cache admission), ``op_chunk``, ``op_drain``
    and ``op_reset``; each is passed to `announce(name, kwargs)` before it
    runs, so that on a mesh (`mesh`, the rank's MeshLayout) the other
    ranks' batchers, built with ``worker=False``, replay it on their
    slots. ``slots`` is the global count (rounded up to the granule).

    Host reads: one transfer of (pos, active, x) a drain (a gather to rank
    0 on a mesh); the worker drains only when it can matter (a stream is
    waiting, a row may have reached its stop bound, or with an EOS the
    wall-clock deadline has passed), and counts its drains in
    ``host_reads`` and its chunks in ``chunks``. A request is checked
    before it is queued. A device error fails the live futures and
    resets the state (the reset announced first); the worker survives."""

    def __init__(self, model, config: Optional[Config], *, slots: int = 8,
                 chunk: int = 8, eos_id: int = -1,
                 device_lock: Optional[threading.Lock] = None,
                 drain_deadline_s: float = 0.05, prefix_min: int = 16,
                 mesh=None, announce=None, worker: bool = True,
                 **decoder_kwargs):
        self.config = config
        self.chunk, self.eos_id = chunk, eos_id
        self.decoder = build_continuous_decoder(
            model, config, slots=slots, chunk=chunk, eos_id=eos_id,
            mesh=mesh, **decoder_kwargs)
        self.split = self.decoder.split
        self.slots = self.split.slots
        self._announce = announce
        self.length = self.decoder.L
        self._max_advance = self.decoder.max_advance
        self._stop_cap = self.decoder.stop_cap
        self.drain_deadline_s = drain_deadline_s
        self._chunk_s = None      # EMA of one chunk's wall time
        self._last_drain = _time.monotonic()
        self._lock = device_lock or threading.Lock()
        self.program = None
        with self._lock:
            if self.decoder.device.type == "cuda":
                from unidisc_tpu_torch.sampling.graph import CapturedChunk
                self.program = CapturedChunk(self.decoder)
                self.state = self.program.state
                self._decode = self.program.step_chunk
            else:
                self.state = self.decoder.init_state()
                self._decode = self.decoder.step_chunk
        self._queue: "queue.Queue" = queue.Queue()
        self._slot_req: list = [None] * self.slots
        # automatic prefix caching: the prompt whose prefill K/V is resident
        # in each slot (valid until the slot is reused: decode writes only
        # positions >= its prompt length); prefix_min is the shortest
        # shared prefix worth a copy, 0 disables
        self._prefix_min = prefix_min
        self._slot_prompt: list = [None] * self.slots
        self.prefix_hits = 0
        self.host_reads = 0     # (pos, active, x) transfers
        self.chunks = 0         # decode chunks run
        self.prefills = 0       # prefill forwards (admissions)
        self._seq = 0
        self._stopping = False
        self._worker_thread = None
        if worker:
            self._worker_thread = threading.Thread(target=self._worker,
                                                   daemon=True)
            self._worker_thread.start()

    def submit(self, prompt_ids: Sequence[int], *, max_new_tokens: int = 64,
               temperature: float = 0.0, seed: Optional[int] = None,
               modality: Optional[Sequence[int]] = None,
               stream_cb: Optional[Callable] = None) -> Future:
        """Queue a request. The Future resolves to {"tokens": the generated
        ids (EOS stripped), "prompt_len"}; stream_cb(new ids) is called from
        the worker as tokens come to the host. A prompt of a length the
        buffer cannot take fails its Future here, before it is queued."""
        if self._stopping:
            raise RuntimeError("batcher is shut down")
        if self._worker_thread is None:
            raise RuntimeError("this batcher replays a leader's ops; it "
                               "takes no requests")
        fut: Future = Future()
        req = dict(prompt=np.asarray(prompt_ids, np.int64),
                   modality=(None if modality is None else
                             np.asarray(modality, np.int64)),
                   max_new=int(max_new_tokens),
                   temperature=float(temperature), seed=seed,
                   stream_cb=stream_cb, future=fut, emitted=0)
        if self._check_length(req):
            self._queue.put(req)
        return fut

    def shutdown(self):
        self._stopping = True
        if self._worker_thread is not None:
            self._worker_thread.join(timeout=30)
        exc = RuntimeError("batcher shut down")
        for slot, r in enumerate(self._slot_req):
            if r is not None and not r["future"].done():
                r["future"].set_exception(exc)
            self._slot_req[slot] = None
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            if not r["future"].done():
                r["future"].set_exception(exc)

    # -- the device ops (under the device lock; replayed on a mesh) ---------
    def _op(self, name: str, **kw):
        if self._announce is not None:
            self._announce(name, kw)
        return getattr(self, "op_" + name)(**kw)

    def op_insert(self, slots_v, prompts, mod_rows, plens, max_news, temps,
                  seeds):
        self.decoder.insert_many(self.state, slots_v, prompts, mod_rows,
                                 plens, max_news, temps, seeds)

    def op_prefix(self, **kw):
        self.decoder.insert_prefix(self.state, **kw)

    def op_chunk(self):
        self._decode(self.state)

    def op_drain(self):
        """(S, L + 2) rows of [pos, active, x] on the leader (None on the
        other ranks): one host read, a gather on a mesh."""
        st = self.state
        return self.split.gather(torch.cat(
            [st.pos[:, None], st.active.long()[:, None], st.x], 1))

    def op_reset(self):
        self.decoder.reset(self.state)

    # -- worker internals ---------------------------------------------------
    def _seed_of(self, req) -> int:
        if req.get("seed") is None:
            self._seq += 1
            req["seed"] = self._seq
        return int(req["seed"])

    def _mod_row(self, req) -> np.ndarray:
        row = np.zeros(self.length, np.int64)
        if req["modality"] is not None:
            n = min(len(req["modality"]), self.length)
            row[:n] = req["modality"][:n]
        return row

    def _check_length(self, req) -> bool:
        plen = len(req["prompt"])
        if plen >= self.length - 1 or plen == 0:
            req["future"].set_exception(ValueError(
                f"prompt length {plen} outside [1, model length "
                f"{self.length} - 2]"))
            return False
        return True

    def _admit_group(self, pairs):
        """Admit [(req, slot)] in one prefill (``insert_many``), each row
        with its own seed (the client's, or a counter value); their
        lengths were checked at submit."""
        plens = [len(req["prompt"]) for req, _ in pairs]
        bucket = min(_bucket(max(plens)), self.length)
        prompts = np.zeros((len(pairs), bucket), np.int64)
        for i, (req, _) in enumerate(pairs):
            prompts[i, :plens[i]] = req["prompt"]
        self._op("insert", slots_v=np.asarray([slot for _, slot in pairs],
                                              np.int64),
                 prompts=prompts,
                 mod_rows=np.stack([self._mod_row(req) for req, _ in pairs]),
                 plens=np.asarray(plens, np.int64),
                 max_news=np.asarray([req["max_new"] for req, _ in pairs],
                                     np.int64),
                 temps=np.asarray([req["temperature"] for req, _ in pairs],
                                  np.float32),
                 seeds=np.asarray([self._seed_of(req) for req, _ in pairs],
                                  np.int64))
        self.prefills += 1
        for (req, slot), plen in zip(pairs, plens):
            self._register_admission(req, slot, plen)

    def _register_admission(self, req, slot, plen):
        req["slot"], req["prompt_len"] = slot, plen
        # the host's upper estimate of the row's position: drains are
        # skipped while no row can have reached its stop bound
        req["pos_est"] = plen
        req["stop_est"] = min(plen + req["max_new"], self._stop_cap)
        self._slot_req[slot] = req
        self._slot_prompt[slot] = np.asarray(req["prompt"], np.int64)

    def _find_prefix_donor(self, prompt, slot=None) -> Optional[tuple]:
        """(src_slot, shared) of the longest usable shared prefix among the
        slots' resident prompts (on a mesh, those of `slot`'s rank), or
        None; at most len(prompt) - 1 so the suffix prefill is never
        empty."""
        if not self._prefix_min:
            return None
        p = np.asarray(prompt, np.int64)
        best, best_slot = 0, None
        for s, q in enumerate(self._slot_prompt):
            if q is None or (slot is not None and self.split.owner(s)
                             != self.split.owner(slot)):
                continue
            m = min(len(q), len(p) - 1)
            if m < self._prefix_min or m <= best:
                continue
            neq = np.flatnonzero(q[:m] != p[:m])
            shared = int(neq[0]) if neq.size else m
            if shared >= self._prefix_min and shared > best:
                best, best_slot = shared, s
        return (best_slot, best) if best_slot is not None else None

    def _admit_prefix(self, req, slot, src_slot, shared):
        plen = len(req["prompt"])
        # the suffix bucket must fit the buffer, or the write would clamp
        # onto the copied prefix
        bucket_s = min(_bucket(plen - shared), self.length - shared)
        self._op("prefix", slot=slot, src_slot=src_slot,
                 prompt=np.asarray(req["prompt"], np.int64),
                 mod_row=self._mod_row(req), shared=shared,
                 bucket_suffix=bucket_s, max_new=req["max_new"],
                 temperature=req["temperature"], seed=self._seed_of(req))
        self.prefix_hits += 1
        self.prefills += 1
        self._register_admission(req, slot, plen)

    def _drain(self):
        """Emit stream deltas and retire finished rows from one host copy
        of (pos, active, x)."""
        snap = self._op("drain")
        self.host_reads += 1
        pos, active, x = snap[:, 0], snap[:, 1].astype(bool), snap[:, 2:]
        self._last_drain = _time.monotonic()
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            req["pos_est"] = int(pos[slot])
            plen = req["prompt_len"]
            gen = x[slot, plen:pos[slot] + 1]
            if req["stream_cb"] is not None and len(gen) > req["emitted"]:
                req["stream_cb"](gen[req["emitted"]:].tolist())
                req["emitted"] = len(gen)
            if not active[slot]:
                toks = gen.tolist()
                if self.eos_id >= 0 and toks and toks[-1] == self.eos_id:
                    toks = toks[:-1]
                req["future"].set_result(dict(tokens=toks, prompt_len=plen))
                self._slot_req[slot] = None

    def _admit(self, pairs) -> bool:
        """Prefix-cache hits admit one by one first (a donor slot may be
        overwritten by this round's group insert), the rest in one
        group; a failure fails its requests."""
        group, admitted = [], False
        for req, slot in pairs:
            donor = self._find_prefix_donor(req["prompt"], slot)
            if donor is None:
                group.append((req, slot))
                continue
            try:
                self._admit_prefix(req, slot, *donor)
                admitted = True
            except Exception as e:  # noqa: BLE001 — fail this request
                if not req["future"].done():
                    req["future"].set_exception(e)
        if group:
            try:
                self._admit_group(group)
                admitted = True
            except Exception as e:  # noqa: BLE001 — fail the group
                for req, _ in group:
                    if not req["future"].done():
                        req["future"].set_exception(e)
        return admitted

    def _decode_and_drain(self, live):
        t0 = _time.monotonic()
        self._op("chunk")
        self.chunks += 1
        chunk_s = _time.monotonic() - t0
        self._chunk_s = chunk_s if self._chunk_s is None \
            else 0.7 * self._chunk_s + 0.3 * chunk_s
        for r in live:
            r["pos_est"] = min(r["pos_est"] + self._max_advance,
                               r["stop_est"])
        must = any(r["stream_cb"] is not None for r in live) \
            or any(r["pos_est"] + 1 >= r["stop_est"] for r in live)
        deadline = max(self._chunk_s or 0.0, self.drain_deadline_s)
        if not self._queue.empty():
            deadline = min(deadline, 2 * (self._chunk_s or 0.0))
        if must or (self.eos_id >= 0 and _time.monotonic()
                    - self._last_drain >= deadline):
            self._drain()

    def _worker(self):
        carry = None  # a request popped while idle, kept first
        while not self._stopping:
            admitted = False
            with self._lock:
                free = [s for s in range(self.slots)
                        if self._slot_req[s] is None]
                pairs = []
                if carry is not None and free:
                    pairs.append((carry, free.pop(0)))
                    carry = None
                for slot in free:
                    try:
                        pairs.append((self._queue.get_nowait(), slot))
                    except queue.Empty:
                        break
                if pairs:
                    admitted = self._admit(pairs)
                live = [r for r in self._slot_req if r is not None]
                if live:
                    try:
                        self._decode_and_drain(live)
                    except Exception as e:  # noqa: BLE001 — device error:
                        # reset (announced first, so the other ranks reset
                        # too), then fail the live futures, so callers
                        # never hang on a dead worker
                        self._op("reset")
                        for slot, r in enumerate(self._slot_req):
                            if r is not None and not r["future"].done():
                                r["future"].set_exception(e)
                            self._slot_req[slot] = None
                        # the resident prompts' K/V is no longer trusted
                        self._slot_prompt = [None] * self.slots
                        self._last_drain = _time.monotonic()
                    continue
            if not admitted and carry is None:
                try:
                    carry = self._queue.get(timeout=0.05)
                except queue.Empty:
                    pass


def elm_continuous_batcher(elm_model, *, slots: int = 8, chunk: int = 8,
                           eos_id: int = -1, length: Optional[int] = None,
                           quant_cache: bool = False, draft=None,
                           gamma: int = 4,
                           lookup_ngram: Optional[int] = None,
                           device_lock: Optional[threading.Lock] = None,
                           prefix_min: int = 16) -> ContinuousBatcher:
    """Continuous batching for the OpenELM baseline (``models/elm.py``,
    the model on its device in eval mode) over its per-layer GQA caches;
    quant_cache=True: the int8 KV cache. draft=<a smaller OpenELM of the
    same vocabulary>: speculative rounds; lookup_ngram=N: prompt-lookup
    rounds. Both keep greedy rows' tokens those of plain decoding."""
    from unidisc_tpu_torch.models.elm import init_elm_cache
    cfg = elm_model.cfg
    dev = elm_model.token_embeddings.device
    L = length or cfg.max_length

    def apply_of(model):
        def apply_fn(tok, mod_tok, kv, cache_index):
            return model(tok, kv_cache=kv, cache_index=cache_index)
        return apply_fn

    def factory_of(model, quant):
        return lambda batch, n: init_elm_cache(model.cfg, batch, n,
                                               quant=quant, device=dev)

    draft_kw = {}
    if draft is not None:
        if draft.cfg.total_vocab != cfg.total_vocab:
            raise ValueError("the speculative draft must share the "
                             "target's vocabulary")
        draft_kw = dict(draft=(apply_of(draft), factory_of(draft, False)),
                        gamma=gamma)
    elif lookup_ngram:
        draft_kw = dict(lookup_ngram=lookup_ngram, gamma=gamma)
    return ContinuousBatcher(
        None, None, slots=slots, chunk=chunk, eos_id=eos_id,
        device_lock=device_lock, prefix_min=prefix_min,
        apply_fn=apply_of(elm_model),
        cache_factory=factory_of(elm_model, quant_cache),
        restrict_fn=lambda lg, mod: lg, length=L, cache_batch_axis=0,
        device=dev, **draft_kw)
