"""Rolling (continuous) batching for diffusion sampling (port of
``unidisc_tpu/serving/rolling.py``).

Every slot row carries its own denoise step, so new text->image or
infill requests are admitted into slots that finish mid-flight instead of
waiting for the whole batch:

  - one persistent ``RollingState`` on the device; ``step_chunk`` runs
    ``chunk`` denoise iterations. On the card it is one captured CUDA
    graph a built sampler (``sampling/graph.py::CapturedChunk``), replayed
    once a chunk over static state buffers; ``insert_many`` runs eager
    between replays and writes the new rows into those buffers in place.
    Every mutation of the state is in place (``copy_``, ``index_copy_``),
    inside and outside the graph.
  - per-row step indices: t, the guidance weight, the maskgit reveal
    budget and the noise-removal branch are taken per row, so rows at
    different stages share each forward batch;
  - per-row noise is a pure function of (request seed, row step, tag,
    element index) (``keyed_uniform``: a counter-based integer hash in
    plain torch integer ops, bit-identical on the CPU and on CUDA), so a
    request's tokens do not depend on when it was admitted or on the rows
    beside it. The draws are not JAX's threefry bits: as for every port
    sampler, parity with JAX is held under injected noise.

Restrictions, as in JAX: predictor must be "maskgit"; ``sampling.cfg ==
-1`` (the per-row CFG sweep) is refused; the t2i path refuses dilation.
The t2i path runs its CFG pass at every step (the JAX one skips it by a
device branch when every row's weight is 0; a guidance weight of 0 gives
the conditional logits either way).

On a device mesh (``mesh=``, a ``parallel/mesh.py::MeshLayout``) the S
slots are the global batch, split over the data-parallel ranks
(``parallel/sample.py::SlotSplit``): a rank's state machine holds its
slots' rows, takes global slot ids in ``insert_many`` (dropping the other
ranks') and reads injected noise at its global rows. A chunk runs outside
the "seq" ring, as JAX jits it outside ``spmd_sampler``; under "pp" its
forward runs in ``pipeline_parallel``. The keyed noise depends only on
(row seed, row step, tag), so a request's tokens are the one-rank
batcher's whatever its slot or rank. The threaded front end runs on the
leader (rank 0): each device op is an ``op_*`` method, announced before it
runs (``announce``) so that the other ranks' batchers, built without a
worker, replay it on their slots; the harvest is a gather of the rows to
rank 0.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import NamedTuple, Optional

import numpy as np
import torch

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.device import resolve_device
from unidisc_tpu_torch.diffusion.noise import get_noise
from unidisc_tpu_torch.diffusion.subs import subs_parameterization
from unidisc_tpu_torch.parallel.sample import SlotSplit, has_collectives
from unidisc_tpu_torch.sampling.sampler import (_LOG_1E_30,
                                                cfg_forward,
                                                check_model_device,
                                                confidence_threshold,
                                                guidance_weight_t)


class RollingState(NamedTuple):
    x: torch.Tensor          # (S, L) long current tokens
    x0: torch.Tensor         # (S, L) long conditioning tokens
    unmask: torch.Tensor     # (S, L) bool conditioning positions
    modality: torch.Tensor   # (S, L) long
    schedule: torch.Tensor   # (S, max_steps) long per-row reveal budget
    step: torch.Tensor       # (S,) long: 0..row_steps-1 denoise,
    #                          row_steps = finalize, row_steps+extra = done
    row_steps: torch.Tensor  # (S,) long per-request denoise step count
    seed: torch.Tensor       # (S,) long request seed
    active: torch.Tensor     # (S,) bool


def adaptive_schedule_ragged(num_masked: torch.Tensor, steps_v: torch.Tensor,
                             max_steps: int, mode: str) -> torch.Tensor:
    """Per-row unmasking schedule with per-row step counts, padded to
    (B, max_steps) long, in the JAX function's float32 operations. For
    uniform rows it is the whole-batch ``sampler.adaptive_schedule`` but
    for one JAX-side difference (linear mode at 16 steps, ROADMAP.md §3);
    rows of one step put the whole budget on that step (the 0/0 guard)."""
    dev = num_masked.device
    i = torch.arange(max_steps, device=dev)[None, :]
    steps_v = steps_v.long()
    act = i < steps_v[:, None]
    denom = torch.clamp(steps_v - 1, min=1)[:, None].float()
    r = torch.clamp(1.0 - i.float() / denom, 0.0, 1.0)
    if mode == "root":
        val = 1 - torch.sqrt(r)
    elif mode == "linear":
        val = 1 - r
    elif mode == "square":
        val = 1 - r ** 2
    elif mode == "cosine":
        val = torch.cos(r * np.float32(np.pi * 0.5))
    elif mode == "arccos":
        val = torch.arccos(r) / np.float32(np.pi * 0.5)
    else:
        raise ValueError(mode)
    val = torch.where(act, val, 0.0)
    frac = val / torch.clamp(val.sum(-1, keepdim=True), min=1e-9)
    nm = num_masked[:, None].float()
    sche = torch.round(frac * nm)
    sche = torch.where(act & (sche == 0), 1.0, sche)
    last_idx = steps_v - 1
    is_last = i == last_idx[:, None]
    sum_except_last = (sche * act).sum(-1) - \
        torch.gather(sche, 1, last_idx[:, None])[:, 0]
    last = torch.clamp(num_masked.float() - sum_except_last, min=0.0)
    sche = torch.where(is_last, last[:, None], sche)
    return torch.where(act, sche, 0.0).long()


# ---------------------------------------------------------------------------
# keyed noise
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32_(x: torch.Tensor, c: int) -> torch.Tensor:
    """x = x * c mod 2^32, in place, for int64 x in [0, 2^32): the product
    is formed from c's 16-bit halves, so no int64 product exceeds 2^49."""
    hi = x * (c >> 16)
    hi.bitwise_and_(0xFFFF).bitwise_left_shift_(16)
    x.mul_(c & 0xFFFF).add_(hi).bitwise_and_(_M32)
    return x


def _mix32_(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser, in place: a bijection of [0, 2^32)
    with full avalanche."""
    x.bitwise_xor_(x >> 16)
    _mul32_(x, 0x85EBCA6B)
    x.bitwise_xor_(x >> 13)
    _mul32_(x, 0xC2B2AE35)
    return x.bitwise_xor_(x >> 16)


def _row_keys(seed: torch.Tensor, step: torch.Tensor, tag: int):
    """Two 32-bit keys a row, functions of (seed, step, tag) only."""
    k = _mix32_((seed.long() & _M32) ^ 0x9E3779B9)
    k = _mix32_(k.bitwise_xor_(step.long() & _M32))
    k = _mix32_(k.bitwise_xor_((tag * 0x632BE5AB) & _M32))
    return k, _mix32_(k ^ 0x5BD1E995)


def unit_interval(bits: torch.Tensor) -> torch.Tensor:
    """23-bit integers in [0, 2^23) -> float32 (bits + 1/2) / 2^23, every
    value exact and strictly inside (0, 1). (With 24 bits the top value,
    1 - 2^-25, is not a float32 and rounds to 1.0, whose Gumbel noise is
    infinite.)"""
    return (bits.float() + 0.5) * np.float32(2.0 ** -23)


def keyed_uniform(seed: torch.Tensor, step: torch.Tensor, tag: int,
                  n: int) -> torch.Tensor:
    """(S, n) float32 uniforms in (0, 1), element j of row r a pure
    function of (seed[r], step[r], tag, j): the top 23 bits of two rounds
    of the finaliser over the element's index, offset by half a step
    (``unit_interval``). Integer ops and exact float conversions only, so
    the CPU and CUDA give the same bits."""
    k1, k2 = _row_keys(seed, step, tag)
    h = torch.arange(n, device=seed.device)[None, :] ^ k1[:, None]
    _mix32_(h)
    h.bitwise_xor_(k2[:, None])
    _mix32_(h)
    return unit_interval(h >> 9)


def keyed_gumbel(seed: torch.Tensor, step: torch.Tensor, tag: int,
                 n: int) -> torch.Tensor:
    """(S, n) float32 standard Gumbel noise, -log(-log(u)) of
    ``keyed_uniform``."""
    return -torch.log(-torch.log(keyed_uniform(seed, step, tag, n)))


# ---------------------------------------------------------------------------
# the state machines
# ---------------------------------------------------------------------------

class _Rolling:
    """What the generic and the t2i rolling samplers share: the state,
    its in-place scatter and reset, the per-row timestep, the chunk loop."""

    def __init__(self, model, config: Config, slots, num_steps, chunk,
                 inject_noise, device, extra, mesh=None):
        self.device = resolve_device(device)
        check_model_device(model, self.device)
        s = config.sampling
        if s.predictor != "maskgit":
            raise ValueError(f"rolling batching supports predictor='maskgit' "
                             f"(got {s.predictor!r})")
        if s.cfg == -1:
            # the sweep maps the guidance weight to the batch row, an
            # accident of slot assignment under rolling admission
            raise ValueError("sampling.cfg == -1 (the per-row CFG sweep) is "
                             "incompatible with rolling batching; use the "
                             "whole-batch sampler for sweeps")
        self.model, self.config = model, config
        self.noise = get_noise(config.noise)
        self.steps = num_steps or s.steps   # per-row maximum and default
        # slots: this rank's rows of the split's global slots
        self.split = SlotSplit(slots, config, mesh)
        self.slots, self.chunk = self.split.local, chunk
        self.inject_noise = inject_noise
        self.use_cfg = s.cfg is not None
        self.extra = extra
        self.done_at = self.steps + extra   # a row finishes at its own
        #                                     row_steps + extra

    def init_state(self) -> RollingState:
        m, S, dev = self.config.model, self.slots, self.device
        z = lambda *shape: torch.zeros(shape, dtype=torch.long, device=dev)
        return RollingState(
            x=torch.full((S, m.length), m.mask_index, dtype=torch.long,
                         device=dev),
            x0=z(S, m.length),
            unmask=torch.zeros((S, m.length), dtype=torch.bool, device=dev),
            modality=z(S, m.length), schedule=z(S, self.steps),
            step=torch.full((S,), self.done_at, dtype=torch.long,
                            device=dev),
            row_steps=torch.full((S,), self.steps, dtype=torch.long,
                                 device=dev),
            seed=z(S), active=torch.zeros((S,), dtype=torch.bool,
                                          device=dev))

    @torch.no_grad()
    def reset(self, state: RollingState) -> None:
        """Every row inactive and done, in place."""
        state.active.zero_()
        state.step.fill_(self.done_at)

    def _scatter(self, state: RollingState, slots_v, rows: dict, seeds,
                 steps_v, num_masked) -> None:
        """Write n requests into their slots in place. slots_v are global
        slot ids: slots >= S are padding and, on a mesh, other ranks' slots
        are theirs; both are dropped here, on the host (admission groups
        are bucketed). The schedule is computed on the host, so a request's
        schedule is the same whichever device serves it."""
        slots_v = np.asarray(torch.as_tensor(slots_v).cpu()).astype(np.int64)
        if (slots_v < 0).any():
            raise ValueError(f"negative slot in {slots_v.tolist()}")
        slots_v = self.split.own(slots_v)
        n = slots_v.shape[0]
        if steps_v is None:
            steps_v = torch.full((n,), self.steps, dtype=torch.long)
        steps_v = torch.as_tensor(steps_v).cpu().long()
        if ((steps_v < 1) | (steps_v > self.steps)).any():
            raise ValueError(f"row steps {steps_v.tolist()} outside "
                             f"[1, {self.steps}]")
        keep = torch.from_numpy(np.nonzero(slots_v < self.slots)[0])
        if keep.numel() == 0:
            return
        idx = torch.from_numpy(slots_v).index_select(0, keep).to(self.device)
        sche = adaptive_schedule_ragged(num_masked.cpu(), steps_v, self.steps,
                                        self.config.sampling.maskgit_mode)
        seeds = torch.as_tensor(seeds).cpu().long()
        rows = {**rows, "schedule": sche, "row_steps": steps_v,
                "seed": seeds, "step": torch.zeros((n,), dtype=torch.long),
                "active": torch.ones((n,), dtype=torch.bool)}
        for name, value in rows.items():
            dst = getattr(state, name)
            dst.index_copy_(0, idx, value.index_select(0, keep).to(
                self.device, dst.dtype))

    def _timestep(self, st: RollingState):
        """Per-row (t, step clipped into [0, row_steps)): the whole-batch
        sampler's timesteps[i] = 1 - i (1 - eps) / steps at each row's own
        step count, and sampling_eps for the noise-removal step."""
        eps = self.config.sampling.sampling_eps
        rs = st.row_steps
        step_c = torch.minimum(st.step.clamp(min=0), rs - 1)
        t_lin = 1.0 - step_c.float() * (1.0 - eps) / rs.clamp(min=1).float()
        return torch.where(st.step >= rs, eps, t_lin), step_c

    def _picked_noise(self, injected, name, st):
        """Each row's injected noise at its own step and its global
        slot."""
        gi = st.step.clamp(0, self.steps - 1)
        lo = self.split.lo
        return injected[name][gi, torch.arange(lo, lo + self.slots,
                                               device=gi.device)]

    def _advance(self, st: RollingState) -> None:
        st.step.copy_(torch.where(
            st.active, torch.minimum(st.step + 1, st.row_steps + self.extra),
            st.step))

    @torch.no_grad()
    def step_chunk(self, state: RollingState, injected=None) -> RollingState:
        """`chunk` denoise iterations over every active row, in place."""
        if (injected is not None) != self.inject_noise:
            raise ValueError("pass `injected` exactly when the sampler was "
                             "built with inject_noise=True")
        if injected is not None:
            injected = {k: torch.as_tensor(v).to(self.device, torch.float32)
                        for k, v in injected.items()}
        with self.split.forward():
            for _ in range(self.chunk):
                self._body(state, injected)
        return state


class RollingSampler(_Rolling):
    """The generic rolling sampler (``build_rolling_sampler``)."""

    def __init__(self, model, config, slots, num_steps, chunk, inject_noise,
                 device, mesh=None):
        super().__init__(model, config, slots, num_steps, chunk,
                         inject_noise, device,
                         1 if config.sampling.noise_removal else 0, mesh)

    def noise_shapes(self) -> dict:
        """The injected noise arrays this sampler reads, by name (at the
        global slots)."""
        m = self.config.model
        base = (self.steps, self.split.slots, m.length)
        return {"exp": base + (m.vocab_size,), "gumbel": base}

    @torch.no_grad()
    def insert_many(self, state, slots_v, x0, unmask, modality, seeds,
                    steps_v=None) -> RollingState:
        """Scatter n requests into their slots (slot >= S: padding,
        dropped); steps_v: per-request denoise step counts <= the maximum
        (default: the maximum)."""
        mask_index = self.config.model.mask_index
        x0 = torch.as_tensor(x0).cpu().long()
        unmask = torch.as_tensor(unmask).cpu().bool()
        x_init = torch.where(unmask, x0, mask_index)
        self._scatter(state, slots_v, {
            "x": x_init, "x0": x0, "unmask": unmask,
            "modality": torch.as_tensor(modality).cpu().long()},
            seeds, steps_v, (x_init == mask_index).sum(-1))
        return state

    def _forward(self, st: RollingState, t):
        """Unnormalized masked log-weights with CFG at per-row t (the JAX
        rolling forward; Gumbel-argmax is shift-invariant and confidences
        take an explicit logsumexp)."""
        m = self.config.model
        mask_index = m.mask_index
        sigma = self.noise.total(t)
        mk = dict(modality=st.modality, text_vocab_size=m.text_vocab_size) \
            if m.force_argmax_valid_indices else {}
        if self.use_cfg:
            x_uncond = torch.where(st.unmask, mask_index, st.x)
            logits = cfg_forward(self.model, st.x, x_uncond, sigma,
                                 modality=st.modality)
            logit_c, logit_u = logits.chunk(2, dim=0)
            w = guidance_weight_t(self.config.sampling, t)[:, None, None]
            combined = (1 + w) * logit_c - w * logit_u
            return subs_parameterization(combined, None, mask_index,
                                         normalize=False, **mk)
        logits = self.model(st.x, sigma, modality=st.modality)
        return subs_parameterization(logits, st.x, mask_index,
                                     normalize=False, **mk)

    def _body(self, st: RollingState, injected) -> None:
        s = self.config.sampling
        mask_index = self.config.model.mask_index
        rs = st.row_steps
        denoise = st.active & (st.step < rs)
        # without noise removal a row at step == row_steps is done and
        # freezes
        final = st.active & (st.step == rs) if self.extra else \
            torch.zeros_like(denoise)
        t, step_c = self._timestep(st)
        raw = self._forward(st, t)
        S, L, V = raw.shape
        if injected is not None:
            exp_n = self._picked_noise(injected, "exp", st)
            gum_n = self._picked_noise(injected, "gumbel", st)
            pred = torch.argmax(raw - torch.log(exp_n), dim=-1)
        else:
            g_tok = keyed_gumbel(st.seed, st.step, 1, L * V).view(S, L, V)
            gum_n = keyed_gumbel(st.seed, st.step, 2, L)
            pred = torch.argmax(raw + g_tok.to(raw.dtype), dim=-1)
            del g_tok
        copy = st.x != mask_index
        lse = torch.logsumexp(raw, dim=-1)
        conf = torch.gather(raw, -1, pred[..., None])[..., 0] - lse
        conf = torch.clamp(conf, min=_LOG_1E_30)
        conf = conf + s.maskgit_r_temp * gum_n * t[:, None]
        conf = torch.where(copy, float("-inf"), conf)
        num = torch.gather(st.schedule, 1, step_c[:, None])[:, 0]
        num = torch.minimum(num, (~copy).sum(-1))
        x_mg = torch.where(conf >= confidence_threshold(conf, num), pred,
                           st.x)
        # noise removal: rows at step == row_steps take argmax of the rest
        x_fin = torch.where(st.x == mask_index, torch.argmax(raw, -1), st.x)
        x_next = torch.where(denoise[:, None], x_mg,
                             torch.where(final[:, None], x_fin, st.x))
        st.x.copy_(torch.where(st.unmask, st.x0, x_next))
        self._advance(st)


class RollingT2ISampler(_Rolling):
    """Rolling batching on the span-factored t2i path
    (``build_rolling_t2i``): each chunk's forward runs the trunk and the
    image-span x image-vocab head (``sampling/t2i_fast.py``); the text is
    conditioning by construction."""

    def __init__(self, model, config, slots, num_steps, chunk, inject_noise,
                 device, mesh=None):
        s = config.sampling
        if s.predictor != "maskgit":
            raise ValueError("rolling t2i supports predictor='maskgit'")
        if s.maskgit_dilation and s.maskgit_dilation > 1:
            raise ValueError("rolling t2i does not schedule dilated groups; "
                             "use per-request low step counts instead")
        super().__init__(model, config, slots, num_steps, chunk,
                         inject_noise, device, 1, mesh)
        from unidisc_tpu_torch.sampling.t2i_fast import img_log_weights_fn
        m = config.model
        self._log_w = img_log_weights_fn(model, config)
        self._modality = torch.cat([
            torch.zeros((self.slots, m.txt_length), dtype=torch.long),
            torch.ones((self.slots, m.img_length), dtype=torch.long)],
            -1).to(self.device)

    def noise_shapes(self) -> dict:
        """The injected noise arrays this sampler reads, by name (at the
        global slots)."""
        m = self.config.model
        base = (self.steps, self.split.slots, m.img_length)
        return {"gumbel_tok": base + (m.image_vocab_size,),
                "gumbel_conf": base}

    @torch.no_grad()
    def insert_many(self, state, slots_v, txt, seeds,
                    steps_v=None) -> RollingState:
        """Scatter n text prompts (n, Lt) into their slots."""
        m = self.config.model
        txt = torch.as_tensor(txt).cpu().long()
        n = txt.shape[0]
        x_init = torch.cat([txt, torch.full((n, m.img_length), m.mask_index,
                                            dtype=torch.long)], -1)
        self._scatter(state, slots_v, {"x": x_init}, seeds, steps_v,
                      torch.full((n,), m.img_length, dtype=torch.long))
        return state

    def _body(self, st: RollingState, injected) -> None:
        m, s = self.config.model, self.config.sampling
        lt, v0, mask_index = m.txt_length, m.text_vocab_size, m.mask_index
        rs = st.row_steps
        denoise = st.active & (st.step < rs)
        final = st.active & (st.step == rs)
        t, step_c = self._timestep(st)
        w = guidance_weight_t(s, t) if self.use_cfg else None
        raw = self._log_w(st.x, t, self._modality, w)   # (S, Li, Vi) fp32
        S, Li, Vi = raw.shape
        if injected is not None:
            g_tok = self._picked_noise(injected, "gumbel_tok", st)
            g_conf = self._picked_noise(injected, "gumbel_conf", st)
        else:
            g_tok = keyed_gumbel(st.seed, st.step, 1, Li * Vi).view(S, Li,
                                                                    Vi)
            g_conf = keyed_gumbel(st.seed, st.step, 2, Li)
        pred_local = torch.argmax(raw + g_tok.to(raw.dtype), dim=-1)
        del g_tok
        lse = torch.logsumexp(raw, dim=-1)
        conf = torch.gather(raw, -1, pred_local[..., None])[..., 0] - lse
        img = st.x[:, lt:]
        eligible = img == mask_index
        num = torch.gather(st.schedule, 1, step_c[:, None])[:, 0]
        num = torch.minimum(num, eligible.sum(-1))
        conf = conf + s.maskgit_r_temp * g_conf * t[:, None]
        conf = torch.where(eligible, conf, float("-inf"))
        thresh = confidence_threshold(conf, num)
        img_mg = torch.where((conf >= thresh) & eligible, pred_local + v0,
                             img)
        img_fin = torch.where(img == mask_index, torch.argmax(raw, -1) + v0,
                              img)
        img_next = torch.where(denoise[:, None], img_mg,
                               torch.where(final[:, None], img_fin, img))
        img.copy_(img_next)
        self._advance(st)


def build_rolling_sampler(model, config: Config, *, slots: int,
                          num_steps: Optional[int] = None, chunk: int = 8,
                          inject_noise: bool = False, device="cuda",
                          mesh=None) -> RollingSampler:
    """The generic rolling state machine over `model` (already on `device`,
    in eval mode; on a mesh, `mesh` the rank's MeshLayout and `slots` the
    global count, module docstring):

      init_state() -> RollingState
      insert_many(state, slots_v, x0, unmask, modality, seeds[, steps_v])
      step_chunk(state[, injected]): `chunk` denoise iterations, eager
        (``sampling/graph.py::CapturedChunk`` is the captured program)
      done_at, steps, chunk, extra

    inject_noise=True: step_chunk takes ``injected`` = {"exp" (steps, S, L,
    V), "gumbel" (steps, S, L)}, each row reading its own step's slice, the
    JAX contract; otherwise the keyed noise."""
    return RollingSampler(model, config, slots, num_steps, chunk,
                          inject_noise, device, mesh)


def build_rolling_t2i(model, config: Config, *, slots: int,
                      num_steps: Optional[int] = None, chunk: int = 8,
                      inject_noise: bool = False, device="cuda",
                      mesh=None) -> RollingT2ISampler:
    """The span-factored t2i rolling state machine; as
    ``build_rolling_sampler`` with insert_many(state, slots_v, txt, seeds[,
    steps_v]) and injected {"gumbel_tok" (steps, S, Li, image_vocab),
    "gumbel_conf" (steps, S, Li)}."""
    return RollingT2ISampler(model, config, slots, num_steps, chunk,
                             inject_noise, device, mesh)


def _bucket(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


# ---------------------------------------------------------------------------
# threaded front ends
# ---------------------------------------------------------------------------

class RollingDiffusionBatcher:
    """Threaded front end: submit() returns a Future of the (L,) token row;
    a worker admits pending requests into free slots (bucketed, padded
    with dropped slot-S rows, one insert an admission group) and advances
    the whole batch `chunk` denoise steps per dispatch. On the card the
    chunk is the captured program over the batcher's static state, built
    here under the dispatch lock (eager where the mesh puts collectives in
    the chunk, ``parallel/sample.py::has_collectives``).

    The device work is five ops, ``op_insert``, ``op_chunk``,
    ``op_harvest`` (step and active of every slot), ``op_rows`` (the token
    rows, read only when a row finished) and ``op_reset``; each is passed
    to `announce(name, kwargs)` before it runs, so that on a mesh (`mesh`,
    the rank's MeshLayout) the other ranks' batchers, built with
    ``worker=False``, replay it on their slots. ``slots`` is the global
    count (rounded up to the mesh granule); the harvest's reads are
    gathers to rank 0. Counters: ``chunks``, ``harvests``, ``row_reads``.

    A device error in the worker announces the reset, resets the state
    and fails every owned and queued future, so callers never hang on a
    dead worker; shutdown() fails what is outstanding too.
    `dispatch_lock` serializes device work with the engine's other routes
    (the engine passes its _device_lock: a capture in progress must see no
    CUDA call from another thread)."""

    def __init__(self, model, config: Config, *, slots: int = 8,
                 chunk: int = 8, num_steps: Optional[int] = None,
                 dispatch_lock=None, device="cuda", mesh=None,
                 announce=None, worker: bool = True):
        self.built = build_rolling_sampler(model, config, slots=slots,
                                           chunk=chunk, num_steps=num_steps,
                                           device=device, mesh=mesh)
        self._start(config, mesh, dispatch_lock, announce, worker)

    # shared front-end machinery (also used by RollingT2IBatcher)
    def _start(self, config, mesh, dispatch_lock, announce, worker):
        self.L, self.Lt = config.model.length, config.model.txt_length
        self.vocab_size = config.model.vocab_size
        self.split = self.built.split
        self.slots = self.split.slots
        self._announce = announce
        self._dispatch_lock = dispatch_lock or threading.Lock()
        self.program = None
        with self._dispatch_lock:
            if self.built.device.type == "cuda" and not (
                    mesh is not None and has_collectives(config, mesh,
                                                         ring=False)):
                from unidisc_tpu_torch.sampling.graph import CapturedChunk
                self.program = CapturedChunk(self.built)
                self.state = self.program.state
                self.step_chunk = self.program.step_chunk
            else:
                self.state = self.built.init_state()
                self.step_chunk = self.built.step_chunk
        self.chunks = self.harvests = self.row_reads = 0
        self._pending: "queue.Queue" = queue.Queue()
        self._submit_lock = threading.Lock()
        self._owner = [None] * self.slots   # slot -> Future | None
        # per-slot finish line: row_steps + extra
        self._done = [self.built.done_at] * self.slots
        self._stop = False
        self._wake = threading.Event()
        self._thread = None
        if worker:
            self._thread = threading.Thread(target=self._worker,
                                            daemon=True)
            self._thread.start()

    def _check_steps(self, steps: Optional[int]) -> int:
        steps = self.built.steps if steps is None else int(steps)
        if not 1 <= steps <= self.built.steps:
            raise ValueError(f"steps={steps} outside [1, {self.built.steps}]")
        return steps

    def _check_ids(self, *rows) -> None:
        """Every id of a request inside the vocabulary, checked before it
        is queued (an id past the embedding table is a device-side assert
        on the card, and on a mesh no replay may fail on a request)."""
        for row in rows:
            if row.size and (row.min() < 0 or row.max() >= self.vocab_size):
                raise ValueError(f"token ids outside [0, {self.vocab_size})")

    # ------------------------------------------------------------------
    # the device ops (run under the dispatch lock; replayed on a mesh)
    def _op(self, name: str, **kw):
        if self._announce is not None:
            self._announce(name, kw)
        return getattr(self, "op_" + name)(**kw)

    def op_insert(self, slots_v, rows, seeds, steps_v):
        x0, unmask, modality = rows
        self.built.insert_many(self.state, slots_v, x0, unmask, modality,
                               seeds, steps_v)

    def op_chunk(self):
        self.step_chunk(self.state)
        self.chunks += 1

    def op_harvest(self):
        """(S, 2) step and active of every global slot on the leader
        (None on the other ranks): one host read, a gather on a mesh."""
        self.harvests += 1
        return self.split.gather(torch.stack(
            [self.state.step, self.state.active.long()], 1))

    def op_rows(self):
        """The (S, L) token rows on the leader (None elsewhere)."""
        self.row_reads += 1
        return self.split.gather(self.state.x)

    def op_reset(self):
        self.built.reset(self.state)

    def warmup(self):
        """One all-padding admission per bucket and one chunk on the empty
        state, under the dispatch lock (the capture happened at
        construction); announced like any op."""
        with self._dispatch_lock:
            b = 1
            while True:
                b = min(b, self.slots)
                self._op("insert", slots_v=np.full((b,), self.slots,
                                                   np.int64),
                         rows=self._empty_rows(b),
                         seeds=np.zeros((b,), np.int64),
                         steps_v=np.full((b,), self.built.steps, np.int64))
                if b == self.slots:
                    break
                b *= 2
            if not any(o is not None for o in self._owner):
                self._op("chunk")
                self._op("harvest")

    def submit(self, x0: np.ndarray, unmask: np.ndarray,
               modality: Optional[np.ndarray] = None, seed: int = 0,
               steps: Optional[int] = None) -> Future:
        """steps: per-request denoise step count <= the batcher's maximum
        (e.g. 8 for a fast request sharing a 32-step batch)."""
        fut: Future = Future()
        if modality is None:
            modality = np.zeros((self.L,), np.int64)
        steps = self._check_steps(steps)
        row = (np.asarray(x0, np.int64), np.asarray(unmask, bool),
               np.asarray(modality, np.int64))
        if row[0].shape != (self.L,) or row[1].shape != (self.L,) \
                or row[2].shape != (self.L,):
            raise ValueError(f"a request row is ({self.L},)")
        self._check_ids(row[0])
        self._enqueue((row, int(seed), steps, fut))
        return fut

    def _enqueue(self, item):
        # the stop check and the put share a lock with shutdown's drain, or
        # a submit racing shutdown could enqueue after the final drain
        with self._submit_lock:
            if self._stop:
                raise RuntimeError("batcher is shut down")
            if self._thread is None:
                raise RuntimeError("this batcher replays a leader's ops; "
                                   "it takes no requests")
            self._pending.put(item)
        self._wake.set()

    def shutdown(self):
        with self._submit_lock:
            self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        self._fail_outstanding(RuntimeError("batcher shut down"))

    def _fail_outstanding(self, exc):
        for i, fut in enumerate(self._owner):
            if fut is not None:
                self._owner[i] = None
                if not fut.done():
                    fut.set_exception(exc)
        while True:
            try:
                item = self._pending.get_nowait()
            except queue.Empty:
                break
            fut = item[-1]
            if not fut.done():
                fut.set_exception(exc)

    # ------------------------------------------------------------------
    def _take_group(self):
        free = [i for i, o in enumerate(self._owner) if o is None]
        group = []
        while free and len(group) < len(free):
            try:
                group.append(self._pending.get_nowait())
            except queue.Empty:
                break
        return free, group

    def _admit(self) -> bool:
        free, group = self._take_group()
        if not group:
            return False
        n = _bucket(len(group), self.slots)
        slots_v = np.full((n,), self.slots, np.int64)   # S = dropped pad
        rows = self._empty_rows(n)
        seeds = np.zeros((n,), np.int64)
        steps_v = np.full((n,), self.built.steps, np.int64)
        for j, (row, seed, stp, fut) in enumerate(group):
            slot = free[j]
            slots_v[j] = slot
            self._fill_row(rows, j, row)
            seeds[j], steps_v[j] = seed, stp
            self._owner[slot] = fut
            self._done[slot] = stp + self.built.extra
        self._op("insert", slots_v=slots_v, rows=rows, seeds=seeds,
                 steps_v=steps_v)
        return True

    # per-mode row packing hooks
    def _empty_rows(self, n):
        return (np.zeros((n, self.L), np.int64), np.zeros((n, self.L), bool),
                np.zeros((n, self.L), np.int64))

    def _fill_row(self, rows, j, row):
        rows[0][j], rows[1][j], rows[2][j] = row

    # ------------------------------------------------------------------
    def _harvest(self):
        """One read of step and active (S,) a chunk decides who finished;
        the (S, L) tokens come to the host only when someone did."""
        step, active = self._op("harvest").T
        done = [i for i, o in enumerate(self._owner)
                if o is not None and active[i] and step[i] >= self._done[i]]
        if not done:
            return
        rows = self._op("rows")
        for i in done:
            fut, self._owner[i] = self._owner[i], None
            if not fut.done():
                fut.set_result(rows[i].copy())

    def _worker(self):
        while not self._stop:
            try:
                with self._dispatch_lock:
                    admitted = self._admit()
                busy = any(o is not None for o in self._owner)
                if not busy and not admitted:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                with self._dispatch_lock:
                    self._op("chunk")
                    self._harvest()
            except Exception as e:  # noqa: BLE001 — device errors
                # reset (announced first, so the other ranks reset too),
                # then fail everyone: callers must never hang on a dead
                # worker, and a caller whose future failed finds the state
                # already reset
                self._done = [self.built.done_at] * self.slots
                try:
                    with self._dispatch_lock:
                        self._op("reset")
                except Exception:  # noqa: BLE001
                    self._stop = True
                self._fail_outstanding(e)
                if self._stop:
                    return


class RollingT2IBatcher(RollingDiffusionBatcher):
    """The rolling front end on the span-factored t2i path
    (``build_rolling_t2i``): submit() takes the text prompt row. Shares the
    worker, the ops, the harvest and failure handling with the base class;
    only the build and the row-packing hooks differ."""

    def __init__(self, model, config: Config, *, slots: int = 8,
                 chunk: int = 8, num_steps: Optional[int] = None,
                 dispatch_lock=None, device="cuda", mesh=None,
                 announce=None, worker: bool = True):
        self.built = build_rolling_t2i(model, config, slots=slots,
                                       chunk=chunk, num_steps=num_steps,
                                       device=device, mesh=mesh)
        self._start(config, mesh, dispatch_lock, announce, worker)

    def submit(self, txt: np.ndarray, seed: int = 0,
               steps: Optional[int] = None) -> Future:
        fut: Future = Future()
        steps = self._check_steps(steps)
        txt = np.asarray(txt, np.int64)
        if txt.shape != (self.Lt,):
            raise ValueError(f"a text row is ({self.Lt},)")
        self._check_ids(txt)
        self._enqueue((txt, int(seed), steps, fut))
        return fut

    def _empty_rows(self, n):
        return np.zeros((n, self.Lt), np.int64)

    def _fill_row(self, rows, j, row):
        rows[j] = row

    def op_insert(self, slots_v, rows, seeds, steps_v):
        self.built.insert_many(self.state, slots_v, rows, seeds, steps_v)
