"""The optimizers of the port's train step (port of the optax chains of
``unidisc_tpu/training/train_state.py::make_optimizer``).

Each is ``optax.chain(clip_by_global_norm(max_norm), <optimizer>[,
mup_lr_scale])`` with optax's arithmetic, updating in place:

  * ``ClippedAdamW``: ``optax.adamw``;
  * ``ClippedLion``: ``optax.lion`` (sign of the b1-interpolated momentum,
    momentum at b2, decoupled weight decay);
  * ``ClippedAdEMAMix``: ``optax.contrib.ademamix`` (fast EMA at b1, slow
    EMA at b3 0.9999 mixed in with alpha 5, Adam's second moment);
  * ``ClippedAdafactor``: ``optax.adafactor(schedule,
    weight_decay_rate=wd or None)``: the factored second moment of every
    leaf with two dims >= 128 (decay 1 - (count + 1)^-0.8, eps 1e-30), the
    update clipped to RMS 1 per leaf, times the LR, times the leaf's
    parameter RMS (at least 1e-3), plus wd x the parameter (after the LR,
    as optax adds it), negated;
  * ``ClippedMuon``: ``optax.contrib.muon(beta=0.95, nesterov=True)``:
    Nesterov momentum orthogonalized by 5 Newton-Schulz steps on the
    block matrices that ``training/muon.py`` routes, scaled by
    sqrt(max(1, out / in)), with decoupled weight decay; Nesterov AdamW
    (eps 1e-8, no weight decay) on every other parameter.

The rules that read a leaf's shape or its RMS (Adafactor, Muon, muP) run
on the flax leaves (``training/layout.py``): a DIT block parameter is one
scan-stacked leaf across the blocks, a kernel is (in, out).

Counts follow optax: every transform of the chain keeps its own count,
the learning rate is read at the schedule's count before the update, and
a step whose loss is not finite (``ok`` False) leaves the parameters and
the whole state, counts included, as they were: a device ``torch.where``,
with nothing read back to the host. Elementwise state (moments) is one
flat buffer in the parameters' order; Adafactor's factored moments are
tensors of each leaf's shape.

With ``model.mup`` the final update of every parameter is multiplied by
its muP LR multiplier (``training/mup.py``), as ``mup_lr_scale`` does at
the end of the JAX chain.

On a device mesh (``init(..., leaves=)``, a ``training/leaf_shards.py::
LeafShards``) the parameters and the gradient are the rank's parts, the
gradient's norm that of the whole (the train step's). The elementwise
chains run on the parts as they are. The rules that read a whole leaf
decide on its whole shape (Adafactor's factored dims, Muon's scale, muP's
fan-in); Adafactor's moments, block RMS and parameter RMS are partial sums
over the rank's part summed over the axes that split the leaf (its
factored moments are the rank's parts of the row and column vectors);
Muon gathers each momentum matrix whole over the axes that split its
(in, out) dims, orthogonalizes it and keeps the rank's part.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, Optional

import numpy as np
import torch

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.training.layout import ParamLayout

Params = Dict[str, torch.Tensor]

OPTIMIZERS = ("adamw", "lion", "ademamix", "adafactor", "muon")


def flat_views(flat: torch.Tensor, like: Params) -> Params:
    """Views of a flat buffer shaped like `like`, in its order."""
    out, off = {}, 0
    for name, p in like.items():
        out[name] = flat[off:off + p.numel()].view(p.shape)
        off += p.numel()
    return out


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------

def _linear(init: float, end: float, steps: int):
    """optax.linear_schedule."""
    if steps <= 0:
        return lambda count: torch.full_like(count, init, dtype=torch.float32)

    def schedule(count):
        c = count.clamp(0, steps).float()
        return (init - end) * (1 - c / steps) + end
    return schedule


def _cosine(init: float, decay_steps: int, alpha: float = 0.0):
    """optax.cosine_decay_schedule."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def schedule(count):
        c = torch.minimum(count.float(), torch.tensor(float(decay_steps),
                                                      device=count.device))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return init * ((1 - alpha) * cosine + alpha)
    return schedule


def _join(schedules, boundaries):
    """optax.join_schedules."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, fn in zip(boundaries, schedules[1:]):
            out = torch.where(count < boundary, out, fn(count - boundary))
        return out
    return schedule


def make_lr_schedule(config: Config):
    """count (an int tensor) -> learning rate (fp32 tensor on its device):
    constant_warmup, cosine_decay, constant_warmup_cosine_decay or
    cosine_hard_restarts, as in the JAX package."""
    t = config.trainer
    if t.scale_lr_by_batch_size:
        t = replace(t, lr=t.lr * t.global_batch_size / 512)
    total = max(t.max_steps, t.warmup_steps + 1)
    warmup = _linear(t.warmup_lr_init, t.lr, t.warmup_steps)
    if t.lr_schedule == "constant_warmup":
        return _join([warmup, lambda c: torch.full_like(
            c, t.lr, dtype=torch.float32)], [t.warmup_steps])
    if t.lr_schedule == "cosine_decay":
        return _join([warmup, _cosine(t.lr, total - t.warmup_steps)],
                     [t.warmup_steps])
    if t.lr_schedule == "constant_warmup_cosine_decay":
        return _join([warmup, _cosine(t.lr, max(total - t.warmup_steps, 1),
                                      alpha=t.lr_min / t.lr)],
                     [t.warmup_steps])
    if t.lr_schedule == "cosine_hard_restarts":
        decay_len = max(total - t.warmup_steps, 1)

        def restarts(step):
            progress = step / decay_len
            phase = torch.remainder(
                t.num_cycles * torch.clamp(progress, max=1.0), 1.0)
            return (t.lr * 0.5 * (1.0 + torch.cos(math.pi * phase))
                    * (progress < 1.0))

        return _join([warmup, restarts], [t.warmup_steps])
    raise ValueError(t.lr_schedule)


# ---------------------------------------------------------------------------
# states
# ---------------------------------------------------------------------------

def _count(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


@dataclass
class AdamState:
    """optax ScaleByAdamState, with the moments as flat buffers in the
    order of the parameters."""
    count: torch.Tensor   # () int32
    mu: torch.Tensor      # flat, the parameters' dtype
    nu: torch.Tensor


@dataclass
class OptState:
    """The state of ``chain(clip_by_global_norm, adamw)``: the Adam state
    and the count of the learning-rate schedule (optax
    ScaleByScheduleState); the clip and the weight decay keep none.
    ``mup``: the flat muP multipliers, or None."""
    adam: AdamState
    schedule_count: torch.Tensor   # () int32
    mup: Optional[torch.Tensor] = None

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {"adam_count": self.adam.count, "mu": self.adam.mu,
                "nu": self.adam.nu, "schedule_count": self.schedule_count}

    def sliced(self, part: slice) -> "OptState":
        """This state over elements `part` of the flat buffers (views;
        the counts shared)."""
        return OptState(adam=AdamState(count=self.adam.count,
                                       mu=self.adam.mu[part],
                                       nu=self.adam.nu[part]),
                        schedule_count=self.schedule_count,
                        mup=None if self.mup is None else self.mup[part])


@dataclass
class GenericOptState:
    """The state of the other chains: named tensors (flat buffers, or a
    leaf's factored moments) and named () int32 counts. ``layout`` and
    ``mup`` are derived from the parameters and are not saved."""
    counts: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    layout: Optional[ParamLayout] = field(default=None, repr=False)
    mup: Optional[torch.Tensor] = None
    # on a mesh: the splits of the rank's leaves (training/leaf_shards.py)
    leaves: Optional[object] = field(default=None, repr=False)

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {**{f"count/{k}": v for k, v in self.counts.items()},
                **{f"buffer/{k}": v for k, v in self.buffers.items()}}

    def sliced(self, part: slice) -> "GenericOptState":
        """This state over elements `part` of its flat buffers (views; the
        counts shared): for the elementwise chains only."""
        return GenericOptState(
            counts=self.counts,
            buffers={k: v[part] for k, v in self.buffers.items()},
            layout=self.layout,
            mup=None if self.mup is None else self.mup[part],
            leaves=self.leaves)


# ---------------------------------------------------------------------------
# the chains
# ---------------------------------------------------------------------------

class _Clipped:
    """clip_by_global_norm, then ``update`` (the optimizer's rule: the
    update to add to p, and the new state tensors), then the muP
    multipliers, then the guarded in-place write."""

    def __init__(self, schedule, *, max_norm: float,
                 mup: Optional[Config] = None):
        self.schedule = schedule
        self.max_norm = max_norm
        self.mup_config = mup

    def _mup(self, params: Optional[Params], flat: torch.Tensor,
             leaves=None):
        if self.mup_config is None:
            return None
        if params is None:
            raise ValueError("muP needs the parameters' names")
        from unidisc_tpu_torch.training.mup import mup_multipliers
        return mup_multipliers(
            params, self.mup_config,
            shapes=None if leaves is None else leaves.shapes).to(
                flat.device, flat.dtype)

    # elementwise chains update the flat buffers SLICE elements at a time,
    # so their temporaries are a few slices, not a few copies of the model
    ELEMENTWISE = False
    SLICE = 1 << 26

    @torch.no_grad()
    def apply(self, p: torch.Tensor, g: torch.Tensor, state,
              ok: Optional[torch.Tensor] = None,
              params: Optional[Params] = None,
              g_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update of the flat parameters `p` and of state, in place,
        from the flat gradients `g`; returns the global norm of the
        gradients (before clipping). Where `ok` (a () bool tensor) is False,
        p and the whole state stay as they were. `params`: views of p by
        name (the rules that read the flax leaves need them). g_norm: the
        norm of the whole gradient where `g` is a rank's shard of it (the
        mesh step), else computed from `g`."""
        if g_norm is None:
            g_norm = torch.sqrt(torch.sum(g.float() * g.float()))

        def clipped(x):
            return torch.where(g_norm < self.max_norm, x,
                               (x / g_norm.to(x.dtype)) * self.max_norm)

        old = state.tensors()
        n = p.numel()
        step = self.SLICE if self.ELEMENTWISE else max(n, 1)
        counts = {}
        for lo in range(0, n, step):
            part = slice(lo, min(lo + step, n))
            sub = state if step >= n else state.sliced(part)
            u, new = self.update(p[part], clipped(g[part]), sub, params)
            if sub.mup is not None:
                u = u * sub.mup
            new_p = (p[part] + u).to(p.dtype)
            if ok is not None:
                new_p = torch.where(ok, new_p, p[part])
            p[part].copy_(new_p)
            cur = sub.tensors()
            for k, v in new.items():
                if old[k].dim() == 0:          # a count: written once, last
                    counts.setdefault(k, v)
                    continue
                cur[k].copy_(v if ok is None else torch.where(ok, v, cur[k]))
        for k, v in counts.items():
            old[k].copy_(v if ok is None else torch.where(ok, v, old[k]))
        return g_norm

    def lr(self, count: torch.Tensor, dtype) -> torch.Tensor:
        return self.schedule(count).to(dtype)


class ClippedAdamW(_Clipped):
    """``optax.chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2,
    eps, weight_decay))`` with optax's arithmetic, updating in place. It
    runs on flat buffers (the parameters and the gradients, each in the
    parameters' order), so a step is a few dozen kernels a slice whatever
    the number of parameter tensors."""
    ELEMENTWISE = True

    def __init__(self, schedule, *, max_norm: float, b1: float, b2: float,
                 eps: float, weight_decay: float, mup=None):
        super().__init__(schedule, max_norm=max_norm, mup=mup)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, flat: torch.Tensor, params: Optional[Params] = None,
             leaves=None) -> OptState:
        """The state for the flat parameter buffer `flat` (`params`: its
        views by name, which muP needs; `leaves`: their splits on a
        mesh)."""
        return OptState(adam=AdamState(count=_count(flat.device),
                                       mu=torch.zeros_like(flat),
                                       nu=torch.zeros_like(flat)),
                        schedule_count=_count(flat.device),
                        mup=self._mup(params, flat, leaves))

    def update(self, p, g, state, params):
        b1, b2 = self.b1, self.b2
        adam = state.adam
        count_inc = adam.count + 1
        bc1 = 1 - b1 ** count_inc.float()
        bc2 = 1 - b2 ** count_inc.float()
        mu = (1 - b1) * g + b1 * adam.mu
        nu = (1 - b2) * (g * g) + b2 * adam.nu
        u = (mu / bc1.to(mu.dtype)) / (
            torch.sqrt(nu / bc2.to(nu.dtype)) + self.eps)
        u = u + self.weight_decay * p
        u = -self.lr(state.schedule_count, u.dtype) * u
        return u, {"adam_count": adam.count + 1, "mu": mu, "nu": nu,
                   "schedule_count": state.schedule_count + 1}


class _GenericChain(_Clipped):
    COUNTS = ()
    BUFFERS = ()

    def init(self, flat: torch.Tensor, params: Optional[Params] = None,
             leaves=None) -> GenericOptState:
        layout = ParamLayout(params) if params is not None else None
        return GenericOptState(
            counts={k: _count(flat.device) for k in self.COUNTS},
            buffers={k: torch.zeros_like(flat) for k in self.BUFFERS},
            layout=layout, mup=self._mup(params, flat, leaves),
            leaves=leaves)

    @staticmethod
    def _inc(state, *names) -> dict:
        return {f"count/{n}": state.counts[n] + 1 for n in names}


class ClippedLion(_GenericChain):
    """``optax.lion(schedule, b1, b2, weight_decay)`` behind the clip."""
    ELEMENTWISE = True
    COUNTS = ("lion", "schedule")
    BUFFERS = ("mu",)

    def __init__(self, schedule, *, max_norm, b1, b2, weight_decay,
                 mup=None):
        super().__init__(schedule, max_norm=max_norm, mup=mup)
        self.b1, self.b2, self.weight_decay = b1, b2, weight_decay

    def update(self, p, g, state, params):
        mu = state.buffers["mu"]
        u = torch.sign((1.0 - self.b1) * g + self.b1 * mu)
        new_mu = (1 - self.b2) * g + self.b2 * mu
        u = u + self.weight_decay * p
        u = -self.lr(state.counts["schedule"], u.dtype) * u
        return u, {"buffer/mu": new_mu,
                   **self._inc(state, "lion", "schedule")}


class ClippedAdEMAMix(_GenericChain):
    """``optax.contrib.ademamix(schedule, b1, b2, eps, weight_decay)``
    (b3 0.9999, alpha 5.0: optax's defaults) behind the clip."""
    ELEMENTWISE = True
    COUNTS = ("ademamix", "ademamix_m2", "schedule")
    BUFFERS = ("m1", "m2", "nu")

    def __init__(self, schedule, *, max_norm, b1, b2, eps, weight_decay,
                 b3=0.9999, alpha=5.0, mup=None):
        super().__init__(schedule, max_norm=max_norm, mup=mup)
        self.b1, self.b2, self.b3, self.alpha = b1, b2, b3, alpha
        self.eps, self.weight_decay = eps, weight_decay

    def update(self, p, g, state, params):
        buf = state.buffers
        m1 = (1 - self.b1) * g + self.b1 * buf["m1"]
        m2 = (1 - self.b3) * g + self.b3 * buf["m2"]
        nu = (1 - self.b2) * (g * g) + self.b2 * buf["nu"]
        count_inc = state.counts["ademamix"] + 1
        bc1 = 1 - self.b1 ** count_inc.float()
        bc2 = 1 - self.b2 ** count_inc.float()
        m1_hat = m1 / bc1.to(m1.dtype)
        nu_hat = nu / bc2.to(nu.dtype)
        u = (m1_hat + self.alpha * m2) / (torch.sqrt(nu_hat) + self.eps)
        u = u + self.weight_decay * p
        u = -self.lr(state.counts["schedule"], u.dtype) * u
        return u, {"buffer/m1": m1, "buffer/m2": m2, "buffer/nu": nu,
                   **self._inc(state, "ademamix", "ademamix_m2",
                               "schedule")}


def _whole_shape(state: GenericOptState, leaf) -> tuple:
    """A leaf's whole flax shape (its own off a mesh)."""
    return leaf.shape if state.leaves is None else \
        state.leaves.shapes[leaf.key]


def _allsum(state: GenericOptState, t: torch.Tensor, key: str,
            dims) -> torch.Tensor:
    """A partial sum over flax `dims` of a leaf, summed over the ranks
    that hold the rest of them (itself off a mesh)."""
    return t if state.leaves is None else state.leaves.allsum(t, key, dims)


def factored_dims(shape, min_dim: int = 128):
    """optax's ``_factored_dims``: the two largest axes (second largest,
    largest), when the second largest has at least `min_dim`."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


def buffer_dims(kind: str, whole_shape, min_dim: int = 128) -> tuple:
    """The flax dims of its leaf that an Adafactor moment of `kind` ("v",
    "v_row" or "v_col") has, in its order: v_row lacks the factored d0,
    v_col d1 (``factored_dims`` of the leaf's whole shape)."""
    dims = tuple(range(len(whole_shape)))
    if kind == "v":
        return dims
    d1, d0 = factored_dims(whole_shape, min_dim)
    drop = d0 if kind == "v_row" else d1
    return tuple(d for d in dims if d != drop)


class ClippedAdafactor(_GenericChain):
    """``optax.adafactor(schedule, weight_decay_rate=wd or None)`` with
    optax's defaults behind the clip, on the flax leaves."""
    COUNTS = ("factored", "schedule")

    def __init__(self, schedule, *, max_norm, weight_decay, decay_rate=0.8,
                 min_dim=128, eps=1e-30, clip_threshold=1.0,
                 min_param_scale=1e-3, mup=None):
        super().__init__(schedule, max_norm=max_norm, mup=mup)
        self.weight_decay = weight_decay or None
        self.decay_rate, self.min_dim, self.eps = decay_rate, min_dim, eps
        self.clip_threshold = clip_threshold
        self.min_param_scale = min_param_scale

    def init(self, flat, params=None, leaves=None) -> GenericOptState:
        if params is None:
            raise ValueError("adafactor needs the parameters' names")
        state = super().init(flat, params, leaves)
        for leaf in state.layout.leaves:
            dims = factored_dims(_whole_shape(state, leaf), self.min_dim)
            if dims is None:
                state.buffers[f"v/{leaf.key}"] = torch.zeros(
                    leaf.shape, dtype=flat.dtype, device=flat.device)
                continue
            d1, d0 = dims
            for name, drop in (("v_row", d0), ("v_col", d1)):
                shape = tuple(np.delete(leaf.shape, drop))
                state.buffers[f"{name}/{leaf.key}"] = torch.zeros(
                    shape, dtype=flat.dtype, device=flat.device)
        return state

    def update(self, p, g, state, params):
        layout, buf = state.layout, state.buffers
        pv, gv = flat_views(p, params), flat_views(g, params)
        u = torch.empty_like(g)
        uv = flat_views(u, params)
        t = (state.counts["factored"] + 1).float()
        decay = 1.0 - t ** (-self.decay_rate)
        lr = self.schedule(state.counts["schedule"])
        new = {}
        for leaf in layout.leaves:
            grad = layout.gather(gv, leaf)
            param = layout.gather(pv, leaf)
            whole, key = _whole_shape(state, leaf), leaf.key
            every = tuple(range(len(whole)))
            dims = factored_dims(whole, self.min_dim)
            grad_sqr = grad * grad + self.eps
            decay_t = decay.to(grad.dtype)
            if dims is not None:
                d1, d0 = dims
                row = decay_t * buf[f"v_row/{key}"] + (1.0 - decay_t) \
                    * _allsum(state, grad_sqr.sum(d0), key, (d0,)) \
                    / whole[d0]
                col = decay_t * buf[f"v_col/{key}"] + (1.0 - decay_t) \
                    * _allsum(state, grad_sqr.sum(d1), key, (d1,)) \
                    / whole[d1]
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = _allsum(
                    state, row.sum(reduced_d1, keepdim=True), key,
                    (d1,)) / whole[d1]
                row_factor = (row / row_col_mean) ** -0.5
                col_factor = col ** -0.5
                upd = grad * row_factor.unsqueeze(d0) \
                    * col_factor.unsqueeze(d1)
                new[f"buffer/v_row/{key}"] = row
                new[f"buffer/v_col/{key}"] = col
            else:
                v = decay_t * buf[f"v/{key}"] + (1.0 - decay_t) * grad_sqr
                upd = grad * v ** -0.5
                new[f"buffer/v/{key}"] = v
            numel = float(math.prod(whole))
            # clip_by_block_rms
            denom = torch.clamp(torch.sqrt(
                _allsum(state, torch.sum(upd * upd), key, every) / numel)
                / self.clip_threshold, min=1.0)
            upd = upd / denom
            upd = lr.to(upd.dtype) * upd
            # scale_by_param_block_rms
            rms = torch.sqrt(_allsum(state, torch.sum(param * param), key,
                                     every) / numel)
            upd = upd * torch.where(rms <= self.min_param_scale,
                                    torch.full_like(rms,
                                                    self.min_param_scale),
                                    rms)
            if self.weight_decay is not None:
                upd = upd + self.weight_decay * param
            layout.scatter(-upd, uv, leaf)
        new.update(self._inc(state, "factored", "schedule"))
        return u, new


NS_COEFFS = (3.4445, -4.7750, 2.0315)


def newton_schulz(x: torch.Tensor, steps: int = 5,
                  eps: float = 1e-8) -> torch.Tensor:
    """optax's ``orthogonalize_via_newton_schulz`` over a batch of
    matrices x (..., K, N) in the flax layout (reduction axis K, output
    axis N): each matrix is transposed when K > N, scaled by its Frobenius
    norm + eps, and run through `steps` quintic Newton-Schulz steps."""
    transposed = x.shape[-2] > x.shape[-1]
    if transposed:
        x = x.mT
    x = x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True) + eps)
    a, b, c = (torch.tensor(v, dtype=x.dtype) for v in NS_COEFFS)
    a, b, c = (v.to(x.device) for v in (a, b, c))
    for _ in range(steps):
        gram = x @ x.mT
        poly = b * gram + c * (gram @ gram)
        x = a * x + poly @ x
    return x.mT if transposed else x


class ClippedMuon(_GenericChain):
    """``optax.contrib.muon(schedule, beta=0.95, nesterov=True,
    weight_decay, adam_b1, adam_b2)`` behind the clip: the leaves that
    ``training/muon.py`` routes take Muon, the rest Nesterov AdamW with
    eps 1e-8 (muon's eps) and no weight decay. One flat momentum buffer
    serves both (each parameter is in one partition); ``nu`` is Adam's."""
    COUNTS = ("muon", "muon_schedule", "adam", "adam_schedule")
    BUFFERS = ("mu", "nu")

    def __init__(self, schedule, *, max_norm, weight_decay, adam_b1,
                 adam_b2, beta=0.95, eps=1e-8, ns_steps=5, mup=None):
        super().__init__(schedule, max_norm=max_norm, mup=mup)
        self.beta, self.eps, self.ns_steps = beta, eps, ns_steps
        self.b1, self.b2 = adam_b1, adam_b2
        self.weight_decay = weight_decay

    def init(self, flat, params=None, leaves=None) -> GenericOptState:
        if params is None:
            raise ValueError("muon needs the parameters' names")
        from unidisc_tpu_torch.training.muon import muon_routes
        state = super().init(flat, params, leaves)
        routes = muon_routes(state.layout)
        state.muon_leaves = [leaf for leaf in state.layout.leaves
                             if routes[leaf.key]]
        mask = torch.zeros_like(flat, dtype=torch.bool)
        mv = flat_views(mask, params)
        for leaf in state.muon_leaves:
            for n in leaf.names:
                mv[n].fill_(True)
        state.muon_mask = mask
        return state

    def update(self, p, g, state, params):
        buf, mask = state.buffers, state.muon_mask
        beta, b1, b2 = self.beta, self.b1, self.b2
        # the muon partition: Nesterov momentum
        c_m = (state.counts["muon"] + 1).float()
        mu_m = (1 - beta) * g + beta * buf["mu"]
        hat_m = beta * (mu_m / (1 - beta ** (c_m + 1)).to(g.dtype)) \
            + (1 - beta) * (g / (1 - beta ** c_m).to(g.dtype))
        # the adam partition: Nesterov AdamW
        c_a = (state.counts["adam"] + 1).float()
        mu_a = (1 - b1) * g + b1 * buf["mu"]
        nu_a = (1 - b2) * (g * g) + b2 * buf["nu"]
        hat_a = b1 * (mu_a / (1 - b1 ** (c_a + 1)).to(g.dtype)) \
            + (1 - b1) * (g / (1 - b1 ** c_a).to(g.dtype))
        u_a = hat_a / (torch.sqrt(nu_a / (1 - b2 ** c_a).to(g.dtype))
                       + self.eps)
        u_a = u_a + 0.0 * p
        u_a = -self.lr(state.counts["adam_schedule"], g.dtype) * u_a
        # orthogonalize the muon leaves' momentum in the flax layout
        u = u_a.clone()
        layout = state.layout
        hv, pv, uv = (flat_views(x, params) for x in (hat_m, p, u))
        lr_m = self.lr(state.counts["muon_schedule"], g.dtype)
        for leaf in state.muon_leaves:
            o = layout.gather(hv, leaf)
            mat = tuple(range(o.dim()))
            if state.leaves is not None:
                # each (in, out) matrix whole over the axes that split it
                o = state.leaves.gather(o, leaf.key, mat, mat[-2:])
            o = newton_schulz(o, self.ns_steps, self.eps)
            if state.leaves is not None:
                o = state.leaves.take(o, leaf.key, mat, mat[-2:])
            k, n = _whole_shape(state, leaf)[-2:]
            scale = torch.sqrt(torch.tensor(max(1.0, n / k),
                                            dtype=torch.float32))
            o = scale.to(o.device, o.dtype) * o
            o = o + self.weight_decay * layout.gather(pv, leaf)
            layout.scatter(-lr_m * o, uv, leaf)
        new = {"buffer/mu": torch.where(mask, mu_m, mu_a),
               "buffer/nu": torch.where(mask, buf["nu"], nu_a),
               **self._inc(state, *self.COUNTS)}
        return u, new


def make_optimizer(config: Config):
    """Global-norm clipping + the configured optimizer (+ the muP
    multipliers with ``model.mup``), as the JAX ``make_optimizer``."""
    t = config.trainer
    schedule = make_lr_schedule(config)
    common = dict(max_norm=t.gradient_clip_val,
                  mup=config if config.model.mup else None)
    if t.optimizer == "adafactor":
        return ClippedAdafactor(schedule, weight_decay=t.weight_decay,
                                **common)
    if t.optimizer == "lion":
        return ClippedLion(schedule, b1=t.beta1, b2=t.beta2,
                           weight_decay=t.weight_decay, **common)
    if t.optimizer == "muon":
        return ClippedMuon(schedule, weight_decay=t.weight_decay,
                           adam_b1=t.beta1, adam_b2=t.beta2, **common)
    if t.optimizer == "ademamix":
        return ClippedAdEMAMix(schedule, b1=t.beta1, b2=t.beta2,
                               eps=t.opt_eps, weight_decay=t.weight_decay,
                               **common)
    if t.optimizer != "adamw":
        raise ValueError(f"unknown trainer.optimizer {t.optimizer!r} "
                         f"(one of {OPTIMIZERS})")
    return ClippedAdamW(schedule, b1=t.beta1, b2=t.beta2, eps=t.opt_eps,
                        weight_decay=t.weight_decay, **common)
