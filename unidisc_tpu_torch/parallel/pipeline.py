"""Pipeline parallelism: GPipe microbatch pipelining over the mesh's "pp"
axis (port of ``unidisc_tpu/parallel/pipeline.py``).

The layer stack splits over the "pp" ranks: each holds a contiguous group
of n_layers / P layers (``parallel/mesh.py::shard_model`` keeps only its
stage's DIT blocks). The batch splits into M microbatches, and the
schedule runs M + P - 1 ticks: at tick t stage 0 takes microbatch t,
every stage applies its layer group to the microbatch it holds (stage s
holds microbatch t - s), the activations move one stage down
(``parallel/comm.py::Shift``, JAX's ``ppermute``) and the last stage
emits microbatch t - (P - 1). Per-microbatch operands (conditioning,
modality, segment ids, per-row rope) are indexed at the stage's own
offset; the broadcast operands (the rope tables) are the same every tick.
The last stage's outputs reach every "pp" rank through
``comm.reduce_from`` (an all-reduce against zeros elsewhere, identity
backward: every rank then runs the head and the loss alike).

The backward is autograd through the schedule, as JAX's is ``jax.grad``
through its scan. Every rank's backward must make the same exchanges in
the same order, so the schedule is one chain on every rank: each tick's
activation is a function of the last tick's shifted one (stage 0 ties the
shifted activation it does not read into its injected one with a zero
gradient, ``comm.Tie``; an idle tick passes it on), a shift runs every
tick but the last, idle ticks included, and the inputs whose gradients
are a part on each stage (x, read by stage 0 only; the microbatch
operands, read by each stage at its own ticks) enter through one
``copy_to``-like node, tied to the chain's first tick, whose backward
all-reduce comes after the whole chain on every rank.

``pipeline_parallel`` is the context under which the DIT (``models/
dit.py``) routes its block stack through ``pipeline_sharded``; the
granule of a pipelined batch is the data-parallel width x the
microbatches (``mesh.pp_microbatches``).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import torch
import torch.distributed as dist

from unidisc_tpu_torch.parallel.comm import (Shift, Tie, all_reduce,
                                             reduce_from)

_STATE = threading.local()


@dataclass(frozen=True)
class PPContext:
    group: object        # the "pp" process group
    rank: int            # this rank's stage
    size: int            # the number of stages
    microbatches: int


@contextlib.contextmanager
def pipeline_parallel(layout, microbatches: int = 4):
    """Enable the pipelined trunk for model calls inside the context over
    `layout`'s "pp" group (a ``parallel/mesh.py::MeshLayout``). No layout,
    or a "pp" size of 1, is a no-op."""
    if layout is None or layout.pp.size <= 1:
        yield
        return
    prev = getattr(_STATE, "value", None)
    _STATE.value = PPContext(layout.pp.group, layout.pp.rank,
                             layout.pp.size, microbatches)
    try:
        yield
    finally:
        _STATE.value = prev


def current_pp() -> Optional[PPContext]:
    """The active PPContext, or None."""
    return getattr(_STATE, "value", None)


class _CopyIn(torch.autograd.Function):
    """``comm.copy_to`` of several tensors as one node: identity forward,
    each gradient summed over the group in the backward."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(all_reduce(g.clone(), ctx.group) for g in grads))


def pipeline_apply(stage_fn: Callable, local_layers, x_mb: torch.Tensor,
                   mb_args: Optional[Mapping[str, torch.Tensor]] = None,
                   *broadcast_args, group) -> torch.Tensor:
    """Per-rank GPipe body over the "pp" `group`.

    stage_fn(local_layers, a, mb_args_t, *broadcast_args) -> a applies this
    stage's layer group. x_mb: (M, mb, ...) microbatched input, the same
    on every rank (only stage 0 reads it). mb_args: (M, mb, ...)
    per-microbatch operands by name, indexed at the stage's offset.
    Returns the (M, mb, ...) outputs on every rank of the group."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    mb_args = dict(mb_args or {})
    m_micro = x_mb.shape[0]
    ticks = m_micro + n - 1
    grad = torch.is_grad_enabled()
    parts = []
    if grad:
        keys = [k for k, v in mb_args.items() if v.requires_grad]
        ins = _CopyIn.apply(group, x_mb, *(mb_args[k] for k in keys))
        x_mb = ins[0]
        mb_args.update(zip(keys, ins[1:]))
        # the chain carries a gradient from tick 0 on every rank, whether
        # or not x and the operands need one
        start = torch.zeros((), device=x_mb.device, requires_grad=True)
        parts = [start, *ins]
    outs = [None] * m_micro
    a_in = None
    for t in range(ticks):
        if idx == 0 and t < m_micro:
            a = x_mb[t]
            if a_in is not None:
                a = Tie.apply(a, a_in)
        else:
            a = a_in if a_in is not None else torch.zeros_like(x_mb[0])
        if t == 0 and parts:
            a = Tie.apply(a, *parts)
        mb = t - idx
        if 0 <= mb < m_micro:
            a = stage_fn(local_layers, a, {k: v[mb] for k, v in
                                           mb_args.items()},
                         *broadcast_args)
            if idx == n - 1:
                outs[mb] = a
        if t < ticks - 1:
            a_in, = Shift.apply(group, a)
    out = torch.stack(outs) if idx == n - 1 else torch.zeros_like(x_mb)
    out = reduce_from(out, group)
    return Tie.apply(out, a) if grad else out


def pipeline_sharded(stage_fn: Callable, stacked, x: torch.Tensor, group,
                     *broadcast_args,
                     mb_args: Optional[Mapping[str, torch.Tensor]] = None,
                     microbatches: int = 4) -> torch.Tensor:
    """Run a stacked layer sequence as a pipeline over `group`.

    stacked: the whole stack, a sequence of layers (the DIT's blocks) or a
    mapping of tensors with a leading (n_layers, ...) axis; stage s takes
    layers [s, s + 1) x n_layers / P of it (n_layers % P == 0). x: (B, ...)
    input, split into `microbatches` along axis 0 (B % microbatches ==
    0); mb_args: (B, ...) per-sample operands by name, microbatched
    alongside. stage_fn(local_layers, a, mb_args_t, *broadcast_args) -> a.
    Returns (B, ...) on every rank of the group."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    bsz = x.shape[0]
    if bsz % microbatches:
        raise ValueError(f"batch {bsz} not divisible by microbatches "
                         f"{microbatches}")
    if isinstance(stacked, Mapping):
        n_layers = next(iter(stacked.values())).shape[0]
    else:
        n_layers = len(stacked)
    if n_layers % n:
        raise ValueError(f"{n_layers} layers not divisible by pp axis size "
                         f"{n}")
    per = n_layers // n
    if isinstance(stacked, Mapping):
        local = {k: v[idx * per:(idx + 1) * per] for k, v in stacked.items()}
    else:
        local = stacked[idx * per:(idx + 1) * per]
    mb = bsz // microbatches

    def split(e):
        return e.reshape(microbatches, mb, *e.shape[1:])
    out = pipeline_apply(stage_fn, local, split(x),
                         {k: split(v) for k, v in (mb_args or {}).items()},
                         *broadcast_args, group=group)
    return out.reshape(bsz, *out.shape[2:])
