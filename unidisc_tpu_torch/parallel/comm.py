"""The collectives the mesh code uses, over a ``torch.distributed`` group.

Where a tensor travels is decided by the group's backend, before the call:
gloo moves host memory, so a CUDA tensor on a gloo group is copied to the
host, sent, and copied back (several ranks sharing one card can only run
over gloo, since NCCL refuses two ranks on one device); NCCL moves device
memory, so a CPU tensor on an NCCL group rides on the rank's card. A
collective that fails raises; nothing falls back.

* ``all_reduce`` (sum, or another ``dist.ReduceOp``: the int8
  row-parallel product's max of the row amaxes), ``all_gather``
  (concatenated along a dim),
  ``gather`` (concatenated along dim 0 on one rank: a batcher's host
  read, ``parallel/sample.py::SlotSplit``), ``broadcast``;
* ``shift``: each rank sends to the next rank of the group and receives
  from the previous one, the ring step (``jax.lax.ppermute`` with
  ``perm=[(i, (i + 1) % n)]``);
* ``Shift``: ``shift`` of several tensors as one autograd node (its
  backward shifts the gradients the other way);
* ``GatherReplicated``: ``all_gather`` for a result every rank then
  computes on alike: its backward keeps the rank's own slice of the
  gradient.
* the all-reduces with autograd (``AllReduce``), by what the backward
  does:
  - ``copy_to``: identity forward, all-reduce backward (megatron's "f"):
    where a tensor every rank holds alike enters work that each rank
    does a part of (a column-parallel product, a pipeline's input), so
    each rank's gradient of it is a part of the whole;
  - ``reduce_from``: all-reduce forward, identity backward (megatron's
    "g"): the sum of the ranks' parts (a row-parallel product's partial
    outputs, the last pipeline stage's output against zeros elsewhere)
    for a consumer every rank then runs alike, so each rank's gradient of
    the sum is already the whole one;
  - ``sum_over``: all-reduce both ways: a sum each rank consumes
    differently (the QK-norm's partial statistics, the MoE dispatch
    buffer read at each rank's own slots).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Axis:
    """A module's view of one mesh axis: its group, this rank's index in
    it and its size."""
    group: object
    rank: int
    size: int


def _wire(group, t: torch.Tensor) -> torch.device:
    """The device a tensor crosses the group's transport on."""
    backend = dist.get_backend(group)
    if backend == "gloo":
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"no transport rule for backend {backend!r}")


def all_reduce(t: torch.Tensor, group=None,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum (or `op`) of `t` over the group (in place when `t` is on the
    wire's device; returns the result)."""
    if dist.get_world_size(group) == 1:
        return t
    wire = _wire(group, t)
    buf = t if t.device == wire else t.to(wire)
    dist.all_reduce(buf, op=op, group=group)
    if buf is not t:
        t.copy_(buf)
    return t


def broadcast(t: torch.Tensor, group, src: int) -> torch.Tensor:
    """Group rank `src`'s `t` on every rank of the group (returned)."""
    if dist.get_world_size(group) == 1:
        return t
    wire = _wire(group, t)
    buf = t.to(wire).contiguous()
    dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    wire = _wire(group, t)
    src = t.to(wire).movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=wire)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(t.device).movedim(0, dim)


def gather(t: torch.Tensor, group, dst: int = 0) -> Optional[torch.Tensor]:
    """The group's tensors (one shape on every rank) concatenated along
    dim 0 in rank order, on group rank `dst`; None on the other ranks."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    if group is None:
        group = dist.group.WORLD
    wire = _wire(group, t)
    src = t.to(wire).contiguous()
    me = dist.get_rank(group)
    parts = [torch.empty_like(src) for _ in range(n)] if me == dst else None
    dist.gather(src, parts, dst=dist.get_global_rank(group, dst),
                group=group)
    return None if parts is None else torch.cat(parts).to(t.device)


def shift(tensors: Sequence[torch.Tensor], group,
          offset: int = 1) -> List[torch.Tensor]:
    """Each tensor sent to group rank + offset and received from group rank
    - offset (modulo the group size), all in one batch of P2P operations."""
    n = dist.get_world_size(group)
    if n == 1:
        return list(tensors)
    if group is None:
        group = dist.group.WORLD
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + offset) % n)
    src = dist.get_global_rank(group, (me - offset) % n)
    ops, pending = [], []
    for t in tensors:
        wire = _wire(group, t)
        send = t.to(wire).contiguous()
        recv = torch.empty_like(send)
        ops.append(dist.P2POp(dist.isend, send, dst, group))
        ops.append(dist.P2POp(dist.irecv, recv, src, group))
        pending.append((recv, t.device))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [r.to(dev) for r, dev in pending]


class Shift(torch.autograd.Function):
    """``shift`` by +1 as one autograd node over several tensors; the
    backward shifts their gradients by -1. One node for all of them keeps
    the order of the P2P exchanges the same on every rank in the backward
    too (autograd orders a chain of nodes, not independent ones)."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(shift(tensors, group, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *shift(grads, ctx.group, -1))


class GatherReplicated(torch.autograd.Function):
    """``all_gather`` along `dim` whose consumer runs alike on every rank
    of the group (the loss over the gathered tokens): the gradient each
    rank receives is then the whole gradient, and its own slice is the
    gradient of its input."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, t.shape[dim]
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        me = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, me * ctx.n, ctx.n), None, None


class AllReduce(torch.autograd.Function):
    """Sum over the group in the forward when `fwd`, in the backward when
    `bwd` (identity otherwise); see ``copy_to``, ``reduce_from`` and
    ``sum_over``."""

    @staticmethod
    def forward(ctx, t, group, fwd: bool, bwd: bool):
        ctx.group, ctx.bwd = group, bwd
        return all_reduce(t.clone(), group) if fwd else t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd:
            g = all_reduce(g.clone(), ctx.group)
        return g, None, None, None


def _one(group) -> bool:
    return dist.get_world_size(group) == 1


def copy_to(t: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce backward (module docstring)."""
    return t if _one(group) else AllReduce.apply(t, group, False, True)


def reduce_from(t: torch.Tensor, group) -> torch.Tensor:
    """All-reduce forward, identity backward (module docstring)."""
    return t if _one(group) else AllReduce.apply(t, group, True, False)


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """All-reduce forward and backward (module docstring)."""
    return t if _one(group) else AllReduce.apply(t, group, True, True)


class Tie(torch.autograd.Function):
    """`out` unchanged, with `tied` as inputs whose gradient is zero: it
    keeps in every rank's backward graph a node (a shift, a ``copy_to``)
    whose result this rank does not use but whose backward collective its
    peers run."""

    @staticmethod
    def forward(ctx, out, *tied):
        ctx.like = [(t.shape, t.dtype, t.device) for t in tied]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=dt, device=dev)
                     for s, dt, dev in ctx.like))
