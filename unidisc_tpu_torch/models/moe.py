"""Mixture-of-Experts MLP (port of ``unidisc_tpu/models/moe.py``).

The drop-in replacement for a ``DDiTBlock``'s MLP when
``model.moe_experts > 0``: capacity-routed top-k experts in the
Switch / GShard style, computing what the JAX module computes.

  * S = B x L tokens share one capacity C = min(max(1, ceil(cf x k x S /
    E)), S) slots per expert (``moe_capacity_factor`` cf, ``moe_top_k`` k,
    ``moe_experts`` E);
  * the router runs in fp32 (no bias): softmax, top-k (exact ties to the
    lower expert, as ``jax.lax.top_k``), the k gates renormalized to sum
    to 1;
  * slots go in choice-major order: every token's first choice claims a
    slot before any second choice (the cumsum of the JAX module); a
    choice past its expert's capacity contributes zero to the MLP branch;
  * the experts' products take compute-dtype operands and accumulate in
    fp32 (on the card one fp32-output product, ``torch.bmm(...,
    out_dtype=torch.float32)``, as JAX's ``preferred_element_type``; on
    the CPU the product in the compute dtype, then fp32), and the bias
    and the tanh-GELU run in fp32;
  * the balance auxiliary is the Switch loss E x sum_e f_e x P_e over the
    top-1 assignments (f_e the routed share, P_e the mean router
    probability).

Dispatch is by index, not by the JAX module's one-hot (S, E, C) dispatch
and combine tensors, which cost S x E x C elements each (377.5 M at S
12,288, E 8, C 3,840) and twice the experts' FLOPs in their two einsums.
Each (token, choice) gets a slot e x C + position, the position the rank
the JAX module's cumsum gives it (computed by a stable sort);
the token rows are copied into an (E x C + 1, D) buffer (the extra row
takes every overflowed choice and is dropped), ``torch.bmm`` runs the
experts over (E, C, D), and each token gathers its choices' outputs
(``index_select``; an overflowed choice reads a zero row) weighted by its
gates. Nothing reads
the device: the capacity comes from the static shapes, so the layer runs
inside a captured CUDA graph.

The forward's four parts run under ``torch.profiler.record_function``
spans, ``moe_route``, ``moe_dispatch``, ``moe_experts`` and
``moe_combine``, which ``profile_train.py`` reads (with the backward of
each span's ops) as each part's device time.

On a mesh (``dp`` and ``ep``, ``comm.Axis`` views of the data-parallel
and "ep" groups that ``parallel/mesh.py::shard_model`` sets) the layer
computes what JAX's GSPMD computes over the global batch:

  * routing: each rank's router probabilities are gathered over the
    data-parallel group (``comm.GatherReplicated``), so every rank routes
    the global S tokens alike (capacity ``capacity(cfg, S_global)``, the
    same gates, experts and slots) and keeps its own rows' choices; the
    balance auxiliary is the global one. A forward whose rows are
    several stacked copies of the batch (CFG's conditional and
    unconditional halves, stacked by ``sampling/sampler.py::cfg_forward``
    under ``stacked_batches``) orders the gathered rows copy-major, as
    one rank running the whole batch lays them;
  * the experts: an "ep" rank holds E / ep of them and runs only those;
  * the exchange, exact and simple: dispatch writes the rank's own rows
    into its experts' (E / ep, C, D) buffer and sums the buffer over the
    data-parallel group (``comm.sum_over``: every rank's slots are
    disjoint); combine reads the rank's rows' outputs from its experts
    and sums the partial results over the "ep" group
    (``comm.reduce_from``). The rows and the gates enter through
    ``comm.copy_to`` over "ep", each "ep" rank's gradient of them being a
    part of the whole. An all-to-all that moves only the routed rows is a
    later speed item.

Under "seq" (``parallel/seq_parallel.py``: the layer gets the rank's
L-chunk) the router probabilities are gathered over the "seq" group as
well, first along L, so the routing is over every token of the global
batch in its (B, L) order, as JAX's GSPMD routes it; the rank keeps its
chunk's choices and the dispatch buffer is summed over "seq" too.

Inside a pipeline stage (``parallel/pipeline.py``) the layer routes over
the stage's microbatch on the rank alone, as JAX's stage body does.

Parameters, in the JAX layout: ``router.weight`` (E, D) (the flax kernel
(D, E) transposed), ``w1`` (E, D, F), ``b1`` (E, 1, F), ``w2`` (E, F, D),
``b2`` (E, 1, D).
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from unidisc_tpu_torch.config import ModelConfig
from unidisc_tpu_torch.parallel.comm import (GatherReplicated, copy_to,
                                             reduce_from, sum_over)
from unidisc_tpu_torch.parallel.pipeline import current_pp
from unidisc_tpu_torch.parallel.seq_parallel import current_seq_mesh


_STACKED = threading.local()


@contextlib.contextmanager
def stacked_batches(n: int):
    """The forwards inside take n stacked copies of the batch's rows (a
    sampler's CFG halves; entered by ``sampling/sampler.py::cfg_forward``
    alone): on a data-parallel mesh the MoE layers order the global
    batch's rows copy-major, as one rank's stacked batch lays them
    (module docstring)."""
    prev = getattr(_STACKED, "value", 1)
    _STACKED.value = n
    try:
        yield
    finally:
        _STACKED.value = prev


def _copy_major(t: torch.Tensor, ranks: int, copies: int) -> torch.Tensor:
    """Rows gathered rank-major ([rank][copy][row]) into copy-major order
    ([copy][rank][row])."""
    return t.view(ranks, copies, -1, *t.shape[1:]).transpose(0, 1) \
        .reshape(t.shape)


def _own(t: torch.Tensor, rank: int, ranks: int,
         copies: int) -> torch.Tensor:
    """This rank's rows of copy-major global rows, in its local order."""
    return t.view(copies, ranks, -1, *t.shape[1:])[:, rank] \
        .reshape(-1, *t.shape[1:])


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for `tokens` routed tokens."""
    k = min(cfg.moe_top_k, cfg.moe_experts)
    cap = max(1, int(math.ceil(cfg.moe_capacity_factor * k * tokens
                               / cfg.moe_experts)))
    return min(cap, tokens)


def route(probs: torch.Tensor, k: int, cap: int):
    """(gates (S, k), expert (S, k), slot (S, k)) of router probabilities
    (S, E): the top-k experts with renormalized gates, and each choice's
    slot e x cap + position in choice-major priority, E x cap where the
    choice overflowed its expert."""
    s, n_exp = probs.shape
    # top-k through a stable descending sort: exact ties go to the lower
    # expert, as jax.lax.top_k breaks them (torch.topk leaves ties open)
    gates, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert = gates[:, :k], expert[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    # a choice's position in its expert: its rank among the (token,
    # choice) pairs routed there in choice-major order, which is the JAX
    # module's cumsum over the flattened one-hots. A stable sort of the
    # flat expert ids gives those ranks: the cumsum along the (k S) axis
    # would be a sequential scan on the card.
    flat = expert.t().reshape(k * s)
    order = torch.sort(flat, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(k * s, device=probs.device)
    counts = (flat == torch.arange(n_exp, device=probs.device)[:, None]
              ).sum(-1)
    starts = torch.cumsum(counts, 0) - counts            # (E,)
    pos = (rank - starts[flat]).reshape(k, s).t()          # (S, k)
    slot = torch.where(pos < cap, expert * cap + pos, n_exp * cap)
    return gates, expert, slot


class MoEMLP(nn.Module):
    """forward(x (B, L, D)) -> (y (B, L, D) in the compute dtype, the
    scalar balance auxiliary in fp32)."""

    def __init__(self, cfg: ModelConfig,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        n_exp, dim = cfg.moe_experts, cfg.hidden_size
        ff = cfg.mlp_ratio * dim
        self.router = nn.Linear(dim, n_exp, bias=False)
        self.w1 = nn.Parameter(torch.empty(n_exp, dim, ff))
        self.b1 = nn.Parameter(torch.zeros(n_exp, 1, ff))
        self.w2 = nn.Parameter(torch.empty(n_exp, ff, dim))
        self.b2 = nn.Parameter(torch.zeros(n_exp, 1, dim))
        # the data-parallel and "ep" axes on a mesh (module docstring)
        self.dp = self.ep = None

    def forward(self, x: torch.Tensor):
        cfg, cdt = self.cfg, self.compute_dtype
        n_exp = cfg.moe_experts
        k = min(cfg.moe_top_k, n_exp)
        b, t, dim = x.shape
        s = b * t
        dp, ep, seq = (self.dp, self.ep, current_seq_mesh()) \
            if current_pp() is None else (None, None, None)
        dp_size = dp.size if dp is not None else 1
        seq_size = seq.size if seq is not None else 1
        cap = capacity(cfg, s * dp_size * seq_size)
        xr = x.reshape(s, dim)
        with record_function("moe_route"):
            logits = F.linear(xr.float(), self.router.weight.float())
            probs = torch.softmax(logits, dim=-1)                # (S, E)
            copies = getattr(_STACKED, "value", 1)
            if seq_size > 1:
                # the rows' whole sequences, in their token order
                probs = GatherReplicated.apply(
                    probs.view(b, t, n_exp), seq.group, 1).reshape(-1, n_exp)
            if dp_size > 1:
                # the global batch's probabilities in the global batch's
                # row order: every rank routes them alike
                probs = _copy_major(GatherReplicated.apply(probs, dp.group,
                                                           0),
                                    dp_size, copies)
            gates, expert, slot = route(probs, k, cap)
            f_e = (expert[:, 0:1] == torch.arange(
                n_exp, device=x.device)).float().mean(0)
            aux = n_exp * torch.sum(f_e * probs.mean(0))
            if dp_size > 1:
                gates, expert, slot = (_own(u, dp.rank, dp_size, copies)
                                       for u in (gates, expert, slot))
            if seq_size > 1:
                gates, expert, slot = (
                    u.view(b, seq_size, t, k)[:, seq.rank].reshape(s, k)
                    for u in (gates, expert, slot))

        local = n_exp
        if ep is not None and ep.size > 1:
            # this rank's experts [e0, e0 + E / ep): their slots, local;
            # the other experts' choices go to the dropped row
            local = n_exp // ep.size
            e0 = ep.rank * local
            slot = torch.where((slot < n_exp * cap) & (expert >= e0)
                               & (expert < e0 + local), slot - e0 * cap,
                               local * cap)
            xr = copy_to(xr, ep.group)
            gates = copy_to(gates, ep.group)

        # dispatch: each (token, choice) row into its slot; overflowed
        # choices all land in the extra last row, which is dropped
        with record_function("moe_dispatch"):
            rows = xr.to(cdt)[:, None, :].expand(s, k, dim) \
                .reshape(s * k, dim)
            buf = torch.zeros((local * cap + 1, dim), dtype=cdt,
                              device=x.device).index_copy(
                                  0, slot.reshape(-1), rows)
            if dp_size > 1:
                buf = sum_over(buf, dp.group)
            if seq_size > 1:
                buf = sum_over(buf, seq.group)
            expert_in = buf[:-1].view(local, cap, dim)
        with record_function("moe_experts"):
            h = bmm_f32(expert_in, self.w1.to(cdt)) + self.b1.float()
            h = F.gelu(h, approximate="tanh")
            out = bmm_f32(h.to(cdt), self.w2.to(cdt)) + self.b2.float()

        # combine: each choice reads its slot's output (an overflowed one
        # the zero row), weighted by its gate in the compute dtype. An
        # index_select, whose backward adds with atomics: the backward of
        # advanced indexing sorts the indices and then runs every
        # overflowed choice's add to the one zero row in sequence
        with record_function("moe_combine"):
            flat = torch.cat([out.to(cdt).reshape(local * cap, dim),
                              torch.zeros((1, dim), dtype=cdt,
                                          device=x.device)])
            picked = flat.index_select(0, slot.reshape(-1)).view(s, k, dim)
            y = (gates.to(cdt).float()[..., None] * picked.float()).sum(1)
            if local < n_exp:
                y = reduce_from(y, ep.group)
        return y.reshape(b, t, dim).to(cdt), aux


class _ProductF32(torch.autograd.Function):
    """a @ b batched, one fp32-output product of compute-dtype operands on
    the card (``torch.bmm(..., out_dtype=torch.float32)``, which has no
    derivative in every torch this runs on); the backward in the
    operands' dtype, as a product in that dtype cast to fp32
    differentiates."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return torch.bmm(g, b.transpose(1, 2)), torch.bmm(a.transpose(1, 2),
                                                          g)


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b batched, accumulated and returned in fp32: on the card one
    fp32-output product of the compute-dtype operands; on the CPU the
    product in their dtype (fp32 there), then fp32."""
    if a.is_cuda and a.dtype != torch.float32:
        return _ProductF32.apply(a, b)
    return torch.bmm(a, b).float()
