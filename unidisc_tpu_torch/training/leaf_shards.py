"""A rank's parts of the flax leaves on a device mesh, for the optimizer
rules that read whole leaves (Adafactor, Muon, muP; ``training/layout.py``).

On a mesh a rank holds a part of a flax leaf: the dim FSDP2 shards it on,
its "tensor" heads (``attn_qkv``'s rows of each of q, k and v, so three
blocks; ``parallel/mesh.py::Part``), its pipeline stage's blocks (the
scan-stacked dim 0) or its "ep" experts. Each is a ``Split``: one flax dim
of the leaf, the mesh axis that splits it and the number of equal blocks
the rank takes its share of. No two axes split one dim (the rule puts
"fsdp" on a dim no other axis takes).

``LeafShards`` gives, for the rank's leaves (keys of ``ParamLayout``):

* ``shapes``: each leaf's whole flax shape (the rules decide on it:
  Adafactor's factored dims, Muon's scale, muP's fan-in);
* ``allsum``: a partial sum over the rank's part, summed over the axes
  that split the dims it reduced (Adafactor's moments and block RMS);
* ``gather`` / ``take``: a tensor whole along some of the leaf's dims, and
  the rank's part of it again (Muon's (in, out) matrices; the factored
  moments of a checkpoint).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from unidisc_tpu_torch.parallel.comm import Axis, all_gather, all_reduce
from unidisc_tpu_torch.parallel.mesh import Part
from unidisc_tpu_torch.training.layout import ParamLayout


@dataclass(frozen=True)
class Split:
    dim: int          # the flax dim of the leaf
    axis: Axis        # the mesh axis that splits it
    parts: int = 1    # equal blocks of the dim; the rank holds 1 / size
    #                   of each


class LeafShards:
    """The splits of the rank's flax leaves. params: the rank's parameters
    by name (its parts); shards: the model's ``MeshShards``; layout: the
    rank's ``MeshLayout``; shard_dims: the torch dim of each FSDP-sharded
    parameter's shard."""

    def __init__(self, params: Dict[str, torch.Tensor], shards, layout,
                 shard_dims: Dict[str, int]):
        whole = ParamLayout({n: torch.empty(s, device="meta")
                             for n, s in shards.shapes.items()})
        self.shapes = {leaf.key: leaf.shape for leaf in whole.leaves}
        fsdp = Axis(layout.fsdp_group, layout.fsdp_rank,
                    layout.sizes["fsdp"])
        self.splits: Dict[str, List[Split]] = {}
        for leaf in ParamLayout(params).leaves:
            n = leaf.names[0]
            nd = params[n].dim()
            off = len(leaf.shape) - nd

            def flax_dim(d):
                if leaf.transposed and d >= nd - 2:
                    d = 2 * nd - 3 - d
                return d + off
            out = []
            if off and n in shards.stage_of:
                out.append(Split(0, layout.pp))
            if n in shard_dims:
                out.append(Split(flax_dim(shard_dims[n]), fsdp))
            part = shards.parts.get(n)
            if part is not None:
                out.append(Split(flax_dim(part.dim), layout.axis(part.axis),
                                 part.parts))
            self.splits[leaf.key] = out

    def allsum(self, t: torch.Tensor, key: str,
               dims: Sequence[int]) -> torch.Tensor:
        """`t`, a sum over the rank's part of flax dims `dims` of leaf
        `key`, summed over the ranks that hold the other parts of them."""
        for sp in self.splits[key]:
            if sp.dim in dims:
                t = all_reduce(t.contiguous(), sp.axis.group)
        return t

    def gather(self, t: torch.Tensor, key: str, dims: Sequence[int],
               along: Optional[Sequence[int]] = None) -> torch.Tensor:
        """`t`, whose dims are the flax dims `dims` of leaf `key` (the
        rank's part of them), whole along those of `along` (default: all
        of them)."""
        for sp in self._splits(key, dims, along):
            d = list(dims).index(sp.dim)
            pieces = all_gather(t[None].contiguous(), sp.axis.group, 0)
            t = Part("", d, sp.parts).join(list(pieces))
        return t

    def take(self, t: torch.Tensor, key: str, dims: Sequence[int],
             along: Optional[Sequence[int]] = None) -> torch.Tensor:
        """The rank's part of `t` (the inverse of ``gather``)."""
        for sp in self._splits(key, dims, along):
            d = list(dims).index(sp.dim)
            t = Part("", d, sp.parts).take(t, sp.axis.rank, sp.axis.size)
        return t

    def _splits(self, key, dims, along) -> List[Split]:
        along = dims if along is None else along
        return [sp for sp in self.splits[key]
                if sp.dim in dims and sp.dim in along]
