"""The JAX package's parameter tree seen from the port's parameters.

The JAX optimizers run over the flax tree: the DIT's blocks (and the
img_cond trunk's) are scan-stacked, so ``blocks/attention/attn_qkv/kernel``
is ONE (n_blocks, in, out) leaf (``blocks/moe/w1`` one (n_blocks, E, in,
out) leaf), and a flax kernel is (in, out) where a torch weight is (out,
in). Adafactor's block RMS (clipping and parameter scaling), its factored
moments, Muon's routing and muP's fan-in test all read that leaf, so the
port's optimizers see the port's parameters through ``ParamLayout``: each
``Leaf`` groups the port tensors of one flax leaf, in block order, with the
flax path and the flax shape. ``gather`` stacks (and transposes) a leaf's
tensors into the flax shape, ``scatter`` writes one back.

Names: a model parameter keeps its reference torch name
(``models/port.py::flax_path`` gives its flax path). A LoRA adapter
tensor (``training/lora.py``) is ``lora.<weight name>.A`` (flax ``a``,
(in, r), stored (r, in)) or ``.B`` (flax ``b``, (r, out), stored (out,
r)), a full delta ``full.<name>``; their flax paths start with "lora" or
"full" as in the JAX adapter tree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from unidisc_tpu_torch.models.port import STACKED, block_index, flax_path


@dataclass(frozen=True)
class Leaf:
    path: Tuple[str, ...]     # the flax path ("blocks" leaves: stacked)
    names: Tuple[str, ...]    # the port tensors, in block order
    transposed: bool          # torch (out, in) against flax (in, out)
    shape: Tuple[int, ...]    # the flax leaf's shape

    @property
    def key(self) -> str:
        return "/".join(self.path)


def _describe(name: str, shape) -> Tuple[tuple, bool]:
    """(flax path, transposed) of a port tensor name."""
    kind, _, rest = name.partition(".")
    if kind == "lora":
        weight, _, ab = rest.rpartition(".")
        return (("lora",) + flax_path(weight, 2) + (ab.lower(),), True)
    if kind == "full":
        path = flax_path(rest, len(shape))
        return ("full",) + path, path[-1] == "kernel"
    path = flax_path(name, len(shape))
    return path, path[-1] == "kernel"


class ParamLayout:
    """The flax leaves of a port parameter dict (name -> tensor), in the
    order of their first tensor."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        groups: Dict[tuple, List[Tuple[int, str, tuple]]] = {}
        transposed = {}
        for name, p in params.items():
            path, tr = _describe(name, p.shape)
            inner = name.split(".", 1)[1] if name.startswith(
                ("lora.", "full.")) else name
            idx = block_index(inner)
            groups.setdefault(path, []).append(
                (-1 if idx is None else idx, name, tuple(p.shape)))
            transposed[path] = tr
        self.leaves: List[Leaf] = []
        for path, members in groups.items():
            members.sort()
            shape = members[0][2]
            if transposed[path]:
                shape = shape[::-1]
            stacked = any(p in STACKED for p in path[:2])
            self.leaves.append(Leaf(
                path=path, names=tuple(n for _, n, _ in members),
                transposed=transposed[path],
                shape=((len(members),) + shape) if stacked else shape))

    @staticmethod
    def gather(views: Dict[str, torch.Tensor], leaf: Leaf) -> torch.Tensor:
        parts = [views[n].mT if leaf.transposed else views[n]
                 for n in leaf.names]
        if len(leaf.shape) == len(parts[0].shape):
            return parts[0]
        return torch.stack(parts)

    @staticmethod
    def scatter(value: torch.Tensor, views: Dict[str, torch.Tensor],
                leaf: Leaf) -> None:
        parts = [value] if len(leaf.shape) == views[leaf.names[0]].ndim \
            else value.unbind(0)
        for n, v in zip(leaf.names, parts):
            views[n].copy_(v.mT if leaf.transposed else v)
