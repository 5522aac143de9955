"""Muon routing for the port's DIT (port of
``unidisc_tpu/training/muon.py``).

Muon orthogonalizes the momentum of the hidden MATRICES; everything else
(embeddings, the vocab head, norms, biases, the timestep MLP) takes the
embedded Adam. The JAX rule reads the flax tree: a leaf is a Muon matrix
iff it lies under ``blocks``, is a ``kernel`` (or an MoE ``w1`` / ``w2``)
and has rank >= 2, its last two axes (in, out) the reduction and output
axes. The port applies the same rule to the flax leaves of its parameters
(``training/layout.py``): a 2-D ``blocks.{i}.*.weight`` of a linear layer
is one block of the stacked ``blocks/.../kernel`` leaf, whose (in, out)
layout is the transpose of the torch weight. So attn_qkv, attn_out, mlp.0,
mlp.2 and adaLN_modulation of every block take Muon; the QK-norm and norm
weights, the biases, and everything outside the blocks take Adam.
"""

from __future__ import annotations

from typing import Dict

from unidisc_tpu_torch.training.layout import ParamLayout

_MATRIX_LEAVES = ("kernel", "w1", "w2")


def muon_routes(layout: ParamLayout) -> Dict[str, bool]:
    """flax leaf key -> True for a Muon matrix, False for an Adam leaf."""
    return {leaf.key: ("blocks" in leaf.path
                       and leaf.path[-1] in _MATRIX_LEAVES
                       and len(leaf.shape) >= 2)
            for leaf in layout.leaves}
