"""muP (maximal-update parameterization) for the port's optimizers (port
of ``unidisc_tpu/training/mup.py``).

The MuAdam rule as the JAX package applies it: every width-scaled matrix
gets its update multiplied by base_width / width; vectors, scalars and the
vocabulary tables ("embed" / "vocab" in the name) keep the full LR. The
test is structural and reads the flax leaf (``training/layout.py``): rank
>= 2 and a fan-in (the last-but-one axis, ``in`` of an (in, out) kernel)
that divides the width or that the width divides. The port reads the same
leaf, so a torch weight (out, in) is tested at its ``in``, and a block's
bias or norm weight at the stacked flax leaf (n_blocks, n), whose fan-in
is n_blocks, exactly as the JAX rule sees it.

``coord_check`` is the muP validation (the reference's mup_coord_plot):
the mean |activation| across widths after one muP-scaled SGD step.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, Dict, Optional, Sequence

import torch

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.training.layout import Leaf, ParamLayout


def mup_multiplier(leaf: Leaf, *, base_width: int, width: int) -> float:
    """A flax leaf's LR multiplier under the MuAdam rule."""
    if len(leaf.shape) < 2:
        return 1.0
    name = "/".join(leaf.path).lower()
    if "embed" in name or "vocab" in name:
        return 1.0
    fan_in = leaf.shape[-2]
    if fan_in % width != 0 and width % fan_in != 0:
        return 1.0
    return base_width / width


def mup_multipliers(params: Dict[str, torch.Tensor], config: Config,
                    shapes: Optional[Dict[str, tuple]] = None
                    ) -> torch.Tensor:
    """The flat fp32 multipliers of `params` (in their order) under
    config.model's mup_base_width and hidden_size. shapes: each leaf's
    whole flax shape by key, where `params` are a mesh rank's parts
    (``training/leaf_shards.py``): the rule reads the whole leaf."""
    m = config.model
    per_name = {}
    for leaf in ParamLayout(params).leaves:
        if shapes is not None:
            leaf = replace(leaf, shape=shapes[leaf.key])
        mult = mup_multiplier(leaf, base_width=m.mup_base_width,
                              width=m.hidden_size)
        for n in leaf.names:
            per_name[n] = mult
    return torch.cat([torch.full((p.numel(),), per_name[n],
                                 dtype=torch.float32)
                      for n, p in params.items()])


def coord_check(make_model: Callable[[int], tuple], widths: Sequence[int],
                batch, *, config: Config, lr: float = 0.1) -> dict:
    """make_model(width) -> (fn(params, batch) -> hidden, params: a dict
    of tensors). Per width: mean |h| before and after ONE muP-scaled SGD
    step on mean(h^2), and the mean |change|; under muP these stay O(1)
    across widths."""
    out = {}
    for w in widths:
        fn, params = make_model(w)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
        h0 = fn(params, batch)
        grads = torch.autograd.grad((h0 ** 2).mean(), list(params.values()))
        mults = {}
        for leaf in ParamLayout(params).leaves:
            for n in leaf.names:
                mults[n] = mup_multiplier(
                    leaf, base_width=config.model.mup_base_width, width=w)
        with torch.no_grad():
            stepped = {k: p - lr * mults[k] * g
                       for (k, p), g in zip(params.items(), grads)}
            h1 = fn(stepped, batch)
        out[w] = {"act_before": float(h0.detach().abs().mean()),
                  "act_after": float(h1.abs().mean()),
                  "delta": float((h1 - h0.detach()).abs().mean())}
    return out
