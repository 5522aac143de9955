"""LoRA fine-tuning: low-rank adapters as a parameter transform (port of
``unidisc_tpu/training/lora.py``).

The adapter is a dict of small tensors beside the frozen base; a merge
``W + (alpha / rank) * delta`` gives the full parameters the unchanged
model runs with (one merged product per target, as in JAX). The train
step differentiates the adapter alone (``make_train_step(param_map=)``),
so gradients, optimizer state, EMA and checkpoints are rank-r sized.

The port keeps the torch layout: a target weight W is (out, in), so its
adapter is ``lora.<name>.A`` (rank, in), drawn N(0, 1 / rank), and
``lora.<name>.B`` (out, rank), zero, with delta = B @ A, which is the
transpose of JAX's a @ b for a = A^T (in, rank) and b = B^T (rank, out).
A ``train_full`` leaf gets a zero full-shape delta ``full.<name>``
(base + delta). The merged model equals the base at init.

Targets match the JAX rule on the flax path of each 2-D weight (a kernel):
"attn_qkv" (the DIT's ``blocks/attention/attn_qkv/kernel``) and "qkv_proj"
(OpenELM's, the reference's target). Being substrings, as in JAX, they
also match an img_cond model's ``blocks/cross_attention/attn_qkv`` and
``attn_qkv_cond`` and ``img_cond_blocks/attention/attn_qkv``. The JAX
adapter is scan-stacked over the DIT blocks; the port's is per block.

``save_lora`` writes ``lora_adapter.npz`` in the JAX package's format (keys
``lora|<flax path>/a`` with the scan-stacked (n_blocks, in, rank) arrays,
``full|<flax path>``, and ``__meta__`` = [alpha, rank]); ``load_lora``
reads one written by either package into the port's names.

As in JAX, the reference's lora_dropout (0.05) is not implemented: it
needs the split x W + s B A dropout(x) path that the merge avoids.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from unidisc_tpu_torch.models.port import (STACKED, flax_path,
                                           torch_names_of_flax_path)
from unidisc_tpu_torch.training.layout import ParamLayout

DEFAULT_TARGETS = ("attn_qkv", "qkv_proj")

Tensors = Dict[str, torch.Tensor]


def _path_str(name: str, ndim: int) -> str:
    return "/".join(flax_path(name, ndim))


def _is_target(name: str, p: torch.Tensor, targets: Sequence[str]) -> bool:
    return (name.endswith(".weight") and p.ndim == 2
            and any(t in _path_str(name, 2) for t in targets))


def init_lora(base: Tensors, *, rank: int = 16,
              targets: Sequence[str] = DEFAULT_TARGETS,
              train_full: Sequence[str] = (),
              generator: Optional[torch.Generator] = None) -> Tensors:
    """The adapter of `base` (name -> tensor): A ~ N(0, 1 / rank), B = 0
    for each target weight, a zero delta for each train_full match; drawn
    on the CPU from `generator` in the order of the sorted names, then
    placed on the base's device."""
    out: Tensors = {}
    for name in sorted(base):
        p = base[name]
        if _is_target(name, p, targets):
            n_out, n_in = p.shape
            a = torch.randn((rank, n_in), generator=generator) \
                / float(np.sqrt(rank))
            out[f"lora.{name}.A"] = a.to(p.device)
            out[f"lora.{name}.B"] = torch.zeros((n_out, rank),
                                                device=p.device)
        elif train_full and any(t in _path_str(name, p.ndim)
                                for t in train_full):
            out[f"full.{name}"] = torch.zeros_like(p, dtype=torch.float32)
    if not out:
        raise ValueError(f"no parameters matched LoRA targets "
                         f"{tuple(targets)} / train_full {tuple(train_full)}")
    return out


def lora_deltas(adapter: Tensors, dtypes: Dict[str, torch.dtype], *,
                alpha: float = 32.0, rank: int = 16) -> Tensors:
    """{weight name: the term the merge adds to it}: (alpha / rank) x B @ A
    in the weight's dtype at an adapted weight, the delta at a full leaf.
    Differentiable in the adapter."""
    scale = alpha / rank
    out = {}
    for key, value in adapter.items():
        kind, _, name = key.partition(".")
        if kind == "lora":
            name, _, ab = name.rpartition(".")
            if ab != "A":
                continue
            delta = adapter[f"lora.{name}.B"] @ value
            out[name] = scale * delta.to(dtypes[name])
        elif kind == "full":
            out[name] = value.to(dtypes[name])
        else:
            raise KeyError(f"not an adapter tensor: {key!r}")
    return out


def merge_lora(base: Tensors, adapter: Tensors, *, alpha: float = 32.0,
               rank: int = 16) -> Tensors:
    """base + (alpha / rank) * B @ A at every adapted weight, base + delta
    at every full leaf; every other tensor of base as it is.
    Differentiable in the adapter."""
    out = dict(base)
    for name, term in lora_deltas(adapter, {k: v.dtype for k, v in
                                            base.items()},
                                  alpha=alpha, rank=rank).items():
        out[name] = (base[name] + term).to(base[name].dtype)
    return out


class LoraParamMap:
    """fn(adapter) -> the full parameters, the base held constant (its
    tensors detached): the train step's ``param_map``.

    On a device mesh (``bind``, after ``parallel/mesh.py::
    params_shardings`` laid the base out) the map keeps only the rank's
    part of each adapted weight of the base: the FSDP2 shard's rows, a
    tensor rank's heads, a pp stage's blocks (``MeshShards.scatter`` of
    the whole delta). ``write(adapter)`` puts base + delta into the
    model's own parameters there, in place, and returns the rank's parts
    of the deltas, differentiable in the adapter: the mesh step runs the
    model with its own parameters (FSDP2 all-gathers the merged shards),
    and the adapted weights, the only base parameters that take gradients
    on a mesh, give the adapter's gradient by the chain rule
    (``training/train_state.py::_lora_mesh_grads``)."""

    def __init__(self, base: Tensors, *, alpha: float, rank: int):
        self.frozen: Optional[Tensors] = {k: v.detach()
                                          for k, v in base.items()}
        self.dtypes = {k: v.dtype for k, v in base.items()}
        self.alpha, self.rank = alpha, rank
        self.layout = self.shards = None
        self.shard_dims: Dict[str, int] = {}
        self._base: Tensors = {}
        self._storage: Tensors = {}

    def __call__(self, adapter: Tensors) -> Tensors:
        if self.frozen is None:
            raise ValueError("the map is bound to a mesh: it writes the "
                             "merge into the model (write)")
        return merge_lora(self.frozen, adapter, alpha=self.alpha,
                          rank=self.rank)

    def deltas(self, adapter: Tensors) -> Tensors:
        return lora_deltas(adapter, self.dtypes, alpha=self.alpha,
                           rank=self.rank)

    @torch.no_grad()
    def bind(self, model: torch.nn.Module, layout, adapter: Tensors) -> None:
        """Keep the rank's part of each weight `adapter` adapts (the model
        laid out on the mesh of `layout`, a MeshLayout), let only those
        take gradients, and drop the whole base."""
        shards = model.mesh_shards
        named = dict(model.named_parameters())
        for name in self.deltas({k: v.detach() for k, v in adapter.items()}):
            if not shards.held(name, layout):
                continue
            p = named[name]
            if hasattr(p, "to_local"):
                self.shard_dims[name] = p.placements[-1].dim
                self._storage[name] = p.to_local()
            else:
                self._storage[name] = p.data
            self._base[name] = self._storage[name].detach().clone()
        for name, p in named.items():
            p.requires_grad_(name in self._storage)
        self.frozen, self.layout, self.shards = None, layout, shards

    def write(self, adapter: Tensors) -> Tensors:
        """base + delta into the rank's part of each adapted weight; the
        rank's parts of the deltas, by weight name."""
        mine = self.shards.scatter(self.deltas(adapter), self.layout,
                                   self.shard_dims)
        with torch.no_grad():
            for name, d in mine.items():
                self._storage[name].copy_(self._base[name] + d)
        return mine


def lora_param_map(base: Tensors, *, alpha: float,
                   rank: int) -> LoraParamMap:
    """The train step's ``param_map`` over `base` (``LoraParamMap``)."""
    return LoraParamMap(base, alpha=alpha, rank=rank)


def lora_from_config(base: Tensors, model_cfg, seed: int) -> Tensors:
    """Config-driven init (model.lora_rank / targets / train_full), drawn
    from `seed`."""
    return init_lora(base, rank=model_cfg.lora_rank,
                     targets=model_cfg.lora_targets,
                     train_full=model_cfg.lora_train_full,
                     generator=torch.Generator().manual_seed(seed))


def count_lora_params(adapter: Tensors) -> int:
    return int(sum(v.numel() for v in adapter.values()))


# ---------------------------------------------------------------------------
# the adapter file, in the JAX package's format
# ---------------------------------------------------------------------------

def save_lora(path: str, adapter: Tensors, *, alpha: float,
              rank: int) -> None:
    """An npz of the adapter under the JAX keys and layouts."""
    flat = {}
    cpu = {k: v.detach().float().cpu() for k, v in adapter.items()}
    for leaf in ParamLayout(cpu).leaves:
        kind = leaf.path[0]
        flat[f"{kind}|{'/'.join(leaf.path[1:])}"] = \
            ParamLayout.gather(cpu, leaf).contiguous().numpy()
    flat["__meta__"] = np.array([alpha, float(rank)], np.float64)
    np.savez(path, **flat)


def load_lora(path: str) -> Tuple[Tensors, float, int]:
    """(adapter in the port's names, alpha, rank) of an npz written by
    ``save_lora`` of either package."""
    z = np.load(path)
    out: Tensors = {}
    for key in z.files:
        if key == "__meta__":
            continue
        kind, p = key.split("|", 1)
        path_ = tuple(p.split("/"))
        arr = np.asarray(z[key], np.float32)
        if kind == "lora":
            weight, ab = path_[:-1], path_[-1]
            stacked = weight[0] in STACKED
            names = torch_names_of_flax_path(
                weight, arr.shape[0] if stacked else 0)
            parts = list(arr) if stacked else [arr]
            for name, a in zip(names, parts):
                out[f"lora.{name}.{ab.upper()}"] = torch.from_numpy(
                    np.ascontiguousarray(a.T))
        elif kind == "full":
            stacked = path_[0] in STACKED
            names = torch_names_of_flax_path(
                path_, arr.shape[0] if stacked else 0)
            parts = list(arr) if stacked else [arr]
            kernel = path_[-1] == "kernel"
            for name, a in zip(names, parts):
                out[f"full.{name}"] = torch.from_numpy(
                    np.ascontiguousarray(a.T if kernel else a))
        else:
            raise KeyError(f"unknown adapter key {key!r}")
    alpha, rank = z["__meta__"]
    return out, float(alpha), int(rank)

