"""Weight carry-over from the JAX package's DIT parameters to the port.

``dit_state_dict_from_jax`` takes the flax parameter tree of
``unidisc_tpu.models.dit.DIT`` (as numpy arrays) and returns a
``state_dict`` for ``unidisc_tpu_torch.models.dit.DIT``. It is the inverse
of ``unidisc_tpu/models/port.py::port_dit_state_dict``, with the same
reference torch names:

  vocab_embed                         -> vocab_embed.embedding
  modality_embed                      -> modality_embed.embedding
  sigma_map/mlp_{0,2}/{kernel,bias}   -> sigma_map.mlp.{0,2}.{weight,bias}
  blocks/attention/attn_qkv/kernel[i] -> blocks.{i}.attn_qkv.weight
  blocks/attention/attn_out/kernel[i] -> blocks.{i}.attn_out.weight
  blocks/attention/{q,k}_norm/{scale,bias}[i]
                                      -> blocks.{i}.{q,k}_norm.{weight,bias}
  blocks/norm{1,2}/weight[i]          -> blocks.{i}.norm{1,2}.weight
  blocks/adaLN_modulation/*[i]        -> blocks.{i}.adaLN_modulation.*
  blocks/mlp_{0,2}/*[i]               -> blocks.{i}.mlp.{0,2}.*
  blocks/{pre_residual,post_ff}_norm/weight[i]
                                      -> blocks.{i}.{...}_norm.weight
  output_layer/{norm_final,adaLN_modulation,linear}/*
                                      -> output_layer.*

The scan axis of the stacked blocks becomes ``blocks.{i}``; flax kernels
(in, out) are transposed to torch weights (out, in).

A quantized tree (``unidisc_tpu/ops/quant.py::quantize_dit_params``)
carries its int8 linears over as the port's ``QLinear``: a ``QDense``'s
``kernel_q`` (in, out) int8 becomes ``weight_q`` (out, in), transposed and
kept int8, and its per-channel ``scale`` stays ``scale``, while a
LayerNorm's ``scale`` still becomes ``weight``. Every other leaf is cast
to fp32.

``train_state_from_jax`` carries a whole JAX ``TrainState`` over (params,
EMA, the Adam moments and counts, the schedule's count) with the same
mapping, into the layout of the port's ``TrainState.state_dict``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_TOP_LEVEL = ("vocab_embed", "modality_embed", "sigma_map", "blocks",
              "output_layer")


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


_LEAVES = {"kernel": "weight", "scale": "weight", "kernel_q": "weight_q"}


def _torch_name(path: tuple, quantized: bool = False) -> str:
    """Flax path (without the scan axis) -> reference torch name. In a
    quantized dense (`quantized`), ``scale`` is the per-channel weight
    scale and keeps its name."""
    if len(path) == 1:                       # a bare table
        return f"{path[0]}.embedding"
    mods = [re.sub(r"^mlp_(\d)$", r"mlp.\1", p) for p in path[:-1]
            if p != "attention"]
    leaf = path[-1] if quantized and path[-1] == "scale" \
        else _LEAVES.get(path[-1], path[-1])
    return ".".join(mods + [leaf])


def dit_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax DIT params (nested mapping of arrays) -> the port's state_dict
    (tensors on the CPU: fp32, and int8 for quantized weights)."""
    sd: Dict[str, torch.Tensor] = {}
    flat = _flatten(params)
    qdense = {path[:-1] for path in flat if path[-1] == "kernel_q"}
    for path, arr in flat.items():
        if path[0] not in _TOP_LEVEL:
            raise NotImplementedError(
                f"parameter {'/'.join(path)} belongs to a DIT branch that "
                f"is not in the port yet")
        kernel = path[-1] in ("kernel", "kernel_q")
        quantized = path[:-1] in qdense
        if path[-1] == "kernel_q":
            if arr.dtype != np.int8:
                raise TypeError(f"{'/'.join(path)} must be int8, got "
                                f"{arr.dtype}")
        else:
            arr = arr.astype(np.float32)
        if path[0] == "blocks":
            name = _torch_name(path[1:], quantized)
            for i, a in enumerate(arr):
                sd[f"blocks.{i}.{name}"] = torch.from_numpy(
                    np.ascontiguousarray(a.T if kernel else a))
        else:
            sd[_torch_name(path, quantized)] = torch.from_numpy(
                np.ascontiguousarray(arr.T if kernel else arr))
    return sd


def _count(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.int32).copy())


def train_state_from_jax(state) -> Dict[str, object]:
    """A JAX ``TrainState`` of ``make_train_step`` (arrays as numpy) -> a
    state_dict for the port's ``TrainState.load_state_dict``.

    The JAX optimizer state is that of ``chain(clip_by_global_norm,
    adamw)``: ``(EmptyState, (ScaleByAdamState, EmptyState,
    ScaleByScheduleState))``."""
    _clip, (adam, _decay, schedule) = state.opt_state
    return {"step": torch.as_tensor(int(np.asarray(state.step))),
            "params": dit_state_dict_from_jax(state.params),
            "ema_params": dit_state_dict_from_jax(state.ema_params),
            "adam_count": _count(adam.count),
            "mu": dit_state_dict_from_jax(adam.mu),
            "nu": dit_state_dict_from_jax(adam.nu),
            "schedule_count": _count(schedule.count)}
