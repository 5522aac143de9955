"""Weight carry-over from the JAX package's DIT parameters to the port.

``dit_state_dict_from_jax`` takes the flax parameter tree of
``unidisc_tpu.models.dit.DIT`` (as numpy arrays) and returns a
``state_dict`` for ``unidisc_tpu_torch.models.dit.DIT``. It is the inverse
of ``unidisc_tpu/models/port.py::port_dit_state_dict``, with the same
reference torch names:

  vocab_embed                         -> vocab_embed.embedding
  modality_embed                      -> modality_embed.embedding
  img_count_embedding                 -> img_count_embedding
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
  img_vocab_embed                     -> img_vocab_embed.weight
  img_vocab_proj/{kernel,bias}        -> img_vocab_proj.{weight,bias}
  y_embedder/embedding_table          -> y_embedder.embedding_table.weight
  cond_img_vocab_embed                -> cond_img_vocab_embed.embedding
                                         (.weight beside a projection)
  cond_img_vocab_proj/{kernel,bias}   -> cond_img_vocab_proj.{weight,bias}
  img_cond_blocks/...[i]              -> img_cond_blocks.{i}.* (as blocks)
  blocks/cross_attention/{attn_qkv,attn_qkv_cond,attn_out}/kernel[i]
                                      -> blocks.{i}.cross_attention.*.weight
  blocks/moe/router/kernel[i]         -> blocks.{i}.moe.router.weight
  blocks/moe/{w1,b1,w2,b2}[i]         -> blocks.{i}.moe.{w1,b1,w2,b2}

The scan axis of the stacked blocks (``blocks``, ``img_cond_blocks``)
becomes ``<stack>.{i}``; flax kernels (in, out) are transposed to torch
weights (out, in); the MoE experts keep their (E, in, out) layout.

A quantized tree (``unidisc_tpu/ops/quant.py::quantize_dit_params``)
carries its int8 linears over as the port's ``QLinear``: a ``QDense``'s
``kernel_q`` (in, out) int8 becomes ``weight_q`` (out, in), transposed and
kept int8, and its per-channel ``scale`` stays ``scale``, while a
LayerNorm's ``scale`` still becomes ``weight``. Every other leaf is cast
to fp32.

``elm_state_dict_from_jax`` does the same for the OpenELM baseline
(``models/elm.py``), float or quantized, and
``transfusion_state_dict_from_jax`` for the transfusion wrapper
(``models/continuous.py``: ``proj_in``, ``proj_out`` and ``dit.*``).

``train_state_from_jax`` carries a whole JAX ``TrainState`` over (params,
EMA, the Adam moments and counts, the schedule's count) with the same
mapping, into the layout of the port's ``TrainState.state_dict``.

Published reference checkpoints (``model.safetensors`` as
PyTorchModelHubMixin saves it, or a torch ``.pt``) load as they are, since
the port keeps the reference names: ``read_reference_state_dict`` reads
one (``.safetensors`` through ``read_safetensors``, on the standard
library), ``infer_dit_overrides`` infers the ``model.*`` config from its
shapes, and ``reference_dit_state_dict`` puts it in the port's form.
"""

from __future__ import annotations

import json
import re
import struct
from typing import Dict, Mapping

import numpy as np
import torch

# the scan-stacked block trees
STACKED = ("blocks", "img_cond_blocks")
_TOP_LEVEL = STACKED + (
    "vocab_embed", "modality_embed", "sigma_map", "output_layer",
    "img_count_embedding", "img_vocab_embed", "img_vocab_proj",
    "y_embedder", "cond_img_vocab_embed", "cond_img_vocab_proj")
# bare tables whose reference name has no ".embedding"
_BARE = ("img_count_embedding",)
# tables the reference keeps as nn.Embedding (".weight"); the cond table is
# one only beside its projection
_WEIGHT_TABLES = ("img_vocab_embed",)
_LABEL_TABLE = "y_embedder.embedding_table.weight"


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


def _torch_name(path: tuple, quantized: bool = False,
                weight_tables=_WEIGHT_TABLES) -> str:
    """Flax path (without the scan axis) -> reference torch name. In a
    quantized dense (`quantized`), ``scale`` is the per-channel weight
    scale and keeps its name."""
    if len(path) == 1:                       # a bare table
        if path[0] in _BARE:
            return path[0]
        return f"{path[0]}.weight" if path[0] in weight_tables \
            else f"{path[0]}.embedding"
    if path == ("y_embedder", "embedding_table"):
        return _LABEL_TABLE
    mods = [re.sub(r"^mlp_(\d)$", r"mlp.\1", p) for p in path[:-1]
            if p != "attention"]
    leaf = path[-1] if quantized and path[-1] == "scale" \
        else _LEAVES.get(path[-1], path[-1])
    return ".".join(mods + [leaf])


_ATTENTION_MODULES = ("attn_qkv", "attn_out", "q_norm", "k_norm")
_BLOCK_NAME = re.compile(r"^(blocks|img_cond_blocks)\.(\d+)\.(.+)$")


def flax_path(name: str, ndim: int) -> tuple:
    """The JAX DIT's parameter path of a port parameter (the inverse of
    ``_torch_name``; a block parameter's path starts with its stack,
    "blocks" or "img_cond_blocks", and has no block index, its leaf being
    scan-stacked in JAX): a 2-D ``weight`` is a ``kernel``, a QK-norm
    ``weight`` its ``scale``."""
    m = _BLOCK_NAME.match(name)
    stack = (m.group(1),) if m else ()
    rest = m.group(3) if m else name
    if rest == _LABEL_TABLE:
        return ("y_embedder", "embedding_table")
    parts = rest.split(".")
    if len(parts) == 2 and (parts[1] == "embedding" or (
            parts[1] == "weight" and parts[0].endswith("vocab_embed"))):
        return stack + (parts[0],)
    mods, leaf = parts[:-1], parts[-1]
    out = []
    for i, p in enumerate(mods):
        if p.isdigit() and out and out[-1] == "mlp":
            out[-1] = f"mlp_{p}"
            continue
        if m and i == 0 and p in _ATTENTION_MODULES:
            out.append("attention")
        out.append(p)
    if leaf == "weight":
        leaf = "kernel" if ndim == 2 else (
            "scale" if mods and mods[-1] in ("q_norm", "k_norm") else leaf)
    return stack + tuple(out) + (leaf,)


def block_index(name: str):
    """The block index of a port parameter name, or None outside the
    block stacks."""
    m = _BLOCK_NAME.match(name)
    return int(m.group(2)) if m else None


def torch_names_of_flax_path(path: tuple, n_blocks: int = 0) -> list:
    """Port parameter names of a JAX parameter path: one per block for a
    scan-stacked DIT block leaf (``n_blocks`` of them), else one; an
    OpenELM path (``layer_{i}/...``) maps as ``elm_state_dict_from_jax``
    names it."""
    if path[0] in STACKED:
        name = _torch_name(path[1:])
        return [f"{path[0]}.{i}.{name}" for i in range(n_blocks)]
    if path[0] in _TOP_LEVEL:
        return [_torch_name(path)]
    mods = [re.sub(r"^layer_(\d+)$", r"layers.\1", p) for p in path[:-1]]
    leaf = {"kernel": "weight", "kernel_q": "weight_q"}.get(path[-1],
                                                            path[-1])
    return [".".join(mods + [leaf])]


def dit_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax DIT params (nested mapping of arrays) -> the port's state_dict
    (tensors on the CPU: fp32, and int8 for quantized weights)."""
    sd: Dict[str, torch.Tensor] = {}
    flat = _flatten(params)
    qdense = {path[:-1] for path in flat if path[-1] == "kernel_q"}
    tables = _WEIGHT_TABLES + (("cond_img_vocab_embed",) if (
        "cond_img_vocab_proj", "kernel") in flat else ())
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
        if path[0] in STACKED:
            name = _torch_name(path[1:], quantized)
            for i, a in enumerate(arr):
                sd[f"{path[0]}.{i}.{name}"] = torch.from_numpy(
                    np.ascontiguousarray(a.T if kernel else a))
        else:
            sd[_torch_name(path, quantized, tables)] = torch.from_numpy(
                np.ascontiguousarray(arr.T if kernel else arr))
    return sd


def transfusion_state_dict_from_jax(params: Mapping
                                    ) -> Dict[str, torch.Tensor]:
    """flax ``TransfusionDIT`` params -> the port's state_dict: proj_in and
    proj_out (kernels transposed) and the wrapped DIT under ``dit.``."""
    sd = {f"dit.{k}": v for k, v in dit_state_dict_from_jax(
        params["dit"]).items()}
    for name in ("proj_in", "proj_out"):
        p = params[name]
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(p["kernel"], np.float32).T))
        sd[f"{name}.bias"] = torch.from_numpy(
            np.asarray(p["bias"], np.float32).copy())
    return sd


def elm_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax OpenELM params (``unidisc_tpu/models/elm.py``, as numpy arrays;
    the float tree or the ``quantize_elm_params`` one) -> the state_dict
    of the port's ``models/elm.py::OpenELM``: ``layer_{i}`` becomes
    ``layers.{i}``, a kernel (in, out) the weight (out, in), a
    ``kernel_q`` the int8 ``weight_q`` (out, in) with its ``scale``, the
    int8 head ``lm_head_q`` (D, V) the (V, D) one; every float leaf fp32."""
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params).items():
        if path[-1] in ("kernel_q", "lm_head_q"):
            if arr.dtype != np.int8:
                raise TypeError(f"{'/'.join(path)} must be int8, got "
                                f"{arr.dtype}")
        else:
            arr = arr.astype(np.float32)
        if path[-1] in ("kernel", "kernel_q", "lm_head_q"):
            arr = arr.T
        mods = [re.sub(r"^layer_(\d+)$", r"layers.\1", p) for p in path[:-1]]
        leaf = {"kernel": "weight", "kernel_q": "weight_q"}.get(path[-1],
                                                                path[-1])
        sd[".".join(mods + [leaf])] = torch.from_numpy(
            np.ascontiguousarray(arr))
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


# ---------------------------------------------------------------------------
# published reference checkpoints
# ---------------------------------------------------------------------------

# safetensors dtype -> (numpy dtype of the stored words, torch dtype)
_ST_DTYPES = {
    "F64": ("<f8", torch.float64), "F32": ("<f4", torch.float32),
    "F16": ("<f2", torch.float16), "BF16": ("<u2", torch.bfloat16),
    "I64": ("<i8", torch.int64), "I32": ("<i4", torch.int32),
    "I16": ("<i2", torch.int16), "I8": ("i1", torch.int8),
    "U8": ("u1", torch.uint8), "BOOL": ("?", torch.bool),
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file (an 8-byte little-endian header length, a
    JSON header of dtype, shape and data_offsets, then the raw
    little-endian data) -> CPU tensors."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{name}: unsupported dtype {info['dtype']}")
        word, dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        arr = np.frombuffer(data[start:end], dtype=word).copy()
        t = torch.from_numpy(arr)
        if dtype is torch.bfloat16:
            t = t.view(torch.bfloat16)
        out[name] = t.reshape(info["shape"])
    return out


def read_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A published-checkpoint file (``.safetensors`` or a torch
    ``.pt``/``.bin``) -> CPU tensors, wrapper prefixes stripped."""
    if path.endswith(".safetensors"):
        sd = read_safetensors(path)
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        sd = ckpt.get("state_dict", ckpt)
    return {k.removeprefix("module.").removeprefix("backbone."):
            torch.as_tensor(v) for k, v in sd.items()}


_COND_ADALN = re.compile(r"^img_cond_blocks\.\d+\.adaLN_modulation\.")


def _ignorable(key: str) -> bool:
    """Reference keys that hold no weight of the DIT: rotary tables, an
    attn_qkv_cond outside the cross-attention, the cond blocks' adaLN
    tables (the reference builds them but runs the cond blocks with no
    conditioning), BatchNorm counters."""
    return ("rotary" in key
            or ("attn_qkv_cond" in key and ".cross_attention." not in key)
            or _COND_ADALN.match(key) is not None
            or key.endswith("num_batches_tracked"))


def reference_dit_state_dict(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A reference DIT state_dict in the port's form: the production DIT's
    nested ``blocks.{i}.attention.*`` flattened to ``blocks.{i}.*`` (as
    the frozen dit_orig names them), keys without weights dropped; the
    split-embed, class-label and img_cond names are the port's own."""
    return {k.replace(".attention.", "."): torch.as_tensor(v)
            for k, v in state_dict.items() if not _ignorable(k)}


# head counts of the reference model zoo (configs/model/*.yaml), by width
_ZOO_HEADS = {256: 8, 512: 8, 768: 12, 1024: 16, 1280: 20, 2048: 16,
              4096: 16}


def infer_dit_overrides(state_dict: Mapping) -> Dict:
    """``model.*`` config overrides inferred from a reference DIT
    state_dict's shapes (the JAX package's rules): hidden and cond widths,
    block count, MLP ratio, the vocab split (exact for split-embed
    checkpoints, else via the 16384-way VQ codebook), norm type, the
    sandwich / modality / QK-norm / time-conditioning flags, split embed,
    the image-count embedding, class-label and image conditioning. The
    head count comes from the reference zoo (head_dim 64 otherwise); the
    sequence layout and rope_2d are not in the weights and stay with the
    preset."""
    sd = {k.replace(".attention.", "."): v for k, v in state_dict.items()}
    shp = {k: tuple(v.shape) for k, v in sd.items()}
    over: Dict = {}

    hidden = shp["vocab_embed.embedding"][1]
    over["model.hidden_size"] = hidden
    n_blocks = 0
    while f"blocks.{n_blocks}.attn_qkv.weight" in shp:
        n_blocks += 1
    if not n_blocks:
        raise ValueError("no blocks.* keys: not a DIT state_dict")
    over["model.n_blocks"] = n_blocks
    over["model.mlp_ratio"] = shp["blocks.0.mlp.0.weight"][0] // hidden

    over["model.qk_norm"] = "blocks.0.q_norm.weight" in shp
    if hidden in _ZOO_HEADS:
        over["model.n_heads"] = _ZOO_HEADS[hidden]
    elif hidden % 64 == 0:
        over["model.n_heads"] = hidden // 64

    over["model.time_conditioning"] = "sigma_map.mlp.0.weight" in shp
    if over["model.time_conditioning"]:
        over["model.cond_dim"] = shp["sigma_map.mlp.0.weight"][0]
    # rms and bias-less layernorm have the same shapes; in the reference
    # zoo rms ships only with the production markers
    production = (over["model.qk_norm"]
                  or "blocks.0.pre_residual_norm.weight" in shp
                  or "modality_embed.embedding" in shp)
    over["model.norm_type"] = (
        "layernorm" if "blocks.0.norm1.bias" in shp
        else ("rms" if production else "layernorm"))
    over["model.sandwich_normalization"] = \
        "blocks.0.pre_residual_norm.weight" in shp
    over["model.modality_embed"] = "modality_embed.embedding" in shp
    over["model.img_count_embed"] = "img_count_embedding" in shp
    if over["model.img_count_embed"]:
        over["model.max_images_per_sample"] = shp["img_count_embedding"][0]
    over["model.cond_label"] = "y_embedder.embedding_table.weight" in shp
    if over["model.cond_label"] and not over["model.time_conditioning"]:
        over["model.cond_dim"] = shp["y_embedder.embedding_table.weight"][1]

    over["model.img_cond"] = \
        "blocks.0.cross_attention.attn_qkv.weight" in shp
    if over["model.img_cond"]:
        key = ("cond_img_vocab_embed.embedding"
               if "cond_img_vocab_embed.embedding" in shp
               else "cond_img_vocab_embed.weight")
        over["model.cond_image_vocab_size"] = shp[key][0]
        if "cond_img_vocab_proj.weight" in shp:
            over["model.cond_img_embed_dim"] = shp[key][1]
        n_cond = 0
        while f"img_cond_blocks.{n_cond}.attn_qkv.weight" in shp:
            n_cond += 1
        over["model.n_cond_blocks"] = n_cond

    if "img_vocab_embed.weight" in shp:
        # split embed: the text table has text_vocab + 1 rows (mask), the
        # image table is the frozen VQ codebook
        over["model.split_embed"] = True
        over["model.text_vocab_size"] = shp["vocab_embed.embedding"][0] - 1
        over["model.image_vocab_size"] = shp["img_vocab_embed.weight"][0]
        over["model.img_embed_dim"] = shp["img_vocab_embed.weight"][1]
    else:
        over["model.split_embed"] = False
        vocab = shp["vocab_embed.embedding"][0]
        if vocab > 16384:
            over["model.text_vocab_size"] = vocab - 16384
            over["model.image_vocab_size"] = 16384
    return over
