"""DiT denoiser backbone in PyTorch (port of ``unidisc_tpu/models/dit.py``).

Mirrors the JAX module's numerics, so that the two agree at identical
weights:

  * weight-only LayerNorm/RMSNorm computed in fp32 and rounded to the
    compute dtype (eps 1e-5 for layernorm, 1e-6 for RMS);
  * QK-norm is a LayerNorm with bias over the full q and k width, with
    flax's eps 1e-6 and its one-pass variance;
  * adaLN time conditioning modulates and gates only image rows;
  * sandwich norm replaces the gate on the attention branch;
  * tanh-GELU MLP; rotary in the GPT-NeoX convention.

Parameters are fp32; matmuls run in the compute dtype (bf16 by default)
like flax ``nn.Dense(dtype=...)``. Parameter names are the reference
torch names (``unidisc_tpu/models/port.py``), so ``models/port.py`` maps
the JAX parameter tree onto ``state_dict`` one to one.

Unmasked self-attention goes through ``ops/flash_attention.py``: on the
card that is the hand-written forward kernel for every shape and, under
grad, the hand-written backward kernels.

With ``model.quant="int8"`` (inference; weights from
``ops/quant.py::quantize_dit_params``) the four trunk matmuls of every
block and the vocab head are ``QLinear`` (int8 W8A8): under
``quant_backend="pallas"`` their products go through the hand-written int8
kernel (``ops/int8_matmul.py``), under "xla" through its plain version.
With ``quant_fused`` as well, attn_qkv and mlp.0 take the norm and the
adaLN modulation as an fp32 prologue of the fused quantize kernel
(``ops/fused_qmm.py``), as the JAX block does.

With ``kv_cache`` (and ``cache_index``, an int or a (B,) tensor of
per-row positions) a forward writes its K/V into the cache at
``cache_index`` and attends over the whole cache (full attention) or the
cached prefix (causal); an int8 cache (``model.kv_cache_dtype="int8"``)
stores K/V through ``ops/quant.py::quantize_kv`` and is read by
``int8_kv_attention``. The writes go into the given cache tensors in place
(the JAX module returns a new cache; the port saves the copy) and the same
tensors come back as the new cache. With ``frozen_kv`` a forward attends
over [frozen K/V || its own K/V] and writes nothing. Unmasked attention
over a cache or a frozen prefix takes the hand-written kernel on the card,
like every unmasked self-attention; the fused int8 block path is left when
a KV cache is given and kept under ``frozen_kv``, as in the JAX block.

Training mode applies ``model.dropout`` to the branch outputs of every
block before the residual add, as flax ``nn.Dropout`` in the JAX block's
``gate_residual``: kept elements are scaled by 1 / (1 - p), and with
modality given the text rows take the raw, undropped branch output. The
masks of a forward are drawn from a seed, a host integer fixed before the
block stack (``dropout=`` of ``forward``; the train step passes its
generator's seed), each block from its own ``torch.Generator`` seeded with
(seed, block index), so a block recomputed under activation checkpointing
draws the same masks; ``dropout=`` may instead carry the masks themselves
(one (keep_attention, keep_mlp) pair per block), which is how the tests
give both packages the same masks.

With ``remat`` (``DIT(remat=True)``; the Trainer sets it from
``trainer.use_gradient_checkpointing``) every block runs
under ``torch.utils.checkpoint`` in training: ``model.remat_policy`` "none"
recomputes the whole block in the backward, "dots" saves the outputs of
its unbatched products (the linear layers: ``aten.mm`` / ``addmm``) and
"dots_all" also the batched ones (``bmm``), through selective activation
checkpointing, as JAX's ``dots_with_no_batch_dims_saveable`` and
``dots_saveable``. The attention kernel is not an aten op, so every policy
recomputes it, as no JAX policy saves the Pallas call: under remat the
forward kernel runs twice a block a step.

Packed interleaved batches (``data/interleaved.py``) give ``sample_ids``
(B, L): a token attends only within its own sample and a token with id -1
(padding) to nothing. Every self-attention then takes them as the
kernel's segment ids, causal or not (on a CPU tensor the kernel's plain
version); under ``attn_backend="xla"`` they become the dense
``make_sample_ids_mask``, as in JAX, and a given ``attn_mask`` wins over
them. ``rope_index`` indexes the [text | image] table per token, or, with
``model.img_resolutions``, the combined multi-resolution table
(``build_multires_rope``) absolutely. ``model.img_count_embed`` adds a
learned row per earlier image block of the sample (``img_block_index``)
to image tokens, and ``extra_embed`` (B, L, hidden) is added to the
embedding (the transfusion branch, ``models/continuous.py``).

The variants of the JAX DIT:

  * ``model.moe_experts > 0``: every block's MLP is ``models/moe.py::
    MoEMLP`` (norm2, the adaLN modulation when time-conditioned, then the
    experts); ``forward(return_moe_aux=True)`` returns (logits, the balance
    auxiliary summed over the blocks). The experts and the router stay in
    floating point in an int8 model.
  * ``model.split_embed``: text ids through a (text_vocab + 1)-row table
    whose last row is the mask token, image ids through
    ``img_vocab_embed`` (image_vocab, img_embed_dim) projected by
    ``img_vocab_proj`` in fp32; each position picks its source by id.
  * ``model.cond_label``: ``label`` (B,) through ``y_embedder``, a
    1001-row table whose row 1000 is the CFG null slot, is the
    conditioning vector c (no SiLU). In training mode labels are dropped
    to the null slot with probability 0.1, drawn from ``generator``.
  * ``model.img_cond``: ``x_cond`` (B, Lc) ids of the conditioning image
    go through ``cond_img_vocab_embed`` (and ``cond_img_vocab_proj`` under
    ``cond_img_embed_dim``), then ``n_cond_blocks`` plain blocks
    (``img_cond_blocks``: no time conditioning, 1D rope, floating point);
    every main block's ``cross_attention`` takes Q from the main stream
    (the Q third of its 3 x dim ``attn_qkv``) and K / V from the trunk's
    output (``attn_qkv_cond``, K with the cond positions' 1D rope), and its
    output is added to the block input through the attention gate, with
    no modality, as the JAX block wires it. The cross-attention (Lq != Lk)
    and the trunk's self-attention take the hand kernels on the card.
    ``img_cond`` takes no KV cache. Without ``x_cond`` the trunk and the
    cross-attention are skipped, as in JAX.

Sequence parallelism (``parallel/seq_parallel.py``): under
``sequence_parallel`` the forward takes its rank's L-chunk of the tokens,
``modality``, ``sample_ids``, ``img_block_index``, ``extra_embed`` and the
rope rows (at the chunk's global positions), runs every self-attention as
the flash-kernel ring over the "seq" group
(``parallel/ring_attention.py::ring_attention_flash``; the plain ring under
``attn_backend="xla"``), and, when the context gathers, gathers the final
hidden states over L before the vocab head, so every rank of the group
gets the whole sequence's logits. The ring takes no dense ``attn_mask``,
KV cache or frozen prefix. An MoE layer under it routes over the global
batch's tokens (``models/moe.py``); an img_cond model raises, as JAX's
``validate()`` refuses img_cond under "seq".

The rest of the device mesh: under ``parallel/pipeline.py::
pipeline_parallel`` (a "pp" axis larger than 1) the block stack runs as a
GPipe pipeline over the "pp" group, each rank running the blocks of its
stage (``_pipelined``); the "seq" chunking above composes with it, L
staying sharded across the stage boundary with the ring inside each
stage. Under "tensor" each block runs megatron tensor parallelism
(``DDiTBlock``); under "ep" and on a data-parallel mesh the MoE layers
route over the global batch and run their experts split over "ep"
(``models/moe.py``). An int8 model runs on each of them: a pp stage's int8
blocks inside the pipeline (the fused path's adaLN rows are the
microbatch's own), a tensor rank's int8 products split as its bf16 ones
(``DDiTBlock``), and under "ep" the int8 attention and head whole on every
rank.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from unidisc_tpu_torch.config import ModelConfig
from unidisc_tpu_torch.models.moe import MoEMLP, bmm_f32
from unidisc_tpu_torch.models.rotary import (apply_rope, build_multimodal_rope,
                                             build_multires_rope, rope_1d)
from unidisc_tpu_torch.ops.attention import (make_sample_ids_mask,
                                             multihead_attention)
from unidisc_tpu_torch.ops.flash_attention import flash_attention
from unidisc_tpu_torch.ops.fused_qmm import fused_qmm
from unidisc_tpu_torch.ops.quant import (int8_kv_attention, qdot,
                                         qdot_row_parallel, quantize_kv)
from unidisc_tpu_torch.parallel.comm import (GatherReplicated, copy_to,
                                             reduce_from, sum_over)
from unidisc_tpu_torch.parallel.pipeline import current_pp
from unidisc_tpu_torch.parallel.seq_parallel import \
    current_seq_mesh as _ring_ctx

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class QLinear(nn.Module):
    """int8 W8A8 linear for inference, the counterpart of the JAX
    ``QDense``: an int8 ``weight_q`` (out, in) and its fp32 per-output-
    channel ``scale``, both buffers (no gradients), and an fp32 bias. The
    activations are quantized per row at each call."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, backend: str = "xla"):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.backend = backend
        self.register_buffer("weight_q", torch.zeros(
            (out_features, in_features), dtype=torch.int8))
        self.register_buffer("scale", torch.full((out_features,),
                                                 1 / 127.0))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_features))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor, out_dtype: torch.dtype,
                prologue=None) -> torch.Tensor:
        """x (..., in) -> (..., out) in `out_dtype`. `prologue`: the keyword
        arguments of ``fused_qmm`` (mode, norm and adaLN operands) for the
        fused path, or None for ``qdot``."""
        if prologue is None:
            return qdot(x, self.weight_q, self.scale, bias=self.bias,
                        out_dtype=out_dtype, backend=self.backend)
        # weight_q's own shape: a tensor rank holds its columns only
        y = fused_qmm(x.reshape(-1, x.shape[-1]), self.weight_q,
                      self.scale, bias=self.bias, out_dtype=out_dtype,
                      backend=self.backend, **prologue)
        return y.reshape(*x.shape[:-1], self.weight_q.shape[0])


def _product_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.T of compute-dtype operands accumulated and returned in fp32:
    on the card one fp32-output product (``models/moe.py::bmm_f32``),
    elsewhere the product of the operands' fp32 values."""
    if x.is_cuda and x.dtype != torch.float32:
        return bmm_f32(x.reshape(1, -1, x.shape[-1]), w.t()[None]).view(
            *x.shape[:-1], w.shape[0])
    return F.linear(x.float(), w.float())


def make_linear(cfg: ModelConfig, in_features: int, out_features: int, *,
                bias: bool) -> nn.Module:
    """``nn.Linear``, or ``QLinear`` when ``cfg.quant == "int8"``."""
    if cfg.quant == "int8":
        return QLinear(in_features, out_features, bias=bias,
                       backend=cfg.quant_backend)
    return nn.Linear(in_features, out_features, bias=bias)


def dense(x: torch.Tensor, layer: nn.Module, dtype: torch.dtype):
    """flax ``nn.Dense(dtype=dtype)``: input, weight and bias cast to
    `dtype`, product in `dtype`; a ``QLinear`` computes in int8 and writes
    `dtype`."""
    if isinstance(layer, QLinear):
        return layer(x, dtype)
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class Embedding(nn.Module):
    """A lookup table stored as ``<name>.embedding`` (reference naming)."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, dim))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding)


class Norm(nn.Module):
    """Weight-only LayerNorm/RMSNorm computed in fp32, rounded to the
    compute dtype."""

    def __init__(self, dim: int, norm_type: str = "layernorm",
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if norm_type not in ("layernorm", "rms"):
            raise ValueError(norm_type)
        self.norm_type = norm_type
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.norm_type == "layernorm":
            mean = x32.mean(-1, keepdim=True)
            var = x32.var(-1, keepdim=True, unbiased=False)
            y = (x32 - mean) * torch.rsqrt(var + 1e-5)
        else:
            y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + 1e-6)
        return (y * self.weight.float()).to(self.compute_dtype)


class QKNorm(nn.Module):
    """flax ``nn.LayerNorm(use_bias=True)``: fp32 statistics with the
    one-pass variance E[x^2] - E[x]^2 clipped at 0, eps 1e-6."""

    def __init__(self, dim: int, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, tp=None) -> torch.Tensor:
        """x: the whole width, or with `tp` (a tensor ``comm.Axis``) the
        rank's block of it: the statistics are then the sums of every
        rank's part, and the rank applies its block of the scale and
        bias."""
        x32 = x.float()
        weight, bias = self.weight, self.bias
        if tp is None:
            mean = x32.mean(-1, keepdim=True)
            ex2 = (x32 * x32).mean(-1, keepdim=True)
        else:
            w = x.shape[-1]
            sums = sum_over(torch.stack([x32.sum(-1), (x32 * x32).sum(-1)],
                                        -1), tp.group) / (w * tp.size)
            mean, ex2 = sums[..., :1], sums[..., 1:]
            lo = tp.rank * w
            weight = copy_to(weight, tp.group)[lo:lo + w]
            bias = copy_to(bias, tp.group)[lo:lo + w]
        var = torch.clamp(ex2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + 1e-6) * weight.float()
        y = (x32 - mean) * mul + bias.float()
        return y.to(self.compute_dtype)


class TimestepEmbedder(nn.Module):
    """Sinusoidal timestep embedding -> 2-layer MLP in fp32, rounded to
    the compute dtype."""

    def __init__(self, cond_dim: int, freq_dim: int = 256,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.freq_dim = freq_dim
        self.compute_dtype = compute_dtype
        self.mlp = nn.Sequential(nn.Linear(freq_dim, cond_dim), nn.SiLU(),
                                 nn.Linear(cond_dim, cond_dim))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        # in fp32 whatever the parameters' dtype (bf16 under
        # low_precision_params), as flax promotes bf16 params to f32 inputs
        h = dense(timestep_features(t, self.freq_dim), self.mlp[0],
                  torch.float32)
        h = dense(F.silu(h), self.mlp[2], torch.float32)
        return h.to(self.compute_dtype)


def timestep_features(t: torch.Tensor, freq_dim: int = 256) -> torch.Tensor:
    half = freq_dim // 2
    freqs = torch.exp(-math.log(10_000)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) with the sigmoid rounded to x.dtype first, as
    ``jax.nn.silu`` computes it in bf16."""
    return x * torch.sigmoid(x)


def modulate(x, shift, scale, modality=None):
    """adaLN modulation; with `modality`, only image rows (1) change."""
    out = x * (1 + scale) + shift
    if modality is None:
        return out
    return torch.where((modality == 1)[..., None], out, x)


def gate_residual(x_skip, out, gate, modality, *, dropout_fn=None):
    """Residual add with the adaLN gate on image rows: image rows take
    gate * dropout(out); text rows take the raw branch output when
    `modality` is given."""
    dropped = dropout_fn(out) if dropout_fn is not None else out
    if gate is None:
        return x_skip + dropped
    gated = gate * dropped
    if modality is not None:
        gated = torch.where((modality == 1)[..., None], gated, out)
    return x_skip + gated


def dropout_with(keep: torch.Tensor, p: float):
    """flax ``nn.Dropout(p)`` with a given keep mask: x / (1 - p) where
    kept, 0 elsewhere."""
    def fn(x):
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
    return fn


def block_dropout_seed(seed: int, block: int) -> int:
    """The seed of one block's dropout generator."""
    return (seed * 1_000_003 + 7_919 * (block + 1)) % (2 ** 63)


def dropout_masks(shape, p: float, seed: int, device, n: int = 2):
    """(keep_attention, keep_mlp) of one block, or (keep_attention,
    keep_cross, keep_mlp) with n 3: bool masks, each element kept with
    probability 1 - p, from a generator seeded with `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.rand(shape, generator=gen, device=device) < 1.0 - p
                 for _ in range(n))


class LabelEmbedder(nn.Module):
    """Class-label embedding with a CFG null slot: ``embedding_table`` has
    num_classes + 1 rows, the last the null label."""

    def __init__(self, num_classes: int, cond_dim: int,
                 dropout_prob: float = 0.1):
        super().__init__()
        self.num_classes, self.dropout_prob = num_classes, dropout_prob
        self.embedding_table = nn.Embedding(num_classes + 1, cond_dim)

    def forward(self, labels: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """In training each label becomes the null slot with probability
        dropout_prob, drawn from `generator` (required there)."""
        labels = labels.long()
        if train and self.dropout_prob > 0:
            if generator is None:
                raise ValueError("the training-mode label drop needs a "
                                 "torch.Generator (generator=)")
            drop = torch.rand(labels.shape, generator=generator,
                              device=labels.device) < self.dropout_prob
            labels = torch.where(drop, self.num_classes, labels)
        return self.embedding_table(labels)


class CrossAttention(nn.Module):
    """Cross-attention of the main stream to the conditioning trunk's
    output: Q from the Q third of ``attn_qkv`` (the whole 3 x dim
    parameter is kept, as in the reference and JAX), K and V from the K and
    V thirds of ``attn_qkv_cond``; Q takes the main stream's rope, K the
    cond positions' 1D rope. Always floating point."""

    def __init__(self, cfg: ModelConfig,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.compute_dtype = cfg, compute_dtype
        dim = cfg.hidden_size
        self.attn_qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.attn_qkv_cond = nn.Linear(dim, 3 * dim, bias=False)
        self.attn_out = nn.Linear(dim, dim, bias=False)

    def forward(self, x, x_cond, rope_cos, rope_sin, cond_rope):
        cfg, dt = self.cfg, self.compute_dtype
        b, l, dim = x.shape
        lc = x_cond.shape[1]
        h, d = cfg.n_heads, cfg.head_dim
        q = F.linear(x.to(dt), self.attn_qkv.weight[:dim].to(dt))
        kv = F.linear(x_cond.to(dt), self.attn_qkv_cond.weight[dim:].to(dt))
        k, v = kv.view(b, lc, 2, h, d).unbind(2)
        q = apply_rope(q.view(b, l, h, d), rope_cos, rope_sin)
        k = apply_rope(k, *cond_rope)
        out = flash_attention(q, k, v) if cfg.attn_backend != "xla" \
            else multihead_attention(q, k, v)
        return dense(out.reshape(b, l, dim), self.attn_out, dt)


_SAVED_PRODUCTS = {
    "dots": ("mm", "addmm"),
    "dots_all": ("mm", "addmm", "bmm", "baddbmm"),
}


def remat_context(policy: str):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a remat
    policy: None for "none" (recompute everything), else selective
    checkpointing that saves the products of the policy and recomputes
    every other op."""
    if policy == "none":
        return None
    if policy not in _SAVED_PRODUCTS:
        raise ValueError(f"unknown model.remat_policy {policy!r}")
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    saved = {getattr(torch.ops.aten, n).default
             for n in _SAVED_PRODUCTS[policy]}

    def policy_fn(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved \
            else CheckpointPolicy.PREFER_RECOMPUTE
    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


class DDiTBlock(nn.Module):
    """Transformer block with optional adaLN time conditioning and
    sandwich normalization. The self-attention parameters sit on the
    block (``attn_qkv``, ``attn_out``, ``q_norm``, ``k_norm``), as in the
    reference torch names.

    ``tp``: under tensor parallelism (set by ``parallel/mesh.py::
    shard_model``, a ``comm.Axis`` of the "tensor" group) the block holds
    its head shard of the megatron leaves and runs them so: ``attn_qkv``,
    ``mlp.0`` and ``adaLN_modulation`` column-parallel (the input through
    ``comm.copy_to``), ``attn_out`` and ``mlp.2`` row-parallel (the
    partial outputs through ``comm.reduce_from``, mlp.2's bias after the
    sum), attention over the rank's n_heads / tensor heads, the QK-norm's
    statistics summed over the group, the six adaLN chunks gathered whole
    on every rank. The residual stream, the norms and the dropout masks
    are whole and alike on every tensor rank.

    An int8 block (``QLinear``) runs the same split with every int8
    product equal to the one-rank product bit for bit (``_tp_linear``):
    the column-parallel products quantize the whole row (the fused path's
    norm and adaLN prologue too, over the whole residual row) against the
    rank's columns, and the row-parallel ones quantize the rank's K-slice
    by the whole row's amax and sum the int32 partials before the one
    epilogue. What can still differ from one device is what differs in
    the bf16 tensor path too: the QK-norm's statistics summed over the
    group, and the floating-point adaLN product taken by columns."""

    def __init__(self, cfg: ModelConfig,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.tp = None
        dim = cfg.hidden_size
        self.norm1 = Norm(dim, cfg.norm_type, compute_dtype)
        self.attn_qkv = make_linear(cfg, dim, 3 * dim, bias=False)
        self.attn_out = make_linear(cfg, dim, dim, bias=False)
        if cfg.qk_norm:
            self.q_norm = QKNorm(dim, compute_dtype)
            self.k_norm = QKNorm(dim, compute_dtype)
        self.norm2 = Norm(dim, cfg.norm_type, compute_dtype)
        if cfg.moe_experts > 0:
            self.moe = MoEMLP(cfg, compute_dtype)
        else:
            self.mlp = nn.Sequential(
                make_linear(cfg, dim, cfg.mlp_ratio * dim, bias=True),
                nn.GELU(approximate="tanh"),
                make_linear(cfg, cfg.mlp_ratio * dim, dim, bias=True))
        if cfg.img_cond:
            self.cross_attention = CrossAttention(cfg, compute_dtype)
        if cfg.time_conditioning:
            self.adaLN_modulation = nn.Linear(cfg.cond_dim, 6 * dim)
        if cfg.sandwich_normalization:
            self.pre_residual_norm = Norm(dim, cfg.norm_type, compute_dtype)
            self.post_ff_norm = Norm(dim, cfg.norm_type, compute_dtype)

    def attention(self, x, rope_cos, rope_sin, attn_mask=None,
                  qkv_prologue=None, kv_cache=None, cache_index=None,
                  frozen_kv=None, segment_ids=None):
        """Self-attention. kv_cache: this block's (k, v) or int8 (k_q, k_s,
        v_q, v_s) slices, written in place at cache_index. segment_ids:
        (q_seg, k_seg) of a packed batch, taken where no attn_mask is."""
        cfg = self.cfg
        dt = self.compute_dtype
        tp = self.tp
        b, l, dim = x.shape
        h, d = cfg.n_heads, cfg.head_dim
        if tp is not None:
            if kv_cache is not None or frozen_kv is not None:
                raise NotImplementedError(
                    "a KV cache or frozen K/V under tensor parallelism is "
                    "not in the port yet (ROADMAP queue 1, item 9)")
            x = copy_to(x, tp.group)
            h, dim = h // tp.size, dim // tp.size
        if qkv_prologue is None:
            qkv = dense(x, self.attn_qkv, dt)
        else:
            qkv = self.attn_qkv(x, dt, qkv_prologue)
        if cfg.qk_norm:
            qkv = torch.cat([self.q_norm(qkv[..., :dim], tp),
                             self.k_norm(qkv[..., dim:2 * dim], tp),
                             qkv[..., 2 * dim:]], dim=-1)
        q, k, v = qkv.view(b, l, 3, h, d).unbind(2)
        q = apply_rope(q, rope_cos, rope_sin)
        k = apply_rope(k, rope_cos, rope_sin)
        causal = not cfg.full_attention
        if cfg.attn_backend not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown attn_backend {cfg.attn_backend!r}")
        kernel = cfg.attn_backend != "xla"
        if kv_cache is not None:
            new = (*quantize_kv(k), *quantize_kv(v)) if len(kv_cache) == 4 \
                else (k, v)
            for cache, value in zip(kv_cache, new):
                write_cache(cache, value, cache_index)
            mask = None if cfg.full_attention else cache_mask(
                l, kv_cache[0].shape[1], cache_index, x.device)
            if len(kv_cache) == 4:
                out = int8_kv_attention(q, *kv_cache, mask=mask)
            elif mask is None and kernel:
                out = flash_attention(q, *kv_cache)
            else:
                out = multihead_attention(q, *kv_cache, mask=mask)
        elif frozen_kv is not None:
            if causal:
                raise ValueError("frozen_kv needs model.full_attention")
            fk, fv = frozen_kv
            k = torch.cat([fk.to(k.dtype), k], dim=1)
            v = torch.cat([fv.to(v.dtype), v], dim=1)
            out = flash_attention(q, k, v) if kernel \
                else multihead_attention(q, k, v)
        elif _ring_ctx() is not None:
            # sequence parallelism: this rank holds an L-chunk; the ring
            # runs over the "seq" group, the ids rotating with K/V
            from unidisc_tpu_torch.parallel.ring_attention import (
                ring_attention, ring_attention_flash)
            ring = ring_attention_flash if kernel else ring_attention
            out = ring(q, k, v, None if segment_ids is None
                       else segment_ids[0], group=_ring_ctx().group,
                       causal=causal)
        elif attn_mask is None and kernel:
            out = flash_attention(q, k, v, causal=causal,
                                  segment_ids=segment_ids)
        else:
            out = multihead_attention(q, k, v, mask=attn_mask, causal=causal)
        if tp is None:
            return dense(out.reshape(b, l, dim), self.attn_out, dt)
        return self._tp_linear(out.reshape(b, l, dim), self.attn_out,
                               cols=False)

    def _tp_linear(self, x, layer, cols: bool):
        """One tensor-parallel product: `cols` column-parallel (the rank's
        block of the output in the compute dtype, its block of the whole
        bias), else row-parallel: the ranks' partial products of the
        compute-dtype operands in fp32, summed, the bias added and rounded
        once to the compute dtype, as the one-rank product rounds its
        fp32 accumulator. A ``QLinear`` holds its own part (its columns and
        their bias, or its K-slice): column-parallel it quantizes the whole
        row, which every rank holds alike, and row-parallel it runs
        ``ops/quant.py::qdot_row_parallel`` (the row amax reduced over the
        group, the int32 partials summed, one epilogue): either way the
        one-rank int8 product bit for bit."""
        dt, tp = self.compute_dtype, self.tp
        if isinstance(layer, QLinear):
            if cols:
                return layer(x, dt)
            return qdot_row_parallel(x, layer.weight_q, layer.scale, tp.group,
                                     bias=layer.bias, out_dtype=dt,
                                     backend=layer.backend)
        if cols:
            w = layer.weight.shape[0]
            bias = None if layer.bias is None else copy_to(
                layer.bias, tp.group)[tp.rank * w:(tp.rank + 1) * w].to(dt)
            return F.linear(copy_to(x, tp.group).to(dt),
                            layer.weight.to(dt), bias)
        y = reduce_from(_product_f32(x.to(dt), layer.weight.to(dt)),
                        tp.group)
        if layer.bias is not None:
            y = y + layer.bias.to(dt).float()
        return y.to(dt)

    def forward(self, x, c, rope_cos, rope_sin, modality=None,
                attn_mask=None, kv_cache=None, cache_index=None,
                frozen_kv=None, dropout=None, segment_ids=None,
                x_cond=None, cond_rope=None):
        """One block; a kv_cache (this block's slices) is written in
        place. dropout: None, this block's seed (an int) or its
        (keep_attention, keep_mlp) masks, (keep_attention, keep_cross,
        keep_mlp) where the cross-attention runs. x_cond: the conditioning
        trunk's output (B, Lc, hidden), with its rope rows cond_rope.
        Returns x, or (x, the MoE auxiliary) under model.moe_experts."""
        cfg = self.cfg
        dt = self.compute_dtype
        cross = cfg.img_cond and x_cond is not None
        drop_attn = drop_cross = drop_mlp = None
        if dropout is not None:
            keep = dropout_masks(x.shape, cfg.dropout, dropout, x.device,
                                 3 if cross else 2) \
                if isinstance(dropout, int) else dropout
            drops = [dropout_with(k, cfg.dropout) for k in keep]
            drop_attn, drop_mlp = drops[0], drops[-1]
            if cross:
                drop_cross = drops[1]
        if cfg.time_conditioning:
            if self.tp is None:
                cond = dense(c, self.adaLN_modulation, dt)
            else:
                cond = self._tp_linear(c, self.adaLN_modulation, cols=True)
                # contiguous: the gather's view along the last dimension
                # is strided, and the fused prologue reads the chunks' rows
                # as contiguous vectors
                cond = GatherReplicated.apply(cond, self.tp.group,
                                              cond.ndim - 1).contiguous()
            cond = cond[:, None, :] if cond.ndim == 2 else cond
            (shift_msa, scale_msa, gate_msa,
             shift_mlp, scale_mlp, gate_mlp) = cond.chunk(6, dim=-1)
        else:
            shift_msa = scale_msa = shift_mlp = scale_mlp = None
            gate_msa = gate_mlp = None
        # fused int8 inference: the norm and the adaLN modulation of the
        # attn_qkv and mlp.0 inputs run in fp32 inside the fused quantize
        # kernel, with no bf16 rounding between them; attn_out and mlp.2
        # keep qdot. The kernel takes one adaLN row per batch element, so
        # per-token rows ((B, L, dim), from a (B, L, cond_dim) c) keep qdot,
        # and so does a forward that writes a KV cache, as in the JAX block
        fused = (cfg.quant == "int8" and cfg.quant_fused
                 and kv_cache is None
                 and (shift_msa is None or shift_msa.shape[1] == 1))
        if fused:
            gate_rows = None if modality is None \
                else modality.reshape(-1).float()

            def prologue(norm, shift, scale):
                pro = dict(mode="adaln_norm", norm_type=cfg.norm_type,
                           norm_w=norm.weight, rows_per_batch=x.shape[1])
                if shift is not None:
                    pro.update(shift=shift[:, 0], scale=scale[:, 0],
                               modality=gate_rows)
                return pro

        x_skip = x
        cache_kw = dict(kv_cache=kv_cache, cache_index=cache_index,
                        frozen_kv=frozen_kv, segment_ids=segment_ids)
        if fused:
            attn_out = self.attention(
                x, rope_cos, rope_sin, attn_mask,
                qkv_prologue=prologue(self.norm1, shift_msa, scale_msa),
                **cache_kw)
        else:
            hidden = self.norm1(x)
            if cfg.time_conditioning:
                hidden = modulate(hidden, shift_msa, scale_msa, modality)
            attn_out = self.attention(hidden, rope_cos, rope_sin, attn_mask,
                                      **cache_kw)
        if cfg.sandwich_normalization:
            x = x_skip + self.pre_residual_norm(attn_out)
        else:
            x = gate_residual(x_skip, attn_out, gate_msa, modality,
                              dropout_fn=drop_attn)
        if cross:
            # the JAX (and reference) wiring: the cross output goes onto
            # the block input through the attention gate, with no modality
            cross_out = self.cross_attention(x, x_cond, rope_cos, rope_sin,
                                             cond_rope)
            x = gate_residual(x_skip, cross_out, gate_msa, None,
                              dropout_fn=drop_cross)

        aux = None
        if cfg.moe_experts > 0:
            hidden = self.norm2(x)
            if cfg.time_conditioning:
                hidden = modulate(hidden, shift_mlp, scale_mlp, modality)
            hidden, aux = self.moe(hidden)
        else:
            if fused:
                hidden = self.mlp[0](x, dt, prologue(self.norm2, shift_mlp,
                                                     scale_mlp))
            else:
                hidden = self.norm2(x)
                if cfg.time_conditioning:
                    hidden = modulate(hidden, shift_mlp, scale_mlp,
                                      modality)
                hidden = dense(hidden, self.mlp[0], dt) if self.tp is None \
                    else self._tp_linear(hidden, self.mlp[0], cols=True)
            hidden = F.gelu(hidden, approximate="tanh")
            hidden = dense(hidden, self.mlp[2], dt) if self.tp is None \
                else self._tp_linear(hidden, self.mlp[2], cols=False)
        if cfg.sandwich_normalization:
            hidden = self.post_ff_norm(hidden)
        x = gate_residual(x, hidden, gate_mlp, modality, dropout_fn=drop_mlp)
        return x if aux is None else (x, aux)


class DDitFinalLayer(nn.Module):
    """Output head: norm, adaLN modulation, linear over the vocab."""

    def __init__(self, cfg: ModelConfig,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.norm_final = Norm(cfg.hidden_size, cfg.norm_type, compute_dtype)
        if cfg.time_conditioning:
            self.adaLN_modulation = nn.Linear(cfg.cond_dim,
                                              2 * cfg.hidden_size)
        self.linear = make_linear(cfg, cfg.hidden_size, cfg.vocab_size,
                                  bias=True)

    def forward(self, x, c, modality=None):
        cfg = self.cfg
        x = self.norm_final(x)
        if cfg.time_conditioning:
            cond = dense(c, self.adaLN_modulation,
                         self.compute_dtype)[:, None, :]
            shift, scale = cond.chunk(2, dim=-1)
            x = modulate(x, shift, scale, modality)
        out_dtype = _DTYPES[cfg.logits_dtype]
        return dense(x.to(out_dtype), self.linear, out_dtype)


class DIT(nn.Module):
    """The UniDisc denoiser.

    forward(indices (B, L), sigma (B,), modality (B, L) 0=text/1=image,
    attn_mask optional boolean (B, L, L) or (B, H, L, L)) -> logits
    (B, L, vocab) in ``model.logits_dtype``; with return_hidden, also the
    final hidden state. ``hidden(...)`` returns only the hidden state and
    skips the vocab head. Packed batches add sample_ids, rope_index and
    img_block_index, the variants label and x_cond (module docstring).
    """

    def __init__(self, cfg: ModelConfig,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 remat: bool = False, device="cpu", init: bool = True):
        """The modules are built on the meta device, so with no draws,
        then given storage on `device`; ``init`` fills them through
        ``reset_parameters`` (seed 0), else they hold no values until
        ``load_state_dict`` or ``reset_parameters`` fills them. The rope
        tables, made from numpy on the host, are carried over."""
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.remat = remat
        with torch.device("meta"):
            self._build(cfg, compute_dtype)
        tables = {n: b for n, b in self.named_buffers() if not b.is_meta}
        self.to_empty(device=device)
        with torch.no_grad():
            for name, value in tables.items():
                self.get_buffer(name).copy_(value)
        if init:
            self.reset_parameters(torch.Generator().manual_seed(0))

    def _build(self, cfg: ModelConfig, compute_dtype: torch.dtype) -> None:
        dim = cfg.hidden_size
        if cfg.split_embed:
            self.vocab_embed = Embedding(cfg.text_vocab_size + 1, dim)
            self.img_vocab_embed = nn.Embedding(cfg.image_vocab_size,
                                                cfg.img_embed_dim)
            self.img_vocab_proj = nn.Linear(cfg.img_embed_dim, dim)
        else:
            self.vocab_embed = Embedding(cfg.vocab_size, dim)
        if cfg.time_conditioning and not cfg.cond_label:
            self.sigma_map = TimestepEmbedder(cfg.cond_dim,
                                              compute_dtype=compute_dtype)
        if cfg.cond_label:
            self.y_embedder = LabelEmbedder(1000, cfg.cond_dim)
        if cfg.modality_embed:
            self.modality_embed = Embedding(2, dim)
        if cfg.img_count_embed:
            # the reference name: a bare table, zero at init
            self.img_count_embedding = nn.Parameter(
                torch.zeros(cfg.max_images_per_sample, dim))
        if cfg.img_cond:
            if cfg.cond_img_embed_dim is not None:
                self.cond_img_vocab_embed = nn.Embedding(
                    cfg.cond_image_vocab_size, cfg.cond_img_embed_dim)
                self.cond_img_vocab_proj = nn.Linear(cfg.cond_img_embed_dim,
                                                     dim)
            else:
                self.cond_img_vocab_embed = Embedding(
                    cfg.cond_image_vocab_size, dim)
            # plain blocks: unconditioned, dense, floating point (JAX builds
            # them with time conditioning, img_cond and MoE off; its
            # quantize leaves them in floating point)
            cond_cfg = dataclasses.replace(cfg, time_conditioning=False,
                                           img_cond=False, moe_experts=0,
                                           quant=None)
            self.img_cond_blocks = nn.ModuleList(
                DDiTBlock(cond_cfg, compute_dtype)
                for _ in range(cfg.n_cond_blocks))
            ccos, csin = rope_1d(cfg.cond_length, cfg.head_dim,
                                 base=cfg.rope_base)
            self.register_buffer("cond_rope_cos", torch.from_numpy(ccos),
                                 persistent=False)
            self.register_buffer("cond_rope_sin", torch.from_numpy(csin),
                                 persistent=False)
        self.blocks = nn.ModuleList(DDiTBlock(cfg, compute_dtype)
                                    for _ in range(cfg.n_blocks))
        self.output_layer = DDitFinalLayer(cfg, compute_dtype)
        if cfg.img_resolutions is not None:
            # the text rows span the whole length, as in JAX
            cos, sin, _ = build_multires_rope(
                cfg.length, tuple(cfg.img_resolutions), cfg.head_dim,
                base=cfg.rope_base)
        else:
            cos, sin = build_multimodal_rope(cfg.txt_length, cfg.img_length,
                                             cfg.head_dim, cfg.rope_2d,
                                             base=cfg.rope_base)
        self.register_buffer("rope_cos", torch.from_numpy(cos),
                             persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin),
                             persistent=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Initialise like ``unidisc_tpu.models.dit.init_dit`` (the same
        distributions; torch and JAX draw different numbers): torch-Linear
        uniform kernels, uniform embeddings, zero adaLN tables, and a zero
        vocab head under ``zero_linear_init``; flax's default lecun-normal
        kernels (zero biases) for the split-embed and cond projections and
        the MoE router and experts. A ``QLinear`` takes the JAX ``QDense``
        init, round(127 x the uniform kernel) with scale 1/127, the vocab
        head too. The numbers are drawn on the generator's device (a
        card's generator draws on the card)."""
        from unidisc_tpu_torch.tokenizers.vqgan import _truncated_normal_
        cfg = self.cfg
        dev = generator.device

        def uniform_(p, fan):
            bound = 1.0 / math.sqrt(fan)
            p.copy_(torch.empty(p.shape, device=dev).uniform_(
                -bound, bound, generator=generator))

        def lecun_(p, fan):
            t = torch.empty(p.shape, device=dev)
            _truncated_normal_(t, math.sqrt(1.0 / fan) / .87962566103423978,
                               generator)
            p.copy_(t)

        def linear_(lin, bias="zeros"):
            if isinstance(lin, QLinear):
                w = torch.empty(lin.weight_q.shape, device=dev)
                uniform_(w, lin.in_features)
                lin.weight_q.copy_(torch.round(w * 127).to(torch.int8))
                lin.scale.fill_(1 / 127.0)
            else:
                uniform_(lin.weight, lin.in_features)
            if lin.bias is not None:
                if bias == "zeros":
                    lin.bias.zero_()
                else:  # the JAX init draws the bias with fan = its length
                    uniform_(lin.bias, lin.bias.numel())

        def dense_(lin):       # flax nn.Dense's default init
            lecun_(lin.weight, lin.in_features)
            lin.bias.zero_()

        def block_(blk):
            linear_(blk.attn_qkv)
            linear_(blk.attn_out)
            if blk.cfg.moe_experts > 0:
                lecun_(blk.moe.router.weight, cfg.hidden_size)
                lecun_(blk.moe.w1, cfg.hidden_size)
                lecun_(blk.moe.w2, cfg.mlp_ratio * cfg.hidden_size)
                blk.moe.b1.zero_()
                blk.moe.b2.zero_()
            else:
                linear_(blk.mlp[0], bias="uniform")
                linear_(blk.mlp[2], bias="uniform")
            if blk.cfg.img_cond:
                for lin in (blk.cross_attention.attn_qkv,
                            blk.cross_attention.attn_qkv_cond,
                            blk.cross_attention.attn_out):
                    linear_(lin)
            if blk.cfg.time_conditioning:
                blk.adaLN_modulation.weight.zero_()
                blk.adaLN_modulation.bias.zero_()
            for m in blk.modules():
                if isinstance(m, (Norm, QKNorm)):
                    m.weight.fill_(1.0)
                    if isinstance(m, QKNorm):
                        m.bias.zero_()

        uniform_(self.vocab_embed.embedding, cfg.hidden_size)
        if cfg.split_embed:
            uniform_(self.img_vocab_embed.weight, cfg.img_embed_dim)
            dense_(self.img_vocab_proj)
        if cfg.img_count_embed:
            self.img_count_embedding.zero_()
        if cfg.modality_embed:
            uniform_(self.modality_embed.embedding, cfg.hidden_size)
        if cfg.time_conditioning and not cfg.cond_label:
            linear_(self.sigma_map.mlp[0])
            linear_(self.sigma_map.mlp[2])
        if cfg.cond_label:
            uniform_(self.y_embedder.embedding_table.weight, cfg.cond_dim)
        if cfg.img_cond:
            if cfg.cond_img_embed_dim is not None:
                uniform_(self.cond_img_vocab_embed.weight,
                         cfg.cond_img_embed_dim)
                dense_(self.cond_img_vocab_proj)
            else:
                uniform_(self.cond_img_vocab_embed.embedding,
                         cfg.hidden_size)
            for blk in self.img_cond_blocks:
                block_(blk)
        for blk in self.blocks:
            block_(blk)
        out = self.output_layer
        out.norm_final.weight.fill_(1.0)
        if cfg.time_conditioning:
            out.adaLN_modulation.weight.zero_()
            out.adaLN_modulation.bias.zero_()
        if isinstance(out.linear, QLinear) or not cfg.zero_linear_init:
            linear_(out.linear)
        else:
            out.linear.weight.zero_()
            out.linear.bias.zero_()

    def _check(self, sigma, modality) -> None:
        if self.cfg.time_conditioning and sigma is None:
            raise ValueError("time_conditioning needs sigma")
        if self.cfg.modality_embed and modality is None:
            raise ValueError("modality_embed needs modality")

    def hidden(self, indices, sigma=None, *, modality=None, attn_mask=None,
               kv_cache=None, cache_index=None, frozen_kv=None,
               rope_index=None, dropout=None, sample_ids=None,
               img_block_index=None, extra_embed=None, label=None,
               x_cond=None, generator=None):
        """Final hidden state (B, L, hidden) after the block stack, without
        the vocab head; with a kv_cache, (hidden, new_cache)."""
        x, _, new_cache, _ = self._trunk(
            indices, sigma, modality, attn_mask, kv_cache, cache_index,
            frozen_kv, rope_index, dropout,
            packed=(sample_ids, img_block_index, extra_embed),
            conditioning=(label, x_cond, generator))
        return x if kv_cache is None else (x, new_cache)

    def _dropout_per_block(self, dropout, n: int):
        """The dropout argument of each of n blocks (the main blocks, then
        the conditioning trunk's), None without dropout: its seed, or the
        given masks. In training with model.dropout > 0 and no `dropout`,
        the seed is drawn from torch's default CPU generator."""
        if not (self.training and self.cfg.dropout > 0):
            return [None] * n
        if dropout is None:
            dropout = int(torch.randint(0, 2 ** 62, (1,)).item())
        if isinstance(dropout, int):
            return [block_dropout_seed(dropout, i) for i in range(n)]
        if len(dropout) != n:
            raise ValueError(f"dropout masks for {len(dropout)} blocks, the "
                             f"forward runs {n}")
        return list(dropout)

    def _embed(self, indices, modality, img_block_index, extra_embed):
        """The token embedding with the image-count rows and the extra
        embedding added, then the modality rows, in the JAX order."""
        cfg = self.cfg
        dt = self.compute_dtype
        if cfg.split_embed:
            tvs = cfg.text_vocab_size
            mask_tok = indices == cfg.mask_index
            img_tok = (indices >= tvs) & ~mask_tok
            txt_ids = torch.where(mask_tok, tvs,
                                  torch.where(indices < tvs, indices, 0))
            img_ids = torch.where(img_tok, indices - tvs, 0)
            img_x = F.linear(self.img_vocab_embed(img_ids),
                             self.img_vocab_proj.weight,
                             self.img_vocab_proj.bias)
            x = torch.where(img_tok[..., None], img_x,
                            self.vocab_embed(txt_ids)).to(dt)
        else:
            x = self.vocab_embed(indices).to(dt)
        if cfg.img_count_embed and img_block_index is not None:
            if modality is None:
                raise ValueError("img_block_index needs modality")
            idx = img_block_index.long().clamp(0,
                                               cfg.max_images_per_sample - 1)
            add = torch.where((modality == 1)[..., None],
                              self.img_count_embedding[idx], 0.0)
            x = x + add.to(dt)
        if extra_embed is not None:
            x = x + extra_embed.to(dt)
        if cfg.modality_embed:
            x = x + self.modality_embed(modality).to(dt)
        return x

    def _cond_trunk(self, x_cond, drops):
        """The conditioning trunk over x_cond (B, Lc): (its output (B, Lc,
        hidden), its 1D rope rows)."""
        cfg = self.cfg
        lc = x_cond.shape[1]
        if lc > self.cond_rope_cos.shape[0]:
            raise ValueError(f"x_cond has {lc} positions; model.cond_length "
                             f"is {cfg.cond_length}")
        ce = self.cond_img_vocab_embed(x_cond.long())
        if cfg.cond_img_embed_dim is not None:
            ce = F.linear(ce, self.cond_img_vocab_proj.weight,
                          self.cond_img_vocab_proj.bias)
        ce = ce.to(self.compute_dtype)
        rope = (self.cond_rope_cos[:lc], self.cond_rope_sin[:lc])
        for blk, drop in zip(self.img_cond_blocks, drops):
            ce = blk(ce, None, *rope, dropout=drop)
        return ce, rope

    def _trunk(self, indices, sigma, modality, attn_mask, kv_cache,
               cache_index, frozen_kv, rope_index, dropout=None,
               packed=(None, None, None), conditioning=(None, None, None)):
        """(hidden, c, new cache, the MoE auxiliary summed over the blocks
        or None)."""
        self._check(sigma, modality)
        sample_ids, img_block_index, extra_embed = packed
        label, x_cond, generator = conditioning
        cfg = self.cfg
        if kv_cache is not None and frozen_kv is not None:
            raise ValueError("pass kv_cache or frozen_kv, not both")
        if kv_cache is not None or frozen_kv is not None:
            if attn_mask is not None or not (
                    isinstance(cache_index, int)
                    or (torch.is_tensor(cache_index)
                        and cache_index.shape == indices.shape[:1])):
                raise ValueError("kv_cache and frozen_kv need a cache_index "
                                 "(an int, or a (B,) tensor of per-row "
                                 "positions) and take no attn_mask")
            if sample_ids is not None:
                raise ValueError("sample_ids take no kv_cache or frozen_kv")
        cross = cfg.img_cond and x_cond is not None
        if cross and kv_cache is not None:
            raise ValueError("img_cond excludes KV-cache decode")
        ring = _ring_ctx()
        l = indices.shape[1]
        if ring is not None:
            if kv_cache is not None or frozen_kv is not None \
                    or attn_mask is not None:
                raise ValueError("sequence parallelism takes no kv_cache, "
                                 "frozen_kv or attn_mask")
            if cross:
                raise ValueError("img_cond under sequence parallelism: "
                                 "JAX's validate() refuses it (img_cond is "
                                 "not wired through pipeline/sequence "
                                 "parallelism)")
            if l % ring.size:
                raise ValueError(f"sequence {l} not divisible by the seq "
                                 f"group size {ring.size}")
            lo = ring.rank * (l // ring.size)
            hi = lo + l // ring.size
            if rope_index is not None:
                rope = self.rope_rows(rope_index, modality)
                rope_index = None
            else:
                rope = (self.rope_cos[:l], self.rope_sin[:l])
            rope = tuple(t[..., lo:hi, :] for t in rope)

            def chunk(t):
                return None if t is None else t[:, lo:hi]
            indices, modality, sample_ids, img_block_index, extra_embed = (
                chunk(t) for t in (indices, modality, sample_ids,
                                   img_block_index, extra_embed))
        x = self._embed(indices, modality, img_block_index, extra_embed)
        c = None
        if cfg.time_conditioning and not cfg.cond_label:
            c = silu(self.sigma_map(sigma))
        if cfg.cond_label:
            if label is None:
                raise ValueError("model.cond_label needs label")
            c = self.y_embedder(label, train=self.training,
                                generator=generator).to(self.compute_dtype)
        segment_ids = None
        if sample_ids is not None and attn_mask is None:
            if cfg.attn_backend == "xla":
                attn_mask = make_sample_ids_mask(sample_ids)
            else:
                sample_ids = sample_ids.to(torch.int32)
                segment_ids = (sample_ids, sample_ids)
        if ring is not None:
            cos, sin = rope
        elif rope_index is not None:
            cos, sin = self.rope_rows(rope_index, modality)
        elif kv_cache is None and frozen_kv is None:
            cos, sin = self.rope_cos[:l], self.rope_sin[:l]
        else:
            cos, sin = cache_rope(self.rope_cos, self.rope_sin, cache_index,
                                  l)
        nb = len(self.blocks)
        drops = self._dropout_per_block(
            dropout, nb + (len(self.img_cond_blocks) if cross else 0))
        cond_kw = {}
        if cross:
            x_cond_repr, cond_rope = self._cond_trunk(x_cond, drops[nb:])
            cond_kw = dict(x_cond=x_cond_repr, cond_rope=cond_rope)
        auxes = []

        def run(out):
            if cfg.moe_experts > 0:
                out, aux = out
                auxes.append(aux)
            return out

        remat = (self.remat and self.training and torch.is_grad_enabled()
                 and kv_cache is None and frozen_kv is None)
        pp = current_pp()
        if pp is not None:
            if kv_cache is not None or frozen_kv is not None \
                    or any(d is not None for d in drops):
                raise NotImplementedError(
                    "a KV cache, frozen K/V or training-mode dropout under "
                    "pipeline parallelism is not in the port yet (a pp "
                    "rank holds one stage's blocks; ROADMAP queue 1, item "
                    "9)")
            x = self._pipelined(x, c, cos, sin, modality, attn_mask,
                                segment_ids, pp)
            new_cache = None
        elif remat:
            from torch.utils.checkpoint import checkpoint
            context = remat_context(cfg.remat_policy)
            kw = {} if context is None else {"context_fn": context}
            for blk, drop in zip(self.blocks, drops):
                x = run(checkpoint(blk, x, c, cos, sin, modality, attn_mask,
                                   dropout=drop, segment_ids=segment_ids,
                                   use_reentrant=False, **cond_kw, **kw))
            new_cache = None
        else:
            for i, blk in enumerate(self.blocks):
                # block i writes its slices of the cache in place
                x = run(blk(x, c, cos, sin, modality, attn_mask,
                            kv_cache=None if kv_cache is None
                            else tuple(t[i] for t in kv_cache),
                            cache_index=cache_index,
                            frozen_kv=None if frozen_kv is None
                            else (frozen_kv[0][i], frozen_kv[1][i]),
                            dropout=drops[i], segment_ids=segment_ids,
                            **cond_kw))
            new_cache = None if kv_cache is None else tuple(kv_cache)
        aux = torch.stack(auxes).sum() if auxes else None
        if ring is not None and ring.gather:
            from unidisc_tpu_torch.parallel.comm import GatherReplicated
            x = GatherReplicated.apply(x, ring.group, 1)
        return x, c, new_cache, aux

    def _pipelined(self, x, c, cos, sin, modality, attn_mask, segment_ids,
                   pp):
        """The block stack as a GPipe pipeline over the "pp" group
        (``parallel/pipeline.py``; JAX's ``models/dit.py`` pp branch): the
        per-row operands ride the microbatches, the rope tables are
        broadcast (per-row rope rows ride along). An MoE block routes
        over its stage's microbatch, and its balance auxiliary is not
        carried out of the stage, as in JAX."""
        from unidisc_tpu_torch.parallel.pipeline import pipeline_sharded
        mb = {k: v for k, v in (("c", c), ("modality", modality),
                                ("attn_mask", attn_mask),
                                ("seg", None if segment_ids is None
                                 else segment_ids[0])) if v is not None}
        bcast = (cos, sin)
        if cos.ndim == 3:
            mb["rope_cos"], mb["rope_sin"] = cos, sin
            bcast = ()
        moe = self.cfg.moe_experts > 0

        def stage(blocks, a, mbt, *rope):
            rc, rs = (mbt["rope_cos"], mbt["rope_sin"]) if not rope \
                else rope
            seg = mbt.get("seg")
            for blk in blocks:
                a = blk(a, mbt.get("c"), rc, rs, mbt.get("modality"),
                        mbt.get("attn_mask"),
                        segment_ids=None if seg is None else (seg, seg))
                a = a[0] if moe else a
            return a
        return pipeline_sharded(stage, list(self.blocks), x, pp.group,
                                *bcast, mb_args=mb,
                                microbatches=pp.microbatches)

    def rope_rows(self, rope_index, modality):
        """Per-token rotary rows (B, L, head_dim / 2) of the [text | image]
        table: a text token's index is clipped into the text rows, an
        image token's into the image rows after them, so rows flipped or
        doubled in the batch keep their within-block positions. Under
        model.img_resolutions the index is absolute into the combined
        table (clipped to it)."""
        cfg = self.cfg
        if cfg.img_resolutions is not None:
            eff = rope_index.long().clamp(0, self.rope_cos.shape[0] - 1)
            return self.rope_cos[eff], self.rope_sin[eff]
        if modality is None:
            raise ValueError("rope_index needs modality")
        eff = torch.where(
            modality == 1,
            cfg.txt_length + rope_index.clamp(0, cfg.img_length - 1),
            rope_index.clamp(0, cfg.txt_length - 1)).long()
        return self.rope_cos[eff], self.rope_sin[eff]

    def forward(self, indices, sigma=None, *, modality=None,
                attn_mask=None, return_hidden: bool = False,
                kv_cache=None, cache_index=None, frozen_kv=None,
                rope_index=None, dropout=None, sample_ids=None,
                img_block_index=None, extra_embed=None, label=None,
                x_cond=None, generator=None, return_moe_aux: bool = False):
        """logits; (logits, hidden) with return_hidden; with a kv_cache
        also the new cache last: (logits, new_cache) or (logits, hidden,
        new_cache); with return_moe_aux (no cache, no hidden) (logits, the
        MoE balance auxiliary summed over the blocks, 0 without MoE).
        rope_index (B, L): each token's position within its text or image
        block (``rope_rows``), in place of the rows of the fixed layout.
        dropout (training with model.dropout > 0): the seed of the masks
        (an int), or the masks, one (keep_attention, keep_mlp) pair of (B,
        L, hidden) bool tensors per block (a triple with the cross mask
        where the cross-attention runs; the conditioning trunk's blocks
        after the main ones). sample_ids, img_block_index (B, L) and
        extra_embed (B, L, hidden): the packed-batch and transfusion
        arguments; label (B,) and x_cond (B, Lc): the cond_label and
        img_cond inputs; generator: the training-mode label drop's
        (module docstring)."""
        if return_moe_aux and (kv_cache is not None or return_hidden):
            raise ValueError("return_moe_aux takes no kv_cache and no "
                             "return_hidden")
        x, c, new_cache, aux = self._trunk(
            indices, sigma, modality, attn_mask, kv_cache, cache_index,
            frozen_kv, rope_index, dropout,
            packed=(sample_ids, img_block_index, extra_embed),
            conditioning=(label, x_cond, generator))
        ring = _ring_ctx()
        if ring is not None and not ring.gather and modality is not None:
            # the chunk's hidden states: the head takes the chunk's rows
            lc = modality.shape[1] // ring.size
            modality = modality[:, ring.rank * lc:(ring.rank + 1) * lc]
        logits = self.output_layer(x, c, modality)
        if return_moe_aux:
            if aux is None:
                aux = torch.zeros((), dtype=torch.float32,
                                  device=logits.device)
            return logits, aux
        out = (logits, x) if return_hidden else (logits,)
        if kv_cache is not None:
            out = out + (new_cache,)
        return out[0] if len(out) == 1 else out


def write_cache(cache: torch.Tensor, new: torch.Tensor, cache_index) -> None:
    """Write new (B, l, ...) into cache (B, max_len, ...) in place at
    positions cache_index + [0, l): cache_index an int, or a (B,) tensor of
    per-row positions. Each start is clamped to [0, max_len - l], as
    ``jax.lax.dynamic_update_slice`` clamps it."""
    l, size = new.shape[1], cache.shape[1]
    new = new.to(cache.dtype)
    if isinstance(cache_index, int):
        start = min(max(cache_index, 0), size - l)
        cache[:, start:start + l] = new
        return
    pos = cache_index.clamp(0, size - l)[:, None] \
        + torch.arange(l, device=cache.device)
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cache[rows, pos] = new


def cache_mask(l: int, lk: int, cache_index, device) -> torch.Tensor:
    """Causal mask of l new queries at cache_index over lk cached keys:
    query j sees keys <= cache_index + j. (1, 1, l, lk), or (B, 1, l, lk)
    for per-row positions."""
    q_pos = torch.arange(l, device=device)
    keys = torch.arange(lk, device=device)
    if isinstance(cache_index, int):
        return (keys[None, :] <= cache_index + q_pos[:, None])[None, None]
    return (keys[None, None, :]
            <= cache_index[:, None, None] + q_pos[None, :, None])[:, None]


def cache_rope(cos: torch.Tensor, sin: torch.Tensor, cache_index, l: int):
    """The rotary rows of l tokens at cache_index: rows [start, start + l)
    for an int (start clamped to the table as ``dynamic_slice`` clamps
    it); each row's own (B, l, d/2) rows at cache_index[b] + [0, l)
    (clipped to the table) for per-row positions."""
    n = cos.shape[0]
    if isinstance(cache_index, int):
        start = min(max(cache_index, 0), n - l)
        return cos[start:start + l], sin[start:start + l]
    pos = (cache_index[:, None]
           + torch.arange(l, device=cos.device)[None, :]).clamp(0, n - 1)
    return cos[pos], sin[pos]


def count_params(model: nn.Module) -> int:
    return int(sum(p.numel() for p in model.parameters()))


@torch.no_grad()
def randomize_(model: nn.Module, seed: int) -> None:
    """Non-zero weights from a seed, for measurement runs without a
    checkpoint: norm scales 1 + 0.1 N(0, 1), matrices and tables
    N(0, 1/fan_in), biases 0.02 N(0, 1). (The default init zeroes the adaLN
    tables and the vocab head, which would make the logits constant.) The
    noise is drawn on the parameters' device."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        noise = torch.randn(p.shape, generator=gen, device=device)
        if p.ndim == 1 and name.endswith("weight"):
            p.copy_(1.0 + 0.1 * noise)
        elif p.ndim == 2:
            p.copy_(noise / math.sqrt(p.shape[1]))
        else:
            p.copy_(0.02 * noise)

