"""W8A8 int8 quantized inference (port of ``unidisc_tpu/ops/quant.py``).

Scheme (dynamic W8A8):
  - weights: symmetric per-output-channel int8, quantized once
    (``quantize_per_channel`` / ``quantize_dit_params``), stored in the
    port's (N, K) layout;
  - activations: symmetric per-row int8, quantized at each call
    (``dynamic_quantize``);
  - the int8 product with int32 accumulation and the rescale by
    row_scale x column_scale (+ bias) in fp32 (``qdot``).

Both quantizers divide, ``amax / 127`` and then ``x / scale``, as the JAX
module does; the fused prologue (``ops/fused_qmm.py``) multiplies by the
reciprocals instead, as its JAX counterpart does. Rounding is half to even
(``torch.round``), as ``jnp.round``.

``dynamic_quantize`` runs on a CUDA tensor through the row kernel of
``ops/csrc/fused_qmm.cu`` in the dividing form (one launch, counted as
"dynamic_quantize", whatever the product's backend), on a CPU tensor
through ``dynamic_quantize_reference``, its plain version.

``qdot_row_parallel`` is ``qdot`` of a row-parallel layer under tensor
parallelism, where each rank of the group holds a K-slice of every input
row and the matching K-slice of the weight. It gives the one-device
``qdot`` bit for bit:

  1. ``row_amax`` of the rank's slice (each row's max |x| in fp32);
  2. the amaxes' max over the group: the whole row's amax, exactly;
  3. ``quantize_by_amax``: the dividing form by that amax, so the slice's
     int8 values and the row's scale are those of ``dynamic_quantize`` of
     the whole row (a slice quantized by its own amax would differ);
  4. the int8 product of the slice to the int32 accumulator, with no
     epilogue (``int8_matmul(out_dtype=torch.int32)``);
  5. the int32 partials summed over the group: exact, as the one-device
     accumulator is (fp32 partials would not be: 1,536 x 127^2 > 2^24);
  6. one fp32 epilogue on the sum in JAX's order, ``(acc * s) * w_scale``,
     ``+ bias``, the cast (``int8_matmul.py::int8_epilogue``).

Steps 1 and 3 run two forms of the row kernel's dividing entry on a CUDA
tensor (counted as "row_amax" and "quantize_by_amax") and their plain
versions on a CPU tensor; step 4 the int32 form of the int8 kernel under
backend "pallas" (counted as "int8_matmul_int32").

The int8 KV cache (``quantize_kv``, ``int8_kv_attention``) reaches no
Pallas kernel in the JAX package (XLA computes it), so its plain PyTorch
form here is its port. ``quantize_elm_params`` converts an OpenELM
(``models/elm.py``) as ``quantize_dit_params`` converts a DIT.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from unidisc_tpu_torch.ops.fused_qmm import (_dynamic_quantize_cuda,
                                             _quantize_by_amax_cuda,
                                             _row_amax_cuda)
from unidisc_tpu_torch.ops.int8_matmul import int8_epilogue, int8_product
from unidisc_tpu_torch.parallel.comm import all_reduce

# the DIT linears that quantize_dit_params converts: the four trunk
# matmuls of every block and the vocab head
_QUANTIZED = re.compile(r"^(blocks\.\d+\.(attn_qkv|attn_out|mlp\.0|mlp\.2)"
                        r"|output_layer\.linear)\.weight$")


def quantize_per_channel(w: torch.Tensor, axis: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 weight quantization.

    `axis` is the contracting (fan-in) axis, 1 for the port's (N, K)
    weights; the scales are per output channel. Returns (w_q int8 of w's
    shape, scale fp32 with `axis` reduced)."""
    w32 = w.float()
    amax = w32.abs().amax(dim=axis)
    scale = torch.where(amax > 0, _div127(amax), 1.0)
    w_q = torch.round(w32 / scale.unsqueeze(axis)).to(torch.int8)
    return w_q, scale


def _div127(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127 in fp32, divided on every device. The divisor is a
    tensor on amax's device: PyTorch's CUDA division by a CPU scalar
    multiplies by the scalar's reciprocal, the fused prologue's form,
    which differs from the quotient by an ulp on some values."""
    return amax / torch.full_like(amax, 127.0)


def dynamic_quantize_reference(x: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: per-row (last dimension) symmetric int8
    activation quantization, (x_q int8, scale fp32 (..., 1))."""
    return quantize_by_amax_reference(x, row_amax_reference(x))


def row_amax_reference(x: torch.Tensor) -> torch.Tensor:
    """The row_amax kernel's plain version: each row's (last dimension)
    max |x| in fp32, (..., 1)."""
    return x.float().abs().amax(dim=-1, keepdim=True)


def quantize_by_amax_reference(x: torch.Tensor, amax: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The quantize_by_amax kernel's plain version: x (..., K) quantized
    in the dividing form by a given per-row amax (..., 1), at least the
    row's own: (x_q int8, scale = amax / 127 fp32 (..., 1))."""
    amax = amax.float()
    scale = torch.where(amax > 0, _div127(amax), 1.0)
    return torch.round(x.float() / scale).to(torch.int8), scale


def row_amax(x: torch.Tensor) -> torch.Tensor:
    """Each row's (last dimension) max |x| in fp32, (..., 1). On the card
    x is bf16 or fp32 with contiguous rows."""
    if x.device.type == "cpu":
        return row_amax_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"row_amax: unsupported device {x.device}")
    return _row_amax_cuda(x.reshape(-1, x.shape[-1])).reshape(
        *x.shape[:-1], 1)


def quantize_by_amax(x: torch.Tensor, amax: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., K) quantized per row in the dividing form by a given amax
    (..., 1), which is at least the row's own (the max over the group of
    the ranks' ``row_amax`` of their slices of the row): (x_q int8,
    scale fp32 (..., 1)); given the row's own amax it is
    ``dynamic_quantize``."""
    if x.device.type == "cpu":
        return quantize_by_amax_reference(x, amax)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_by_amax: unsupported device {x.device}")
    x_q, scale = _quantize_by_amax_cuda(x.reshape(-1, x.shape[-1]), amax)
    return x_q.reshape(x.shape), scale.reshape(*x.shape[:-1], 1)


def dynamic_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last dimension) symmetric int8 activation quantization:
    (x_q int8, scale fp32 (..., 1)). On the card x is bf16 or fp32 with
    contiguous rows."""
    if x.device.type == "cpu":
        return dynamic_quantize_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"dynamic_quantize: unsupported device {x.device}")
    x_q, scale = _dynamic_quantize_cuda(x.reshape(-1, x.shape[-1]))
    return x_q.reshape(x.shape), scale.reshape(*x.shape[:-1], 1)


def qdot(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, *,
         bias: Optional[torch.Tensor] = None,
         out_dtype: torch.dtype = torch.bfloat16,
         backend: str = "xla") -> torch.Tensor:
    """y = x @ dequant(w_q)^T through int8 products.

    x: (..., K) float; w_q: (N, K) int8; w_scale: (N,) fp32.
    backend "pallas": the hand-written int8 kernel (``ops/int8_matmul.py``)
    on a CUDA tensor; "xla": its plain version (exact integer product, the
    same fp32 epilogue)."""
    matmul = int8_product(backend)
    lead = x.shape[:-1]
    x_q, x_scale = dynamic_quantize(x.reshape(-1, x.shape[-1]))
    y = matmul(x_q, x_scale, w_q, w_scale, bias=bias, out_dtype=out_dtype)
    return y.reshape(*lead, w_q.shape[0])


def qdot_row_parallel(x: torch.Tensor, w_q: torch.Tensor,
                      w_scale: torch.Tensor, group, *,
                      bias: Optional[torch.Tensor] = None,
                      out_dtype: torch.dtype = torch.bfloat16,
                      backend: str = "xla") -> torch.Tensor:
    """``qdot`` of a row-parallel layer over the tensor `group` (module
    docstring): x (..., K / T) the rank's K-slice of each row, w_q (N,
    K / T) int8 its K-slice of the weight, w_scale (N,) and bias (N,) or
    None whole. Returns the whole (..., N) on every rank, equal to
    ``qdot`` of the whole rows and weight."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    amax = all_reduce(row_amax(x2), group, op=dist.ReduceOp.MAX)
    x_q, x_scale = quantize_by_amax(x2, amax)
    acc = int8_product(backend)(x_q, None, w_q, None,
                                out_dtype=torch.int32)
    acc = all_reduce(acc, group)
    y = int8_epilogue(acc, x_scale, w_scale, bias=bias, out_dtype=out_dtype)
    return y.reshape(*lead, w_q.shape[0])


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, position, head) symmetric int8 over the last (head_dim)
    axis, in the multiplying form of the JAX package: s = amax x (1/127),
    q = round(x x (1/s)). x (..., D) -> (int8 of x's shape, fp32 scale
    (..., 1)). Used for the KV cache writes and for the q and p
    quantization inside ``int8_kv_attention``."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax > 0, amax * (1.0 / 127.0), 1.0)
    return torch.round(x32 * (1.0 / s)).to(torch.int8), s


# keys per exact partial sum of the value product: n int8 x int8 products
# sum exactly in fp32 while n x 127^2 < 2^24, that is n <= 1040
_PV_CHUNK = 1024


def int8_kv_attention(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                      vq: torch.Tensor, vs: torch.Tensor, *,
                      mask: Optional[torch.Tensor] = None,
                      softmax_scale: Optional[float] = None
                      ) -> torch.Tensor:
    """Attention over an int8 KV cache without dequantizing it:

      scores = (q8 . k8) * q_s * k_s * scale
      out    = (p8 . v8) * p_s,   p8, p_s = quantize_kv(softmax(scores) * v_s)

    q (B, l, H, D) float; kq, vq (B, L, Hk, D) int8; ks, vs (B, L, Hk, 1)
    fp32, Hk dividing H: query head h reads cache head h // (H / Hk), as
    the JAX package's repeat of a grouped (GQA) cache gives it, without the
    repeat; mask broadcastable to (B, H, l, L), True = attend. Returns
    (B, l, H, D) in q's dtype.

    PyTorch has no batched int8 product on the card, so both contractions
    run in fp32 on int8-valued operands, where they are exact integers as
    in the JAX package's int32 accumulation: the score product sums
    D <= 128 terms; the value product sums the cache length in chunks of
    at most 1024 keys, each exact in fp32, added exactly in int64."""
    b, l, h, d = q.shape
    hk = kq.shape[2]
    if h % hk:
        raise ValueError(f"{h} query heads over {hk} cache heads")
    rep = h // hk
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    q_q, q_s = quantize_kv(q)
    # (B, Hk, rep, l, L): head h = g * rep + r
    acc = torch.einsum("blgrd,bkgd->bgrlk",
                       q_q.float().view(b, l, hk, rep, d), kq.float())
    scores = (acc * q_s.view(b, l, hk, rep).permute(0, 2, 3, 1)[..., None]
              * ks[..., 0].permute(0, 2, 1)[:, :, None, None, :] * scale)
    if mask is not None:
        if mask.ndim == 3:
            mask = mask[:, None]
        mask = mask[:, :, None] if mask.shape[1] == 1 else \
            mask.reshape(mask.shape[0], hk, rep, *mask.shape[2:])
        scores = torch.where(mask, scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    p_q, p_s = quantize_kv(p * vs[..., 0].permute(0, 2, 1)[:, :, None, None,
                                                           :])
    acc_v = sum(torch.einsum("bgrlk,bkgd->bgrld",
                             p_q[..., k0:k0 + _PV_CHUNK].float(),
                             vq[:, k0:k0 + _PV_CHUNK].float()).to(torch.int64)
                for k0 in range(0, vq.shape[1], _PV_CHUNK))
    out = acc_v.float() * p_s
    return out.permute(0, 3, 1, 2, 4).reshape(b, l, h, d).to(q.dtype)


def quantize_dit_params(state_dict: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """A float DIT state_dict -> the state_dict of a quant="int8" DIT.

    Quantized: the trunk matmuls (attn_qkv, attn_out, mlp.0, mlp.2 of every
    block, per output channel) and the vocab head (output_layer.linear):
    ``<name>.weight`` becomes ``<name>.weight_q`` (int8, (N, K)) and
    ``<name>.scale`` (fp32, (N,)). The adaLN tables, the timestep MLP, the
    embeddings and the norms stay as they are."""
    out = {}
    for name, value in state_dict.items():
        if _QUANTIZED.match(name):
            stem = name[:-len("weight")]
            out[stem + "weight_q"], out[stem + "scale"] = \
                quantize_per_channel(value, axis=1)
        else:
            out[name] = value
    return out


# the OpenELM linears that quantize_elm_params converts: every projection
_ELM_QUANTIZED = re.compile(r"^layers\.\d+\.(attn\.(qkv_proj|out_proj)"
                            r"|proj_1|proj_2)\.weight$")


def quantize_elm_params(state_dict: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """A float OpenELM state_dict -> the state_dict of a quant="int8" one.

    Every projection (qkv_proj, out_proj, proj_1, proj_2 of every layer)
    quantizes per output channel into ``weight_q`` / ``scale``; the head
    becomes an int8 copy of the concatenated [text | extra] table in the
    (N, K) = (V, D) layout of ``int8_matmul``, ``lm_head_q``, with
    per-vocab scales ``lm_head_scale`` (the JAX module's (D, V) copy,
    transposed). The fp tables stay for the embedding lookups; the norms
    stay as they are. Quantize fp32 weights: a model stored in bf16 has
    already rounded its projections."""
    out = {}
    for name, value in state_dict.items():
        if _ELM_QUANTIZED.match(name):
            stem = name[:-len("weight")]
            out[stem + "weight_q"], out[stem + "scale"] = \
                quantize_per_channel(value, axis=1)
        else:
            out[name] = value
    table = torch.cat([state_dict["token_embeddings"],
                       state_dict["token_embeddings_extra"]], 0)
    out["lm_head_q"], out["lm_head_scale"] = quantize_per_channel(table,
                                                                  axis=1)
    return out


def quantize_model(config, model):
    """One-call int8 conversion of a DIT: returns (config, model) with
    ``model.quant="int8"`` and a new DIT of that config, on the model's
    device and in eval mode, holding the quantized weights."""
    from unidisc_tpu_torch.models.dit import DIT

    if getattr(model, "mesh_shards", None) is not None:
        # a shard's per-channel scales would be maxima over its slice
        raise ValueError("quantize_model takes the one-rank model: quantize "
                         "before parallel/mesh.py::shard_model splits it")
    qm = dataclasses.replace(config.model, quant="int8")
    qconfig = dataclasses.replace(config, model=qm)
    device = next(model.parameters()).device
    qmodel = DIT(qm, compute_dtype=model.compute_dtype, init=False)
    qmodel.load_state_dict(quantize_dit_params(model.state_dict()))
    return qconfig, qmodel.to(device).eval()
