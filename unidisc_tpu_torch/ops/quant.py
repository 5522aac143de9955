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

The int8 KV cache (``quantize_kv``, ``int8_kv_attention``) and the OpenELM
conversion (``quantize_elm_params``) come with the port's KV-cache and ELM
slices.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import torch

from unidisc_tpu_torch.ops.fused_qmm import _dynamic_quantize_cuda
from unidisc_tpu_torch.ops.int8_matmul import int8_product

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
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, _div127(amax), 1.0)
    return torch.round(x32 / scale).to(torch.int8), scale


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


def quantize_model(config, model):
    """One-call int8 conversion of a DIT: returns (config, model) with
    ``model.quant="int8"`` and a new DIT of that config, on the model's
    device and in eval mode, holding the quantized weights."""
    from unidisc_tpu_torch.models.dit import DIT

    qm = dataclasses.replace(config.model, quant="int8")
    qconfig = dataclasses.replace(config, model=qm)
    device = next(model.parameters()).device
    qmodel = DIT(qm, compute_dtype=model.compute_dtype)
    qmodel.load_state_dict(quantize_dit_params(model.state_dict()))
    return qconfig, qmodel.to(device).eval()
