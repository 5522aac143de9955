"""The hand-written attention kernel against its plain version, on the
card. Skips where CUDA is absent. This file imports no JAX, so it also
runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_cuda.py

Tolerance in bf16: max abs 2e-2 on O (bf16 outputs of magnitude ~1 round
at 4e-3, and the kernel rounds unnormalised P where the reference rounds
normalised P), 1e-3 on the fp32 LSE (summation order of Q K^T).
"""

import pytest
import torch

from unidisc_tpu_torch.ops import _build
from unidisc_tpu_torch.ops.flash_attention import (attention_reference,
                                                   flash_attention)


def inputs(b, l, h, d, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, l, 3, h, d), generator=gen, device="cuda")
    q, k, v = qkv.to(torch.bfloat16).unbind(2)   # strided views
    seg = torch.zeros((b, l), dtype=torch.int32, device="cuda")
    seg[:, l // 3:] = 1
    seg[:, 2 * l // 3:] = 2
    seg[0, l - l // 6:] = -1
    return q, k, v, seg


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("mode", ["plain", "causal", "segments"])
def test_kernel_matches_reference_on_card(d, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run chip_smoke.py or this file "
                    "on the card")
    q, k, v, seg = inputs(2, 200, 3, d, seed=d)
    kw = {"plain": {}, "causal": {"causal": True},
          "segments": {"segment_ids": (seg, seg)}}[mode]
    before = _build.launch_counts["flash_fwd"]
    out, lse = flash_attention(q, k, v, need_lse=True, **kw)
    ref, ref_lse = attention_reference(q, k, v, need_lse=True, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_fwd"] == before + 1
    assert (out.float() - ref.float()).abs().max().item() < 2e-2
    assert (lse - ref_lse).abs().max().item() < 1e-3
    if mode == "segments":
        assert bool((out[seg < 0] == 0).all())


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v, _ = inputs(1, 64, 2, 64, seed=0)
    with pytest.raises(TypeError):
        flash_attention(q.float(), k.float(), v.float())
    q96 = torch.zeros((1, 64, 2, 96), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):
        flash_attention(q96, q96, q96)
