"""The hand-written attention kernels (forward and backward) against their
plain versions, on the card. Skips where CUDA is absent. This file imports
no JAX, so it also runs on a GPU machine without it:

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


# --- backward kernels (ops/csrc/flash_bwd.cu) -------------------------------
#
# Tolerance: max abs error of each of dq, dk, dv against
# attention_backward_reference (fp32 from the same bf16 inputs) at most
# 2e-2 x the largest |gradient|: the kernels round P and dS to bf16 before
# the second product of each pair (2^-9 relative) and write bf16 outputs
# (2^-9 relative), and sum in another order.
BWD_REL_TOL = 2e-2


def backward_case(b, l, h, d, mode, seed):
    from unidisc_tpu_torch.ops.flash_attention import (
        _flash_bwd_cuda, attention_backward_reference)
    q, k, v, seg = inputs(b, l, h, d, seed)
    kw = {"plain": {}, "causal": {"causal": True},
          "segments": {"segment_ids": (seg, seg)},
          "causal_segments": {"causal": True,
                              "segment_ids": (seg, seg)}}[mode]
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn((b, l, h, d), generator=gen,
                     device="cuda").to(torch.bfloat16)
    o, lse = flash_attention(q, k, v, need_lse=True, **kw)
    scale = d ** -0.5
    got = _flash_bwd_cuda(q, k, v, o, lse, do, kw.get("segment_ids"),
                          kw.get("causal", False), scale)
    want = attention_backward_reference(q.float(), k.float(), v.float(),
                                        o.float(), lse, do.float(), **kw)
    torch.cuda.synchronize()
    return got, want, seg


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("mode", ["plain", "causal", "segments",
                                  "causal_segments"])
def test_backward_kernels_match_reference_on_card(d, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run chip_smoke.py or this file "
                    "on the card")
    before = dict(_build.launch_counts)
    got, want, seg = backward_case(2, 200, 3, d, mode, seed=d + len(mode))
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert _build.launch_counts[name] == before.get(name, 0) + 1
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        err = (g.float() - w).abs().max().item()
        scale = w.abs().max().item()
        assert err <= BWD_REL_TOL * scale, (name, err, scale)
    if mode in ("segments", "causal_segments"):
        pad = seg < 0       # padded rows (queries) and keys: zero gradients
        for g in got:
            assert bool((g[pad] == 0).all())


@pytest.mark.cuda
def test_autograd_goes_through_the_backward_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v, _ = inputs(2, 128, 2, 64, seed=3)
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    _build.reset_launch_counts()
    out = flash_attention(q, k, v)
    # an upstream gradient with zero strides, as out.sum() hands over
    g = torch.full((), 0.5, dtype=out.dtype, device="cuda").expand_as(out)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                          "flash_bwd_dkv": 1}
    assert all(bool(torch.isfinite(x.float()).all()) for x in (dq, dk, dv))
