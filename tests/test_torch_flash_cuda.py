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


# --- backward kernels (ops/csrc/flash_bwd_dq.cu, flash_bwd_dkv.cu) -----------
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


# --- shapes the TMA / wgmma designs make risky ------------------------------
#
# Lengths that are not multiples of the tiles (TMA's zero fill at the end of
# a head), lengths with more KV or Q tiles than the shared-memory ring has
# stages (mbarrier parity at wraparound), Lq != Lk, causal with segment ids
# and padding rows, operands whose strides are not the (B, L, H, D)
# contiguous ones, and the shape list of KERNEL_CHECK.json. Same tolerances
# as above.

def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run chip_smoke.py or this file "
                    "on the card")


def make_case(b, lq, lk, h, d, seed, layout="projection", segments=False):
    """q (B, Lq, H, D), k and v (B, Lk, H, D) bf16 in one of three layouts:
    "projection" (views of one (B, L, 3, H, D) tensor, needs Lq == Lk),
    "heads_outer" (transposes of (B, H, L, D) tensors) or "contiguous";
    segment ids (three segments, the last eighth of batch row 0 padding)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    if layout == "projection":
        assert lq == lk
        q, k, v = rand(b, lq, 3, h, d).unbind(2)
    elif layout == "heads_outer":
        q = rand(b, h, lq, d).transpose(1, 2)
        k, v = rand(b, h, lk, d).transpose(1, 2), rand(b, h, lk, d).transpose(1, 2)
    else:
        q, k, v = rand(b, lq, h, d), rand(b, lk, h, d), rand(b, lk, h, d)
    kw = {}
    if segments:
        def seg(n):
            s = torch.zeros((b, n), dtype=torch.int32, device="cuda")
            s[:, n // 3:] = 1
            s[:, 2 * n // 3:] = 2
            s[0, n - n // 8:] = -1
            return s
        kw["segment_ids"] = (seg(lq), seg(lk))
    return q, k, v, kw, gen


def check_forward(q, k, v, kw):
    before = _build.launch_counts["flash_fwd"]
    out, lse = flash_attention(q, k, v, need_lse=True, **kw)
    ref, ref_lse = attention_reference(q, k, v, need_lse=True, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_fwd"] == before + 1
    assert bool(torch.isfinite(out.float()).all())
    assert (out.float() - ref.float()).abs().max().item() < 2e-2
    assert (lse - ref_lse).abs().max().item() < 1e-3
    if "segment_ids" in kw:
        pad = kw["segment_ids"][0] < 0
        assert bool((out[pad] == 0).all()) and bool((lse.transpose(1, 2)[pad]
                                                     == 0).all())
    return out, lse


def check_backward(q, k, v, kw, gen, repeat=False):
    from unidisc_tpu_torch.ops.flash_attention import (
        attention_backward_reference, bwd_launches)
    o, lse = flash_attention(q, k, v, need_lse=True, **kw)
    do = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    causal = kw.get("causal", False)
    seg = kw.get("segment_ids")
    grads, launch_dq, launch_dkv = bwd_launches(q, k, v, o, lse, do, seg,
                                                causal, q.shape[-1] ** -0.5)
    before = _build.launch_counts["flash_bwd_dkv"]
    launch_dq()
    launch_dkv()
    want = attention_backward_reference(q.float(), k.float(), v.float(),
                                        o.float(), lse, do.float(), **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_bwd_dkv"] == before + 1
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert bool(torch.isfinite(g.float()).all()), name
        err = (g.float() - w).abs().max().item()
        top = w.abs().max().item()
        assert err <= BWD_REL_TOL * top, (name, err, top)
    if seg is not None:
        assert bool((grads[0][seg[0] < 0] == 0).all())
        for g in grads[1:]:
            assert bool((g[seg[1] < 0] == 0).all())
    if repeat:
        # no atomics: a second launch of each kernel writes the same bits
        dq, dk, dv = (g.clone() for g in grads)
        launch_dq()
        launch_dkv()
        torch.cuda.synchronize()
        assert torch.equal(grads[0], dq)
        assert torch.equal(grads[1], dk) and torch.equal(grads[2], dv)


# (B, Lq, Lk, H, D, layout, causal, segments)
RISKY_CASES = {
    "L200_d64": (2, 200, 200, 3, 64, "projection", False, False),
    "L385_d64": (2, 385, 385, 3, 64, "projection", False, False),
    "L1024_d64": (1, 1024, 1024, 2, 64, "projection", False, False),
    "L200_d128": (2, 200, 200, 3, 128, "projection", False, False),
    "L385_d128": (2, 385, 385, 3, 128, "projection", False, False),
    "L1024_d128": (1, 1024, 1024, 2, 128, "projection", False, False),
    "Lq200_Lk385": (2, 200, 385, 3, 64, "contiguous", False, False),
    "Lq385_Lk200": (2, 385, 200, 3, 128, "contiguous", False, False),
    "Lq385_Lk200_causal": (2, 385, 200, 2, 64, "contiguous", True, False),
    "causal_segments_d64": (2, 385, 385, 3, 64, "projection", True, True),
    "causal_segments_d128": (2, 300, 300, 2, 128, "projection", True, True),
    "heads_outer_d64": (2, 257, 257, 4, 64, "heads_outer", False, False),
    "heads_outer_d128": (2, 257, 257, 4, 128, "heads_outer", True, True),
    # KERNEL_CHECK.json's shape list
    "B4_L384_H12_D64": (4, 384, 384, 12, 64, "projection", False, False),
    "B2_L1024_H12_D64": (2, 1024, 1024, 12, 64, "projection", False, False),
    "B2_L1024_H8_D128": (2, 1024, 1024, 8, 128, "projection", False, False),
    "B1_L4096_H8_D128": (1, 4096, 4096, 8, 128, "projection", False, False),
    "B2_L512_H8_D128_causal": (2, 512, 512, 8, 128, "projection", True,
                               False),
    "B2_L1024_H8_D128_seg": (2, 1024, 1024, 8, 128, "projection", False,
                             True),
    # ar_inpainting's doubled rows on the causal DIT-AR: 12 KV tiles
    "B2_L768_H12_D64_causal": (2, 768, 768, 12, 64, "projection", True,
                               False),
    # img_cond at the flagship width: the cross-attention (384 queries of
    # the main stream against the 256 conditioning positions) and the
    # conditioning trunk's self-attention, training batch 32
    "B32_Lq384_Lk256_H12_D64_cross": (32, 384, 256, 12, 64, "contiguous",
                                      False, False),
    "B32_L256_H12_D64_trunk": (32, 256, 256, 12, 64, "projection", False,
                               False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RISKY_CASES))
def test_forward_kernel_on_risky_shapes(case):
    needs_card()
    b, lq, lk, h, d, layout, causal, segments = RISKY_CASES[case]
    q, k, v, kw, _ = make_case(b, lq, lk, h, d, seed=lq + d, layout=layout,
                               segments=segments)
    if causal:
        kw["causal"] = True
    check_forward(q, k, v, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RISKY_CASES))
def test_backward_kernels_on_risky_shapes(case):
    needs_card()
    b, lq, lk, h, d, layout, causal, segments = RISKY_CASES[case]
    q, k, v, kw, gen = make_case(b, lq, lk, h, d, seed=lq + d + 1,
                                 layout=layout, segments=segments)
    if causal:
        kw["causal"] = True
    check_backward(q, k, v, kw, gen, repeat=True)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_backward_kernels_take_strided_and_broadcast_o_and_do(d):
    # dO with a non-contiguous last dimension (bwd_operands copies it) and
    # an O broadcast over heads (stride 0, copied for the tensor maps): the
    # dq kernel reads both through TMA to form di
    from unidisc_tpu_torch.ops.flash_attention import (
        attention_backward_reference, bwd_launches)
    needs_card()
    q, k, v, kw, gen = make_case(2, 200, 200, 3, d, seed=d + 7)
    o, lse = flash_attention(q, k, v, need_lse=True)
    o = o[:, :, :1].expand_as(o)
    do = torch.randn((2, 200, d, 3), generator=gen,
                     device="cuda").bfloat16().transpose(2, 3)
    grads, launch_dq, launch_dkv = bwd_launches(q, k, v, o, lse, do, None,
                                                False, d ** -0.5)
    launch_dq()
    launch_dkv()
    want = attention_backward_reference(q.float(), k.float(), v.float(),
                                        o.float(), lse, do.float())
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        err = (g.float() - w).abs().max().item()
        top = w.abs().max().item()
        assert err <= BWD_REL_TOL * top, (name, err, top)


@pytest.mark.cuda
def test_forward_kernel_takes_a_broadcast_operand():
    needs_card()
    q, k, v, kw, _ = make_case(2, 200, 200, 4, 64, seed=5,
                               layout="contiguous")
    k = k[:, :, :1].expand_as(k)    # head stride 0
    check_forward(q, k, v, kw)


def test_tma_ready_copies_only_broadcast_operands():
    # runs on the CPU: the TMA tensor maps take no zero stride, so the
    # wrappers copy a broadcast operand and leave every other view alone
    from unidisc_tpu_torch.ops.flash_attention import _tma_ready
    qkv = torch.zeros((2, 5, 3, 4, 64), dtype=torch.bfloat16)
    v = qkv[:, :, 2]
    assert _tma_ready(v) is v
    k = torch.zeros((2, 5, 1, 64), dtype=torch.bfloat16).expand(2, 5, 4, 64)
    out = _tma_ready(k)
    assert out is not k and out.is_contiguous() and torch.equal(out, k)
    # a zero stride on a dimension of size 1 is never followed: no copy
    h1 = torch.zeros((2, 5, 64), dtype=torch.bfloat16)[:, :, None]
    h1 = h1.as_strided(h1.shape, (h1.stride(0), h1.stride(1), 0, 1))
    assert _tma_ready(h1) is h1


# the conditioning-frozen serve paths' attention: the image rows' queries (a
# view of the qkv projection) against [frozen text K/V || image K/V] (or a
# block's slice of the whole cache), contiguous: Lq 256, Lk 384, 12 heads of
# 64, at B 16 (frozen_cond under CFG) and B 8 (distilled_stack)
FROZEN_BATCHES = {"frozen_cond_B16": 16, "distilled_stack_B8": 8}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FROZEN_BATCHES))
def test_forward_kernel_at_the_frozen_paths_shapes(case):
    needs_card()
    b = FROZEN_BATCHES[case]
    gen = torch.Generator(device="cuda").manual_seed(b)
    q = torch.randn((b, 256, 3, 12, 64), generator=gen,
                    device="cuda").bfloat16().unbind(2)[0]
    k, v = (torch.randn((b, 384, 12, 64), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    check_forward(q, k, v, {})


# --- the packed interleaved batch (the interleaved training slice) -----------
#
# (16, 12, 1024, 64) with the sample ids of a real packed batch: documents
# of 1-3 images of 256 tokens and text spans of 8-120 tokens packed into
# rows of 1024 with EOS (data/interleaved.py), so documents end mid-tile
# and rows end in -1 padding. Same tolerances as above; padded query rows
# give output 0, LSE 0 and gradient 0, padded keys gradient 0.

def packed_segment_ids(b=16, length=1024, seed=0):
    import numpy as np
    from unidisc_tpu_torch.data.interleaved import (Document, Segment,
                                                    pack_documents)
    rng = np.random.RandomState(seed)
    docs = []
    for _ in range(3 * b):
        segs = []
        for _ in range(rng.randint(1, 4)):
            segs.append(Segment("text", np.full(rng.randint(8, 121), 5,
                                                np.int32)))
            segs.append(Segment("image", np.zeros(256, np.int32), 16))
        docs.append(Document(segs))
    batch = pack_documents(docs, length, pad_id=0, eos_id=2, batch_size=b)
    return torch.from_numpy(batch["sample_ids"]).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_kernels_at_the_packed_interleaved_shape(direction):
    needs_card()
    seg = packed_segment_ids()
    assert bool((seg < 0).any()) and bool((seg[:, -1] < 0).any())
    # documents end inside a 64-row tile
    ends = (seg[:, 1:] != seg[:, :-1]).nonzero()[:, 1] + 1
    assert bool((ends % 64 != 0).any())
    q, k, v, _, gen = make_case(16, 1024, 1024, 12, 64, seed=21)
    kw = {"segment_ids": (seg, seg)}
    if direction == "forward":
        check_forward(q, k, v, kw)
    else:
        check_backward(q, k, v, kw, gen)
