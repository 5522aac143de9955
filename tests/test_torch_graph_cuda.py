"""The captured sampler programs (sampling/graph.py) against the eager
samplers, on the card. Skips where CUDA is absent. This file imports no
JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_graph_cuda.py

On a tiny bf16 model (the hand kernels take bf16), for the text->image
sampler in bf16 and int8 (the kernels' paths), its conditioning-frozen
int8 variant, its refresh-2 int8 variant with an int8 KV cache, and the
generic maskgit sampler, its packed form (interleaved documents' sample
ids and rope indices), and the caching sampler (recompute txt, and img
with the int8 KV cache): the captured program gives the eager sampler's
tokens and NFE under the same injected noise, exactly (the same kernels
on the same inputs in the same order). Launch counts after one and after
three replays are the eager call's counts, once and three times; two
replays at one seed give the same tokens.
"""

import pytest
import torch

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.models.dit import DIT, randomize_
from unidisc_tpu_torch.ops import _build
from unidisc_tpu_torch.ops.quant import quantize_model
from unidisc_tpu_torch.sampling.caching import build_caching_sampler
from unidisc_tpu_torch.sampling.graph import captured
from unidisc_tpu_torch.sampling.sampler import build_sampler
from unidisc_tpu_torch.sampling.t2i_fast import build_t2i_sampler

B, STEPS = 4, 5
TINY = {"model.hidden_size": 128, "model.n_heads": 2, "model.n_blocks": 2,
        "model.cond_dim": 32, "model.length": 24, "model.txt_length": 8,
        "model.img_length": 16, "model.text_vocab_size": 24,
        "model.image_vocab_size": 40, "model.time_conditioning": True,
        "model.qk_norm": True, "model.norm_type": "rms",
        "model.sandwich_normalization": True, "model.modality_embed": True,
        "model.rope_2d": True, "model.dropout": 0.0,
        "model.force_argmax_valid_indices": True,
        "sampling.predictor": "maskgit", "sampling.steps": STEPS,
        "sampling.cfg": 2.0}
INT8 = {"model.quant_backend": "pallas", "model.quant_fused": True}

# name: (int8, sampler kind, extra overrides)
CASES = {
    "t2i_bf16": (False, "t2i", {}),
    "t2i_int8": (True, "t2i", {}),
    "frozen_int8": (True, "t2i", {"sampling.cached_cond": True}),
    "refresh_2_int8_kv_int8": (True, "t2i", {
        "sampling.cached_cond": True, "sampling.cached_cond_refresh": 2,
        "model.kv_cache_dtype": "int8"}),
    "generic_maskgit": (False, "generic", {}),
    # the packed generic sampler of interleaved documents
    "packed_generic": (False, "packed", {}),
    # the caching sampler, both modes, with the bf16 and the int8 KV cache
    "caching_txt": (False, "caching_txt", {}),
    "caching_img_int8_kv": (False, "caching_img",
                            {"model.kv_cache_dtype": "int8"}),
}


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run chip_smoke.py or this file "
                    "on the card")


def tiny(int8, seed=0, **extra):
    cfg = Config.make("tiny", **TINY, **(INT8 if int8 else {}), **extra)
    model = DIT(cfg.model, compute_dtype=torch.bfloat16).to("cuda").eval()
    randomize_(model, seed)
    if int8:
        cfg, model = quantize_model(cfg, model)
    return cfg, model


def build(kind, cfg, model, inject_noise):
    s = cfg.sampling
    if kind == "t2i":
        return build_t2i_sampler(model, cfg, inject_noise=inject_noise,
                                 cached_cond=s.cached_cond,
                                 cond_refresh=s.cached_cond_refresh)
    if kind.startswith("caching"):
        return build_caching_sampler(model, cfg, txt_to_img_ratio=2,
                                     recompute=kind.split("_")[1],
                                     inject_noise=inject_noise)
    return build_sampler(model, cfg, inject_noise=inject_noise,
                         packed=kind == "packed")


def inputs(kind, m, gen):
    txt = torch.randint(0, m.mask_index, (B, m.txt_length), generator=gen,
                        device="cuda")
    if kind == "t2i":
        return (txt,)
    x0 = torch.cat([txt, torch.full((B, m.img_length), m.mask_index,
                                    device="cuda")], 1)
    unmask = torch.zeros_like(x0, dtype=torch.bool)
    unmask[:, :m.txt_length] = True
    unmask[1, :m.txt_length] = False         # one joint row
    modality = (torch.arange(m.length, device="cuda") >= m.txt_length
                ).long().expand(B, -1)
    if kind != "packed":
        return x0, unmask, modality
    # two documents a row: ids 0 and 1, the last two positions padding
    sample_ids = torch.zeros_like(x0, dtype=torch.int32)
    sample_ids[:, 12:] = 1
    sample_ids[:, -2:] = -1
    rope_index = torch.arange(m.length, device="cuda").expand(B, -1) % 12
    return x0, unmask, modality, sample_ids, rope_index


def noise(kind, m, gen):
    kw = dict(generator=gen, device="cuda")
    if kind == "t2i":
        e = torch.rand((STEPS, B, m.img_length, m.image_vocab_size), **kw)
        c = torch.rand((STEPS, B, m.img_length), **kw)
        return {"gumbel_tok": -torch.log(-torch.log(e)),
                "gumbel_conf": -torch.log(-torch.log(c))}
    shape = (STEPS, B, m.length)
    return {"exp": torch.empty(shape + (m.vocab_size,), device="cuda")
            .exponential_(generator=gen),
            "gumbel": -torch.log(-torch.log(torch.rand(shape, **kw)))}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_captured_program_equals_the_eager_sampler(case):
    needs_card()
    int8, kind, extra = CASES[case]
    cfg, model = tiny(int8, **extra)
    gen = torch.Generator(device="cuda").manual_seed(len(case))
    args = inputs(kind, cfg.model, gen)
    injected = noise(kind, cfg.model, gen)
    sample = build(kind, cfg, model, inject_noise=True)
    want = sample(*args, injected=injected)
    program = captured(sample, B)
    assert captured(sample, B) is program            # cached per batch
    for _ in range(2):
        got = program(*args, injected=injected)
        assert torch.equal(got.tokens, want.tokens)
        assert got.nfe == want.nfe


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["t2i_int8", "frozen_int8",
                                  "generic_maskgit"])
def test_replays_count_the_launches_the_device_ran(case):
    needs_card()
    int8, kind, extra = CASES[case]
    cfg, model = tiny(int8, **extra)
    gen = torch.Generator(device="cuda").manual_seed(1)
    args = inputs(kind, cfg.model, gen)
    sample = build(kind, cfg, model, inject_noise=False)
    _build.reset_launch_counts()
    eager = sample(*args, generator=torch.Generator(device="cuda")
                   .manual_seed(0))
    eager_counts = dict(_build.launch_counts)
    if eager.nfe != sample.steps:
        pytest.skip("a mask was left: the noise-removal pass runs eager")
    _build.reset_launch_counts()
    program = captured(sample, B)
    # the warm-up ran the loop once on the device; the capture's launches
    # never ran and are not counted
    assert dict(_build.launch_counts) == eager_counts
    assert dict(program.launches) == eager_counts
    for replays in (1, 3):
        _build.reset_launch_counts()
        for i in range(replays):
            out = program(*args, seed=i)
            assert out.nfe == sample.steps
        assert dict(_build.launch_counts) == {
            k: replays * n for k, n in eager_counts.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["t2i_bf16", "generic_maskgit"])
def test_two_replays_at_one_seed_agree(case):
    needs_card()
    int8, kind, extra = CASES[case]
    cfg, model = tiny(int8, **extra)
    gen = torch.Generator(device="cuda").manual_seed(2)
    args = inputs(kind, cfg.model, gen)
    program = captured(build(kind, cfg, model, inject_noise=False), B)
    a = program(*args, seed=5).tokens
    b = program(*args, seed=5).tokens
    c = program(*args, seed=6).tokens
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not (a == cfg.model.mask_index).any()


@pytest.mark.cuda
def test_capture_refuses_what_it_cannot_capture():
    needs_card()
    cfg, model = tiny(False)
    cache = build_sampler(model, cfg.override(
        **{"sampling.predictor": "ddpm_cache"}))
    with pytest.raises(ValueError, match="ddpm_cache"):
        captured(cache, B)
    traj = build_t2i_sampler(model, cfg, return_trajectory=True)
    with pytest.raises(ValueError, match="trajectory"):
        captured(traj, B)
    program = captured(build_t2i_sampler(model, cfg), B)
    with pytest.raises(ValueError, match="shape"):
        program(torch.zeros((B + 1, cfg.model.txt_length),
                            dtype=torch.long, device="cuda"))
