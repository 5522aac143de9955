"""The rolling chunk program (sampling/graph.py::CapturedChunk) against the
eager rolling state machine (serving/rolling.py), and the scaffold
sampler's captured program against its eager loop, on the card. Skips
where CUDA is absent. This file imports no JAX, so it also runs on a GPU
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_rolling_cuda.py

On a tiny bf16 model (the hand kernels take bf16), generic and t2i, bf16
and int8: the captured chunk gives the eager chunk's state after every
chunk of a staggered, ragged run, under injected noise and under the keyed
noise; its replays count the launches the eager chunk makes; the keyed
uniforms are bit-identical to the CPU's; the threaded batcher on the card
gives the eager state machine's rows.
"""

import numpy as np
import pytest
import torch

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.models.dit import DIT, randomize_
from unidisc_tpu_torch.ops import _build
from unidisc_tpu_torch.ops.quant import quantize_model
from unidisc_tpu_torch.sampling.graph import CapturedChunk, captured
from unidisc_tpu_torch.sampling.scaffold import build_scaffold_sampler
from unidisc_tpu_torch.serving.rolling import (RollingDiffusionBatcher,
                                               build_rolling_sampler,
                                               build_rolling_t2i,
                                               keyed_uniform)

S, STEPS, CHUNK = 4, 5, 2
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
CASES = {"generic_bf16": ("generic", False), "t2i_bf16": ("t2i", False),
         "t2i_int8": ("t2i", True), "generic_int8": ("generic", True)}


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run chip_smoke.py or this file "
                    "on the card")


def tiny(int8, seed=0, **extra):
    cfg = Config.make("tiny", **{**TINY, **(INT8 if int8 else {}), **extra})
    model = DIT(cfg.model, compute_dtype=torch.bfloat16).to("cuda").eval()
    randomize_(model, seed)
    if int8:
        cfg, model = quantize_model(cfg, model)
    return cfg, model


def build(kind, cfg, model, inject_noise):
    fn = build_rolling_t2i if kind == "t2i" else build_rolling_sampler
    return fn(model, cfg, slots=S, chunk=CHUNK, inject_noise=inject_noise)


def admit(built, kind, state, slots, rng, steps):
    """Insert len(slots) random text-conditioned requests."""
    m = built.config.model
    n = len(slots)
    txt = rng.randint(1, m.mask_index, (n, m.txt_length))
    seeds = rng.randint(0, 2 ** 31 - 1, n)
    if kind == "t2i":
        return built.insert_many(state, slots, txt, seeds, steps)
    x0 = np.zeros((n, m.length), np.int64)
    x0[:, :m.txt_length] = txt
    unmask = np.zeros((n, m.length), bool)
    unmask[:, :m.txt_length] = True
    unmask[-1, 2:m.txt_length] = False           # one row infills text
    modality = (np.arange(m.length) >= m.txt_length).astype(np.int64)
    return built.insert_many(state, slots, x0, unmask,
                             np.repeat(modality[None], n, 0), seeds, steps)


def noise(built, gen):
    out = {}
    for name, shape in built.noise_shapes().items():
        u = torch.rand(shape, generator=gen, device="cuda")
        out[name] = -torch.log(u) if name == "exp" else -torch.log(-torch.log(
            u))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("inject", [True, False], ids=["injected", "keyed"])
def test_captured_chunk_equals_the_eager_chunk(case, inject):
    needs_card()
    kind, int8 = CASES[case]
    cfg, model = tiny(int8)
    built = build(kind, cfg, model, inject)
    gen = torch.Generator(device="cuda").manual_seed(3)
    injected = noise(built, gen) if inject else None
    program = CapturedChunk(built)
    eager = built.init_state()
    rng_a, rng_b = np.random.RandomState(0), np.random.RandomState(0)
    for chunk in range(6):
        if chunk in (0, 1):
            slots = [0, S] if chunk == 0 else [1, 2]     # S: a padding row
            admit(built, kind, eager, slots, rng_a, [2, STEPS][:len(slots)])
            admit(built, kind, program.state, slots, rng_b,
                  [2, STEPS][:len(slots)])
        built.step_chunk(eager, injected)
        program.step_chunk(program.state, injected)
        for a, b in zip(program.state, eager):
            assert torch.equal(a, b), chunk
    assert not (eager.x[:3] == cfg.model.mask_index).any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["generic_bf16", "t2i_int8"])
def test_replays_count_the_eager_chunks_launches(case):
    needs_card()
    kind, int8 = CASES[case]
    cfg, model = tiny(int8)
    built = build(kind, cfg, model, False)
    state = built.init_state()
    _build.reset_launch_counts()
    built.step_chunk(state)
    eager = dict(_build.launch_counts)
    assert eager.get("flash_fwd") == CHUNK * cfg.model.n_blocks
    _build.reset_launch_counts()
    program = CapturedChunk(built)
    assert dict(_build.launch_counts) == eager       # the warm run only
    _build.reset_launch_counts()
    for _ in range(3):
        program.step_chunk()
    assert dict(_build.launch_counts) == {k: 3 * n for k, n in eager.items()}


@pytest.mark.cuda
def test_a_foreign_state_is_copied_in_and_out():
    needs_card()
    cfg, model = tiny(False)
    built = build("t2i", cfg, model, False)
    program = CapturedChunk(built)
    a, b = built.init_state(), built.init_state()
    rng = np.random.RandomState(1)
    admit(built, "t2i", a, [0, 3], rng, None)
    for t, s in zip(b, a):
        t.copy_(s)
    program.step_chunk(a)
    built.step_chunk(b)
    for t, s in zip(a, b):
        assert torch.equal(t, s)


@pytest.mark.cuda
def test_keyed_uniforms_equal_the_cpus():
    needs_card()
    seed = torch.tensor([0, 7, 2 ** 31 - 1, 123456789])
    step = torch.tensor([0, 31, 5, 16])
    for tag, n in ((1, 384 * 1000), (2, 384)):
        cpu = keyed_uniform(seed, step, tag, n)
        card = keyed_uniform(seed.cuda(), step.cuda(), tag, n).cpu()
        assert torch.equal(cpu, card)


@pytest.mark.cuda
def test_batcher_on_the_card_gives_the_state_machines_rows():
    needs_card()
    cfg, model = tiny(False)
    m = cfg.model
    built = build("generic", cfg, model, False)
    rng = np.random.RandomState(2)
    x0 = np.zeros((2, m.length), np.int64)
    x0[:, :m.txt_length] = rng.randint(1, m.mask_index, (2, m.txt_length))
    unmask = np.zeros_like(x0, bool)
    unmask[:, :m.txt_length] = True
    modality = (np.arange(m.length) >= m.txt_length).astype(np.int64)
    want = []
    for r, steps in ((0, 3), (1, STEPS)):
        st = built.insert_many(built.init_state(), [0], x0[r:r + 1],
                               unmask[r:r + 1], modality[None], [r + 5],
                               [steps])
        for _ in range(8):
            built.step_chunk(st)
        want.append(st.x[0].cpu().numpy())
    batcher = RollingDiffusionBatcher(model, cfg, slots=S, chunk=CHUNK)
    try:
        assert batcher.program is not None
        f0 = batcher.submit(x0[0], unmask[0], modality, seed=5, steps=3)
        f1 = batcher.submit(x0[1], unmask[1], modality, seed=6)
        np.testing.assert_array_equal(f0.result(timeout=60), want[0])
        np.testing.assert_array_equal(f1.result(timeout=60), want[1])
    finally:
        batcher.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("split", [0, 2, STEPS])
def test_scaffold_captured_program_equals_its_eager_loop(split):
    needs_card()
    cfg, big = tiny(False)
    _, small = tiny(False, seed=1, **{"model.n_blocks": 1})
    sample = build_scaffold_sampler(big, small, cfg, split=split,
                                    inject_noise=True)
    # split >= steps: every forward is "early", the noise removal too
    assert sample.big == [i < split for i in range(STEPS)] + [split >= STEPS]
    gen = torch.Generator(device="cuda").manual_seed(4)
    m = cfg.model
    txt = torch.randint(0, m.mask_index, (S, m.txt_length), generator=gen,
                        device="cuda")
    x0 = torch.cat([txt, torch.full((S, m.img_length), m.mask_index,
                                    device="cuda")], 1)
    unmask = torch.zeros_like(x0, dtype=torch.bool)
    unmask[:, :m.txt_length] = True
    modality = (torch.arange(m.length, device="cuda") >= m.txt_length
                ).long().expand(S, -1)
    shape = (STEPS, S, m.length)
    injected = {"exp": torch.empty(shape + (m.vocab_size,), device="cuda")
                .exponential_(generator=gen),
                "gumbel": -torch.log(-torch.log(torch.rand(
                    shape, generator=gen, device="cuda")))}
    _build.reset_launch_counts()
    want = sample(x0, unmask, modality, injected=injected)
    eager = dict(_build.launch_counts)
    n_big = sum(sample.big[:STEPS]) + (want.nfe > STEPS) * sample.big[STEPS]
    assert eager["flash_fwd"] == n_big * 2 + (want.nfe - n_big) * 1
    program = captured(sample, S)
    got = program(x0, unmask, modality, injected=injected)
    assert torch.equal(got.tokens, want.tokens) and got.nfe == want.nfe
