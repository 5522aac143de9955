"""The AR serving path's captured programs and its int8 kernels at the
decode shapes, on the card. Skips where CUDA is absent. This file imports
no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_ar_cuda.py

- The continuous decode chunk (serving/continuous.py) captured by
  sampling/graph.py::CapturedChunk gives the eager chunk's state, every
  field after every chunk, on a tiny ELM (bf16 and int8 with the int8 KV
  cache), with plain, speculative and prompt-lookup rounds, and on a tiny
  DIT-AR; the replays count the launches the eager chunk makes.
- The AR decode loop's captured program (graph.py::captured_ar) gives the
  eager loop's tokens, under injected noise and the keyed noise, with CFG.
- int8_matmul and dynamic_quantize at the decode shapes of OpenELM-270M
  (M 8 and 16; K 1,280 and the layers' widths; the 48,385-wide head)
  equal their plain versions bit for bit (tests/test_torch_int8_cuda.py
  states why).
"""

import dataclasses

import numpy as np
import pytest
import torch

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.models.dit import DIT, randomize_
from unidisc_tpu_torch.models.elm import ELM_PRESETS, OpenELM
from unidisc_tpu_torch.ops import _build
from unidisc_tpu_torch.ops.int8_matmul import (int8_matmul,
                                               int8_matmul_reference)
from unidisc_tpu_torch.ops.quant import (dynamic_quantize,
                                         dynamic_quantize_reference,
                                         quantize_elm_params, quantize_model)
from unidisc_tpu_torch.sampling.ar_sampler import (build_ar_sampler,
                                                   make_apply_token)
from unidisc_tpu_torch.sampling.graph import CapturedChunk, captured_ar
from unidisc_tpu_torch.serving.continuous import (ContinuousDecoder,
                                                  build_continuous_decoder,
                                                  elm_continuous_batcher)

TINY_AR = {"model.hidden_size": 128, "model.n_heads": 2, "model.n_blocks": 2,
           "model.cond_dim": 32, "model.length": 24, "model.txt_length": 8,
           "model.img_length": 16, "model.text_vocab_size": 24,
           "model.image_vocab_size": 40, "model.qk_norm": True,
           "model.norm_type": "rms", "model.sandwich_normalization": True,
           "model.modality_embed": True, "model.rope_2d": True,
           "model.dropout": 0.0, "model.force_argmax_valid_indices": True,
           "model.full_attention": False,
           "trainer.parameterization": "ar", "trainer.ar_shift": True}
INT8 = {"model.quant_backend": "pallas", "model.quant_fused": True}


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run chip_smoke.py or this file "
                    "on the card")


def tiny_elm(int8, seed=0):
    cfg = dataclasses.replace(ELM_PRESETS["tiny"], max_length=48)
    master = OpenELM(cfg, compute_dtype=torch.float32)
    master.reset_parameters(torch.Generator().manual_seed(seed))
    state = master.state_dict()
    # the JAX init's tables are tiny: widen them so tokens vary
    state["token_embeddings"] = state["token_embeddings"] * 50
    if int8:
        cfg = dataclasses.replace(cfg, quant="int8")
        state = quantize_elm_params(state)
    model = OpenELM(cfg, compute_dtype=torch.bfloat16)
    model.load_state_dict(state)
    return model.to("cuda").eval()


def tiny_dit_ar(int8, **extra):
    cfg = Config.make("tiny", **{**TINY_AR, **(INT8 if int8 else {}),
                                 **extra})
    model = DIT(cfg.model, compute_dtype=torch.bfloat16).to("cuda").eval()
    randomize_(model, 0)
    if int8:
        cfg, model = quantize_model(cfg, model)
    return cfg, model


def states_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        xs = x if isinstance(x, (list, tuple)) else [x]
        ys = y if isinstance(y, (list, tuple)) else [y]
        flat = lambda t: [u for v in t for u in
                          (v if isinstance(v, (list, tuple)) else [v])]
        for u, v in zip(flat(xs), flat(ys)):
            assert torch.equal(u, v), name


def clone_state(state):
    def c(x):
        if isinstance(x, (list, tuple)):
            return type(x)(c(v) for v in x)
        return x.clone()
    return type(state)(*(c(f) for f in state))


def drive(decoder: ContinuousDecoder, program, rng, chunks=5):
    """Admissions between chunks into the program's state and a copy of
    it; the eager chunk on the copy, a replay on the program's."""
    eager = clone_state(program.state)
    L, S = decoder.L, decoder.slots
    for c in range(chunks):
        if c in (0, 2):
            slots = [0, 1] if c == 0 else [2]
            n = len(slots)
            plens = rng.randint(2, 9, n)
            prompts = rng.randint(1, 60, (n, 16))
            temps = np.asarray([0.0, 3.0][:n] if c == 0 else [0.0],
                               np.float32)
            args = (slots, prompts, np.zeros((n, L), np.int64), plens,
                    rng.randint(6, 20, n), temps, rng.randint(0, 999, n))
            for st in (eager, program.state):
                decoder.insert_many(st, *args)
        before = dict(_build.launch_counts)
        decoder.step_chunk(eager)
        eager_launches = {k: v - before.get(k, 0)
                          for k, v in _build.launch_counts.items()}
        before = dict(_build.launch_counts)
        program.step_chunk()
        replay = {k: v - before.get(k, 0)
                  for k, v in _build.launch_counts.items()}
        torch.cuda.synchronize()
        assert replay == eager_launches
        states_equal(eager, program.state)
    assert S >= 3


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "draft", "lookup"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_elm_decode_chunk_captured_equals_eager(mode, int8):
    needs_card()
    model = tiny_elm(int8)
    kw = {"draft": dict(draft=tiny_elm(False, seed=1), gamma=3),
          "lookup": dict(lookup_ngram=2, gamma=3), "plain": {}}[mode]
    b = elm_continuous_batcher(model, slots=4, chunk=8, quant_cache=int8,
                               **kw)
    try:
        # the batcher's capture is on its own state; drive a second
        # program of the same decoder synchronously, captured under the
        # batcher's lock (its idle worker makes no CUDA call)
        with b._lock:
            program = CapturedChunk(b.decoder)
        drive(b.decoder, program, np.random.RandomState(0))
        if int8:
            assert program.launches["int8_matmul"] > 0
            assert program.launches["dynamic_quantize"] > 0
    finally:
        b.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_dit_ar_decode_chunk_captured_equals_eager(int8):
    needs_card()
    cfg, model = tiny_dit_ar(int8, **({"model.kv_cache_dtype": "int8"}
                                      if int8 else {}))
    decoder = build_continuous_decoder(model, cfg, slots=4, chunk=4,
                                       eos_id=2)
    drive(decoder, CapturedChunk(decoder), np.random.RandomState(1))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["greedy_cfg", "gumbel_cfg_injected",
                                  "nucleus_keyed", "int8_gumbel_keyed"])
def test_ar_sampler_program_equals_eager(case):
    needs_card()
    s = {"greedy_cfg": {"sampling.temperature": 0.0, "sampling.cfg": 2.0},
         "gumbel_cfg_injected": {"sampling.temperature": 0.8,
                                 "sampling.cfg": 2.0},
         "nucleus_keyed": {"sampling.temperature": 1.0, "sampling.cfg": None,
                           "sampling.top_p": 0.9},
         "int8_gumbel_keyed": {"sampling.temperature": 1.0,
                               "sampling.cfg": 2.0,
                               "model.kv_cache_dtype": "int8"}}[case]
    cfg, model = tiny_dit_ar(case.startswith("int8"), **s)
    m, b = cfg.model, 3
    inject = case.endswith("injected")
    sampler = build_ar_sampler(make_apply_token(model), cfg, chunk=5,
                               inject_noise=inject)
    rng = np.random.RandomState(2)
    x0 = rng.randint(0, m.text_vocab_size, (b, m.length))
    unmask = np.zeros((b, m.length), bool)
    unmask[:, :4] = True
    modality = np.concatenate([np.zeros((b, m.txt_length)),
                               np.ones((b, m.img_length))], 1)
    injected = {"gumbel": rng.gumbel(size=(m.length - 1, b, m.vocab_size)
                                     ).astype(np.float32)} if inject else None
    program = captured_ar(sampler, b)
    for seed in (0, 1):
        want = sampler(x0, unmask, modality, seed=seed, injected=injected)
        got = program(x0, unmask, modality, seed=seed, injected=injected)
        assert torch.equal(got.tokens, want.tokens), seed


# OpenELM-270M's decode products: (K, N) of every projection width and
# the head
_C = ELM_PRESETS["270m"]
_HD, _D = _C.head_dim, _C.model_dim
ELM_PRODUCTS = sorted(
    {(_D, (q + 2 * kv) * _HD) for q, kv in zip(_C.layer_q_heads(),
                                                _C.layer_kv_heads())}
    | {(q * _HD, _D) for q in _C.layer_q_heads()}
    | {(_D, 2 * f) for f in _C.layer_ffn_dims()}
    | {(f, _D) for f in _C.layer_ffn_dims()}
    | {(_D, _C.total_vocab)})


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 16])
def test_int8_kernels_at_the_elm_decode_shapes(m):
    needs_card()
    gen = torch.Generator(device="cuda").manual_seed(m)
    for k, n in ELM_PRODUCTS:
        x = torch.randn((m, k), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        before = dict(_build.launch_counts)
        xq, s = dynamic_quantize(x)
        rq, rs = dynamic_quantize_reference(x)
        assert torch.equal(xq, rq) and torch.equal(s, rs), (m, k)
        wq = torch.randint(-127, 128, (n, k), dtype=torch.int8,
                           generator=gen, device="cuda")
        ws = torch.rand((n,), generator=gen, device="cuda") * 0.02
        out = torch.float32 if n == _C.total_vocab else torch.bfloat16
        got = int8_matmul(xq, s, wq, ws, out_dtype=out)
        want = int8_matmul_reference(xq, s, wq, ws, out_dtype=out)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (m, k, n)
        assert _build.launch_counts["int8_matmul"] == \
            before.get("int8_matmul", 0) + 1
        assert _build.launch_counts["dynamic_quantize"] == \
            before.get("dynamic_quantize", 0) + 1
