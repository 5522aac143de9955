"""The port's inference engine: request preparation equals the JAX
engine's, a tiny engine serves text->image, image->text, infilling and
joint requests on the CPU, and the entry points refuse to run without CUDA
unless asked for the CPU."""

import jax
import numpy as np
import pytest
import torch

from unidisc_tpu.models.dit import init_dit
from unidisc_tpu.serving.engine import InferenceEngine as JaxEngine
from unidisc_tpu_torch.models.dit import DIT
from unidisc_tpu_torch.sampling.t2i_fast import build_t2i_sampler
from unidisc_tpu_torch.serving.engine import InferenceEngine, build_engine
from test_torch_dit import OVERRIDES, configs

OVER = {"sampling.predictor": "maskgit", "sampling.steps": 4,
        "sampling.cfg": 2.0, "model.text_vocab_size": 300}

REQUESTS = [
    dict(text="a red cube"),
    dict(text=""),
    dict(text="x" * 40),                                   # truncated
    dict(text="a <mask:3> on a table"),                    # infill slots
    dict(text="two <mask> cats", task="gen_image"),
    dict(image_ids=np.arange(16) % 7),                     # gen_text
    dict(text="caption", image_ids=np.arange(16) % 5,
         image_mask=np.arange(16) % 2 == 0),               # infill
    dict(),                                                # joint
]


def test_prepare_matches_jax_engine():
    jcfg, tcfg = configs(**OVER)
    jmodel, params = init_dit(jax.random.PRNGKey(0), jcfg.model)
    jeng = JaxEngine(jcfg, jmodel, params)
    eng = InferenceEngine(tcfg, DIT(tcfg.model), device="cpu")
    for req in REQUESTS:
        want, got = jeng.prepare(**req), eng.prepare(**req)
        assert got["task"] == want["task"], req
        assert got["fastpath"] == want["fastpath"], req
        np.testing.assert_array_equal(got["x0"], want["x0"])
        np.testing.assert_array_equal(got["unmask"], want["unmask"])


def test_tiny_engine_serves_requests_on_cpu():
    eng = build_engine(preset="tiny", device="cpu",
                       overrides={**OVERRIDES, **OVER})
    prompts = ["a cat", "a dog", "a boat"]
    results = eng.run_batch([eng.prepare(text=p) for p in prompts], seed=1,
                            pad_to=4)
    m = eng.m
    assert len(results) == 3
    for p, r in zip(prompts, results):
        assert r["text"] == p
        assert r["image_ids"].shape == (1, m.img_length)
        assert r["image_ids"].min() >= 0
        assert r["image_ids"].max() < m.image_vocab_size
        assert r["nfe"] == 4
    again = eng.run_batch([eng.prepare(text=p) for p in prompts], seed=1,
                          pad_to=4)
    for r, s in zip(results, again):
        np.testing.assert_array_equal(r["image_ids"], s["image_ids"])
    one = eng.run(text="a cat", seed=1, batch=2)
    assert one["image_ids"].shape == (2, m.img_length)
    # a request that is not pure text->image takes the generic sampler
    infill = eng.run_batch([eng.prepare(text="a <mask:2> cat")])
    assert infill[0]["nfe"] in (4, 5)
    assert len(eng._samplers) == 2


def test_tiny_int8_engine_serves_requests_on_cpu():
    from unidisc_tpu_torch.config import FLAGSHIP_INT8_OVERRIDES
    from unidisc_tpu_torch.models.dit import QLinear
    eng = build_engine(preset="tiny", device="cpu", quantize="int8",
                       overrides={**FLAGSHIP_INT8_OVERRIDES, **OVERRIDES,
                                  **OVER})
    m = eng.m
    assert (m.quant, m.quant_backend, m.quant_fused) == \
        ("int8", "pallas", True)
    lin = eng.model.blocks[0].attn_qkv
    assert isinstance(lin, QLinear) and lin.weight_q.dtype == torch.int8
    assert isinstance(eng.model.output_layer.linear, QLinear)
    prompts = ["a cat", "a dog"]
    results = eng.run_batch([eng.prepare(text=p) for p in prompts], seed=2)
    again = eng.run_batch([eng.prepare(text=p) for p in prompts], seed=2)
    for p, r, s in zip(prompts, results, again):
        assert r["text"] == p and r["nfe"] == 4
        assert r["image_ids"].shape == (1, m.img_length)
        assert 0 <= r["image_ids"].min() <= r["image_ids"].max() \
            < m.image_vocab_size
        np.testing.assert_array_equal(r["image_ids"], s["image_ids"])
    with pytest.raises(ValueError, match="quantize"):
        build_engine(preset="tiny", device="cpu", quantize="int4")


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = configs(**OVER)
    model = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_engine(preset="tiny")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(tcfg, model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_t2i_sampler(model, tcfg)


@pytest.mark.parametrize("predictor", ["maskgit", "ddpm", "first_hitting"])
def test_tiny_engine_serves_the_generic_tasks_on_cpu(predictor):
    """gen_text (image -> caption), infill and joint requests run through
    the generic sampler: known tokens stay, generated ids lie in their
    modality's vocabulary (force_argmax_valid_indices), and the NFE is the
    step count (plus one where the noise-removal pass ran)."""
    eng = build_engine(preset="tiny", device="cpu",
                       overrides={**OVERRIDES, **OVER,
                                  "model.force_argmax_valid_indices": True,
                                  "sampling.predictor": predictor})
    m = eng.m
    requests = [dict(image_ids=np.arange(m.img_length) % 7),
                dict(text="a <mask:3> on a table",
                     image_ids=np.arange(m.img_length) % 5,
                     image_mask=np.arange(m.img_length) % 2 == 0),
                dict()]
    prepared = [eng.prepare(**r) for r in requests]
    assert [p["task"] for p in prepared] == ["gen_text", "infill", "joint"]
    assert not any(p["fastpath"] for p in prepared)
    results = eng.run_batch(prepared, seed=3, pad_to=4)
    again = eng.run_batch(prepared, seed=3, pad_to=4)
    lt, v0 = m.txt_length, m.text_vocab_size
    for p, r, s in zip(prepared, results, again):
        assert r["task"] == p["task"]
        assert r["nfe"] in (4, 5)
        assert r["image_ids"].shape == (1, m.img_length)
        np.testing.assert_array_equal(r["image_ids"], s["image_ids"])
        img = r["image_ids"][0] + v0
        assert (img >= v0).all() and (img < m.vocab_size).all()
        known = p["unmask"][lt:]
        np.testing.assert_array_equal(img[known], p["x0"][lt:][known])
    # the caption of the gen_text request is text: decodes to a string
    assert isinstance(results[0]["text"], str)
    out = eng._sampler(batch=4)(*[np.stack([p[k] for p in prepared]
                                           + [prepared[-1][k]])
                                  for k in ("x0", "unmask")],
                                eng._layout(4), seed=3)
    tokens = out.tokens.numpy()
    assert (tokens[:, :lt] < v0).all() and (tokens[:, :lt] != m.mask_index
                                            ).all()
    assert (tokens[:, lt:] >= v0).all()
    for i, p in enumerate(prepared):
        np.testing.assert_array_equal(tokens[i][p["unmask"]],
                                      p["x0"][p["unmask"]])


def test_unported_engine_options_raise_naming_their_queue_item():
    _, tcfg = configs(**OVER)
    model = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    for name, value, item in (("codec", object(), 3), ("mesh", object(), 9),
                              ("rolling", 8, 10)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            InferenceEngine(tcfg, model, device="cpu", **{name: value})
    with pytest.raises(TypeError, match="unexpected"):
        InferenceEngine(tcfg, model, device="cpu", shards=2)
    eng = InferenceEngine(tcfg, model, device="cpu", rolling=0)
    with pytest.raises(NotImplementedError, match="item 4"):
        eng.enable_scaffold(model, 4)
    with pytest.raises(NotImplementedError, match="item 10"):
        eng.continuous
