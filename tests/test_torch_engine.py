"""The port's inference engine: request preparation equals the JAX
engine's, a tiny engine serves text->image, image->text, infilling and
joint requests on the CPU, and the entry points refuse to run without CUDA
unless asked for the CPU."""

import base64

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.serving.engine import InferenceEngine as JaxEngine
from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.models.dit import DIT
from unidisc_tpu_torch.sampling.t2i_fast import build_t2i_sampler
from unidisc_tpu_torch.serving.engine import InferenceEngine, build_engine
from test_torch_dit import OVERRIDES, configs, param_tree
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

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
    # prepare and the decode tail run no forward: the tree's shapes do
    jmodel, params = JaxDIT(jcfg.model), param_tree(jcfg.model, jnp.float32)
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
    """The options still to port raise naming their items; the AR options
    that the AR slice ported (ar_draft, lookup_ngram, speculative, the
    elm preset, continuous, complete_text) are held in
    tests/test_torch_speculative.py and tests/test_torch_serving.py, and
    here only refuse a diffusion model."""
    _, tcfg = configs(**OVER)
    model = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    # mesh= is ported for every axis (tests/test_torch_seq_parallel.py
    # serves on 4 ranks); a one-device spec builds the one-rank engine, a
    # spec larger than the world is refused, and what stays refused on a
    # mesh names item 9: ep inside a pipeline stage (int8 serves on every
    # axis: tests/test_torch_seq_parallel.py)
    assert build_engine(preset="tiny", device="cpu", overrides=OVER,
                        mesh="fsdp=1,seq=1").mesh is None
    for spec in ("fsdp=2,seq=2", "pp=2", "tensor=2", "fsdp=2,pp=2"):
        with pytest.raises(ValueError, match="does not cover"):
            build_engine(preset="tiny", device="cpu", mesh=spec)
    with pytest.raises(NotImplementedError, match="item 9"):
        build_engine(preset="tiny", device="cpu", mesh="pp=2,ep=2")
    for spec in ("pp=2", "tensor=2"):
        with pytest.raises(ValueError, match="does not cover"):
            build_engine(preset="tiny", device="cpu", quantize="int8",
                         overrides={"model.dropout": 0.0}, mesh=spec)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        build_engine(preset="tiny", device="cpu", mesh="data=2")
    # lora= is ported (tests/test_torch_lora.py)
    with pytest.raises(TypeError, match="unexpected"):
        build_engine(preset="tiny", device="cpu", shards=2)
    with pytest.raises(TypeError, match="unexpected"):
        InferenceEngine(tcfg, model, device="cpu", shards=2)
    with pytest.raises(ValueError, match="scaffold"):
        build_engine(preset="tiny", device="cpu", speculative="lookup")
    eng = InferenceEngine(tcfg, model, device="cpu", rolling=0)
    with pytest.raises(ValueError, match="AR model"):
        eng.continuous
    with pytest.raises(ValueError, match="AR model"):
        eng.complete_text("hi")
    # interleaved documents run since the interleaved slice (tests/
    # test_torch_interleaved.py); one longer than the model still raises
    with pytest.raises(ValueError, match="exceeds model.length"):
        eng.run_interleaved([{"kind": "text", "generate": tcfg.model.length
                              + 1}])


# ---------------------------------------------------------------------------
# pixels: the codec behind the engine, run dirs, reference checkpoints
# ---------------------------------------------------------------------------

def tiny_codecs():
    """A tiny LlamaGen-layout VQGAN (downsample 2: the 4 x 4 image grid of
    the tiny model becomes 8 px) as a JAX codec and as the port's, with
    the same weights."""
    from unidisc_tpu.tokenizers import vqgan as J
    from unidisc_tpu.tokenizers.image_codecs import ImageCodec as JaxCodec
    from unidisc_tpu_torch.tokenizers.image_codecs import get_codec
    from unidisc_tpu_torch.tokenizers.vqgan import vqgan_state_dict_from_jax
    from test_torch_vqgan import random_params
    from test_vqgan import TINY
    fm = J.VQGAN(J.VQConfig(**TINY))
    params = random_params(fm, np.zeros((1, 8, 8, 3), np.float32))
    jcodec = JaxCodec(
        name="llamagen-vq16", params=params, vocab_size=64, downsample=2,
        encode=lambda p, x: fm.apply({"params": p}, x,
                                     method=J.VQGAN.encode),
        decode=lambda p, ids: fm.apply({"params": p}, ids, 4,
                                       method=J.VQGAN.decode))
    codec = get_codec("llamagen-vq16", image_size=8, device="cpu", **TINY)
    codec.module.load_state_dict(vqgan_state_dict_from_jax(params))
    return jcodec, codec


def png_pixels(b64):
    from unidisc_tpu_torch.utils.png import decode_png
    return decode_png(base64.b64decode(b64)).astype(np.int16)


def test_engine_images_equal_the_jax_engines_decode():
    """The same token rows through both engines' decode tails: the PNGs
    hold the same pixels, to one step of 255 where an fp32 value lies on
    an integer boundary (the codecs agree to ~1e-6); out-of-codebook ids
    are clamped alike, and gen_text rows carry no image."""
    jcfg, tcfg = configs(**OVER)
    jcodec, codec = tiny_codecs()
    # prepare and the decode tail run no forward: the tree's shapes do
    jmodel, params = JaxDIT(jcfg.model), param_tree(jcfg.model, jnp.float32)
    jeng = JaxEngine(jcfg, jmodel, params, codec=jcodec)
    eng = InferenceEngine(tcfg, DIT(tcfg.model), codec=codec, device="cpu")
    m = eng.m
    prepared = [eng.prepare(text="a red cube"),
                eng.prepare(text="caption", image_ids=np.arange(16) % 5,
                            image_mask=np.arange(16) % 2 == 0),
                eng.prepare(image_ids=np.arange(16) % 7)]
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, m.text_vocab_size, (3, m.length))
    # image ids, some below (text leakage) and above the image codebook
    tokens[:, m.txt_length:] = rng.randint(
        m.text_vocab_size - 3, m.vocab_size + 3, (3, m.img_length))
    images = eng._decode_images(prepared, torch.from_numpy(tokens))
    got = eng._decode_rows(prepared, tokens, 4, images)
    want = jeng._decode_rows(prepared, tokens, 4)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert "images_b64" not in got[2]
    for r, w in zip(got[:2], want[:2]):
        a, b = png_pixels(r["images_b64"][0]), png_pixels(w["images_b64"][0])
        assert a.shape == b.shape == (8, 8, 3)
        assert np.abs(a - b).max() <= 1 and (a == b).mean() >= 0.98
        np.testing.assert_array_equal(r["image_ids"], w["image_ids"])
    # a batch of gen_text requests decodes no image at all
    assert eng._decode_images(prepared[2:], torch.from_numpy(tokens)) is None


def test_engine_serves_pngs_of_the_returned_ids():
    _, tcfg = configs(**OVER)
    _, codec = tiny_codecs()
    eng = InferenceEngine(tcfg, DIT(tcfg.model), codec=codec, device="cpu")
    results = eng.run_batch([eng.prepare(text="a cat"),
                             eng.prepare(image_ids=np.arange(16) % 7)],
                            seed=1)
    assert "images_b64" not in results[1]
    # the tiny model does not force image ids into the codebook: clamp
    ids = results[0]["image_ids"].clip(0, eng.m.image_vocab_size - 1)
    want = ((codec.decode(ids) + 1) * 127.5).clamp(0, 255).to(torch.uint8)
    got = png_pixels(results[0]["images_b64"][0])
    assert np.abs(got - want[0].numpy()).max() <= 1
    one = eng.run(text="a cat", seed=1, batch=2)
    assert len(one["images_b64"]) == 2
    # a codebook smaller than the model's image vocabulary is refused
    small = configs(**{**OVER, "model.image_vocab_size": 65})[1]
    with pytest.raises(ValueError, match="64 codes"):
        InferenceEngine(small, DIT(small.model), codec=codec, device="cpu")


def test_build_engine_serves_a_trainer_run_dir_with_pixels(tmp_path):
    """checkpoint=: the EMA weights of the port Trainer's run dir, under
    its config snapshot (overrides beat it), with the full-width VQ-16
    codec sized to the tiny model's 4 x 4 grid (64 px)."""
    from test_torch_generate import trained_run_dir
    cfg, ema, _ = trained_run_dir(tmp_path)
    eng = build_engine(checkpoint=str(tmp_path), codec_name="llamagen-vq16",
                       device="cpu", steps=3)
    assert eng.config.sampling.steps == 3
    assert eng.config.model == cfg.model
    for name, value in eng.model.state_dict().items():
        assert torch.equal(value, ema[name]), name
    assert (eng.codec.name, eng.codec.image_size, eng.codec.downsample) == (
        "llamagen-vq16", 64, 16)
    assert eng.codec.module.cfg.ch == 128       # the published width
    r = eng.run_batch([eng.prepare(text="a cat")])[0]
    assert png_pixels(r["images_b64"][0]).shape == (64, 64, 3)
    assert r["nfe"] in (3, 4)


def test_restore_refuses_lora_and_host_offload_run_dirs(tmp_path):
    """LoRA and host-offload run dirs are served since the training slice
    (tests/test_torch_lora.py, tests/test_torch_offload.py); what restore
    still refuses: a LoRA run whose recorded base is itself a LoRA run, a
    run dir without checkpoints, and both a run dir and a reference
    checkpoint."""
    import json
    from unidisc_tpu_torch.serving.engine import restore_run
    _, tcfg = configs(**OVER)
    for sub, over, meta in (
            ("base", {"model.lora_rank": 4}, {}),
            ("lora", {"model.lora_rank": 4},
             {"lora_base_checkpoint": str(tmp_path / "base")})):
        step_dir = tmp_path / sub / "checkpoints" / "1"
        step_dir.mkdir(parents=True)
        (step_dir / "meta.json").write_text(json.dumps(
            {"config": json.loads(tcfg.override(**over).to_json()),
             "step": 1, **meta}))
        torch.save({"ema_params": {}, "params": {}},
                   str(step_dir / "state.pt"))
    with pytest.raises(ValueError, match="itself a LoRA run"):
        restore_run(str(tmp_path / "lora"))
    with pytest.raises(ValueError, match="itself a LoRA run"):
        build_engine(checkpoint=str(tmp_path / "lora"), device="cpu")
    with pytest.raises(FileNotFoundError):
        restore_run(str(tmp_path / "empty"))
    with pytest.raises(ValueError, match="pass one"):
        build_engine(checkpoint=str(tmp_path), reference_ckpt="x.pt",
                     device="cpu")


REFERENCE = {"model.hidden_size": 128, "model.n_blocks": 2,
             "model.text_vocab_size": 300, "model.image_vocab_size": 16384,
             "model.time_conditioning": True, "model.cond_dim": 32,
             "model.qk_norm": True, "model.norm_type": "rms",
             "model.sandwich_normalization": True,
             "model.modality_embed": True, "model.dropout": 0.0}
LAYOUT = {"model.length": 24, "model.txt_length": 8, "model.img_length": 16,
          "model.rope_2d": True}


def reference_state_dict():
    """A state_dict in the published checkpoints' naming: the production
    DIT nests attention under blocks.{i}.attention, and the files carry a
    rotary table."""
    from unidisc_tpu_torch.models.dit import randomize_
    cfg = Config.make("tiny", **REFERENCE, **LAYOUT)
    model = DIT(cfg.model)
    randomize_(model, 3)
    sd = {}
    for k, v in model.state_dict().items():
        for leaf in ("attn_qkv", "attn_out", "q_norm", "k_norm"):
            k = k.replace(f".{leaf}.", f".attention.{leaf}.")
        sd[k] = v
    sd["blocks.0.attention.rotary_emb.inv_freq"] = torch.ones(32)
    return model.state_dict(), sd


@pytest.mark.parametrize("fmt", ["safetensors", "pt"])
def test_reference_checkpoint_loads_with_the_jax_overrides(tmp_path, fmt):
    from safetensors.numpy import save_file
    from unidisc_tpu.models.port import (infer_dit_overrides as jax_infer,
                                         read_reference_state_dict as
                                         jax_read)
    from unidisc_tpu_torch.models.port import (infer_dit_overrides,
                                               read_reference_state_dict)
    weights, sd = reference_state_dict()
    path = str(tmp_path / f"model.{fmt}")
    if fmt == "pt":
        torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
                   path)
    else:
        save_file({k: v.numpy() for k, v in sd.items()}, path)
    want_sd = jax_read(path)
    got_sd = read_reference_state_dict(path)
    assert sorted(got_sd) == sorted(want_sd)
    for k in want_sd:
        np.testing.assert_array_equal(got_sd[k].numpy(), want_sd[k])
    want = jax_infer(want_sd)
    assert infer_dit_overrides(got_sd) == want
    assert want["model.n_heads"] == 2 and want["model.norm_type"] == "rms"
    eng = build_engine(preset="tiny", reference_ckpt=path, overrides=LAYOUT,
                       device="cpu")
    for k, v in want.items():
        assert getattr(eng.config.model, k.split(".")[1]) == v, k
    for name, value in eng.model.state_dict().items():
        assert torch.equal(value, weights[name]), name
    r = eng.run_batch([eng.prepare(text="a cat")])[0]
    assert r["image_ids"].shape == (1, 16)


def test_infer_dit_overrides_matches_jax_on_split_and_conditioned_keys():
    """The shape rules beyond the flagship's: split embedding, layernorm
    with bias, class labels without time conditioning, image conditioning
    and the image-count table (the config inferred as JAX infers it;
    tests/test_torch_img_cond.py serves such checkpoints)."""
    from unidisc_tpu.models.port import infer_dit_overrides as jax_infer
    from unidisc_tpu_torch.models.port import infer_dit_overrides
    z = np.zeros
    sd = {"vocab_embed.embedding": z((301, 96)),
          "img_vocab_embed.weight": z((1024, 8)),
          "blocks.0.attention.attn_qkv.weight": z((288, 96)),
          "blocks.1.attn_qkv.weight": z((288, 96)),
          "blocks.0.mlp.0.weight": z((384, 96)),
          "blocks.0.norm1.bias": z(96), "img_count_embedding": z((4, 96)),
          "y_embedder.embedding_table.weight": z((11, 48)),
          "blocks.0.cross_attention.attn_qkv.weight": z((288, 96)),
          "cond_img_vocab_embed.weight": z((512, 16)),
          "cond_img_vocab_proj.weight": z((96, 16)),
          "img_cond_blocks.0.attn_qkv.weight": z((288, 96))}
    want = jax_infer(sd)
    assert infer_dit_overrides({k: torch.from_numpy(v)
                                for k, v in sd.items()}) == want
    # width 96: no zoo entry and not a multiple of 64, so no head count
    assert want["model.split_embed"] and "model.n_heads" not in want


@pytest.mark.parametrize("dtype", ["float32", "float16", "int64", "int8",
                                   "uint8", "bool"])
def test_safetensors_reader_matches_the_library(tmp_path, dtype):
    from safetensors.numpy import save_file
    from unidisc_tpu_torch.models.port import read_safetensors
    rng = np.random.RandomState(0)
    arrs = {"a": (rng.standard_normal((3, 5)) * 50).astype(dtype),
            "empty": np.zeros((0, 4), dtype),
            "scalar": np.array(7, dtype)}
    save_file(arrs, str(tmp_path / "lib.safetensors"),
              metadata={"format": "pt"})
    got = read_safetensors(str(tmp_path / "lib.safetensors"))
    assert sorted(got) == sorted(arrs)
    for k, v in arrs.items():
        assert got[k].numpy().dtype == v.dtype
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_safetensors_reader_reads_bf16(tmp_path):
    from safetensors.torch import save_file
    from unidisc_tpu_torch.models.port import read_safetensors
    w = {"w": torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
         .to(torch.bfloat16), "b": torch.arange(3, dtype=torch.int32)}
    save_file(w, str(tmp_path / "w.safetensors"))
    got = read_safetensors(str(tmp_path / "w.safetensors"))
    for k in w:
        assert got[k].dtype == w[k].dtype and torch.equal(got[k], w[k])


def test_downscale_bool_mask_matches_jax():
    from unidisc_tpu.serving.engine import downscale_bool_mask as jax_down
    from unidisc_tpu_torch.serving.engine import downscale_bool_mask
    rng = np.random.RandomState(0)
    for mask in (rng.rand(16, 8) > 0.9, rng.rand(16, 8, 3) > 0.97):
        np.testing.assert_array_equal(downscale_bool_mask(mask, 4),
                                      jax_down(mask, 4))
    with pytest.raises(ValueError, match="divisible"):
        downscale_bool_mask(np.zeros((6, 8), bool), 4)
