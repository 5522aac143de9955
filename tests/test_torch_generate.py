"""The port's generate CLI (unidisc_tpu_torch/generate.py) on a tiny run
dir that the port's Trainer writes on the CPU: it restores the EMA (or,
without --use-ema, the live) weights of the latest checkpoint exactly,
and writes one samples.jsonl line and, with a codec, one PNG a sample, as
unidisc_tpu/generate.py does."""

import base64
import json

import numpy as np
import pytest
import torch

from unidisc_tpu_torch import generate
from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.data.synthetic import SyntheticDataLoader
from unidisc_tpu_torch.training.trainer import Trainer
from unidisc_tpu_torch.utils.png import decode_png
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

# the byte tokenizer's ids need a text vocabulary of 260 and more
RUN = {"model.length": 24, "model.txt_length": 8, "model.img_length": 16,
       "model.text_vocab_size": 300, "model.image_vocab_size": 40,
       "model.hidden_size": 64, "model.n_heads": 1, "model.dropout": 0.0,
       "model.time_conditioning": True, "model.modality_embed": True,
       "model.force_argmax_valid_indices": True, "trainer.warmup_steps": 1,
       "trainer.lr": 1e-3, "sampling.steps": 4}


def trained_run_dir(path, steps=2):
    """Train a tiny model for `steps` steps into run dir `path`; returns
    (config, final EMA, final live params)."""
    cfg = Config.make("tiny", **RUN)
    trainer = Trainer(cfg, str(path), device="cpu", log_every=100)
    trainer.fit(SyntheticDataLoader(cfg, 2, seed=cfg.seed), max_steps=steps)
    trainer.close()
    ema = {k: v.detach().clone() for k, v in
           trainer.state.ema_params.items()}
    live = {k: v.detach().clone() for k, v in trainer.state.params.items()}
    return cfg, ema, live


@pytest.mark.parametrize("use_ema", [True, False])
def test_generate_writes_samples_from_a_trainer_run_dir(tmp_path, use_ema,
                                                        capsys):
    run = tmp_path / "run"
    _, ema, live = trained_run_dir(run)
    out = tmp_path / "samples"
    argv = ["--ckpt", str(run), "--out", str(out), "--n", "3", "--batch",
            "2", "--prompt", "a cat", "--codec", "dummy",
            "--image-size", "64", "--steps", "3", "--device", "cpu"]
    result = generate.main(argv + (["--use-ema"] if use_ema else []))
    assert result["step"] == 2 and result["samples"] == 3
    want = ema if use_ema else live
    for name, value in result["engine"].model.state_dict().items():
        assert torch.equal(value, want[name].float()), name
    lines = [json.loads(x) for x in open(out / "samples.jsonl")]
    assert [r["index"] for r in lines] == [0, 1, 2]
    assert all(r["text"] == "a cat" and r["nfe"] in (3, 4)
               for r in lines)
    pngs = sorted(p.name for p in out.glob("*.png"))
    assert pngs == ["sample_0000.png", "sample_0001.png", "sample_0002.png"]
    for name in pngs:
        assert decode_png((out / name).read_bytes()).shape == (64, 64, 3)
    assert f"restored step 2 ({'EMA' if use_ema else 'live'} params)" in \
        capsys.readouterr().out


def test_generate_without_a_codec_writes_only_text(tmp_path):
    run = tmp_path / "run"
    trained_run_dir(run)
    out = tmp_path / "samples"
    generate.main(["--ckpt", str(run), "--out", str(out), "--n", "2",
                   "--task", "joint", "--device", "cpu", "--quantize",
                   "int8"])
    assert len(open(out / "samples.jsonl").readlines()) == 2
    assert not list(out.glob("*.png"))


def test_generate_needs_a_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        generate.main(["--ckpt", str(tmp_path), "--device", "cpu",
                       "--out", str(tmp_path / "o")])


def test_generate_runs_on_the_card_unless_asked_for_the_cpu(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = tmp_path / "run"
    trained_run_dir(run)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate.main(["--ckpt", str(run), "--out", str(tmp_path / "o")])
