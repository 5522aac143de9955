"""The port's data loader, Trainer, checkpoints and CLI on the CPU.

SyntheticDataLoader must equal the JAX package's byte for byte. The
Trainer runs a tiny model on the CPU (the kernels' plain versions); a run
saved at step 2 and resumed to step 3 must equal 3 steps straight exactly,
because each step's generator is seeded from the step and the checkpoint
holds the whole state.
"""

import json
import os

import types

import numpy as np
import pytest
import torch

from unidisc_tpu.config import Config as JaxConfig
from unidisc_tpu.data.synthetic import SyntheticDataLoader as JaxLoader
from unidisc_tpu_torch import train as train_cli
from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.data.synthetic import SyntheticDataLoader
from unidisc_tpu_torch.training.checkpoint import CheckpointManager
from unidisc_tpu_torch.training.trainer import Trainer
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

SMALL = {"model.length": 24, "model.txt_length": 8, "model.img_length": 16,
         "model.text_vocab_size": 24, "model.image_vocab_size": 40,
         "model.hidden_size": 64, "model.n_heads": 1, "model.dropout": 0.0,
         "model.time_conditioning": True, "model.modality_embed": True,
         "model.force_argmax_valid_indices": True,
         "trainer.warmup_steps": 1, "trainer.lr": 1e-3,
         "trainer.mask_entire_modality": 0.15}


def config(**extra):
    return Config.make("tiny", **{**SMALL, **extra})


@pytest.mark.parametrize("structured", [True, False])
def test_synthetic_loader_equals_jax(structured):
    jl = JaxLoader(JaxConfig.make("tiny", **SMALL), 3, seed=5,
                   vocab_structured=structured)
    tl = SyntheticDataLoader(config(), 3, seed=5,
                             vocab_structured=structured)
    for _ in range(3):
        want, got = next(jl), next(tl)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes()
    tl2 = SyntheticDataLoader(config(), 3, seed=0,
                              vocab_structured=structured)
    tl2.load_state_dict(tl.state_dict())
    assert next(tl2)["input_ids"].tobytes() == next(jl)["input_ids"].tobytes()


def test_fit_runs_three_steps_on_cpu(tmp_path):
    cfg = config()
    trainer = Trainer(cfg, str(tmp_path), device="cpu", log_every=1)
    before = {k: v.detach().clone() for k, v in trainer.state.params.items()}
    result = trainer.fit(SyntheticDataLoader(cfg, 4, seed=cfg.seed),
                         max_steps=3)
    trainer.close()
    assert result["step"] == 3 and np.isfinite(result["loss"])
    assert int(trainer.state.step) == 3
    assert any(not torch.equal(v, before[k])
               for k, v in trainer.state.params.items())
    lines = [json.loads(x) for x in
             open(os.path.join(tmp_path, "metrics.jsonl"))]
    assert [r["step"] for r in lines] == [1, 2, 3]
    assert all(r["step_s"] > 0 for r in lines)
    assert CheckpointManager(str(tmp_path / "checkpoints")).all_steps() == [3]


def test_resume_equals_straight_run(tmp_path):
    cfg = config()
    straight = Trainer(cfg, str(tmp_path / "a"), device="cpu", log_every=1)
    straight.fit(SyntheticDataLoader(cfg, 4, seed=cfg.seed), max_steps=3)

    first = Trainer(cfg, str(tmp_path / "b"), device="cpu", log_every=1)
    first.fit(SyntheticDataLoader(cfg, 4, seed=cfg.seed), max_steps=2)
    resumed = Trainer(cfg, str(tmp_path / "b"), device="cpu", log_every=1)
    loader = SyntheticDataLoader(cfg, 4, seed=123)   # state comes from meta
    out = resumed.fit(loader, max_steps=3)
    assert out["step"] == 3 and loader.step == 3

    want = straight.state.state_dict()
    got = resumed.state.state_dict()
    for key in ("params", "ema_params", "mu", "nu"):
        for name in want[key]:
            assert torch.equal(got[key][name], want[key][name]), (key, name)
    for key in ("step", "adam_count", "schedule_count"):
        assert int(got[key]) == int(want[key]) == 3
    losses = [[json.loads(x)["loss"] for x in open(tmp_path / d /
                                                  "metrics.jsonl")]
              for d in ("a", "b")]
    assert losses[1] == losses[0]       # steps 1, 2 then the resumed 3


def test_checkpoint_retention_and_meta(tmp_path):
    cfg = config()
    trainer = Trainer(cfg, str(tmp_path), device="cpu", log_every=100,
                      ckpt_every=1, max_ckpts=2)
    trainer.fit(SyntheticDataLoader(cfg, 2, seed=1), max_steps=3)
    mgr = trainer.ckpt
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    meta = mgr.read_meta()
    assert meta["step"] == 3 and meta["loader"]["step"] == 3
    assert Config.from_json(json.dumps(meta["config"])) == cfg
    assert not mgr.save(3, trainer.state, cfg, force=True)   # exists


def test_validate_aggregates_eval_metrics(tmp_path):
    cfg = config()
    trainer = Trainer(cfg, str(tmp_path), device="cpu", log_every=100)
    out = trainer.validate(SyntheticDataLoader(cfg, 2, seed=9), step=0,
                           max_batches=2)
    assert set(out) == {"val/loss", "val/nll", "val/bpd", "val/ppl",
                        "val/txt_ppl", "val/img_bpd"}
    assert all(np.isfinite(v) for v in out.values())
    again = trainer.validate(SyntheticDataLoader(cfg, 2, seed=9), step=0,
                             max_batches=2)
    assert again == out          # the eval draws are seeded per batch


def test_unported_trainer_options_raise(tmp_path):
    # LoRA and host offload are ported (tests/test_torch_lora.py,
    # tests/test_torch_offload.py), and meshes over every axis
    # (tests/test_torch_mesh.py, tests/test_torch_seq_parallel.py); wandb
    # and a mesh with ep inside a pipeline stage still raise
    cfg = config()
    with pytest.raises(NotImplementedError):
        Trainer(cfg, str(tmp_path), device="cpu", use_wandb=True)
    from unidisc_tpu_torch.parallel.mesh import AXES
    for axis in ("fsdp", "tensor"):
        sizes = {a: 2 if a in (axis, "pp", "ep") else 1 for a in AXES}
        mesh = types.SimpleNamespace(mesh_dim_names=AXES,
                                     size=lambda i: sizes[AXES[i]])
        with pytest.raises(NotImplementedError, match="item 9"):
            Trainer(cfg, str(tmp_path), device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="LoRA"):
        Trainer(cfg, str(tmp_path), device="cpu", base_params={})
    # JAX's own refusals: host offload is a single-device mode (its
    # Trainer asserts so), and validate() refuses img_cond under "seq"
    sizes = {a: 2 if a == "fsdp" else 1 for a in AXES}
    mesh = types.SimpleNamespace(mesh_dim_names=AXES,
                                 size=lambda i: sizes[AXES[i]])
    with pytest.raises(ValueError, match="single-device mode"):
        Trainer(cfg.override(**{"trainer.host_offload_optimizer": True}),
                str(tmp_path), device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="img_cond is not wired"):
        cfg.override(**{"model.img_cond": True,
                        "model.cond_image_vocab_size": 8,
                        "model.cond_length": 4, "model.qk_norm": False,
                        "model.sandwich_normalization": False,
                        "model.rope_2d": False, "mesh.seq": 2}).validate()


def test_train_cli_runs_on_cpu(tmp_path, capsys):
    argv = ["--device", "cpu", "--run-dir", str(tmp_path), "--batch-size",
            "2", "--log-every", "1", "--overfit", "model=tiny",
            *(f"{k}={v}" for k, v in SMALL.items()), "trainer.max_steps=2"]
    result = train_cli.main(argv)
    assert result["step"] == 2 and np.isfinite(result["loss"])
    assert "[train] done at step 2" in capsys.readouterr().out
    assert train_cli.parse_overrides(["model=tiny", "trainer.lr=0.1",
                                      "data.dataset=x"]) == (
        "tiny", {"trainer.lr": 0.1, "data.dataset": "x"})


def test_train_cli_takes_every_flag_of_jax_train_py():
    """Every flag of JAX's train.py (its add_argument calls) but --wandb
    (unported: not installed, and no network) parses in the port's CLI."""
    import ast
    import inspect

    from unidisc_tpu import train as jax_train_cli
    tree = ast.parse(inspect.getsource(jax_train_cli))
    flags = {a.value for node in ast.walk(tree)
             if isinstance(node, ast.Call)
             and getattr(node.func, "attr", None) == "add_argument"
             for a in node.args if isinstance(a, ast.Constant)}
    assert "--print-hashes" in flags and len(flags) > 5
    known = set(train_cli.build_parser()._option_string_actions)
    assert flags - {"--wandb"} <= known, flags - known


def test_train_cli_prints_the_param_hash(tmp_path, capsys):
    """--print-hashes prints one param_hash line before the first step: the
    same for the same seed, another for another seed."""
    hashes = []
    for i, seed in enumerate((0, 0, 1)):
        train_cli.main(["--device", "cpu", "--run-dir", str(tmp_path / str(i)),
                        "--batch-size", "2", "--print-hashes",
                        "model=tiny", *(
                            f"{k}={v}" for k, v in SMALL.items()),
                        f"seed={seed}", "trainer.max_steps=1"])
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if "param_hash=" in ln]
        assert len(lines) == 1 and lines[0].startswith(
            "[trainer] param_hash="), lines
        hashes.append(lines[0].split("=")[1].split()[0])
    assert len(hashes[0]) == 16
    assert hashes[0] == hashes[1] != hashes[2]


def test_cuda_is_the_default_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(config(), str(tmp_path))
