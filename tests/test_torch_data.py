"""The port's token-shard and streaming loaders against the JAX package's,
and the train CLI on them.

* TokenShardDataset / WeightedDatasetSampler and StreamingShardReader on
  shards the test writes (the port's writers; the JAX readers read them
  too): every batch bit-equal to the JAX loader's for the same seed,
  across epochs, and a loader restored from a mid-epoch state_dict
  continues the same sequence.
* ``train.py --data`` (two shard dirs, dataset_weights) and ``--stream``
  on the CPU: a run checkpointed mid-epoch and resumed logs the straight
  run's losses at the same steps, and its loader state equals the
  straight run's. ``--iterate-data-only`` reports the host tok/s.
"""

import json
import os

import numpy as np
import pytest

from unidisc_tpu.data import streaming as jstream
from unidisc_tpu.data import token_shards as jshards
from unidisc_tpu_torch import train as train_cli
from unidisc_tpu_torch.data import streaming as tstream
from unidisc_tpu_torch.data import token_shards as tshards
from unidisc_tpu_torch.training.checkpoint import CheckpointManager
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

TXT, IMG, TEXT_VOCAB, IMAGE_VOCAB = 8, 16, 24, 40


def rows(n, seed):
    rng = np.random.RandomState(seed)
    tokens = np.concatenate(
        [rng.randint(0, TEXT_VOCAB - 1, (n, TXT)),
         rng.randint(TEXT_VOCAB, TEXT_VOCAB + IMAGE_VOCAB, (n, IMG))],
        1).astype(np.int32)
    modality = np.concatenate([np.zeros((n, TXT)), np.ones((n, IMG))], 1)
    return tokens, modality


def assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), k
        else:
            assert got[k] == want[k], k


@pytest.fixture(scope="module")
def shard_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    dirs = []
    for i, n in enumerate((20, 13)):
        d = str(root / f"ds{i}")
        tshards.write_shard(d, *rows(n, seed=i), source=f"test{i}")
        dirs.append(d)
    stream = str(root / "stream")
    tokens, modality = rows(50, seed=7)
    tstream.write_stream_shards(stream, tokens, modality, rows_per_shard=12)
    return {"shards": dirs, "stream": stream}


def test_shard_writer_layout(shard_dirs):
    d = tshards.TokenShardDataset(shard_dirs["shards"][0])
    j = jshards.TokenShardDataset(shard_dirs["shards"][0])
    assert d.meta == j.meta == {"n": 20, "length": TXT + IMG,
                                "source": "test0"}
    assert isinstance(d.tokens, np.memmap)
    idx = np.asarray([3, 0, 19])
    assert_same(d.get(idx), j.get(idx))
    with open(os.path.join(shard_dirs["stream"], "stream_meta.json")) as f:
        assert json.load(f) == {"n": 50, "shards": 5, "length": TXT + IMG}


@pytest.mark.parametrize("weights,shuffle", [(None, True), ((0.3, 0.7), True),
                                             (None, False)])
def test_weighted_sampler_equals_jax(shard_dirs, weights, shuffle):
    def make(mod, seed=4):
        return mod.WeightedDatasetSampler(
            [mod.TokenShardDataset(d) for d in shard_dirs["shards"]],
            weights, batch_size=6, seed=seed, shuffle=shuffle)
    got, want = make(tshards), make(jshards)
    seen = set()
    for _ in range(12):          # several epochs of both datasets
        g, w = next(got), next(want)
        assert_same(g, w)
        seen.add(g["dataset_idx"])
    assert seen == {0, 1}
    assert got.state_dict() == want.state_dict() == {"step": 12, "seed": 4}
    # a sampler restored mid-epoch continues the sequence
    resumed = make(tshards, seed=0)
    resumed.load_state_dict(got.state_dict())
    for _ in range(5):
        assert_same(next(resumed), next(want))


@pytest.mark.parametrize("process_index,process_count", [(0, 1), (1, 2)])
def test_stream_reader_equals_jax(shard_dirs, process_index, process_count):
    def make(mod, seed=3):
        return mod.StreamingShardReader(
            shard_dirs["stream"], batch_size=5, seed=seed,
            process_index=process_index, process_count=process_count)
    got, want = make(tstream), make(jstream)
    got_it, want_it = iter(got), iter(want)
    states = []
    for _ in range(14):          # past the end of an epoch
        assert_same(next(got_it), next(want_it))
        states.append(got.state_dict())
        assert states[-1] == want.state_dict()
    assert states[-1]["epoch"] >= 1
    # restored from a mid-shard state, the reader continues exactly
    mid = next(s for s in states if s["row_cursor"] and s["epoch"] == 0)
    k = states.index(mid)
    resumed = make(tstream, seed=0)
    resumed.load_state_dict(mid)
    again = make(jstream)
    again_it = iter(again)
    for _ in range(k + 1):
        next(again_it)
    for g, w in zip(iter(resumed), again_it):
        assert_same(g, w)
        if resumed.state_dict() == states[-1]:
            break
    else:
        raise AssertionError("the resumed reader ended")


def test_interleaved_streams_raise(tmp_path):
    """Ragged shards stream since the interleaved slice (tests/
    test_torch_interleaved.py); a ragged dir without pack_length, a dir
    mixing both kinds and an unknown packer still raise."""
    (tmp_path / "ishard-00000.npz").write_bytes(b"")
    with pytest.raises(ValueError, match="pack_length"):
        tstream.StreamingShardReader(str(tmp_path))
    with pytest.raises(ValueError, match="packer"):
        tstream.StreamingShardReader(str(tmp_path), pack_length=8,
                                     packer="rust")
    (tmp_path / "shard-00000.npz").write_bytes(b"")
    with pytest.raises(ValueError, match="mixes"):
        tstream.StreamingShardReader(str(tmp_path), pack_length=8)


def cli(run_dir, data, *extra):
    return ["--device", "cpu", "--run-dir", run_dir, "--data", data,
            "--batch-size", "4", "--log-every", "1", "model=tiny",
            "model.length=24", "model.txt_length=8", "model.img_length=16",
            f"model.text_vocab_size={TEXT_VOCAB}",
            f"model.image_vocab_size={IMAGE_VOCAB}", "model.hidden_size=64",
            "model.n_heads=1", "model.n_blocks=1", "model.dropout=0.0",
            "model.modality_embed=True", "trainer.warmup_steps=1",
            "trainer.lr=1e-3", *extra]


def losses(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)
                if "loss" in r}


@pytest.mark.parametrize("stream", [False, True])
def test_train_cli_on_shards_resumes_exactly(shard_dirs, tmp_path, stream,
                                             capsys):
    data = shard_dirs["stream"] if stream else ",".join(shard_dirs["shards"])
    extra = ["--stream"] if stream else ["data.dataset_weights=(1.0,2.0)"]
    extra += ["trainer.parameterization=ar", "trainer.ar_shift=True",
              "model.full_attention=False", "model.time_conditioning=False",
              "trainer.ar_inpainting=True", "trainer.rand_flip_ar_prob=0.5"]
    straight = str(tmp_path / "straight")
    result = train_cli.main(cli(straight, data, "trainer.max_steps=5",
                                "--ckpt-every", "0", *extra))
    assert result["step"] == 5
    # 2 steps, then a resume to 5 from the step-2 checkpoint
    split = str(tmp_path / "split")
    train_cli.main(cli(split, data, "trainer.max_steps=2", "--ckpt-every",
                       "2", *extra))
    train_cli.main(cli(split, data, "trainer.max_steps=5", "--ckpt-every",
                       "0", *extra))
    want, got = losses(straight), losses(split)
    assert sorted(got) == [1, 2, 3, 4, 5]
    for step in range(1, 6):
        assert got[step] == want[step], step
    mgr_a = CheckpointManager(os.path.join(straight, "checkpoints"))
    mgr_b = CheckpointManager(os.path.join(split, "checkpoints"))
    assert mgr_a.read_meta(5)["loader"] == mgr_b.read_meta(5)["loader"]
    assert "resumed from step 2" in capsys.readouterr().out


def test_iterate_data_only_and_length_warning(shard_dirs, tmp_path, capsys):
    out = train_cli.main(cli(str(tmp_path), shard_dirs["shards"][0],
                             "--iterate-data-only", "3",
                             "model.length=32", "model.img_length=24"))
    assert out["step"] == 0 and out["data_tok_per_s"] > 0
    text = capsys.readouterr().out
    assert "data-only: 3 batches" in text
    assert "WARNING: model.length=32" in text
