"""The data layer's tail against the JAX package's: ``data/prefetch.py``,
``data/precompute.py`` and ``data/hf_datasets.py``, on the CPU with local
files only.

* ``DevicePrefetcher`` hands out the loader's batches (as tensors, other
  entries passed through), raises a loader's exception in the consumer,
  and resumes exactly: a loader restored from its ``state_dict`` after 3
  batches continues with batch 4. JAX's wrapper returns the loader's live
  state, which its worker has moved past the batches training consumed.
* ``precompute_tokens`` and the CLI with the dummy codec write the same
  shards as JAX's, id for id.
* The local sources (an image folder, a generate run dir, unpaired
  pairing) give JAX's captions and images exactly (both resize with
  PIL); ``hf_stream`` and ``text_stream`` read a parquet dataset the test
  writes, through ``datasets.load_dataset`` offline, as JAX's do; a
  missing ``datasets`` or PIL raises an ImportError naming it.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from unidisc_tpu.data import hf_datasets as jax_hf
from unidisc_tpu.data import precompute as jax_pre
from unidisc_tpu.data.prefetch import DevicePrefetcher as JaxPrefetcher
from unidisc_tpu.tokenizers.image_codecs import get_codec as jax_codec
from unidisc_tpu.tokenizers.text import get_tokenizer as jax_tokenizer
from unidisc_tpu_torch.data import hf_datasets, precompute
from unidisc_tpu_torch.data.prefetch import DevicePrefetcher
from unidisc_tpu_torch.data.token_shards import (TokenShardDataset,
                                                 WeightedDatasetSampler,
                                                 write_shard)
from unidisc_tpu_torch.device import cap_test_threads
from unidisc_tpu_torch.tokenizers.image_codecs import get_codec
from unidisc_tpu_torch.tokenizers.text import get_tokenizer

cap_test_threads()


# ---------------------------------------------------------------------------
# DevicePrefetcher
# ---------------------------------------------------------------------------

def shard_loader(directory):
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 100, (40, 6)).astype(np.int32)
    write_shard(str(directory), tokens, (tokens % 2).astype(np.int8))
    return lambda: WeightedDatasetSampler(
        [TokenShardDataset(str(directory))], batch_size=4, seed=3)


def assert_batches_equal(got, want):
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert torch.is_tensor(got[key]) and got[key].device.type == "cpu"
            np.testing.assert_array_equal(got[key].numpy(), value)
        else:
            assert got[key] == value


def test_prefetcher_resumes_exactly_where_jax_skips(tmp_path):
    make = shard_loader(tmp_path / "shard")
    loader = make()
    straight = [next(loader) for _ in range(6)]

    pf = DevicePrefetcher(make(), device="cpu", depth=2)
    for i in range(3):
        assert_batches_equal(next(pf), straight[i])
    state = pf.state_dict()
    pf.close()
    assert state["step"] == 3
    again = DevicePrefetcher(make(), device="cpu", depth=2)
    again.load_state_dict(state)
    for i in range(3, 6):
        assert_batches_equal(next(again), straight[i])
    again.close()

    # JAX's wrapper: the live state of a loader its worker has read ahead
    jloader = make()
    jpf = JaxPrefetcher(jloader, depth=2)
    for i in range(3):
        np.testing.assert_array_equal(np.asarray(next(jpf)["input_ids"]),
                                      straight[i]["input_ids"])
    deadline = time.time() + 30
    while jloader.step < 5 and time.time() < deadline:
        time.sleep(0.01)
    jstate = jpf.state_dict()
    jpf.close()
    assert jstate["step"] >= 5          # ahead of the 3 consumed
    resumed = make()
    resumed.load_state_dict(jstate)
    assert not np.array_equal(next(resumed)["input_ids"],
                              straight[3]["input_ids"])


def test_prefetcher_raises_the_loaders_exception_and_ends():
    def loader():
        yield {"x": np.arange(3), "tag": "a"}
        raise RuntimeError("shard unreadable")

    pf = DevicePrefetcher(loader(), device="cpu")
    first = next(pf)
    assert first["tag"] == "a" and torch.equal(first["x"], torch.arange(3))
    with pytest.raises(RuntimeError, match="shard unreadable"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)
    done = DevicePrefetcher(iter([{"x": np.zeros(2)}]), device="cpu")
    assert len(list(done)) == 1
    assert done.state_dict() == {}       # a loader without state


# ---------------------------------------------------------------------------
# precompute
# ---------------------------------------------------------------------------

def read_shards(root):
    out = {}
    for d in sorted(os.listdir(root)):
        for name in ("tokens.npy", "modality.npy"):
            out[d, name] = np.load(os.path.join(root, d, name))
        with open(os.path.join(root, d, "meta.json")) as f:
            out[d, "meta"] = json.load(f)
    return out


def assert_same_shards(got_root, want_root):
    got, want = read_shards(got_root), read_shards(want_root)
    assert sorted(got) == sorted(want)
    for key in want:
        if key[1] == "meta":
            assert got[key] == want[key], key
        else:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_precompute_tokens_matches_jax(tmp_path):
    kw = dict(txt_length=16, batch_size=4, shard_size=4)
    want = jax_pre.precompute_tokens(
        jax_pre.procedural_samples(10, 32, seed=1), str(tmp_path / "jax"),
        tokenizer=jax_tokenizer("byte"),
        codec=jax_codec("dummy", image_size=32), text_vocab_size=300, **kw)
    got = precompute.precompute_tokens(
        precompute.procedural_samples(10, 32, seed=1),
        str(tmp_path / "port"), tokenizer=get_tokenizer("byte"),
        codec=get_codec("dummy", image_size=32, device="cpu"),
        text_vocab_size=300, **kw)
    assert [os.path.basename(d) for d in got] == \
        [os.path.basename(d) for d in want]
    assert len(got) == 3                 # 4 + 4 rows, then the last 2
    assert_same_shards(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_precompute_cli_matches_jax(tmp_path, capsys):
    args = ["--n", "6", "--image-size", "32", "--txt-length", "12",
            "--batch-size", "4", "--shard-size", "8"]
    jax_pre.main(["--out", str(tmp_path / "jax")] + args)
    dirs = precompute.main(["--out", str(tmp_path / "port"), "--device",
                            "cpu"] + args)
    assert len(dirs) == 1
    assert "wrote 1 shard(s)" in capsys.readouterr().out
    assert_same_shards(str(tmp_path / "port"), str(tmp_path / "jax"))


# ---------------------------------------------------------------------------
# hf_datasets
# ---------------------------------------------------------------------------

def write_png(path, size=24, seed=0):
    from PIL import Image
    arr = (np.random.RandomState(seed).rand(size, size, 3) * 255)
    Image.fromarray(arr.astype(np.uint8)).save(path)


def assert_pairs_equal(got, want):
    assert [c for c, _ in got] == [c for c, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_registries_are_jax_s():
    assert hf_datasets.DATASETS == jax_hf.DATASETS
    assert hf_datasets.TEXT_DATASETS == jax_hf.TEXT_DATASETS
    with pytest.raises(KeyError, match="unknown dataset"):
        next(hf_datasets.hf_image_caption_stream("no_such_set"))


def test_local_sources_match_jax(tmp_path):
    d = tmp_path / "folder" / "red_car"
    d.mkdir(parents=True)
    write_png(d / "a.png", seed=1)
    write_png(d / "b.png", seed=2)
    (d / "b.txt").write_text("a custom caption")
    (d / "c.png").write_bytes(b"not an image")     # skipped by both
    root = str(tmp_path / "folder")
    for limit in (None, 1):
        assert_pairs_equal(
            list(hf_datasets.imagefolder_stream(root, image_size=16,
                                                limit=limit)),
            list(jax_hf.imagefolder_stream(root, image_size=16,
                                           limit=limit)))
    assert len(list(hf_datasets.imagefolder_stream(root))) == 2

    run = tmp_path / "run"
    run.mkdir()
    write_png(run / "sample_0000.png", seed=3)
    write_png(run / "sample_0001.png", seed=4)
    (run / "samples.jsonl").write_text(
        json.dumps({"image": "sample_0000.png", "text": "a cat"})
        + "\n{not json\n"
        + json.dumps({"image": "sample_0001.png", "text": "a dog"}) + "\n")
    got = list(hf_datasets.generated_images_stream(str(run), image_size=8))
    assert_pairs_equal(got, list(jax_hf.generated_images_stream(
        str(run), image_size=8)))
    assert [c for c, _ in got] == ["a cat", "a dog"]

    imgs = [(f"orig{i}", np.full((2, 2, 3), i, np.float32))
            for i in range(6)]
    for n_text in (3, 10):
        texts = [f"t{i}" for i in range(n_text)]
        assert_pairs_equal(
            list(hf_datasets.unpaired_stream(iter(imgs), iter(texts),
                                             seed=2, buffer=2)),
            list(jax_hf.unpaired_stream(iter(imgs), iter(texts), seed=2,
                                        buffer=2)))


@pytest.fixture
def offline_datasets(tmp_path, monkeypatch):
    """datasets with the hub switched off and its cache under tmp_path."""
    for name in ("HF_DATASETS_OFFLINE", "HF_HUB_OFFLINE"):
        monkeypatch.setenv(name, "1")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf_home"))
    import datasets
    for name in ("HF_DATASETS_OFFLINE", "HF_HUB_OFFLINE"):
        monkeypatch.setattr(datasets.config, name, True)
    monkeypatch.setattr(datasets.config, "HF_DATASETS_CACHE",
                        tmp_path / "hf_home" / "datasets")
    return datasets


def test_hf_stream_reads_a_local_parquet_dataset_as_jax(tmp_path,
                                                        offline_datasets):
    datasets = offline_datasets
    from PIL import Image
    images = [Image.fromarray((np.random.RandomState(i).rand(20, 20, 3)
                               * 255).astype(np.uint8)) for i in range(4)]
    features = datasets.Features({
        "image": datasets.Image(),
        "caption": datasets.Value("string")})
    # a row without a caption is skipped
    ds = datasets.Dataset.from_dict(
        {"image": images, "caption": ["a cat", None, "a dog", ""]},
        features=features)
    (tmp_path / "pairs").mkdir()
    ds.to_parquet(str(tmp_path / "pairs" / "train.parquet"))
    path = str(tmp_path / "pairs")
    for limit in (None, 2):
        got = list(hf_datasets.hf_stream(path, "image", "caption",
                                         image_size=16, limit=limit))
        want = list(jax_hf.hf_stream(path, "image", "caption",
                                     image_size=16, limit=limit))
        assert_pairs_equal(got, want)
    assert [c for c, _ in got] == ["a cat", "a dog"]

    texts = datasets.Dataset.from_dict({"text": ["one", "", "two",
                                                 "three"]})
    (tmp_path / "texts").mkdir()
    texts.to_parquet(str(tmp_path / "texts" / "train.parquet"))
    tpath = str(tmp_path / "texts")
    assert list(hf_datasets.text_stream(tpath, limit=2)) == \
        list(jax_hf.text_stream(tpath, limit=2)) == ["one", "two"]
    with pytest.raises(RuntimeError, match="could not load"):
        next(hf_datasets.text_stream(str(tmp_path / "absent")))


def test_a_missing_package_raises_naming_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="'datasets'"):
        next(hf_datasets.text_stream(str(tmp_path)))
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError, match="'Pillow'"):
        next(hf_datasets.imagefolder_stream(str(tmp_path)))
