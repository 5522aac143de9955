"""Interleaved documents in the port against the JAX package: packing,
the native packer, tokenization, the ragged stream reader, the DIT's
packed-batch arguments, a train step on a packed batch, and
run_interleaved behind the engine and the HTTP server.

* pack_documents, unpack_rows, tokenize_interleaved, write_interleaved_shard
  / docs_from_ishard and the ishard reader's batches (and its mid-epoch
  resume) equal JAX's bit for bit; the native packer equals the Python
  packer on fuzzed documents (hypothesis).
* The DIT with sample_ids, rope_index (the [text | image] table and the
  multi-resolution one), img_block_index (img_count_embed) and
  extra_embed against JAX's at identical weights: atol 2e-4, rtol 1e-3,
  the DIT file's tolerance (fp32 on both sides, summation order only).
  JAX runs its attention as it chooses for the case: XLA with the dense
  sample-ids mask (its auto choice at L 32), or the Pallas kernel in
  interpret mode; the port runs its kernel path (the plain versions on
  the CPU). Padded rows (sample id -1) attend to nothing on both backends
  (XLA's -inf rows become 0 through nan_to_num, the kernels define them
  as 0), so every row is compared.
* One whole train step on a packed batch with the JAX draws replayed
  (the interleaved block mask's draw included), at the train-step file's
  tolerance: JAX with its Pallas kernels in interpret mode (its XLA path
  gives NaN gradients on a padded query row: softmax of an all -inf row).
* run_interleaved: both engines over the same weights and codec, the
  samplers under the same injected noise, give the same document (text,
  image ids, NFE; PNGs to one step of 255), and so does the port's HTTP
  server; under model.img_resolutions the port's image rope indices carry
  the block's offset, where JAX's engine writes raw raster indices.
"""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from hypothesis import given, settings
from hypothesis import strategies as st

from unidisc_tpu.config import Config as JaxConfig
from unidisc_tpu.data import interleaved as jil
from unidisc_tpu.data import streaming as jstream
from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.sampling.sampler import build_sampler as jax_build_sampler
from unidisc_tpu.serving.engine import InferenceEngine as JaxEngine
from unidisc_tpu.tokenizers.interleaved_text import \
    tokenize_interleaved as jax_tokenize_interleaved
from unidisc_tpu.tokenizers.text import ByteTokenizer as JaxByteTokenizer
from unidisc_tpu.training import train_state as jts
from unidisc_tpu_torch import train as train_cli
from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.data import interleaved as til
from unidisc_tpu_torch.data import streaming as tstream
from unidisc_tpu_torch.data.native_packer import pack_documents_native
from unidisc_tpu_torch.device import cap_test_threads
from unidisc_tpu_torch.models.dit import DIT
from unidisc_tpu_torch.models.port import (dit_state_dict_from_jax,
                                           train_state_from_jax)
from unidisc_tpu_torch.models.rotary import build_multires_rope
from unidisc_tpu_torch.sampling.sampler import build_sampler
from unidisc_tpu_torch.serving import server
from unidisc_tpu_torch.serving.engine import InferenceEngine
from unidisc_tpu_torch.tokenizers.interleaved_text import \
    tokenize_interleaved
from unidisc_tpu_torch.tokenizers.text import ByteTokenizer
from unidisc_tpu_torch.training import train_state as tts
from test_torch_dit import OVERRIDES
from test_torch_engine import png_pixels, tiny_codecs
from test_torch_train_step import TINY, compare_states, loss_draws

cap_test_threads()

ATOL, RTOL = 2e-4, 1e-3
PAD, EOS = 0, 2
L = 32
TEXT_VOCAB, IMAGE_VOCAB = 64, 64
PACKED = {"model.length": L, "model.txt_length": L, "model.img_length": 16,
          "model.text_vocab_size": TEXT_VOCAB,
          "model.image_vocab_size": IMAGE_VOCAB, "trainer.interleaved": True}


# ---------------------------------------------------------------------------
# documents
# ---------------------------------------------------------------------------

def random_docs(seed, n=6, grids=(4,), text_max=6):
    """Documents from a seeded generator: text spans of 1..text_max ids
    and 0..2 images of the given grids, in a random order."""
    rng = np.random.RandomState(seed)
    docs = []
    for _ in range(n):
        segs = []
        for _ in range(rng.randint(1, 4)):
            if rng.rand() < 0.5:
                g = int(rng.choice(grids))
                segs.append(("image", TEXT_VOCAB + rng.randint(
                    0, IMAGE_VOCAB, g * g), g))
            else:
                segs.append(("text", rng.randint(3, TEXT_VOCAB,
                                                 rng.randint(1, text_max + 1)
                                                 )))
        docs.append(segs)
    return docs


def both_docs(spec):
    """The same documents as JAX's and the port's Document objects."""
    return ([jil.make_document(interleave=d) for d in spec],
            [til.make_document(interleave=d) for d in spec])


def assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


PACK_CASES = {
    "eos": dict(length=32, eos_id=EOS),
    "no_eos_batch": dict(length=32, eos_id=None, batch_size=5),
    "truncated_cut_rows": dict(length=20, eos_id=EOS, batch_size=2),
    "multires": dict(length=48, eos_id=EOS, multires=True),
}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_and_unpack_match_jax(case):
    kw = dict(PACK_CASES[case])
    multires = kw.pop("multires", False)
    grids = (2, 4) if multires else (4,)
    spec = random_docs(3, n=8, grids=grids, text_max=12)
    if case.startswith("truncated"):
        # a document longer than a row: cut at a segment boundary
        spec.append([("text", np.arange(3, 12)),
                     ("image", TEXT_VOCAB + np.arange(16), 4)])
    if multires:
        kw["rope_offsets"] = build_multires_rope(kw["length"], (4, 16),
                                                 64)[2]
    jdocs, tdocs = both_docs(spec)
    want = jil.pack_documents(jdocs, pad_id=PAD, **kw)
    got = til.pack_documents(tdocs, pad_id=PAD, **kw)
    assert_batches_equal(got, want)
    assert (got["sample_ids"] < 0).any()
    for g_row, w_row in zip(til.unpack_rows(got), jil.unpack_rows(want)):
        assert [e["sample_id"] for e in g_row] == \
            [e["sample_id"] for e in w_row]
        for ge, we in zip(g_row, w_row):
            assert [s["kind"] for s in ge["segments"]] == \
                [s["kind"] for s in we["segments"]]
            for gs, ws in zip(ge["segments"], we["segments"]):
                np.testing.assert_array_equal(gs["ids"], ws["ids"])


def documents_strategy():
    seg = st.one_of(
        st.tuples(st.just("text"), st.lists(st.integers(3, 500), min_size=0,
                                            max_size=40)),
        st.tuples(st.just("image"), st.sampled_from([1, 2, 4, 8])))
    return st.lists(st.lists(seg, min_size=0, max_size=5), min_size=0,
                    max_size=12)


@settings(max_examples=60, deadline=None)
@given(documents_strategy(), st.integers(1, 90), st.booleans(),
       st.sampled_from([None, 1, 3, 20]), st.booleans())
def test_native_packer_equals_python_packer_fuzzed(spec, length, eos,
                                                   batch_size, multires):
    offsets = {1: 100, 4: 101, 16: 105, 64: 121} if multires else None
    docs = []
    for d in spec:
        segs = []
        for kind, arg in d:
            if kind == "text":
                segs.append(til.Segment("text", np.asarray(arg, np.int32)))
            else:
                segs.append(til.Segment("image", np.arange(
                    arg * arg, dtype=np.int32) + 600, arg))
        docs.append(til.Document(segs))
    kw = dict(pad_id=PAD, eos_id=EOS if eos else None,
              batch_size=batch_size, rope_offsets=offsets)
    want = til.pack_documents(docs, length, **kw)
    assert_batches_equal(pack_documents_native(docs, length, **kw), want)


def test_tokenize_interleaved_matches_jax():
    blocks = [np.arange(16) % 7, np.arange(4)]
    prompt = "a photo <image> of two <image> cats"
    want = jax_tokenize_interleaved(prompt, blocks, JaxByteTokenizer(),
                                    text_vocab_size=300, grid=4)
    got = tokenize_interleaved(prompt, blocks, ByteTokenizer(),
                               text_vocab_size=300, grid=4)
    assert [(s.kind, s.grid) for s in got.segments] == \
        [(s.kind, s.grid) for s in want.segments]
    for g, w in zip(got.segments, want.segments):
        np.testing.assert_array_equal(g.ids, w.ids)
    with pytest.raises(ValueError, match="slots"):
        tokenize_interleaved(prompt, blocks[:1], ByteTokenizer(),
                             text_vocab_size=300)


def write_ishards(directory, writer, docs, n_shards=3):
    per = len(docs) // n_shards
    for s in range(n_shards):
        writer(str(directory), docs[s * per:(s + 1) * per], shard_index=s)


@pytest.mark.parametrize("packer", ["native", "python"])
def test_ishard_reader_matches_jax_and_resumes(tmp_path, packer):
    """Shards written by each package read back to the same documents;
    the port's reader (either packer) gives JAX's batches over two epochs;
    a reader restored mid-epoch gives the rest of the sequence."""
    spec = random_docs(5, n=36)
    jdocs, tdocs = both_docs(spec)
    write_ishards(tmp_path / "jax", jstream.write_interleaved_shard, jdocs)
    write_ishards(tmp_path / "port", tstream.write_interleaved_shard, tdocs)
    for s in range(3):
        name = f"ishard-{s:05d}.npz"
        with np.load(tmp_path / "jax" / name) as a, \
                np.load(tmp_path / "port" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        got = tstream.docs_from_ishard(str(tmp_path / "port" / name))
        want = jstream.docs_from_ishard(str(tmp_path / "port" / name))
        assert [[(x.kind, x.grid, x.ids.tolist()) for x in d.segments]
                for d in got] == \
            [[(x.kind, x.grid, x.ids.tolist()) for x in d.segments]
             for d in want]
    kw = dict(batch_size=3, seed=4, pack_length=L, eos_id=EOS)
    jreader = jstream.StreamingShardReader(str(tmp_path / "jax"), **kw)
    reader = tstream.StreamingShardReader(str(tmp_path / "port"),
                                          packer=packer, **kw)
    n = 12
    want = [b for _, b in zip(range(n), iter(jreader))]
    it = iter(reader)
    got, states = [], []
    for _ in range(n):
        got.append(next(it))
        states.append(reader.state_dict())
    assert reader.epoch >= 1        # the sequence crossed an epoch
    for g, w in zip(got, want):
        assert_batches_equal(g, w)
    again = tstream.StreamingShardReader(str(tmp_path / "port"),
                                         packer=packer, **{**kw, "seed": 0})
    again.load_state_dict(states[4])
    for g, w in zip(iter(again), got[5:]):
        assert_batches_equal(g, w)
        if again.state_dict() == states[-1]:
            break
    assert again.state_dict() == states[-1]


def test_train_cli_streams_ishards_with_rope_offsets(tmp_path):
    """make_loaders packs at model.length with EOS 2, as JAX's train.py;
    under model.img_resolutions it passes the combined table's offsets,
    which JAX's train.py leaves out (ROADMAP section 3)."""
    _, tdocs = both_docs(random_docs(1, n=6))
    tstream.write_interleaved_shard(str(tmp_path), tdocs)
    cfg = Config.make("tiny", **PACKED)
    reader, val = train_cli.make_loaders(cfg, 2, str(tmp_path), stream=True)
    assert (reader.pack_length, reader.eos_id, reader.rope_offsets) == \
        (L, EOS, None)
    assert val.seed == reader.seed + 777
    cfg = Config.make("tiny", **PACKED,
                      **{"model.img_resolutions": (4, 16)})
    reader, _ = train_cli.make_loaders(cfg, 2, str(tmp_path), stream=True)
    assert reader.rope_offsets == {4: L, 16: L + 4}


# ---------------------------------------------------------------------------
# the DIT's packed-batch arguments
# ---------------------------------------------------------------------------

def abstract_random_params(jcfg, seed=0):
    """Every parameter of the JAX DIT drawn from its abstract shape: norm
    scales near 1, everything else small (the image-count table too, which
    the init zeroes)."""
    m = jcfg.model
    shapes = jax.eval_shape(lambda k: JaxDIT(m, compute_dtype=jnp.float32)
                            .init({"params": k},
                                  jnp.zeros((1, m.length), jnp.int32),
                                  jnp.zeros((1,)),
                                  modality=jnp.zeros((1, m.length),
                                                     jnp.int32))["params"],
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in traverse_util.flatten_dict(shapes, sep="/").items():
        if k.endswith(("weight", "scale")):
            arr = 1.0 + 0.1 * rng.standard_normal(v.shape)
        else:
            fan = v.shape[-2] if len(v.shape) >= 2 else v.shape[-1]
            arr = rng.standard_normal(v.shape) / np.sqrt(fan)
        out[k] = jnp.asarray(arr, jnp.float32)
    return traverse_util.unflatten_dict(out, sep="/")


DIT_CASES = {
    # JAX: XLA with the dense mask; image-count rows and an extra embedding
    "auto_count_extra": {"model.img_count_embed": True,
                         "model.max_images_per_sample": 4},
    "xla_both": {"model.attn_backend": "xla"},
    "pallas_interpret": {"model.attn_backend": "pallas"},
    "causal": {"model.full_attention": False},
    "multires": {"model.img_resolutions": (4, 16)},
}


def packed_batch(multires=False, seed=7):
    grids = (2, 4) if multires else (4,)
    offsets = build_multires_rope(L, (4, 16), 64)[2] if multires else None
    # and a document with two images (img_block_index 0 and 1)
    spec = random_docs(seed, n=6, grids=grids) + [[
        ("text", [5, 6]), ("image", TEXT_VOCAB + np.arange(4), 2),
        ("image", TEXT_VOCAB + 7 + np.arange(4), 2)]]
    _, tdocs = both_docs(spec)
    return til.pack_documents(tdocs, L, pad_id=PAD, eos_id=EOS,
                              batch_size=4, rope_offsets=offsets)


@pytest.mark.parametrize("case", sorted(DIT_CASES))
def test_packed_forward_matches_jax(case):
    over = {**OVERRIDES, **PACKED, **DIT_CASES[case]}
    jcfg, tcfg = JaxConfig.make("tiny", **over), Config.make("tiny", **over)
    params = abstract_random_params(jcfg)
    batch = packed_batch(multires=case == "multires")
    assert (batch["sample_ids"] == -1).any(axis=1).all()
    b = batch["input_ids"].shape[0]
    sigma = np.linspace(0.2, 2.0, b).astype(np.float32)
    kw = {k: batch[k] for k in ("modality", "sample_ids", "rope_index")}
    if case == "auto_count_extra":
        kw["img_block_index"] = batch["img_block_index"]
        assert kw["img_block_index"].max() >= 1
        kw["extra_embed"] = np.random.RandomState(1).standard_normal(
            (b, L, 128)).astype(np.float32)
    want, want_h = JaxDIT(jcfg.model, compute_dtype=jnp.float32).apply(
        {"params": params}, jnp.asarray(batch["input_ids"]),
        jnp.asarray(sigma), return_hidden=True,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    model = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    model.load_state_dict(dit_state_dict_from_jax(params))
    with torch.no_grad():
        got, got_h = model(torch.from_numpy(batch["input_ids"]).long(),
                           torch.from_numpy(sigma), return_hidden=True,
                           **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=ATOL,
                               rtol=RTOL)


def test_samples_are_isolated_in_the_port():
    """Changing one sample's tokens leaves another sample's logits in the
    same row bit for bit (the kernel path, segment ids)."""
    over = {**OVERRIDES, **PACKED}
    tcfg = Config.make("tiny", **over)
    model = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    from unidisc_tpu_torch.models.dit import randomize_
    randomize_(model, 0)
    batch = {k: torch.from_numpy(v) for k, v in packed_batch().items()}
    sids = batch["sample_ids"][0]
    first, other = sids[0].item(), sids[sids != sids[0]][0].item()
    assert other >= 0
    ids = batch["input_ids"].long()
    ids2 = ids.clone()
    ids2[0, sids == other] = 5
    kw = {k: batch[k] for k in ("modality", "sample_ids", "rope_index")}
    with torch.no_grad():
        a = model(ids, torch.ones(4), **kw)
        b = model(ids2, torch.ones(4), **kw)
    assert torch.equal(a[0, sids == first], b[0, sids == first])
    assert not torch.equal(a[0, sids == other], b[0, sids == other])


def test_train_step_on_a_packed_batch_matches_jax():
    over = {**TINY, **PACKED, "model.attn_backend": "pallas"}
    jcfg = JaxConfig.make("tiny", **over).validate()
    tcfg = Config.make("tiny", **{**over, "model.attn_backend": "auto"}
                       ).validate()
    assert jcfg.trainer.mask_entire_modality     # the block mask runs
    params = abstract_random_params(jcfg, seed=2)
    batch = packed_batch(seed=11)
    jstate = jts.init_train_state(jcfg, params)
    rng = jax.random.PRNGKey(7)
    jnew, jm = jax.jit(jts.make_train_step(
        jcfg, JaxDIT(jcfg.model, compute_dtype=jnp.float32)))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    model = DIT(tcfg.model, compute_dtype=torch.float32)
    state = tts.init_train_state(tcfg, model)
    state.load_state_dict(train_state_from_jax(jax.device_get(jstate)))
    step_rng = jax.random.fold_in(rng, 0)
    draws = loss_draws(step_rng, 4, jcfg.model)
    rng_mask = jax.random.split(step_rng, 3)[1]
    draws["block"] = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(rng_mask, 3), (4, L))))
    state, m = tts.make_train_step(tcfg, model)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        draws=draws)
    assert np.isfinite(float(jm.loss)) and float(jm.grad_norm) > 0
    compare_states(jnew, jm, state, m)


# ---------------------------------------------------------------------------
# run_interleaved behind the engine and the server
# ---------------------------------------------------------------------------

STEPS = 4
ENGINE = {**OVERRIDES, "model.length": 48, "model.txt_length": 48,
          "model.img_length": 16, "model.text_vocab_size": 300,
          "model.image_vocab_size": 64, "trainer.interleaved": True,
          "model.force_argmax_valid_indices": True,
          "sampling.predictor": "maskgit", "sampling.steps": STEPS,
          "sampling.cfg": 2.0}


def document():
    pixel_mask = np.zeros((8, 8), bool)
    pixel_mask[:4, :4] = True          # the top-left 2 x 2 tokens
    return [{"kind": "text", "text": "two cats"},
            {"kind": "image", "ids": (np.arange(16) * 5) % 64,
             "pixel_mask": pixel_mask},
            {"kind": "text", "generate": 4},
            {"kind": "image", "generate": True, "grid": 4}]


def injected_noise(m, seed=3):
    rng = np.random.RandomState(seed)
    return {"exp": rng.exponential(size=(STEPS, 1, m.length, m.vocab_size)
                                   ).astype(np.float32),
            "gumbel": rng.gumbel(size=(STEPS, 1, m.length)
                                 ).astype(np.float32)}


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's over the same weights and codec,
    each sampler under the same injected noise; the JAX sampler records
    the rows it is given."""
    jcfg = JaxConfig.make("tiny", **ENGINE)
    tcfg = Config.make("tiny", **ENGINE)
    params = abstract_random_params(jcfg, seed=4)
    jcodec, codec = tiny_codecs()
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    jeng = JaxEngine(jcfg, jmodel, params, codec=jcodec)
    model = DIT(tcfg.model, compute_dtype=torch.float32)
    model.load_state_dict(dit_state_dict_from_jax(params))
    eng = InferenceEngine(tcfg, model, codec=codec, device="cpu")
    noise = injected_noise(tcfg.model)
    seen = {}

    def jax_sampler(steps=None):
        def run(p, rng, x0, unmask, modality, sample_ids, rope_index):
            seen.update(x0=x0, unmask=unmask, modality=modality,
                        sample_ids=sample_ids, rope_index=rope_index)

            def fwd(p, x, sigma, mm):
                reps = x.shape[0] // sample_ids.shape[0]
                return jmodel.apply(
                    {"params": p}, x, sigma, modality=mm,
                    sample_ids=jnp.tile(sample_ids, (reps, 1)),
                    rope_index=jnp.tile(rope_index, (reps, 1)))
            sample = jax_build_sampler(fwd, jcfg, num_steps=steps or STEPS,
                                       inject_noise=True)
            return sample(p, rng, x0, unmask, modality,
                          {k: jnp.asarray(v) for k, v in noise.items()})
        return run

    def port_sampler(steps=None):
        sample = build_sampler(eng.model, tcfg, num_steps=steps or STEPS,
                               inject_noise=True, device="cpu", packed=True)

        def run(*inputs, seed):
            return sample(*inputs, injected={
                k: torch.from_numpy(v) for k, v in noise.items()})
        return run

    jeng._interleaved_sampler = jax_sampler
    eng._interleaved_sampler = port_sampler
    return {"jax": jeng, "port": eng, "seen": seen}


def assert_same_document(got, want):
    assert [s["kind"] for s in got["segments"]] == \
        [s["kind"] for s in want["segments"]]
    for g, w in zip(got["segments"], want["segments"]):
        if g["kind"] == "text":
            assert g["text"] == w["text"]
            continue
        assert g["grid"] == w["grid"]
        np.testing.assert_array_equal(np.asarray(g["ids"]),
                                      np.asarray(w["ids"]))
        a, b = png_pixels(g["image_b64"]), png_pixels(w["image_b64"])
        assert a.shape == b.shape == (8, 8, 3)
        assert np.abs(a - b).max() <= 1 and (a == b).mean() >= 0.98


def test_run_interleaved_matches_jax_engine(engines):
    want = engines["jax"].run_interleaved(document(), seed=3)
    got = engines["port"].run_interleaved(document(), seed=3)
    row = engines["port"].interleaved_row(document())["row"]
    for k, v in engines["seen"].items():
        np.testing.assert_array_equal(row[k], np.asarray(v)[0], err_msg=k)
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    assert got["nfe"] == int(want["nfe"]) >= STEPS
    assert_same_document(got, want)
    # the given image keeps its tokens outside the regenerated region
    kept = np.ones((4, 4), bool)
    kept[:2, :2] = False
    np.testing.assert_array_equal(
        got["segments"][1]["ids"].reshape(4, 4)[kept],
        document()[1]["ids"].reshape(4, 4)[kept])


def test_interleaved_route_of_the_port_server(engines):
    eng = engines["port"]
    srv = server.make_server(eng, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        doc = document()
        doc[1] = dict(doc[1], pixel_mask=doc[1]["pixel_mask"].tolist(),
                      ids=doc[1]["ids"].tolist())
        req = {"segments": doc, "seed": 3, "steps": STEPS}
        r = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/v1/chat/completions",
            data=json.dumps(req).encode(),
            headers={"Content-Type": "application/json"}), timeout=60)
        resp = json.load(r)
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.shutdown()
    assert resp["object"] == "interleaved.completion"
    want = engines["jax"].run_interleaved(document(), seed=3)
    assert resp["usage"]["nfe"] == int(want["nfe"])
    assert_same_document(resp, want)


def test_multires_rope_offsets_where_jax_engine_writes_raw_indices():
    """Under model.img_resolutions JAX's engine writes an image's raster
    indices without its block's offset (unidisc_tpu/serving/engine.py:
    546), so its image tokens index the 1D text rows of the combined
    table; the port adds the offset, the rule of JAX's own
    pack_documents(rope_offsets=)."""
    over = {**ENGINE, "model.img_resolutions": (16,)}
    jcfg, tcfg = JaxConfig.make("tiny", **over), Config.make("tiny", **over)
    seen = {}

    class Stop(Exception):
        pass

    def jax_sampler(steps=None):
        def run(p, rng, x0, unmask, modality, sample_ids, rope_index):
            seen["rope_index"] = np.asarray(rope_index)[0]
            raise Stop
        return run
    jeng = JaxEngine(jcfg, JaxDIT(jcfg.model), {})
    jeng._interleaved_sampler = jax_sampler
    with pytest.raises(Stop):
        jeng.run_interleaved(document())
    eng = InferenceEngine(tcfg, DIT(tcfg.model), device="cpu")
    row = eng.interleaved_row(document())["row"]
    img = row["modality"] == 1
    assert (seen["rope_index"][img] < 16).all()
    offset = build_multires_rope(48, (16,), 64)[2][16]
    assert offset == 48
    np.testing.assert_array_equal(row["rope_index"][img],
                                  seen["rope_index"][img] + offset)
    np.testing.assert_array_equal(row["rope_index"][~img],
                                  seen["rope_index"][~img])
    with pytest.raises(ValueError, match="img_resolutions"):
        eng.interleaved_row([{"kind": "image", "generate": True,
                              "grid": 2}])


def test_packed_sampler_warm_up_inputs_fit_the_interleaved_layout():
    """A captured program's warm-up runs the sampler on example_inputs:
    at the interleaved layout (txt_length + img_length != length) they
    span model.length and carry sample ids and rope indices."""
    tcfg = Config.make("tiny", **ENGINE)
    model = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    sample = build_sampler(model, tcfg, num_steps=2, device="cpu",
                           packed=True)
    inputs = sample.example_inputs(2)
    assert {k: tuple(v.shape) for k, v in inputs.items()
            if k != "schedule"} == {
        k: (2, 48) for k in ("x0", "unmask", "modality", "sample_ids",
                             "rope_index")}
    x, state = sample.denoise(inputs)
    assert x.shape == (2, 48) and state["nfe"] == 2
