"""The port's judges (eval/judges.py, eval/judge_nets.py, tokenizers/bpe.py)
against the JAX package's and against the ``transformers`` path the JAX
package takes.

Tolerances:
* CIDEr-D and the bag-of-ngrams features: exactly (the same float64 code).
* random_conv weights against ``jax.random.normal``: 1e-6 relative (the
  bits are threefry's exactly; erfinv is XLA's float32 polynomial in numpy,
  within 2 ulp); the features against JAX's: atol 1e-5 (fp32 convolutions
  in another summation order); "SAME" padding and the antialiased resize
  alone: atol 1e-5.
* PCA against sklearn: 1e-8 up to each component's sign.
* k-means: labels equal to sklearn's up to a permutation on well-separated
  data; on the bag-of-ngrams features of the JAX MAUVE test's texts, an
  inertia within 1% of sklearn's. The seeding draws from numpy, not from
  sklearn's generator, so the two runs reach different local optima of
  the same objective, and MAUVE over 240 texts in 24 buckets moves with
  them: MAUVE within 0.02 absolute of the JAX package's (the three cases
  differ by 0.0134, 0.0015 and 0.0), with the JAX test's
  ordering (same > 0.8 > mixed > disjoint, disjoint < 0.1).
* The BPE: ids exactly equal to HF's slow and fast tokenizers. CLIP's image
  preprocessing: exactly equal to CLIPImageProcessor (PIL's bicubic bit for
  bit). CLIP / LAION / HPSv2 / GPT-2 scores and embeddings on tiny random
  judges against the JAX package's transformers path: 1e-4 (fp32, another
  attention formulation).
"""

import itertools
import json
import re

import jax
import numpy as np
import pytest
import torch

from unidisc_tpu.eval import judges as jjudges
from unidisc_tpu_torch.device import cap_test_threads
from unidisc_tpu_torch.eval import judge_nets, judges
from unidisc_tpu_torch.tokenizers.bpe import BPETokenizer, bytes_to_unicode
from unidisc_tpu_torch.utils.resize import pil_resize_uint8

cap_test_threads()

SCORE_TOL = 1e-4


# ---------------------------------------------------------------------------
# the native judges
# ---------------------------------------------------------------------------

REFS = [["a red bird sits on a branch", "a bird on a branch"],
        ["two dogs play in the park"],
        ["a man rides a blue bicycle", "a cyclist in blue"]]
CANDIDATES = {
    "perfect": [r[0] for r in REFS],
    "partial": ["a red bird on a rock", "two dogs sleep in the house",
                "a man rides a red car"],
    "padded": [r[0] + " filler" * 20 for r in REFS],
    "unrelated": ["quantum flux capacitors everywhere",
                  "stochastic gradient descent converges",
                  "seven eight nine ten eleven"]}


@pytest.mark.parametrize("name", sorted(CANDIDATES))
def test_cider_d_equals_jax(name):
    assert judges.cider_d(CANDIDATES[name], REFS) == \
        jjudges.cider_d(CANDIDATES[name], REFS)


def test_bag_of_ngrams_features_equal_jax():
    texts = [c for cands in CANDIDATES.values() for c in cands] + ["", "x"]
    for kw in ({}, {"dim": 64, "max_n": 2, "seed": 3}):
        np.testing.assert_array_equal(
            judges.bag_of_ngrams_features(texts, **kw),
            jjudges.bag_of_ngrams_features(texts, **kw))


SHAPES = [(3, 3, 3, 32), (3, 3, 32, 64), (3, 3, 64, 192)]


def test_random_conv_weights_match_jax_normal():
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    np.testing.assert_array_equal(
        judges.jax_split(np.array([0, 7], np.uint32), 3), np.asarray(keys))
    got = judges.random_conv_weights(192, 7)
    for k, shape, w in zip(keys, SHAPES, got):
        want = np.asarray(jax.random.normal(k, shape)) / np.sqrt(
            9 * shape[2])
        assert w.shape == shape and w.dtype == np.float32
        np.testing.assert_allclose(w, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("h,size,dim,scale", [(256, 64, 192, 1.0),
                                              (32, 32, 64, 255.0),
                                              (32, 64, 192, 1.0),
                                              (50, 64, 192, 255.0)])
def test_random_conv_features_match_jax(h, size, dim, scale):
    imgs = np.random.RandomState(h).rand(3, h, h, 3).astype(np.float32)
    want = jjudges.random_conv_features(dim=dim, image_size=size)(
        imgs * scale)
    got = judges.random_conv_features(dim=dim, image_size=size,
                                      device="cpu")(imgs * scale)
    assert got.shape == (3, dim)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", [64, 33, 8])
def test_same_padding_and_antialiased_resize_match_jax(size):
    import jax.numpy as jnp
    import torch.nn.functional as F
    rng = np.random.RandomState(size)
    x = rng.rand(2, size, size, 3).astype(np.float32)
    w = rng.randn(3, 3, 3, 5).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    (t, b), (l, r) = judges.same_pad(size), judges.same_pad(size)
    got = F.conv2d(F.pad(torch.from_numpy(x).permute(0, 3, 1, 2),
                         (l, r, t, b)),
                   torch.from_numpy(w).permute(3, 2, 0, 1), stride=2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5, rtol=0)
    out = max(size // 4, 2)
    want = jax.image.resize(jnp.asarray(x), (2, out, out, 3), "bilinear")
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                        size=(out, out), mode="bilinear", antialias=True,
                        align_corners=False)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5, rtol=0)


def test_pca_matches_sklearn_up_to_sign():
    from sklearn.decomposition import PCA
    rng = np.random.RandomState(0)
    for x, var in ((rng.randn(100, 20) @ rng.randn(20, 20), 0.9),
                   (rng.randn(60, 8), 0.5)):
        want = PCA(n_components=var, svd_solver="full").fit_transform(x)
        got = judges.pca_fit_transform(x, var)
        assert got.shape == want.shape
        sign = np.sign((got * want).sum(0))
        np.testing.assert_allclose(got * sign, want, atol=1e-8, rtol=0)


def test_kmeans_labels_equal_sklearn_up_to_permutation():
    from sklearn.cluster import KMeans
    rng = np.random.RandomState(1)
    x = np.concatenate([rng.randn(50, 5) + c for c in (0, 10, 20, -15)])
    labels, centers, inertia = judges.kmeans(x, 4, seed=25)
    want = KMeans(4, n_init=5, random_state=25).fit(x)
    assert any((np.asarray(p)[labels] == want.labels_).all()
               for p in itertools.permutations(range(4)))
    np.testing.assert_allclose(inertia, want.inertia_, rtol=1e-9)


def mauve_texts():
    """The JAX MAUVE test's texts (tests/test_judges.py)."""
    rng = np.random.RandomState(3)
    vocab_a = [f"tok{i}" for i in range(50)]
    vocab_b = [f"other{i}" for i in range(50)]

    def sample_texts(vocab, n):
        return [" ".join(rng.choice(vocab, size=12)) for _ in range(n)]

    p = sample_texts(vocab_a, 120)
    return p, {"same": sample_texts(vocab_a, 120),
               "disjoint": sample_texts(vocab_b, 120),
               "mixed": sample_texts(vocab_a + vocab_b, 120)}


def test_kmeans_reaches_sklearns_inertia_on_text_features():
    from sklearn.cluster import KMeans
    p, qs = mauve_texts()
    for q in qs.values():
        joint = np.concatenate([judges.bag_of_ngrams_features(p),
                                judges.bag_of_ngrams_features(q)])
        z = judges.pca_fit_transform(joint - joint.mean(0), 0.9)
        inertia = judges.kmeans(z, 24, seed=1)[2]
        assert inertia <= 1.01 * KMeans(24, n_init=5,
                                        random_state=1).fit(z).inertia_


def test_mauve_matches_jax_within_tolerance():
    p, qs = mauve_texts()
    got = {k: judges.mauve_score(p, q, seed=1)["mauve"]
           for k, q in qs.items()}
    want = {k: jjudges.mauve_score(p, q, seed=1)["mauve"]
            for k, q in qs.items()}
    for k in qs:
        assert abs(got[k] - want[k]) <= 0.02, (k, got[k], want[k])
    assert got["same"] > 0.8 and got["disjoint"] < 0.1
    assert got["same"] > got["mixed"] > got["disjoint"]


@pytest.mark.parametrize("h,w,nh,nw", [(48, 48, 224, 224),
                                       (300, 200, 336, 224),
                                       (37, 51, 13, 29),
                                       (512, 384, 298, 224)])
def test_pil_resize_is_pils_bit_for_bit(h, w, nh, nw):
    from PIL import Image
    img = np.random.RandomState(h).randint(0, 256, (h, w, 3)).astype(
        np.uint8)
    want = np.asarray(Image.fromarray(img).resize((nw, nh),
                                                  Image.BICUBIC))
    np.testing.assert_array_equal(pil_resize_uint8(img, nw, nh), want)


# ---------------------------------------------------------------------------
# the asset-gated judges on tiny judges written in the published layout
# ---------------------------------------------------------------------------

CORPUS = ("a red cube on a blue table. the cat's hat isn't there! 123 "
          "4567 the thing that then there a photo of a dog")
TEXTS = ["A red cube on a BLUE table.", "the cat's hat isn't there!  123",
         "héllo wörld — dash", "a photo of a dog", "x",
         "emoji 😀 ok <|endoftext|> inside", "  spaces   here "]


def learn_merges(words, n):
    """A BPE merge list learned greedily from `words` (lists of
    symbols)."""
    merges = []
    for _ in range(n):
        counts = {}
        for w in words:
            for pair in zip(w, w[1:]):
                counts[pair] = counts.get(pair, 0) + 1
        if not counts:
            break
        best = max(counts, key=counts.get)
        merges.append(best)
        out = []
        for w in words:
            new, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    new.append(w[i] + w[i + 1])
                    i += 2
                else:
                    new.append(w[i])
                    i += 1
            out.append(new)
        words = out
    return merges


def write_bpe(path, clip: bool) -> int:
    """vocab.json + merges.txt of a byte-level BPE: the 256 byte symbols
    (and their word-final forms for CLIP), merges learned from CORPUS, the
    special tokens last. Returns the vocabulary size."""
    bm = bytes_to_unicode()
    syms = [bm[b] for b in range(256)]
    if clip:
        words = [list(w[:-1]) + [w[-1] + "</w>"]
                 for w in re.findall(r"[a-z]+", CORPUS.lower())]
        vocab = {s: i for i, s in enumerate(syms + [s + "</w>"
                                                    for s in syms])}
    else:
        words = [list("".join(bm[b] for b in w.encode()))
                 for w in re.findall(r" ?\w+|[^\w\s]+", CORPUS)]
        vocab = {s: i for i, s in enumerate(syms)}
    merges = learn_merges(words, 40)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    for tok in (["<|startoftext|>"] if clip else []) + ["<|endoftext|>"]:
        vocab[tok] = len(vocab)
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return len(vocab)


def write_assets(root, *, inception=True, aesthetic=True, hps=True):
    """An asset dir in the JAX package's layout: a tiny random HF CLIP
    (clip-vit-large-patch14/) and GPT-2 (gpt2-large/) with byte-level BPE
    tokenizers, and, as asked, pytorch-fid's inception file name holding a
    random FIDInceptionV3, an aesthetic head and an HPSv2 open_clip
    checkpoint."""
    from transformers import (CLIPConfig, CLIPImageProcessor, CLIPModel,
                              CLIPTokenizer, GPT2Config, GPT2LMHeadModel,
                              GPT2Tokenizer)
    from unidisc_tpu.eval.judge_nets import (AestheticPredictor,
                                             FIDInceptionV3, OpenClipModel)
    torch.manual_seed(0)
    clip = root / "clip-vit-large-patch14"
    clip.mkdir(parents=True)
    clip_vocab = write_bpe(clip, clip=True)
    cfg = CLIPConfig(
        projection_dim=64,
        text_config={"hidden_size": 32, "intermediate_size": 64,
                     "num_hidden_layers": 2, "num_attention_heads": 2,
                     "max_position_embeddings": 77,
                     "vocab_size": clip_vocab},
        vision_config={"hidden_size": 32, "intermediate_size": 64,
                       "num_hidden_layers": 2, "num_attention_heads": 2,
                       "image_size": 224, "patch_size": 32})
    CLIPModel(cfg).save_pretrained(clip)
    CLIPImageProcessor().save_pretrained(clip)
    CLIPTokenizer(str(clip / "vocab.json"),
                  str(clip / "merges.txt")).save_pretrained(clip)
    lm = root / "gpt2-large"
    lm.mkdir()
    vocab = write_bpe(lm, clip=False)
    GPT2LMHeadModel(GPT2Config(n_layer=2, n_embd=32, n_head=2,
                               vocab_size=vocab, n_positions=128)
                    ).save_pretrained(lm)
    GPT2Tokenizer(str(lm / "vocab.json"),
                  str(lm / "merges.txt")).save_pretrained(lm)
    if inception:
        torch.save(FIDInceptionV3().state_dict(),
                   root / "pt_inception-2015-12-05.pt")
    if aesthetic:
        torch.save(AestheticPredictor(64).state_dict(),
                   root / "ava+logos-l14-linearMSE.pth")
    if hps:
        model = OpenClipModel(image_size=28, patch=14, v_width=160,
                              v_layers=2, v_heads=2, t_width=128,
                              t_layers=2, t_heads=2, vocab=clip_vocab,
                              ctx=77, embed_dim=64)
        for prm in model.parameters():
            prm.data.normal_(0, 0.02)
        torch.save({"state_dict": model.state_dict()},
                   root / "HPS_v2_compressed.pt")
    return root


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return write_assets(tmp_path_factory.mktemp("assets"))


@pytest.mark.parametrize("family", ["clip-vit-large-patch14", "gpt2-large"])
def test_bpe_ids_equal_hf_tokenizers(assets, family):
    from transformers import AutoTokenizer, CLIPTokenizer, GPT2Tokenizer
    path = assets / family
    slow_cls = CLIPTokenizer if family.startswith("clip") else GPT2Tokenizer
    slow, fast = slow_cls.from_pretrained(path), \
        AutoTokenizer.from_pretrained(path)
    mine = BPETokenizer.from_pretrained(str(path))
    assert mine.clip == family.startswith("clip")
    for t in TEXTS:
        assert mine.encode(t) == slow(t)["input_ids"] == \
            fast(t)["input_ids"], t
    if mine.clip:
        want = fast(TEXTS, padding=True, truncation=True,
                    return_tensors="np")
        got = mine(TEXTS, padding="longest", truncation=True)
        for k in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(got[k], want[k])
        want = slow(TEXTS, padding="max_length", truncation=True,
                    max_length=12, return_tensors="np")["input_ids"]
        got = mine(TEXTS, padding="max_length", truncation=True,
                   max_length=12)["input_ids"]
        np.testing.assert_array_equal(got, want)


def test_clip_preprocess_equals_clip_image_processor(assets):
    from transformers import CLIPImageProcessor
    path = assets / "clip-vit-large-patch14"
    proc = CLIPImageProcessor.from_pretrained(path)
    conf = judge_nets.read_preprocess(str(path))
    rng = np.random.RandomState(0)
    for shape in ((2, 48, 64, 3), (1, 300, 200, 3), (2, 224, 224, 3)):
        imgs = rng.randint(0, 256, shape).astype(np.uint8)
        want = proc(images=list(imgs), return_tensors="np")["pixel_values"]
        np.testing.assert_array_equal(
            judge_nets.clip_preprocess(imgs, conf).numpy(), want)


def judge_images(seed, size=48):
    return np.random.RandomState(seed).randint(
        0, 256, (3, size, size, 3)).astype(np.uint8)


def test_clip_score_matches_jax(assets):
    path = str(assets / "clip-vit-large-patch14")
    imgs, texts = judge_images(1), TEXTS[:3]
    want = jjudges.clip_score_fn(path)(imgs, texts)
    for arg in (path, str(assets)):     # the model dir, or the asset base
        got = judges.clip_score_fn(arg, device="cpu")(imgs, texts)
        np.testing.assert_allclose(got, want, rtol=SCORE_TOL,
                                   atol=SCORE_TOL)


def test_laion_aesthetic_matches_jax(assets, monkeypatch):
    monkeypatch.delenv("UNIDISC_ASSETS", raising=False)
    imgs = judge_images(2).astype(np.float32)
    want = jjudges.laion_aesthetic_fn(str(assets))(imgs)
    got = judges.laion_aesthetic_fn(str(assets), device="cpu")(imgs)
    np.testing.assert_allclose(got, want, rtol=SCORE_TOL, atol=SCORE_TOL)
    assert ((got > 0) & (got < 1)).all()


def test_hpsv2_matches_jax(assets):
    imgs = judge_images(3, 32).astype(np.float32) / 255
    want = jjudges.hpsv2_fn(str(assets))(imgs, TEXTS[:3])
    got = judges.hpsv2_fn(str(assets), device="cpu")(imgs, TEXTS[:3])
    np.testing.assert_allclose(got, want, rtol=SCORE_TOL, atol=SCORE_TOL)


def test_judge_lm_matches_jax(assets):
    path = str(assets / "gpt2-large")
    jnll, jemb = jjudges.judge_lm(path)
    nll, emb = judges.judge_lm(str(assets), device="cpu")
    texts = TEXTS[:4]
    np.testing.assert_allclose(nll(texts), jnll(texts), rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    np.testing.assert_allclose(emb(texts), jemb(texts), rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    # an empty generation, or one of a single token, is read after the
    # end token (the JAX path returns NaN or raises there)
    eot = "<|endoftext|>"
    np.testing.assert_allclose(nll(["", "a"]), jnll([eot + eot, eot + "a"]),
                               rtol=SCORE_TOL, atol=SCORE_TOL)
    assert np.isfinite(nll([""])).all()
    np.testing.assert_allclose(emb([""]), jemb([eot]), rtol=SCORE_TOL,
                               atol=SCORE_TOL)


def test_inception_features_match_jax(assets):
    imgs = np.random.RandomState(4).rand(1, 64, 64, 3).astype(np.float32)
    want = jjudges.inception_features(str(assets))(imgs)
    got = judges.inception_features(str(assets), device="cpu")(imgs)
    assert got.shape == (1, 2048)
    np.testing.assert_allclose(got, want, rtol=SCORE_TOL, atol=SCORE_TOL)


def test_asset_gated_judges_raise_without_assets(monkeypatch, tmp_path):
    monkeypatch.delenv("UNIDISC_ASSETS", raising=False)
    for fn in (judges.inception_features, judges.clip_score_fn,
               judges.judge_lm, judges.laion_aesthetic_fn,
               judges.hpsv2_fn):
        with pytest.raises(FileNotFoundError):
            fn(device="cpu")
    monkeypatch.setenv("UNIDISC_ASSETS", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        judges.inception_features(device="cpu")


def test_judges_run_on_the_card_unless_asked(assets):
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        judges.random_conv_features()
    with pytest.raises(RuntimeError, match="CUDA"):
        judges.clip_score_fn(str(assets))


def test_rewards_route_to_the_judges(assets):
    from unidisc_tpu_torch.eval.rewards import get_scorer
    batch = {"images": judge_images(5).astype(np.float32),
             "texts": ["abc", "a dog", "the cube"]}
    hps = get_scorer("hpsv2", assets=str(assets), device="cpu")(batch)
    aes = get_scorer("laion_aesthetic", assets=str(assets),
                     device="cpu")(batch)
    clip = get_scorer("clip", assets=str(assets), device="cpu")(batch)
    for v in (hps, aes, clip):
        assert v.shape == (3,) and np.isfinite(v).all()
    np.testing.assert_allclose(
        clip, jjudges.clip_score_fn(str(assets / "clip-vit-large-patch14"))(
            batch["images"], batch["texts"]), rtol=SCORE_TOL,
        atol=SCORE_TOL)
    with pytest.raises(RuntimeError, match="needs downloaded"):
        get_scorer("clip", assets="/nonexistent", device="cpu")(batch)
