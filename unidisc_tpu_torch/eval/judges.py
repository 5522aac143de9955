"""Quality judges: CIDEr-D, MAUVE, FID feature extractors, CLIP score,
LAION aesthetic, HPSv2 and the generative-perplexity judge LM (port of
``unidisc_tpu/eval/judges.py``).

As in the JAX package, each judge has
  * a NATIVE path that needs no asset: CIDEr-D (n-gram math), MAUVE on
    the hashing bag-of-ngrams embedder, and the Frechet distance over a
    fixed-seed random-conv net; and
  * an ASSET-GATED path that loads the published judge network from a
    local directory (``UNIDISC_ASSETS`` or an explicit path), in the JAX
    package's layout:
      $UNIDISC_ASSETS/clip-vit-large-patch14/   (HF CLIP dir)
      $UNIDISC_ASSETS/gpt2-large/               (HF GPT-2 dir)
      $UNIDISC_ASSETS/pt_inception-2015-12-05.pt
      $UNIDISC_ASSETS/ava+logos-l14-linearMSE.pth
      $UNIDISC_ASSETS/HPS_v2_compressed.pt
    A missing asset raises FileNotFoundError, which callers turn into the
    native fallback.

Differences from the JAX package, by design:
  * the networks are the port's own (``eval/judge_nets.py``) and the text
    tokenizers its byte-level BPE (``tokenizers/bpe.py``): the card's
    machine has neither ``transformers`` nor ``tokenizers``;
  * MAUVE's PCA and k-means are numpy (no ``sklearn`` there): PCA by a
    full SVD in float64 keeping the fewest components that explain
    ``pca_var`` of the variance (sklearn's rule), k-means++ restarted
    ``n_init`` times from a seeded numpy generator with Lloyd's iterations
    to sklearn's tolerance, the lowest inertia kept. Its clusters are a
    k-means optimum as sklearn's are, not sklearn's labels bit for bit;
  * ``random_conv_features`` draws JAX's weights (threefry2x32 under
    ``jax_threefry_partitionable``, then XLA's float32 erfinv) in numpy,
    so ``fid/random_conv(seed7)`` is the same metric on both sides; its
    "SAME" stride-2 convolutions pad (0, 1) as XLA does, and its resize
    is JAX's antialiased bilinear;
  * every judge runs on a given device (the card by default).
"""

from __future__ import annotations

import math
import os
from collections import Counter, defaultdict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from unidisc_tpu_torch.device import resolve_device


def assets_dir(path: Optional[str] = None) -> Optional[str]:
    path = path or os.environ.get("UNIDISC_ASSETS")
    return path if path and os.path.isdir(path) else None


# ---------------------------------------------------------------------------
# CIDEr-D (native; reference wires pycocoevalcap's CIDEr — captioning eval,
# model_setup.py:236-247)
# ---------------------------------------------------------------------------

def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def _tokenize(text: str) -> List[str]:
    return text.lower().strip().split()


def cider_d(candidates: Sequence[str],
            references: Sequence[Sequence[str]],
            max_n: int = 4, sigma: float = 6.0) -> float:
    """CIDEr-D over a corpus (Vedantam et al. 2015, the -D variant with
    count clipping + length penalty, matching pycocoevalcap semantics).

    candidates: one generated caption per image.
    references: list of reference captions per image.
    Returns the corpus CIDEr-D score (typically 0..~2, scaled by 10).
    """
    assert len(candidates) == len(references) and len(candidates) > 0
    num_images = len(candidates)

    # document frequency: number of images where the ngram appears in ANY ref
    df = [defaultdict(float) for _ in range(max_n)]
    ref_grams = []
    for refs in references:
        per_image = [[_ngrams(_tokenize(r), n + 1) for r in refs]
                     for n in range(max_n)]
        ref_grams.append(per_image)
        for n in range(max_n):
            seen = set()
            for g in per_image[n]:
                seen.update(g.keys())
            for ng in seen:
                df[n][ng] += 1.0

    log_n = math.log(max(num_images, 2))

    def tfidf(grams: Counter, n: int):
        vec = {}
        norm = 0.0
        total = max(sum(grams.values()), 1)
        for ng, cnt in grams.items():
            idf = log_n - math.log(max(df[n][ng], 1.0))
            w = (cnt / 1.0) * idf  # raw counts, as pycocoevalcap
            vec[ng] = w
            norm += w * w
        return vec, math.sqrt(norm)

    scores = np.zeros(num_images)
    for i, (cand, refs) in enumerate(zip(candidates, references)):
        cand_toks = _tokenize(cand)
        per_n = []
        for n in range(max_n):
            cgrams = _ngrams(cand_toks, n + 1)
            s = 0.0
            for ref, rgrams in zip(refs, ref_grams[i][n]):
                cvec, cnorm = tfidf(cgrams, n)
                rvec, rnorm = tfidf(rgrams, n)
                # CIDEr-D: clip candidate counts to the reference's
                num = 0.0
                for ng, w in cvec.items():
                    if ng in rvec:
                        num += min(w, rvec[ng]) * rvec[ng]
                denom = cnorm * rnorm
                sim = num / denom if denom > 0 else 0.0
                dl = len(cand_toks) - len(_tokenize(ref))
                sim *= math.exp(-dl * dl / (2 * sigma ** 2))
                s += sim
            per_n.append(10.0 * s / max(len(refs), 1))
        scores[i] = np.mean(per_n)
    return float(scores.mean())


# ---------------------------------------------------------------------------
# MAUVE (native pipeline; reference: model_eval.py:1590-1733 uses the mauve
# package over GPT-2 features)
# ---------------------------------------------------------------------------

def bag_of_ngrams_features(texts: Sequence[str], dim: int = 512,
                           max_n: int = 3, seed: int = 0) -> np.ndarray:
    """Deterministic hashing embedder: char+word n-gram counts hashed into
    `dim` buckets, l2-normalized. Zero-asset stand-in for the GPT-2
    feature extractor — distributional differences in vocabulary and
    phrasing still register."""
    import zlib

    # zlib.crc32 is process-stable (Python's str hash() is salted per
    # process, which would make the metric irreproducible across runs)
    def h32(kind, n, payload):
        return zlib.crc32(f"{kind}|{n}|{seed}|{payload}".encode())

    feats = np.zeros((len(texts), dim), np.float64)
    for i, t in enumerate(texts):
        toks = _tokenize(t)
        for n in range(1, max_n + 1):
            for j in range(len(toks) - n + 1):
                h = h32("w", n, " ".join(toks[j:j + n]))
                feats[i, h % dim] += 1 if (h >> 16) & 1 else -1
        for n in (3, 5):
            s = t.lower()
            for j in range(len(s) - n + 1):
                h = h32("c", n, s[j:j + n])
                feats[i, h % dim] += 1 if (h >> 16) & 1 else -1
    norms = np.linalg.norm(feats, axis=1, keepdims=True)
    return feats / np.maximum(norms, 1e-12)


# ---------------------------------------------------------------------------
# MAUVE (native pipeline; reference: model_eval.py:1590-1733 uses the mauve
# package over GPT-2 features)
# ---------------------------------------------------------------------------

def pca_fit_transform(x: np.ndarray, var: float) -> np.ndarray:
    """sklearn's ``PCA(n_components=var, svd_solver="full")
    .fit_transform`` for 0 < var < 1, up to each component's sign: centre,
    full SVD in float64, keep the fewest leading components whose explained
    variance ratios sum past `var`, project."""
    x = np.asarray(x, np.float64)
    x = x - x.mean(0, keepdims=True)
    u, s, vt = np.linalg.svd(x, full_matrices=False)
    ev = s ** 2 / max(x.shape[0] - 1, 1)
    total = ev.sum()
    ratio = ev / total if total > 0 else np.zeros_like(ev)
    k = int(np.searchsorted(np.cumsum(ratio), var, side="right")) + 1
    k = min(k, len(s))
    return u[:, :k] * s[:k]


def _sq_dists(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    d = ((x * x).sum(1)[:, None] - 2 * x @ centers.T
         + (centers * centers).sum(1)[None])
    return np.maximum(d, 0.0)


def _kmeans_pp(x: np.ndarray, k: int, rng: np.random.Generator
               ) -> np.ndarray:
    """k-means++ seeding with sklearn's 2 + log(k) local trials."""
    n = x.shape[0]
    trials = 2 + int(np.log(k))
    centers = [x[rng.integers(n)]]
    closest = _sq_dists(x, np.asarray(centers))[:, 0]
    pot = closest.sum()
    for _ in range(1, k):
        if pot <= 0:
            cand = rng.integers(n, size=trials)
        else:
            cand = np.searchsorted(np.cumsum(closest),
                                   rng.random(trials) * pot)
            cand = np.minimum(cand, n - 1)
        d = np.minimum(closest[None], _sq_dists(x, x[cand]).T)
        best = int(np.argmin(d.sum(1)))
        closest, pot = d[best], d[best].sum()
        centers.append(x[cand[best]])
    return np.asarray(centers)


def kmeans(x: np.ndarray, k: int, *, n_init: int = 5, seed: int = 0,
           max_iter: int = 300, tol: float = 1e-4):
    """(labels, centers, inertia) of the best of `n_init` k-means runs:
    k-means++ seeding from ``np.random.default_rng(seed)``, Lloyd's
    iterations until the labels settle or the centres move less than
    sklearn's tolerance (tol x the mean feature variance), an empty
    cluster re-seeded at the point farthest from its centre; the labels
    of the final centres."""
    x = np.asarray(x, np.float64)
    rng = np.random.default_rng(seed)
    tol = float(np.mean(np.var(x, axis=0))) * tol
    best = None
    for _ in range(n_init):
        centers = _kmeans_pp(x, k, rng)
        labels = None
        for _ in range(max_iter):
            d = _sq_dists(x, centers)
            new = d.argmin(1)
            moved = np.empty_like(centers)
            far = np.argsort(-d[np.arange(len(x)), new])
            taken = 0
            for c in range(k):
                members = new == c
                if members.any():
                    moved[c] = x[members].mean(0)
                else:
                    moved[c] = x[far[taken]]
                    taken += 1
            shift = ((moved - centers) ** 2).sum()
            settled = labels is not None and np.array_equal(labels, new)
            centers, labels = moved, new
            if settled or shift <= tol:
                break
        d = _sq_dists(x, centers)
        labels = d.argmin(1)
        inertia = float(d[np.arange(len(x)), labels].sum())
        if best is None or inertia < best[2]:
            best = (labels, centers, inertia)
    return best


def mauve_from_features(p_feats: np.ndarray, q_feats: np.ndarray, *,
                        num_buckets: Optional[int] = None,
                        scaling: float = 5.0, seed: int = 25,
                        pca_var: float = 0.9) -> Dict[str, float]:
    """MAUVE (Pillutla et al. 2021): quantize both feature sets with joint
    k-means, then integrate the KL-divergence frontier.

    Returns {"mauve": area, "num_buckets": k}.
    """
    n_p, n_q = len(p_feats), len(q_feats)
    num_buckets = num_buckets or max(2, min(n_p, n_q) // 10)
    joint = np.concatenate([p_feats, q_feats], 0).astype(np.float64)
    joint = joint - joint.mean(0, keepdims=True)
    if joint.shape[1] > 1:
        joint = pca_fit_transform(joint, pca_var)
    labels = kmeans(joint, num_buckets, n_init=5, seed=seed)[0]
    p_hist = np.bincount(labels[:n_p], minlength=num_buckets).astype(float)
    q_hist = np.bincount(labels[n_p:], minlength=num_buckets).astype(float)
    p_hist /= p_hist.sum()
    q_hist /= q_hist.sum()

    def kl(a, b):
        nz = a > 0
        return float(np.sum(a[nz] * (np.log(a[nz]) - np.log(b[nz]))))

    lambdas = np.linspace(0, 1, 100)[1:-1]
    xs, ys = [1.0], [0.0]
    for lam in lambdas:
        r = lam * p_hist + (1 - lam) * q_hist
        xs.append(math.exp(-scaling * kl(q_hist, r)))
        ys.append(math.exp(-scaling * kl(p_hist, r)))
    xs.append(0.0)
    ys.append(1.0)
    xs, ys = np.asarray(xs), np.asarray(ys)
    order = np.argsort(xs)
    area = float(np.trapezoid(ys[order], xs[order]))
    return {"mauve": area, "num_buckets": num_buckets}


def mauve_score(p_texts: Sequence[str], q_texts: Sequence[str],
                feature_fn: Optional[Callable] = None,
                **kw) -> Dict[str, float]:
    """End-to-end MAUVE on texts. feature_fn defaults to the hashing
    embedder; pass a judge-LM embedder for reference parity."""
    feature_fn = feature_fn or bag_of_ngrams_features
    return mauve_from_features(np.asarray(feature_fn(p_texts)),
                               np.asarray(feature_fn(q_texts)), **kw)


# ---------------------------------------------------------------------------
# FID feature extractors
# ---------------------------------------------------------------------------

def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counters (x0, x1) under key
    (k0, k1), as XLA computes it: uint32 arrays."""
    k0, k1 = np.uint32(k0), np.uint32(k1)
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):      # uint32 arithmetic wraps
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in rot[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _threefry_counts(key, n: int):
    """threefry2x32 over the 64-bit indices 0..n-1 split into (hi, lo)
    words: JAX's partitionable split and bit draws."""
    idx = np.arange(n, dtype=np.uint64)
    return threefry2x32(key[0], key[1],
                        (idx >> np.uint64(32)).astype(np.uint32),
                        (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def jax_split(key, num: int) -> np.ndarray:
    """``jax.random.split(key, num)`` (threefry, partitionable)."""
    return np.stack(_threefry_counts(key, num), 1)


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv (Giles' single-precision polynomials)."""
    lo = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941], np.float32)
    hi = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                   -0.00367342844, 0.00573950773, -0.0076224613,
                   0.00943887047, 1.00167406, 2.83297682], np.float32)
    w = -np.log1p(-x * x)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(small, lo[0], hi[0]).astype(np.float32)
    for i in range(1, 9):
        p = (np.where(small, lo[i], hi[i]) + p * w).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max,
                    p * x).astype(np.float32)


def jax_normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``: 32 random bits a value,
    a uniform in JAX's open interval (nextafter(-1, 0), 1), then
    sqrt(2) erfinv(u)."""
    a, b = _threefry_counts(key, int(np.prod(shape)))
    bits = (a ^ b) >> np.uint32(9) | np.float32(1.0).view(np.uint32)
    f = bits.view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, f * (np.float32(1.0) - lo) + lo)
    return (np.float32(np.sqrt(2)) * _erfinv_f32(u)).reshape(shape)


def random_conv_weights(dim: int = 192, seed: int = 7) -> List[np.ndarray]:
    """The JAX package's random-conv weights (HWIO, float32):
    normal(split(PRNGKey(seed), 3)[i]) / sqrt(fan_in)."""
    ks = jax_split(np.array([0, seed], np.uint32), 3)
    shapes = ((3, 3, 3, 32), (3, 3, 32, 64), (3, 3, 64, dim))
    return [jax_normal(k, s) / np.float32(math.sqrt(9 * s[2]))
            for k, s in zip(ks, shapes)]


def same_pad(size: int, k: int = 3, stride: int = 2) -> tuple:
    """XLA's "SAME" padding (low, high) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def random_conv_features(dim: int = 192, seed: int = 7,
                         image_size: int = 64, device="cuda") -> Callable:
    """Fixed-seed random conv feature net on `device`: a weights-free
    extractor for Frechet tracking, the JAX package's net with its weights
    (a stable, reproducible relative metric; absolute FID needs the
    inception asset). images (B, H, W, 3) in [0, 1] (or [0, 255]) ->
    (B, dim) float32 numpy."""
    dev = resolve_device(device)
    ws = [torch.from_numpy(w).permute(3, 2, 0, 1).contiguous().to(dev)
          for w in random_conv_weights(dim, seed)]

    @torch.no_grad()
    def feats(images):
        x = torch.as_tensor(np.asarray(images, np.float32)).to(dev)
        if x.ndim == 3:
            x = x[None]
        x = torch.where(x.max() > 1.5, x / 255.0, x)
        x = x.permute(0, 3, 1, 2)
        if tuple(x.shape[2:]) != (image_size, image_size):
            # jax.image.resize "bilinear" antialiases when it shrinks
            x = F.interpolate(x, size=(image_size, image_size),
                              mode="bilinear", antialias=True,
                              align_corners=False)
        for w in ws:
            (t, b), (l, r) = same_pad(x.shape[2]), same_pad(x.shape[3])
            x = torch.tanh(F.conv2d(F.pad(x, (l, r, t, b)), w, stride=2))
        return x.mean((2, 3)).cpu().numpy()   # global average pool

    return feats


def inception_features(asset_path: Optional[str] = None,
                       device="cuda") -> Callable:
    """pytorch-fid InceptionV3 features (pool3, 2048-d) from a local
    weights file on `device` -- the reference's absolute-FID judge.
    Asset-gated. The JAX package also takes a whole pickled module; the
    port reads state dicts only (``weights_only``)."""
    base = assets_dir(asset_path)
    path = None
    for cand in ([asset_path] if asset_path and os.path.isfile(
            asset_path) else []) + \
            ([os.path.join(base, "pt_inception-2015-12-05.pt")]
             if base else []):
        if cand and os.path.isfile(cand):
            path = cand
            break
    if path is None:
        raise FileNotFoundError(
            "inception FID weights not found; place pytorch-fid's "
            "pt_inception-2015-12-05.pt under $UNIDISC_ASSETS "
            "(see docs/EVAL_ASSETS.md)")
    from unidisc_tpu_torch.eval.judge_nets import FIDInceptionV3

    dev = resolve_device(device)
    # pytorch-fid's published file: a state dict in torchvision's layout
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    net = FIDInceptionV3()
    net.load_state_dict(sd)
    net = net.to(dev).eval()

    @torch.no_grad()
    def feats(images):
        x = torch.as_tensor(np.asarray(images, np.float32))
        if x.max() > 1.5:
            x = x / 255.0
        out = net(x.permute(0, 3, 1, 2).to(dev))   # NHWC -> NCHW
        return out.cpu().numpy()

    return feats


# ---------------------------------------------------------------------------
# CLIP score (asset-gated; reference: model_eval.py:1265)
# ---------------------------------------------------------------------------

def _model_dir(asset_path: Optional[str], name: str) -> Optional[str]:
    """An HF model directory: `asset_path` itself when it holds a
    config.json, else `name` under it (or under $UNIDISC_ASSETS). The JAX
    package takes any directory given as the model's own, so an asset base
    directory passed as --assets fails there; here it works."""
    if asset_path and os.path.isfile(os.path.join(asset_path,
                                                  "config.json")):
        return asset_path
    base = assets_dir(asset_path)
    path = os.path.join(base, name) if base else None
    return path if path and os.path.isdir(path) else None


class ClipJudge:
    """An HF CLIP directory on one device: its model, image processor and
    BPE, as the JAX package's CLIPModel + CLIPProcessor."""

    def __init__(self, path: str, device):
        from unidisc_tpu_torch.eval.judge_nets import (load_clip,
                                                       read_preprocess)
        from unidisc_tpu_torch.tokenizers.bpe import BPETokenizer
        self.device = resolve_device(device)
        self.model = load_clip(path, self.device)
        self.preprocess = read_preprocess(path)
        self.tokenizer = BPETokenizer.from_pretrained(path)

    def pixels(self, images) -> torch.Tensor:
        from unidisc_tpu_torch.eval.judge_nets import clip_preprocess
        return clip_preprocess(images, self.preprocess).to(self.device)

    @torch.no_grad()
    def image_embeds(self, images) -> torch.Tensor:
        return self.model.get_image_features(self.pixels(images))

    @torch.no_grad()
    def score(self, images, texts) -> np.ndarray:
        enc = self.tokenizer(list(texts), padding="longest",
                             truncation=True)
        ids = torch.from_numpy(enc["input_ids"]).to(self.device)
        mask = torch.from_numpy(enc["attention_mask"]).to(self.device)
        img, txt = self.model(ids, self.pixels(images), mask)
        return (100.0 * (img * txt).sum(-1)).cpu().numpy()


def clip_score_fn(asset_path: Optional[str] = None,
                  device="cuda") -> Callable:
    """Returns score(images (B,H,W,3), texts list[str]) -> (B,) cosine*100.
    Loads a local HF CLIP dir (clip-vit-large-patch14)."""
    path = _model_dir(asset_path, "clip-vit-large-patch14")
    if path is None:
        raise FileNotFoundError(
            "CLIP judge dir not found; place an HF clip-vit-large-patch14 "
            "directory under $UNIDISC_ASSETS (see docs/EVAL_ASSETS.md)")
    return ClipJudge(path, device).score


# ---------------------------------------------------------------------------
# LAION aesthetic v2 (asset-gated; reference:
# unidisc/tokenizers/laion_aesthetic_v2.py)
# ---------------------------------------------------------------------------

def laion_aesthetic_fn(asset_path: Optional[str] = None,
                       device="cuda") -> Callable:
    """Returns score(images (B,H,W,3)) -> (B,) sigmoid aesthetic scores.

    Loads the published ava+logos-l14-linearMSE.pth MLP head
    (eval/judge_nets.AestheticPredictor) over CLIP ViT-L/14 image
    embeddings from the clip-vit-large-patch14 asset dir:
    sigmoid(mlp(emb / |emb|) - 5.6)."""
    base = assets_dir(asset_path)
    head_path = None
    for name in ("ava+logos-l14-linearMSE.pth",
                 "sac+logos+ava1-l14-linearMSE.pth"):
        cand = os.path.join(base, name) if base else None
        if cand and os.path.isfile(cand):
            head_path = cand
            break
    if head_path is None:
        raise FileNotFoundError(
            "LAION aesthetic head not found; place "
            "ava+logos-l14-linearMSE.pth under $UNIDISC_ASSETS "
            "(see docs/EVAL_ASSETS.md)")
    clip_dir = os.path.join(base, "clip-vit-large-patch14")
    if not os.path.isdir(clip_dir):
        raise FileNotFoundError(
            "LAION aesthetic needs the clip-vit-large-patch14 asset dir "
            "for image embeddings (see docs/EVAL_ASSETS.md)")
    from unidisc_tpu_torch.eval.judge_nets import AestheticPredictor

    judge = ClipJudge(clip_dir, device)
    sd = torch.load(head_path, map_location="cpu", weights_only=True)
    head = AestheticPredictor(sd["layers.0.weight"].shape[1])
    head.load_state_dict(sd)
    head = head.to(judge.device).eval()

    @torch.no_grad()
    def score(images):
        emb = judge.image_embeds(images)
        emb = emb / emb.norm(dim=-1, keepdim=True)
        raw = head(emb.float())[:, 0] - 5.6
        return 1.0 / (1.0 + np.exp(-raw.cpu().numpy()))

    return score


# ---------------------------------------------------------------------------
# HPSv2 (asset-gated; reference: unidisc/tokenizers/hpsv2_img_score.py)
# ---------------------------------------------------------------------------

def hpsv2_fn(asset_path: Optional[str] = None, device="cuda") -> Callable:
    """Returns score(images (B,H,W,3), prompts list[str]) -> (B,) HPS.

    Loads the published HPSv2 checkpoint (an open_clip ViT-H-14
    state_dict under 'state_dict') into eval/judge_nets.OpenClipModel
    (tower sizes read off the checkpoint). Text uses the CLIP BPE of the
    clip-vit-large-patch14 asset dir (one vocabulary across CLIP models).
    HPS = image_feat . text_feat."""
    base = assets_dir(asset_path)
    ckpt = None
    for name in ("HPS_v2.1_compressed.pt", "HPS_v2_compressed.pt",
                 "HPS_v2.pt"):
        cand = os.path.join(base, name) if base else None
        if cand and os.path.isfile(cand):
            ckpt = cand
            break
    if ckpt is None:
        raise FileNotFoundError(
            "HPSv2 checkpoint not found; place HPS_v2_compressed.pt "
            "under $UNIDISC_ASSETS (see docs/EVAL_ASSETS.md)")
    tok_dir = os.path.join(base, "clip-vit-large-patch14")
    if not os.path.isdir(tok_dir):
        raise FileNotFoundError(
            "HPSv2 needs the clip-vit-large-patch14 asset dir for the "
            "CLIP BPE tokenizer (see docs/EVAL_ASSETS.md)")
    from unidisc_tpu_torch.eval.judge_nets import OpenClipModel
    from unidisc_tpu_torch.tokenizers.bpe import BPETokenizer

    dev = resolve_device(device)
    sd = torch.load(ckpt, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    model = OpenClipModel.from_state_dict(sd).to(dev)
    tokenizer = BPETokenizer.from_pretrained(tok_dir)
    ctx = model.positional_embedding.shape[0]
    size = model.visual.conv1.weight.shape[-1] * int(round(
        (model.visual.positional_embedding.shape[0] - 1) ** 0.5))
    # open_clip val preprocess: CLIP mean/std normalization, bicubic
    # resize to the tower's input size
    mean = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
    std = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

    @torch.no_grad()
    def score(images, prompts):
        x = np.asarray(images, np.float32)
        if x.max() > 1.5:
            x = x / 255.0
        x = torch.as_tensor((x - mean) / std).permute(0, 3, 1, 2).to(dev)
        if x.shape[-2:] != (size, size):
            x = F.interpolate(x, size=(size, size), mode="bicubic",
                              align_corners=False)
        toks = tokenizer(list(prompts), padding="max_length",
                         truncation=True, max_length=ctx)["input_ids"]
        out = model(x, torch.from_numpy(toks).to(dev))
        return (out["image_features"]
                * out["text_features"]).sum(-1).cpu().numpy()

    return score


# ---------------------------------------------------------------------------
# Generative perplexity judge LM (asset-gated; reference:
# model_utils.py:514-603 gen-PPL vs GPT-2-large)
# ---------------------------------------------------------------------------

def judge_lm(asset_path: Optional[str] = None, name: str = "gpt2-large",
             device="cuda"):
    """Returns (nll_fn(texts) -> (B,) mean NLL, embed_fn(texts) -> (B, D))
    from a local HF GPT-2 directory, on `device`. embed_fn (the last
    token's final hidden state) feeds MAUVE for reference-parity
    features. Each text runs alone, as in the JAX package; a text too
    short to score (no token, or one for the NLL) is read after GPT-2's
    end token, and an empty one as the end token twice."""
    path = _model_dir(asset_path, name)
    if path is None:
        raise FileNotFoundError(
            f"judge LM dir '{name}' not found under $UNIDISC_ASSETS "
            "(see docs/EVAL_ASSETS.md)")
    from unidisc_tpu_torch.eval.judge_nets import load_gpt2
    from unidisc_tpu_torch.tokenizers.bpe import BPETokenizer

    dev = resolve_device(device)
    tok = BPETokenizer.from_pretrained(path)
    model = load_gpt2(path, dev)

    def ids_of(text, least: int):
        """The text's ids; one with fewer than `least` goes after GPT-2's
        end token, its document separator, and an empty one is that token
        followed by the end token, a document that ends at once (the JAX
        package's path returns NaN or raises on such texts)."""
        ids = tok.encode(text, truncation=True)
        if len(ids) < least:
            eot = tok.eos_token_id
            ids = [eot] + (ids or [eot] * (least - 1))
        return torch.tensor([ids], dtype=torch.long, device=dev)

    @torch.no_grad()
    def nll_fn(texts):
        out = []
        for t in texts:
            ids = ids_of(t, 2)
            logits = model(ids)[0][:, :-1]
            lp = torch.log_softmax(logits.float(), -1)
            nll = -lp.gather(-1, ids[:, 1:, None])[..., 0].mean()
            out.append(float(nll))
        return np.asarray(out)

    @torch.no_grad()
    def embed_fn(texts):
        return np.stack([model(ids_of(t, 1))[1][0, -1].float().cpu()
                         .numpy() for t in texts])

    return nll_fn, embed_fn
