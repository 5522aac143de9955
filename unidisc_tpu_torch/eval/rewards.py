"""Reward models for generation re-ranking (port of
``unidisc_tpu/eval/rewards.py``).

The reference battery's reward models (CLIP score, HPSv2, LAION
aesthetic, DFN, chameleon perplexity, model likelihood) register here as
scorers: the model-likelihood and heuristic scorers run natively; the
judge-backed ones load their assets (``eval/judges.py``) at first call and
raise with guidance when the assets are absent.

All scorers share one signature: score(batch: dict) -> (B,) float, where
batch carries whichever of input_ids / modality / image_ids / images /
texts the scorer needs.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_scorer(name: str, **kw) -> Callable:
    if name not in _REGISTRY:
        raise KeyError(f"unknown reward {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kw)


def combine(scorers: Sequence, weights: Optional[Sequence[float]] = None):
    """Weighted reward mixture (reference reward_config weighting)."""
    weights = weights or [1.0] * len(scorers)

    def score(batch):
        total = None
        for s, w in zip(scorers, weights):
            v = np.asarray(s(batch), np.float64) * w
            total = v if total is None else total + v
        return total
    return score


# ---------------------------------------------------------------------------
# native scorers
# ---------------------------------------------------------------------------

@register("model_likelihood")
def _model_likelihood(*, config, apply_fn, params=None, seed: int = 0,
                      device="cpu", n_timesteps: int = 4, draws=None):
    """-sequence_nll of each row under the model (higher = more likely):
    the batch's input_ids / modality moved to `device`, every call under
    the same noise (a generator reseeded with `seed`, or ``draws``), as the
    JAX scorer reuses its key."""
    from unidisc_tpu_torch.eval.harness import sequence_nll

    def score(batch):
        tb = {k: torch.as_tensor(np.asarray(batch[k])).to(device)
              for k in ("input_ids", "modality") if k in batch}
        gen = torch.Generator(device=device).manual_seed(seed)
        return -sequence_nll(config, apply_fn, params, tb, gen,
                             n_timesteps=n_timesteps,
                             draws=draws).cpu().numpy()
    return score


@register("token_entropy")
def _token_entropy(*, vocab_size):
    def score(batch):
        toks = np.asarray(batch["input_ids"])
        out = []
        for row in toks:
            counts = np.bincount(row, minlength=vocab_size).astype(float)
            p = counts / counts.sum()
            p = p[p > 0]
            out.append(float(-(p * np.log(p)).sum()))
        return np.asarray(out)
    return score


@register("image_diversity")
def _image_diversity():
    """Unique-token fraction in the image span: a cheap degeneracy guard."""
    def score(batch):
        toks = np.asarray(batch["image_ids"])
        return np.asarray([len(np.unique(r)) / r.size for r in toks])
    return score


# ---------------------------------------------------------------------------
# judge-backed scorers (assets required)
# ---------------------------------------------------------------------------

def _needs_assets(name: str, hint: str):
    @register(name)
    def factory(**kw):
        def score(batch):
            raise RuntimeError(
                f"reward '{name}' needs downloaded judge weights ({hint}); "
                f"run it offline on the eval host, or use a native scorer "
                f"(model_likelihood, token_entropy, image_diversity)")
        return score
    return factory


def _lazy_judge(name: str, make: Callable, call: Callable):
    """A scorer that builds its judge at the first call; a missing asset
    raises RuntimeError naming the reward."""
    state = {}

    def score(batch):
        if "fn" not in state:
            try:
                state["fn"] = make()
            except FileNotFoundError as e:
                raise RuntimeError(f"reward '{name}' needs downloaded judge "
                                   f"weights: {e}") from e
        return call(state["fn"], batch)
    return score


@register("clip")
def _clip(*, assets=None, device="cuda", **kw):
    """CLIP text-image alignment (eval/judges.py clip_score_fn)."""
    from unidisc_tpu_torch.eval.judges import clip_score_fn
    return _lazy_judge("clip", lambda: clip_score_fn(assets, device),
                       lambda fn, b: fn(b["images"], b["texts"]))


@register("hpsv2")
def _hpsv2(*, assets=None, device="cuda", **kw):
    """Human Preference Score v2: the open_clip ViT-H-14 HPSv2 checkpoint
    in eval/judge_nets.OpenClipModel."""
    from unidisc_tpu_torch.eval.judges import hpsv2_fn
    return _lazy_judge("hpsv2", lambda: hpsv2_fn(assets, device),
                       lambda fn, b: fn(b["images"], b["texts"]))


@register("laion_aesthetic")
def _laion_aesthetic(*, assets=None, device="cuda", **kw):
    """LAION aesthetic v2: MLP head over CLIP ViT-L/14 embeddings,
    sigmoid(mlp(emb) - 5.6)."""
    from unidisc_tpu_torch.eval.judges import laion_aesthetic_fn
    return _lazy_judge("laion_aesthetic",
                       lambda: laion_aesthetic_fn(assets, device),
                       lambda fn, b: fn(b["images"]))


_needs_assets("dfn", "DFN CLIP checkpoint")
_needs_assets("chameleon_perplexity", "Anole-7b; reference: "
              "unidisc/tokenizers/chameleon_tokenizers.py")
