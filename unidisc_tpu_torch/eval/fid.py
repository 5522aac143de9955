"""Frechet distance machinery with pluggable feature extractors (port of
``unidisc_tpu/eval/fid.py``; numpy and scipy only).

The statistics pipeline (running mean / covariance accumulated in float64
on the host, Frechet distance through ``scipy.linalg.sqrtm``) is native;
the feature extractor is any callable images -> features
(``eval/judges.py``: the inception judge, or the weights-free random-conv
net), so judges plug in while tests use cheap extractors.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


class RunningMoments:
    """Streaming mean + covariance over feature batches
    (replaces torchmetrics FID internal state)."""

    def __init__(self, dim: int):
        self.n = 0
        self.sum = np.zeros(dim, np.float64)
        self.outer = np.zeros((dim, dim), np.float64)

    def update(self, feats: np.ndarray):
        feats = np.asarray(feats, np.float64)
        self.n += feats.shape[0]
        self.sum += feats.sum(0)
        self.outer += feats.T @ feats

    @property
    def mean(self):
        return self.sum / max(self.n, 1)

    @property
    def cov(self):
        if self.n < 2:
            return np.zeros_like(self.outer)
        mu = self.mean
        return (self.outer - self.n * np.outer(mu, mu)) / (self.n - 1)

    def state(self):
        return {"n": self.n, "sum": self.sum, "outer": self.outer}


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """FID = |mu1-mu2|^2 + Tr(C1 + C2 - 2 sqrt(C1 C2))."""
    import scipy.linalg
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(cov1 @ cov2)
    if not np.isfinite(covmean).all():
        offset = np.eye(cov1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((cov1 + offset) @ (cov2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2 * np.trace(covmean))


class FIDMetric:
    """Two-stream FID accumulator (real vs generated)."""

    def __init__(self, feature_fn: Callable, dim: int):
        self.feature_fn = feature_fn
        self.real = RunningMoments(dim)
        self.fake = RunningMoments(dim)

    def update_real(self, images):
        self.real.update(self.feature_fn(images))

    def update_fake(self, images):
        self.fake.update(self.feature_fn(images))

    def compute(self) -> float:
        return frechet_distance(self.real.mean, self.real.cov,
                                self.fake.mean, self.fake.cov)


def pixel_stat_features(images) -> np.ndarray:
    """Cheap offline feature extractor: channelwise moments on a 4x4 grid
    (for smoke tests and relative tracking without an inception net)."""
    x = np.asarray(images, np.float64)
    b, h, w, c = x.shape
    g = 4
    x = x.reshape(b, g, h // g, g, w // g, c)
    mean = x.mean((2, 4)).reshape(b, -1)
    std = x.std((2, 4)).reshape(b, -1)
    return np.concatenate([mean, std], -1)
