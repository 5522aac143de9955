"""The port's legacy SEDD / D3PM functions (``diffusion/legacy.py``)
against the JAX package's, in fp32 on the same inputs: rtol 1e-5 (both
sides compute the same elementwise formulas and one reduction over the
vocabulary; atol 1e-6 for values near 0).

Inputs: (B 3, L 5, V 11) logits and log-probabilities from a numpy seed,
with the mask id (V - 1) at some positions of xt, sigma and t spanning
small and large values (the log(expm1(sigma)) of SEDD at sigma 1e-3; t
above D3PM's 1/T, where both sides divide 0 by 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.diffusion import legacy as jl
from unidisc_tpu_torch.diffusion import legacy as tl
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

B, L, V = 3, 5, 11
MASK = V - 1
RTOL, ATOL = 1e-5, 1e-6


def data(seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.standard_normal((B, L, V)).astype(np.float32) * 3
    log_p = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    x0 = rng.randint(0, V - 1, (B, L)).astype(np.int32)
    xt = np.where(rng.rand(B, L) < 0.5, MASK, x0).astype(np.int32)
    sigma = np.asarray([1e-3, 0.7, 4.0], np.float32)
    # d3pm_loss divides by t - 1/T: NaN at t <= 1/T on both sides
    t = np.asarray([2e-3, 0.4, 0.9999], np.float32)
    return dict(logits=logits, log_p=log_p.astype(np.float32), x0=x0, xt=xt,
                sigma=sigma, t=t, dsigma=np.asarray([0.1, 1.3, 2.5],
                                                    np.float32))


CASES = {
    "sedd_parameterization": lambda m, d: m.sedd_parameterization(
        d["logits"], d["xt"], d["sigma"]),
    "d3pm_parameterization": lambda m, d: m.d3pm_parameterization(
        d["logits"]),
    "d3pm_parameterization_masked": lambda m, d: m.d3pm_parameterization(
        d["logits"], MASK),
    "score_entropy": lambda m, d: m.score_entropy(
        m.sedd_parameterization(d["logits"], d["xt"], d["sigma"]),
        d["sigma"], d["xt"], d["x0"], MASK),
    "d3pm_loss": lambda m, d: m.d3pm_loss(
        m.d3pm_parameterization(d["logits"]), d["xt"], d["x0"], d["t"],
        1000, MASK),
    "get_score": lambda m, d: m.get_score(d["log_p"], d["xt"], d["sigma"],
                                          MASK),
    "staggered_score": lambda m, d: m.staggered_score(
        m.get_score(d["log_p"], d["xt"], d["sigma"], MASK), d["dsigma"],
        MASK),
    "transp_transition": lambda m, d: m.transp_transition(
        d["xt"], d["sigma"], V, MASK),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_legacy_function_matches_jax(name):
    d = data()
    want = np.asarray(CASES[name](jl, {k: jnp.asarray(v)
                                       for k, v in d.items()}))
    got = CASES[name](tl, {k: torch.from_numpy(v) for k, v in d.items()})
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_losses_are_zero_where_unmasked():
    d = {k: torch.from_numpy(v) for k, v in data(1).items()}
    unmasked = d["xt"] != MASK
    ent = tl.score_entropy(tl.sedd_parameterization(
        d["logits"], d["xt"], d["sigma"]), d["sigma"], d["xt"], d["x0"],
        MASK)
    vb = tl.d3pm_loss(tl.d3pm_parameterization(d["logits"]), d["xt"],
                      d["x0"], d["t"], 1000, MASK)
    assert not ent[unmasked].any() and not vb[unmasked].any()
    assert ent[~unmasked].abs().min() > 0
