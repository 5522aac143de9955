"""The port's SUBS parameterization and losses against the JAX package's.

Same numpy inputs on both sides, fp32: atol 1e-5 (rtol 1e-5). The -1e6
entries of the SUBS output are compared like the rest.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.diffusion import loss as jloss
from unidisc_tpu.diffusion import subs as jsubs
from unidisc_tpu_torch.diffusion import loss as tloss
from unidisc_tpu_torch.diffusion import subs as tsubs
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

ATOL = RTOL = 1e-5
B, L, TXT_V, V = 3, 10, 12, 20
MASK = TXT_V - 1


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    logits = (3 * rng.standard_normal((B, L, V))).astype(np.float32)
    modality = np.zeros((B, L), np.int32)
    modality[:, 4:] = 1
    x0 = np.where(modality == 0, rng.randint(0, TXT_V - 1, (B, L)),
                  rng.randint(TXT_V, V, (B, L))).astype(np.int32)
    xt = np.where(rng.rand(B, L) < 0.5, MASK, x0).astype(np.int32)
    sigma = rng.uniform(0.1, 3.0, B).astype(np.float32)
    dsigma = rng.uniform(0.5, 2.0, B).astype(np.float32)
    attn = rng.rand(B, L) > 0.15
    ignore = np.asarray([False, True, False])
    return logits, x0, xt, modality, sigma, dsigma, attn, ignore


def close(got, want):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor)
                               else got, np.asarray(want), atol=ATOL,
                               rtol=RTOL)


T = torch.from_numpy
J = jnp.asarray


def test_restrict_modality_logits():
    logits, _, _, modality, *_ = inputs()
    close(tsubs.restrict_modality_logits(T(logits), T(modality).long(),
                                         TXT_V),
          jsubs.restrict_modality_logits(J(logits), J(modality), TXT_V))


@pytest.mark.parametrize("carry_over", [True, False])
@pytest.mark.parametrize("restrict", [True, False])
@pytest.mark.parametrize("normalize", [True, False])
def test_subs_parameterization(carry_over, restrict, normalize):
    logits, _, xt, modality, *_ = inputs(1)
    kw_t = dict(modality=T(modality).long() if restrict else None,
                text_vocab_size=TXT_V, normalize=normalize)
    kw_j = dict(modality=J(modality) if restrict else None,
                text_vocab_size=TXT_V, normalize=normalize)
    got = tsubs.subs_parameterization(
        T(logits), T(xt).long() if carry_over else None, MASK, **kw_t)
    want = jsubs.subs_parameterization(
        J(logits), J(xt) if carry_over else None, MASK, **kw_j)
    close(got, want)


@pytest.mark.parametrize("restrict", [True, False])
def test_subs_log_p_at_equals_the_gathered_full_tensor(restrict):
    logits, x0, xt, modality, *_ = inputs(2)
    xt[0, 0] = x0[0, 0] + 1 if x0[0, 0] + 1 != MASK else 0  # carry-over miss
    kw = dict(modality=T(modality).long() if restrict else None,
              text_vocab_size=TXT_V)
    full = tsubs.subs_parameterization(T(logits), T(xt).long(), MASK, **kw)
    want = full.gather(-1, T(x0).long()[..., None]).squeeze(-1)
    got = tsubs.subs_log_p_at(T(logits), T(xt).long(), T(x0).long(), MASK,
                              **kw)
    assert torch.equal(got, want)
    assert got[0, 0] == tsubs.NEG_INFINITY


LOSS_VARIANTS = {
    "nelbo": {},
    "softmin_snr": {"softmin_snr": 5.0},
    "modality_weights": {"softmin_snr": 5.0, "text_loss_weight": 1.0,
                         "img_loss_weight": 0.6},
    "cov_weight": {"cov_weight": -0.0009995},
    "no_ce_weighting": {"no_ce_weighting": True, "softmin_snr": 5.0},
    "no_mask_no_ignore": {"_plain": True},
}


@pytest.mark.parametrize("variant", sorted(LOSS_VARIANTS))
def test_diffusion_loss(variant):
    logits, x0, xt, modality, sigma, dsigma, attn, ignore = inputs(3)
    kw = dict(LOSS_VARIANTS[variant])
    plain = kw.pop("_plain", False)
    log_p_j = jsubs.subs_parameterization(J(logits), J(xt), MASK,
                                          modality=J(modality),
                                          text_vocab_size=TXT_V)
    want = jloss.diffusion_loss(
        log_p_j, J(x0), J(sigma), J(dsigma),
        attention_mask=None if plain else J(attn), modality=J(modality),
        batch_ignore=None if plain else J(ignore), **kw)
    log_p_t = torch.from_numpy(np.asarray(log_p_j).copy())
    got = tloss.diffusion_loss(
        log_p_t, T(x0).long(), T(sigma), T(dsigma),
        attention_mask=None if plain else T(attn), modality=T(modality),
        batch_ignore=None if plain else T(ignore), **kw)
    for name in tloss.LossOutput._fields:
        g, w = getattr(got, name), getattr(want, name)
        if g.dtype == torch.bool:
            assert np.array_equal(g.numpy(), np.asarray(w)), name
        else:
            close(g, w)


@pytest.mark.parametrize("softmin", [None, 5.0])
def test_nelbo_weighting(softmin):
    *_, sigma, dsigma, _, _ = inputs(4)
    close(tloss.nelbo_weighting(T(sigma), T(dsigma), softmin),
          jloss.nelbo_weighting(J(sigma), J(dsigma), softmin))


@pytest.mark.parametrize("restrict", [True, False])
def test_ar_llm_token_nll(restrict):
    logits, x0, _, modality, *_ = inputs(5)
    close(tloss.ar_llm_token_nll(
        T(logits), T(x0).long(), MASK,
        modality=T(modality).long() if restrict else None,
        text_vocab_size=TXT_V if restrict else None),
        jloss.ar_llm_token_nll(
            J(logits), J(x0), MASK,
            modality=J(modality) if restrict else None,
            text_vocab_size=TXT_V if restrict else None))


@pytest.mark.parametrize("with_mask", [True, False])
def test_ar_loss(with_mask):
    logits, x0, _, modality, _, _, attn, _ = inputs(6)
    got = tloss.ar_loss(T(logits[:, :-1]), T(x0[:, 1:]).long(), MASK,
                        attention_mask=T(attn[:, 1:]) if with_mask else None,
                        modality=T(modality[:, 1:]).long(),
                        text_vocab_size=TXT_V)
    want = jloss.ar_loss(J(logits[:, :-1]), J(x0[:, 1:]), MASK,
                         attention_mask=J(attn[:, 1:]) if with_mask else None,
                         modality=J(modality[:, 1:]), text_vocab_size=TXT_V)
    close(got.loss, want.loss)
    close(got.nlls, want.nlls)
    assert np.array_equal(got.token_mask.numpy(), np.asarray(want.token_mask))
