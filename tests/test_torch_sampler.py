"""The port's generic sampler (build_sampler) against the JAX one, token
for token.

Both samplers take the same numpy noise through the injected-noise
contract ("exp" for the token picks, "gumbel" for maskgit's confidences,
"uniform" for first_hitting's positions) and run on identical weights
(the tiny flagship-shaped DIT of tests/test_torch_dit.py, fp32 on both
sides, carried over with dit_state_dict_from_jax). Each of the five
predictors runs with and without CFG on a batch whose rows condition on
the text, on the image, and on part of the text; the tokens and the NFE
must be equal. A ddpm run with a large sampling_eps leaves masks after the
loop, so the noise-removal pass and its extra NFE are compared too.
nucleus_sample is held to JAX's on its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.sampling import sampler as jax_sampler
from unidisc_tpu_torch.sampling import sampler
from test_torch_dit import B, TXT, configs, port_model, random_dit
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

STEPS = 5


def conditioning(m, seed):
    """x0, x0_unmask, modality: row 0 gives the text (text -> image), row 1
    the image (image -> text); both leave the rest masked."""
    rng = np.random.RandomState(seed)
    li = m.length - TXT
    x0 = np.concatenate([rng.randint(0, m.mask_index, (B, TXT)),
                         rng.randint(m.text_vocab_size, m.vocab_size,
                                     (B, li))], 1).astype(np.int32)
    unmask = np.zeros((B, m.length), bool)
    unmask[0, :TXT] = True
    unmask[1, TXT:] = True
    unmask[1, :3] = True                 # and a few text tokens (infill)
    modality = np.concatenate([np.zeros((B, TXT)), np.ones((B, li))],
                              1).astype(np.int32)
    return x0, unmask, modality


def run_both(predictor, cfg, seed=0, steps=STEPS, **extra):
    over = {"sampling.predictor": predictor, "sampling.steps": steps,
            "sampling.cfg": cfg, "model.force_argmax_valid_indices": True,
            **extra}
    jcfg, tcfg = configs(**over)
    m = jcfg.model
    jmodel, params = random_dit(m, seed=seed, compute_dtype=jnp.float32)
    x0, unmask, modality = conditioning(m, seed + 1)
    rng = np.random.RandomState(seed + 2)
    shape = (steps, B, m.length)
    injected = {
        "exp": rng.exponential(size=shape + (m.vocab_size,)
                               ).astype(np.float32),
        "gumbel": rng.gumbel(size=shape).astype(np.float32),
        "uniform": rng.uniform(size=shape).astype(np.float32)}

    def forward(p, x, sigma, mod):
        return jmodel.apply({"params": p}, x, sigma, modality=mod)

    jsample = jax.jit(jax_sampler.build_sampler(forward, jcfg,
                                                inject_noise=True))
    want = jsample(params, jax.random.PRNGKey(0), jnp.asarray(x0),
                   jnp.asarray(unmask), jnp.asarray(modality),
                   injected={k: jnp.asarray(v) for k, v in injected.items()})
    sample = sampler.build_sampler(port_model(tcfg, params), tcfg,
                                   inject_noise=True, device="cpu")
    got = sample(x0, unmask, modality,
                 injected={k: torch.from_numpy(v)
                           for k, v in injected.items()})
    return want, got, tcfg, (x0, unmask)


@pytest.mark.parametrize("cfg", [None, 2.0], ids=["no_cfg", "cfg"])
@pytest.mark.parametrize("predictor", ["ddpm", "ddpm_cache", "maskgit",
                                       "maskgit_nucleus", "first_hitting"])
def test_predictor_matches_jax_token_for_token(predictor, cfg):
    extra = {}
    if predictor == "maskgit_nucleus":
        extra = {"sampling.top_p": 0.9, "sampling.temperature": 0.8}
    want, got, tcfg, (x0, unmask) = run_both(predictor, cfg, **extra)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    assert got.nfe == int(want.nfe)
    m = tcfg.model
    tokens = got.tokens.numpy()
    assert not (tokens == m.mask_index).any()
    np.testing.assert_array_equal(tokens[unmask], x0[unmask])
    # generated ids lie in their modality's vocabulary
    assert (tokens[:, :TXT] < m.text_vocab_size).all()
    assert (tokens[:, TXT:] >= m.text_vocab_size).all()


@pytest.mark.parametrize("predictor", ["ddpm", "ddpm_cache"])
def test_noise_removal_pass_matches_jax(predictor):
    """With sampling_eps 0.5 the last reverse step leaves about half the
    masks, so the noise-removal pass runs: one more NFE, argmax p(x0)."""
    want, got, _, _ = run_both(predictor, 2.0, steps=2,
                               **{"sampling.sampling_eps": 0.5})
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    assert got.nfe == int(want.nfe)
    if predictor == "ddpm":
        assert got.nfe == 3


def test_ddpm_cache_skips_forwards_as_jax_does():
    """Many steps over few masks: most steps change nothing, so ddpm_cache
    reuses log p and its NFE is below the step count."""
    want, got, _, _ = run_both("ddpm_cache", None, steps=24)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    assert got.nfe == int(want.nfe) < 24


@pytest.mark.parametrize("top_p,temperature", [(0.9, 1.0), (0.5, 0.7),
                                               (1.0, 1.0)])
def test_nucleus_sample_matches_jax(top_p, temperature):
    rng = np.random.RandomState(3)
    logits = rng.standard_normal((4, 7, 50)).astype(np.float32) * 2
    logits[:, :, 30:] = -1e6            # a restricted vocabulary: ties at 0
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    exp_noise = rng.exponential(size=probs.shape).astype(np.float32)
    want = np.asarray(jax_sampler.nucleus_sample(
        None, jnp.asarray(probs), top_p, temperature,
        exp_noise=jnp.asarray(exp_noise)))
    got = sampler.nucleus_sample(torch.from_numpy(probs), top_p,
                                 temperature,
                                 exp_noise=torch.from_numpy(exp_noise))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() < 30).all()


def test_sampler_draws_from_generator_without_injection():
    _, tcfg = configs(**{"sampling.predictor": "maskgit",
                         "sampling.steps": 3, "sampling.cfg": 2.0})
    from unidisc_tpu_torch.models.dit import DIT
    model = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    m = tcfg.model
    x0, unmask, modality = conditioning(m, seed=4)
    sample = sampler.build_sampler(model, tcfg, device="cpu")
    a = sample(x0, unmask, modality,
               generator=torch.Generator().manual_seed(3))
    b = sample(x0, unmask, modality,
               generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.tokens, b.tokens) and a.nfe == b.nfe in (3, 4)
    assert not (a.tokens == m.mask_index).any()
    with pytest.raises(ValueError, match="predictor"):
        sampler.build_sampler(model, tcfg.override(
            **{"sampling.predictor": "ar"}), device="cpu")
    with pytest.raises(ValueError, match="injected"):
        sample(x0, unmask, modality, injected={})
    assert sampler.build_sampler(model, tcfg, device="cpu").capturable
    assert not sampler.build_sampler(model, tcfg.override(
        **{"sampling.predictor": "ddpm_cache"}), device="cpu").capturable


def test_sample_categorical_follows_probs():
    gen = torch.Generator().manual_seed(0)
    probs = torch.tensor([[0.0, 0.7, 0.3, 0.0]]).expand(20000, 4)
    picks = sampler.sample_categorical(probs, generator=gen)
    share = torch.bincount(picks, minlength=4).float() / picks.numel()
    assert share[0] == 0 and share[3] == 0
    assert abs(share[1].item() - 0.7) < 0.02
