"""The port's other samplers (sampling/extras.py) against JAX's, token for
token under injected noise: the analytic SEDD sampler, semi-AR block
stride (a time-conditioned model, where p(x0) is never reused, and one
without, where it is reused while the tokens stand), Tweedie best-of-N
with reward_on "tokens" and "tweedie_img", and class_conditional_prior.

A tiny DIT (fp32, random weights from abstract shapes), B 2, 8 text + 16
image tokens; JAX's forward_logits(params, x, sigma, modality) and the
port's forward_logits(x, sigma, modality) run the same weights. The
injected draws are numpy exponentials (the JAX contract: the token pick is
argmax(probs / E)). NFE equals JAX's in every case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.config import Config as JaxConfig
from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.sampling import extras as jextras
from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.device import cap_test_threads
from unidisc_tpu_torch.models.dit import DIT
from unidisc_tpu_torch.models.port import dit_state_dict_from_jax
from unidisc_tpu_torch.sampling import extras
from test_torch_interleaved import abstract_random_params

cap_test_threads()

B, TXT, IMG, STEPS = 2, 8, 16, 6
L = TXT + IMG
OVER = {"model.length": L, "model.txt_length": TXT, "model.img_length": IMG,
        "model.text_vocab_size": 24, "model.image_vocab_size": 24,
        "model.dropout": 0.0, "model.time_conditioning": True,
        "model.modality_embed": True, "model.rope_2d": True,
        "model.zero_linear_init": False, "sampling.steps": STEPS}


def setup(**extra):
    over = {**OVER, **extra}
    jcfg, tcfg = JaxConfig.make("tiny", **over), Config.make("tiny", **over)
    params = abstract_random_params(jcfg, seed=6)
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    model = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    model.load_state_dict(dit_state_dict_from_jax(params))

    def jfwd(p, x, sigma, modality):
        return jmodel.apply({"params": p}, x, sigma, modality=modality)

    def tfwd(x, sigma, modality):
        return model(x, sigma, modality=modality)
    return jcfg, tcfg, params, jfwd, tfwd


def rows(m, seed=0):
    rng = np.random.RandomState(seed)
    x0 = np.concatenate([rng.randint(0, m.text_vocab_size - 1, (B, TXT)),
                         rng.randint(m.text_vocab_size, m.vocab_size,
                                     (B, IMG))], 1).astype(np.int32)
    unmask = np.zeros((B, L), bool)
    unmask[:, :TXT] = True
    unmask[0, :3] = False
    modality = np.concatenate([np.zeros((B, TXT)), np.ones((B, IMG))],
                              1).astype(np.int32)
    return x0, unmask, modality


def exp_noise(shape, seed):
    return np.random.RandomState(seed).exponential(size=shape).astype(
        np.float32)


def test_analytic_sampler_matches_jax():
    jcfg, tcfg, params, jfwd, tfwd = setup()
    m = jcfg.model
    x0, unmask, modality = rows(m)
    noise = exp_noise((STEPS + 1, B, L, m.vocab_size), 1)
    want = jax.jit(jextras.build_analytic_sampler(jfwd, jcfg))(
        params, jax.random.PRNGKey(0), jnp.asarray(x0), jnp.asarray(unmask),
        jnp.asarray(modality), {"exp": jnp.asarray(noise)})
    got = extras.build_analytic_sampler(tfwd, tcfg, device="cpu")(
        x0, unmask, modality, injected={"exp": torch.from_numpy(noise)})
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    assert got.nfe == int(want.nfe) == STEPS + 1
    assert (got.tokens.numpy()[unmask] == x0[unmask]).all()


@pytest.mark.parametrize("time_conditioning", [True, False])
def test_semi_ar_sampler_matches_jax(time_conditioning):
    jcfg, tcfg, params, jfwd, tfwd = setup(
        **{"model.time_conditioning": time_conditioning})
    m = jcfg.model
    stride, strides, per = 4, 2, 5
    _, _, modality = rows(m)
    noise = exp_noise((strides + 1, per + 1, B, L, m.vocab_size), 2)
    want = jextras.build_semi_ar_sampler(
        jfwd, jcfg, stride_length=stride, num_strides=strides,
        steps_per_stride=per)(params, jax.random.PRNGKey(0), B,
                              jnp.asarray(modality),
                              {"exp": jnp.asarray(noise)})
    sampler = extras.build_semi_ar_sampler(
        tfwd, tcfg, stride_length=stride, num_strides=strides,
        steps_per_stride=per, device="cpu")
    assert sampler.reuses == (not time_conditioning)
    got = sampler(B, modality, injected={"exp": torch.from_numpy(noise)})
    assert got.tokens.shape == (B, strides * stride + L)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    assert got.nfe == int(want.nfe)
    if time_conditioning:
        assert got.nfe == (strides + 1) * (per + 2)


@pytest.mark.parametrize("reward_on", ["tokens", "tweedie_img"])
def test_tweedie_sampler_matches_jax(reward_on):
    jcfg, tcfg, params, jfwd, tfwd = setup()
    m = jcfg.model
    x0, unmask, modality = rows(m, seed=1)
    n = 3
    noise = exp_noise((STEPS, n, B, L, m.vocab_size), 3)

    def jreward(t):
        return jnp.sum(t % 5 == 2, axis=-1).astype(jnp.float32)

    def treward(t):
        return (t % 5 == 2).sum(-1).float()
    want = jax.jit(jextras.build_tweedie_sampler(
        jfwd, jcfg, jreward, n_candidates=n, reward_on=reward_on))(
        params, jax.random.PRNGKey(0), jnp.asarray(x0), jnp.asarray(unmask),
        jnp.asarray(modality), {"exp": jnp.asarray(noise)})
    got = extras.build_tweedie_sampler(
        tfwd, tcfg, treward, n_candidates=n, reward_on=reward_on,
        device="cpu")(x0, unmask, modality,
                      injected={"exp": torch.from_numpy(noise)})
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    assert got.nfe == int(want.nfe)


def test_class_conditional_prior_matches_jax():
    over = {**OVER, "model.add_labels": 10}
    jcfg, tcfg = JaxConfig.make("tiny", **over), Config.make("tiny", **over)
    label = np.asarray([3, 0, 9])
    wx0, wun = jextras.class_conditional_prior(label, jcfg)
    x0, un = extras.class_conditional_prior(label, tcfg, device="cpu")
    np.testing.assert_array_equal(x0.numpy(), np.asarray(wx0))
    np.testing.assert_array_equal(un.numpy(), np.asarray(wun))
    with pytest.raises(ValueError, match="add_labels"):
        extras.class_conditional_prior(label, Config.make("tiny", **OVER),
                                       device="cpu")
