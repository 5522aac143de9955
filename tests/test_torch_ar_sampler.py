"""The port's AR decode loop (sampling/ar_sampler.py) against the JAX
package's build_ar_sampler, token for token.

A tiny causal flagship-shaped DIT (tests/test_torch_dit.py's config, L 24
= 8 text + 16 image tokens, force_argmax_valid_indices) at identical fp32
weights: random_params, then every leaf moved by 0.5 N(0, 1) from a numpy
seed so that greedy decoding depends on the content (as the JAX package's
AR tests perturb theirs). Conditioning is teacher-forced at a prompt and at
an infill span. Greedy; Gumbel at temperature 1 and 0.7; CFG with the
annealed weight and with force_cfg_value; nucleus (top_p) under CFG; and
greedy on the int8 KV cache. The noise is JAX's injected contract
(injected["gumbel"][i], injected["exp"][i]), so the tokens must be equal.
The port's own properties: the chunk length does not change the tokens, a
state is reloaded cleanly, and the keyed noise reproduces by seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.models.dit import init_dit
from unidisc_tpu.sampling.ar_sampler import build_ar_sampler as jax_build
from unidisc_tpu.sampling.ar_sampler import make_apply_token as jax_apply
from unidisc_tpu_torch.sampling.ar_sampler import (build_ar_sampler,
                                                   make_apply_token)
from test_torch_dit import B, IMG, L, TXT, configs, port_model, random_params
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

AR = {"trainer.parameterization": "ar", "trainer.ar_shift": True,
      "model.full_attention": False,
      "model.force_argmax_valid_indices": True}


def flax_dit(jcfg):
    return JaxDIT(jcfg.model, compute_dtype=jnp.float32)


def ar_params(jcfg, seed=1, scale=0.5):
    """random_params at the flax DIT's shapes (an abstract init: nothing
    is traced to XLA), moved by scale N(0, 1): greedy tokens then depend
    on the content."""
    shapes = jax.eval_shape(lambda key: init_dit(
        key, jcfg.model, compute_dtype=jnp.float32)[1],
        jax.random.PRNGKey(0))
    flat = traverse_util.flatten_dict(random_params(shapes), sep="/")
    rng = np.random.RandomState(seed)
    return traverse_util.unflatten_dict(
        {k: (np.asarray(v) + scale * rng.standard_normal(np.shape(v))
             ).astype(np.float32) for k, v in flat.items()}, sep="/")


def ar_models(**extra):
    """(jax config, port config, flax module, params, port DIT) of a
    causal tiny DIT."""
    jcfg, tcfg = configs(**AR, **extra)
    params = ar_params(jcfg)
    return jcfg, tcfg, flax_dit(jcfg), params, port_model(tcfg, params)


@pytest.fixture(scope="module")
def base():
    jcfg, _ = configs(**AR)
    return ar_params(jcfg)


def inputs(m, seed=0):
    """x0 with a 5-token prompt on every row and a teacher-forced span in
    row 1's image."""
    rng = np.random.RandomState(seed)
    x0 = np.concatenate([rng.randint(0, m.text_vocab_size, (B, TXT)),
                         rng.randint(m.text_vocab_size, m.vocab_size,
                                     (B, IMG))], 1)
    modality = np.concatenate([np.zeros((B, TXT)), np.ones((B, IMG))],
                              1).astype(np.int64)
    unmask = np.zeros((B, L), bool)
    unmask[:, :5] = True
    unmask[1, 12:15] = True
    return x0, unmask, modality


CASES = {
    "greedy": ({"sampling.temperature": 0.0, "sampling.cfg": None}, None),
    "gumbel": ({"sampling.temperature": 1.0, "sampling.cfg": None},
               "gumbel"),
    "cfg_annealed": ({"sampling.temperature": 0.7, "sampling.cfg": 2.0},
                     "gumbel"),
    "cfg_forced": ({"sampling.temperature": 0.7, "sampling.cfg": 2.0,
                    "sampling.force_cfg_value": True}, "gumbel"),
    "nucleus_cfg": ({"sampling.temperature": 1.0, "sampling.cfg": 1.5,
                     "sampling.top_p": 0.9}, "exp"),
    "greedy_int8_kv": ({"sampling.temperature": 0.0, "sampling.cfg": 2.0,
                        "model.kv_cache_dtype": "int8"}, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tokens_match_jax(base, case):
    extra, noise = CASES[case]
    jcfg, tcfg = configs(**AR, **extra)
    jmodel = flax_dit(jcfg)
    model = port_model(tcfg, base)
    m = jcfg.model
    x0, unmask, modality = inputs(m)
    injected = None
    if noise is not None:
        rng = np.random.RandomState(7)
        shape = (L - 1, B, m.vocab_size)
        injected = {noise: (rng.gumbel(size=shape) if noise == "gumbel"
                            else rng.exponential(size=shape)
                            ).astype(np.float32)}
    sample = jax.jit(jax_build(jax_apply(jmodel), jcfg))
    want = np.asarray(sample(base, jax.random.PRNGKey(0), jnp.asarray(x0),
                             jnp.asarray(unmask), jnp.asarray(modality),
                             injected).tokens)
    sampler = build_ar_sampler(make_apply_token(model), tcfg, chunk=5,
                               inject_noise=noise is not None, device="cpu")
    out = sampler(x0, unmask, modality, injected=injected)
    got = out.tokens.numpy()
    np.testing.assert_array_equal(got, want)
    assert out.nfe == L - 1
    np.testing.assert_array_equal(got[unmask], x0[unmask])
    # every generated token is of its position's modality
    assert (got[:, :TXT] < m.text_vocab_size).all()
    assert (got[:, TXT:] >= m.text_vocab_size).all()


def test_chunk_length_and_reload_do_not_change_tokens(base):
    """The decode is the same in chunks of 1, 5 or past the end, and a
    state loaded again after a full run decodes the same."""
    _, tcfg = configs(**AR, **{"sampling.temperature": 0.8,
                               "sampling.cfg": 2.0})
    apply = make_apply_token(port_model(tcfg, base))
    x0, unmask, modality = inputs(tcfg.model, seed=2)
    outs = []
    for chunk in (1, 5, 40):
        sampler = build_ar_sampler(apply, tcfg, chunk=chunk, device="cpu")
        assert sampler.n_chunks == -(-(L - 1) // chunk)
        outs.append(sampler(x0, unmask, modality, seed=3).tokens)
    sampler = build_ar_sampler(apply, tcfg, chunk=5, device="cpu")
    state = sampler.init_state(B)
    for _ in range(2):
        sampler.load(state, x0, unmask, modality, seed=3)
        for _ in range(sampler.n_chunks):
            sampler.step_chunk(state)
        assert int(state.i) == L - 1
        outs.append(sampler.result(state).tokens)
        # a chunk past the end changes no token
        sampler.step_chunk(state)
        assert torch.equal(sampler.result(state).tokens, outs[-1])
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_keyed_noise_reproduces_by_seed(base):
    _, tcfg = configs(**AR, **{"sampling.temperature": 1.0,
                               "sampling.cfg": None})
    sampler = build_ar_sampler(make_apply_token(port_model(tcfg, base)),
                               tcfg, device="cpu")
    x0, unmask, modality = inputs(tcfg.model)
    a = sampler(x0, unmask, modality, seed=11).tokens
    assert torch.equal(a, sampler(x0, unmask, modality, seed=11).tokens)
    assert not torch.equal(a, sampler(x0, unmask, modality, seed=12).tokens)


def test_keyed_noise_stays_finite_at_the_extreme_bits():
    """The keyed uniforms' conversion keeps its largest and smallest values
    strictly inside (0, 1), so the Gumbel noise of every draw is finite:
    with V = 48,385 ids a step, a value of 1.0 (an infinite Gumbel, which
    outranks the vocabulary restriction) came up at about one step in
    forty under the earlier 24-bit conversion."""
    from unidisc_tpu_torch.serving.rolling import unit_interval
    u = unit_interval(torch.tensor([0, 1, 2 ** 22, 2 ** 23 - 2, 2 ** 23 - 1]))
    assert float(u.min()) > 0 and float(u.max()) < 1
    assert torch.isfinite(-torch.log(-torch.log(u))).all()
    assert torch.isfinite(-torch.log(u)).all()
    assert len(set(u.tolist())) == 5


def test_refuses_a_bidirectional_model_and_wrong_noise(base):
    _, tcfg = configs(**{"sampling.cfg": None})
    apply = make_apply_token(port_model(configs(**AR)[1], base))
    with pytest.raises(ValueError, match="causal"):
        build_ar_sampler(apply, tcfg, device="cpu")
    _, tcfg = configs(**AR)
    sampler = build_ar_sampler(apply, tcfg, device="cpu")
    x0, unmask, modality = inputs(tcfg.model)
    with pytest.raises(ValueError, match="inject_noise"):
        sampler(x0, unmask, modality, injected={"gumbel": np.zeros(1)})
