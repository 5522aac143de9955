"""The port's forward (corruption) process against the JAX package's.

The JAX functions draw from a PRNG key; these tests replay that draw in
JAX (the same splits and fold_ins as `forward_process.py`) and inject the
resulting numbers into the port. With the same draws the results must be
exactly equal: every branch is a comparison or a selection, and sample_t
repeats the same fp32 operations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.diffusion import forward_process as jfp
from unidisc_tpu_torch.diffusion import forward_process as tfp
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

B, TXT, IMG = 6, 8, 12
L = TXT + IMG
TXT_V, V = 30, 70
MASK = TXT_V - 1


def replay(rng, b, l):
    """The draws of jfp.q_xt(rng, ...) for every branch, as tensors."""
    k_move, k_txt, k_img = jax.random.split(rng, 3)
    k_rand = jax.random.fold_in(rng, 9)
    k_t, k_i = jax.random.split(k_rand)
    d = {"move": jax.random.uniform(k_move, (b, l)),
         "txt": jax.random.uniform(k_txt, (b, 1)),
         "img": jax.random.uniform(k_img, (b, 1)),
         "block": jax.random.uniform(jax.random.fold_in(rng, 3), (b, l)),
         "drop": jax.random.uniform(jax.random.fold_in(rng, 5), (b,)),
         "txt_rand": jax.random.randint(k_t, (b, l), 0, TXT_V - 1),
         "img_rand": jax.random.randint(k_i, (b, l), TXT_V, V),
         "rand": jax.random.randint(k_rand, (b, l), 0, V)}
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def batch(seed=0):
    rng = np.random.RandomState(seed)
    modality = np.zeros((B, L), np.int32)
    modality[:, TXT:] = 1
    modality[1] = 0                      # a text-only row
    x = np.where(modality == 0, rng.randint(0, TXT_V - 1, (B, L)),
                 rng.randint(TXT_V, V, (B, L))).astype(np.int32)
    move = rng.uniform(0.05, 0.95, B).astype(np.float32)
    return x, modality, move


@pytest.mark.parametrize("antithetic", [True, False])
@pytest.mark.parametrize("force", [None, 0.3])
def test_sample_t_exact(antithetic, force):
    rng = jax.random.PRNGKey(11)
    want = jfp.sample_t(rng, 7, antithetic=antithetic, sampling_eps=1e-3,
                        force_timestep=force)
    u = torch.from_numpy(np.array(jax.random.uniform(rng, (7,))))
    got = tfp.sample_t(7, antithetic=antithetic, sampling_eps=1e-3,
                       force_timestep=force, draws={"t": u})
    assert np.array_equal(got.numpy(), np.asarray(want))


BRANCHES = {
    "plain": {},
    "entire_modality_multimodal": {"mask_entire_modality": 0.9},
    "entire_modality_static": {"mask_entire_modality": 0.9,
                               "multimodal": False},
    "protect_first": {"protect_first": True},
    "first_token_dropout": {"first_token_dropout": 0.5},
    "allow_move_mask": {"_allow": True},
    "uniform_split": {"diffusion_mode": "uniform", "text_vocab_size": TXT_V,
                      "vocab_size": V},
    "uniform_full_vocab": {"diffusion_mode": "uniform", "vocab_size": V,
                           "_no_modality": True},
    "interleaved_blocks": {"mask_entire_modality": 0.4, "_samples": True},
}


@pytest.mark.parametrize("name", sorted(BRANCHES))
@pytest.mark.parametrize("seed", [0, 1])
def test_q_xt_exact(name, seed):
    x, modality, move = batch(seed)
    kw = dict(BRANCHES[name])
    rng = jax.random.PRNGKey(100 + seed)
    jkw, tkw = {}, {}
    if not kw.pop("_no_modality", False):
        jkw["modality"], tkw["modality"] = (jnp.asarray(modality),
                                            torch.from_numpy(modality))
    if kw.pop("_allow", False):
        allow = np.random.RandomState(seed).rand(B, L) > 0.3
        jkw["allow_move_mask"] = jnp.asarray(allow)
        tkw["allow_move_mask"] = torch.from_numpy(allow)
    if kw.pop("_samples", False):
        sid = np.zeros((B, L), np.int32)
        sid[:, L // 2:] = 1
        sid[0, -3:] = -1
        modality[:, 3:6] = 1 - modality[:, 3:6]   # more, shorter blocks
        jkw["modality"] = jnp.asarray(modality)
        tkw["modality"] = torch.from_numpy(modality)
        jkw["sample_ids"] = jnp.asarray(sid)
        tkw["sample_ids"] = torch.from_numpy(sid)
    want = jfp.q_xt(rng, jnp.asarray(x), jnp.asarray(move), MASK, **jkw,
                    **kw)
    got = tfp.q_xt(torch.from_numpy(x), torch.from_numpy(move), MASK, **tkw,
                   **kw, draws=replay(rng, B, L))
    for field in tfp.CorruptionResult._fields:
        assert np.array_equal(getattr(got, field).numpy(),
                              np.asarray(getattr(want, field))), field


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interleaved_block_mask_exact(seed):
    rng = np.random.RandomState(seed)
    b, l = 4, 40
    modality = (rng.rand(b, l) < 0.5).astype(np.int32)
    modality = np.repeat(modality[:, ::5], 5, axis=1)   # runs of 5 or more
    sid = np.repeat(rng.randint(-1, 3, (b, 4)), 10, axis=1).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    want = jfp.interleaved_block_mask(key, jnp.asarray(modality),
                                      jnp.asarray(sid), 0.45)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (b, l))))
    got = tfp.interleaved_block_mask(torch.from_numpy(modality),
                                     torch.from_numpy(sid), 0.45, u=u)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[0].any()


def test_draws_from_a_generator_are_reproducible():
    x, modality, move = batch(0)
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        runs.append(tfp.q_xt(torch.from_numpy(x), torch.from_numpy(move),
                             MASK, modality=torch.from_numpy(modality),
                             mask_entire_modality=0.15, generator=gen))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
