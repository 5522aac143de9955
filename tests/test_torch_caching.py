"""The port's attention-caching sampler (sampling/caching.py) against
JAX's build_caching_sampler, token for token.

The JAX sampler draws from one key: each step splits it into (key, token
key, confidence key), the token pick is argmax(p / (E + 1e-10)) with
E = exponential(token key) and the confidence noise gumbel(confidence
key). The test replays that derivation and injects the same draws into
the port's sampler, so the two must give the same tokens and the same
NFE. Both modes (recompute txt and img), CFG on and off, the int8 KV
cache, and txt_to_img_ratio 0 (refresh only at step 0); a tiny flagship-
shaped DIT (fp32, random weights from abstract shapes), B 2, 8 text + 16
image tokens, 8 maskgit steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.config import Config as JaxConfig
from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.sampling.caching import \
    build_caching_sampler as jax_build_caching_sampler
from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.device import cap_test_threads
from unidisc_tpu_torch.models.dit import DIT
from unidisc_tpu_torch.models.port import dit_state_dict_from_jax
from unidisc_tpu_torch.sampling.caching import build_caching_sampler
from test_torch_interleaved import abstract_random_params

cap_test_threads()

B, TXT, IMG, STEPS = 2, 8, 16, 8
L = TXT + IMG
OVER = {"model.length": L, "model.txt_length": TXT, "model.img_length": IMG,
        "model.text_vocab_size": 24, "model.image_vocab_size": 24,
        "model.dropout": 0.0, "model.time_conditioning": True,
        "model.force_argmax_valid_indices": True, "model.qk_norm": True,
        "model.norm_type": "rms", "model.modality_embed": True,
        "model.rope_2d": True, "model.zero_linear_init": False,
        "sampling.steps": STEPS, "sampling.predictor": "maskgit"}

# recompute, txt_to_img_ratio, extra overrides
CASES = {
    "txt_ratio4": ("txt", 4, {}),
    "txt_ratio4_cfg": ("txt", 4, {"sampling.cfg": 1.5}),
    "img_ratio3_cfg": ("img", 3, {"sampling.cfg": 2.0}),
    "txt_ratio0": ("txt", 0, {}),
    "img_ratio4_int8_kv": ("img", 4, {"model.kv_cache_dtype": "int8"}),
}


def rows(m, seed):
    rng = np.random.RandomState(seed)
    x0 = np.concatenate([rng.randint(0, m.text_vocab_size - 1, (B, TXT)),
                         rng.randint(m.text_vocab_size, m.vocab_size,
                                     (B, IMG))], 1).astype(np.int32)
    unmask = np.zeros((B, L), bool)
    unmask[:, :TXT] = True
    unmask[1, TXT:TXT + 3] = True      # a row with given image tokens too
    modality = np.concatenate([np.zeros((B, TXT)), np.ones((B, IMG))],
                              1).astype(np.int32)
    return x0, unmask, modality


def jax_draws(key, m):
    """The exponential and Gumbel draws of JAX's loop from `key`."""
    exp, gum = [], []
    rng = key
    for _ in range(STEPS):
        rng, k_tok, k_g = jax.random.split(rng, 3)
        exp.append(jax.random.exponential(k_tok, (B, L, m.vocab_size),
                                          dtype=jnp.float32))
        gum.append(jax.random.gumbel(k_g, (B, L)))
    return {"exp": torch.from_numpy(np.stack(exp)),
            "gumbel": torch.from_numpy(np.stack(gum))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_caching_sampler_matches_jax(case):
    recompute, ratio, extra = CASES[case]
    over = {**OVER, **extra}
    jcfg, tcfg = JaxConfig.make("tiny", **over), Config.make("tiny", **over)
    m = jcfg.model
    params = abstract_random_params(jcfg, seed=1)
    x0, unmask, modality = rows(m, seed=2)
    key = jax.random.PRNGKey(5)
    jmodel = JaxDIT(m, compute_dtype=jnp.float32)
    want = jax.jit(jax_build_caching_sampler(
        jmodel, jcfg, txt_to_img_ratio=ratio, recompute=recompute))(
        params, key, jnp.asarray(x0), jnp.asarray(unmask),
        jnp.asarray(modality))
    model = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    model.load_state_dict(dit_state_dict_from_jax(params))
    sampler = build_caching_sampler(model, tcfg, txt_to_img_ratio=ratio,
                                    recompute=recompute, inject_noise=True,
                                    device="cpu")
    got = sampler(x0, unmask, modality, injected=jax_draws(key, m))
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    assert got.nfe == int(want.nfe)
    tokens = got.tokens.numpy()
    assert not (tokens == m.mask_index).any()
    np.testing.assert_array_equal(tokens[unmask], x0[unmask])
    assert (tokens[:, TXT:] >= m.text_vocab_size).all()


def test_partial_steps_reveal_only_their_part():
    """recompute="txt" with a ratio past the step count: image tokens are
    revealed only at step 0 and the final pass (the trajectory), and the
    NFE is JAX's formula, 1 + 1 + (steps - 1) x txt / L."""
    over = {**OVER, "sampling.steps": 6}
    tcfg = Config.make("tiny", **over)
    model = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    from unidisc_tpu_torch.models.dit import randomize_
    randomize_(model, 3)
    x0, _, modality = rows(tcfg.model, seed=4)
    unmask = np.zeros((B, L), bool)     # nothing given: text is generated
    sampler = build_caching_sampler(model, tcfg, txt_to_img_ratio=100,
                                    return_trajectory=True, device="cpu")
    out, traj = sampler(x0, unmask, modality,
                        generator=torch.Generator().manual_seed(0))
    mask = tcfg.model.mask_index
    img_masked = (traj[:, :, TXT:] == mask).sum(dim=(1, 2))
    assert (img_masked[1:] == img_masked[0]).all()
    assert out.nfe == 2 + (5 * TXT) // L
    assert not (out.tokens == mask).any()
    with pytest.raises(ValueError, match="recompute"):
        build_caching_sampler(model, tcfg, recompute="both", device="cpu")
