"""The port's noise schedules and byte tokenizer against the JAX
package's (float32 on both sides: atol 1e-6, rtol 1e-5; the tokenizer
exactly)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.config import NoiseConfig as JaxNoiseConfig
from unidisc_tpu.diffusion.noise import get_noise as jax_get_noise
from unidisc_tpu.tokenizers import text as jax_text
from unidisc_tpu_torch.config import NoiseConfig
from unidisc_tpu_torch.diffusion.noise import get_noise
from unidisc_tpu_torch.tokenizers import text
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

T = np.linspace(0.0, 0.99, 23, dtype=np.float32)


@pytest.mark.parametrize("kind", ["loglinear", "cosine", "cosinesqr",
                                  "linear", "geometric"])
def test_schedules_match_jax(kind):
    ours = get_noise(NoiseConfig(type=kind))
    theirs = jax_get_noise(JaxNoiseConfig(type=kind))
    t = torch.from_numpy(T)
    for method in ("total", "rate", "importance_sampling_transformation"):
        if not hasattr(theirs, method):
            assert not hasattr(ours, method)
            continue
        want = np.asarray(getattr(theirs, method)(jnp.asarray(T)))
        got = getattr(ours, method)(t).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5,
                                   err_msg=f"{kind}.{method}")
    with pytest.raises(ValueError):
        get_noise(NoiseConfig(type="nope"))


def test_byte_tokenizer_matches_jax():
    ours, theirs = text.get_tokenizer("byte"), jax_text.get_tokenizer("byte")
    samples = ["a red cube", "", "café <image> and more",
               "x" * 200]
    for s in samples:
        assert ours.encode(s) == theirs.encode(s)
        assert ours.encode(s, add_bos=False, add_eos=False) == \
            theirs.encode(s, add_bos=False, add_eos=False)
        assert ours.decode(ours.encode(s)) == theirs.decode(theirs.encode(s))
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(ours(samples, max_length=32)[key],
                                      theirs(samples, max_length=32)[key])
    ids = np.asarray([[5, 6, 2, 7, 8], [9, 2, 2, 10, 11]])
    np.testing.assert_array_equal(text.mask_after_eos(ids, 2, 0),
                                  jax_text.mask_after_eos(ids, 2, 0))
    assert text.wrapped_batch_decode(ours, ids) == \
        jax_text.wrapped_batch_decode(theirs, ids)
    with pytest.raises(NotImplementedError):
        text.get_tokenizer("gpt2")
