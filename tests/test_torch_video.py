"""The port's video VQVAE (unidisc_tpu_torch/tokenizers/video.py) and
get_video_codec against unidisc_tpu/tokenizers/video.py and JAX's
get_video_codec.

The same weights (flax parameters drawn with numpy, DHWIO kernels carried
over by video_state_dict_from_jax) and the same clips go through both
sides at a tiny config (ch 16, ch_mult (1, 2), 8 frames of 16 px): the
latents, the decode of JAX's ids and the round trip agree within atol
1e-4 / rtol 1e-3 (fp32 3D convolutions in another order, GroupNorm's
variance taken two ways); ids are compared where the top-2 margin of the
codebook scores exceeds ID_MARGIN. The layout rules are held on their
own: flax's stride-2 4^3 conv with padding=1 equals torch's padding=1,
and jax.image.resize "nearest" at 2x equals repeat_interleave on each
axis, which F.interpolate gives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unidisc_tpu.tokenizers import image_codecs as JC
from unidisc_tpu.tokenizers import video as J
from unidisc_tpu_torch.tokenizers import image_codecs as TC
from unidisc_tpu_torch.tokenizers import video as T
from test_torch_magvit import reference
from test_torch_vqgan import random_params
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

ATOL, RTOL = 1e-4, 1e-3
ID_MARGIN = 1e-4
CLEAR_SHARE = 0.9
TINY = dict(codebook_size=64, codebook_dim=16, ch=16, ch_mult=(1, 2),
            num_res_blocks=1)


def clips(b=2, frames=8, size=16, seed=0):
    return np.random.RandomState(seed).uniform(
        -1, 1, (b, frames, size, size, 3)).astype(np.float32)


def test_video_vqvae_matches_flax():
    fm = J.VideoVQVAE(J.VideoVQConfig(**TINY))
    params = random_params(fm, clips(1))
    model = T.VideoVQVAE(T.VideoVQConfig(**TINY)).eval()
    model.load_state_dict(T.video_state_dict_from_jax(params))
    x = clips()
    want_z, want_ids, want_rec, _ = reference(fm, params, x, (2, 4))
    with torch.no_grad():
        z = model.latents(torch.from_numpy(x))
        ids = model.encode(torch.from_numpy(x)).numpy()
        rec = model.decode(torch.tensor(want_ids), 2, 4).numpy()
        auto, auto_ids = model(torch.from_numpy(x))
        cb = model._codes()
        zn = z / z.norm(dim=-1, keepdim=True)
        top = (zn @ cb.T - 0.5 * (cb * cb).sum(-1)).topk(2, -1).values
    np.testing.assert_allclose(z.numpy(), want_z, atol=ATOL, rtol=RTOL)
    clear = ((top[..., 0] - top[..., 1]) > ID_MARGIN).reshape(2, -1).numpy()
    assert clear.mean() >= CLEAR_SHARE, clear.mean()
    np.testing.assert_array_equal(ids[clear], want_ids[clear])
    np.testing.assert_allclose(rec, want_rec, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(auto_ids.numpy(), ids)
    assert ids.shape == (2, 2 * 4 * 4) and auto.shape == x.shape
    # an id past the codebook: JAX's take fills NaN, the port raises
    with pytest.raises(ValueError, match="outside the codebook"):
        model.decode(torch.full((1, 32), 64), 2, 4)


def test_layouts_match_jax():
    """flax's Conv((4, 4, 4), strides 2, padding=1) is torch's symmetric
    padding 1; jax.image.resize "nearest" at exactly 2x is
    repeat_interleave on each axis, and F.interpolate's nearest."""
    rng = np.random.RandomState(2)
    x = rng.standard_normal((1, 6, 8, 10, 3)).astype(np.float32)
    import flax.linen as nn
    conv = nn.Conv(5, (4, 4, 4), strides=(2, 2, 2), padding=1)
    kernel = rng.standard_normal((4, 4, 4, 3, 5)).astype(np.float32)
    want = np.asarray(conv.apply({"params": {"kernel": kernel,
                                             "bias": np.zeros(5, np.float32)}},
                                 jnp.asarray(x)))
    got = F.conv3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                   torch.from_numpy(kernel).permute(4, 3, 0, 1, 2),
                   stride=2, padding=1).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    up = np.asarray(jax.image.resize(jnp.asarray(x), (1, 12, 16, 20, 3),
                                     "nearest"))
    rep = torch.from_numpy(x)
    for axis in (1, 2, 3):
        rep = rep.repeat_interleave(2, axis)
    np.testing.assert_array_equal(up, rep.numpy())
    interp = F.interpolate(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                           scale_factor=2, mode="nearest")
    np.testing.assert_array_equal(interp.permute(0, 2, 3, 4, 1).numpy(), up)


def test_get_video_codec_matches_jax(monkeypatch):
    """The factory: JAX's vocabulary, downsample and name, its weights
    carried over encode and decode clips as JAX's codec does; the image
    factory points video users at it, as JAX's does."""
    params = random_params(J.VideoVQVAE(J.VideoVQConfig(**TINY)),
                           clips(1), seed=3)
    # the weights drawn from the abstract shapes (a traced init compiles
    # every layer)
    monkeypatch.setattr(J.VideoVQVAE, "init",
                        lambda self, rng, x: {"params": params})
    jcodec = JC.get_video_codec("video", frames=8, image_size=16, **TINY)
    codec = TC.get_video_codec("video", frames=8, image_size=16,
                               device="cpu", **TINY)
    codec.module.load_state_dict(T.video_state_dict_from_jax(params))
    assert (codec.name, codec.vocab_size, codec.downsample) == (
        jcodec.name, jcodec.vocab_size, jcodec.downsample) == (
        "video-vqvae", 64, 4)
    x = clips(seed=5)

    @jax.jit
    def reference(p, x):
        ids = jcodec.encode(p, x)
        return ids, jcodec.decode(p, ids)

    want, want_rec = map(np.asarray, reference(params, jnp.asarray(x)))
    ids = codec.encode(x)
    assert ids.dtype == torch.int64 and ids.shape == want.shape == (2, 32)
    np.testing.assert_allclose(codec.decode(want).numpy(), want_rec,
                               atol=ATOL, rtol=RTOL)
    for factory in (lambda: JC.get_codec("video-vqvae"),
                    lambda: TC.get_codec("video-vqvae", device="cpu")):
        with pytest.raises(ValueError, match="get_video_codec"):
            factory()
    for factory in (lambda: JC.get_video_codec("nope"),
                    lambda: TC.get_video_codec("nope", device="cpu")):
        with pytest.raises(ValueError, match="unknown video codec"):
            factory()
    assert (T.VideoVQConfig().downsample, T.VideoVQConfig().codebook_size) \
        == (4, 2048)
