"""The port's codec factory (unidisc_tpu_torch/tokenizers/image_codecs.py)
against unidisc_tpu/tokenizers/image_codecs.py, and its PNG encoder and
decoder (unidisc_tpu_torch/utils/png.py, the standard library) against
PIL.

With the JAX codec's weights carried over, the LFQ, BSQ and FSQ ids are
equal (integer arithmetic on the same signs and levels) and the decoded
pixels agree within 1e-5; the pixels and dummy codecs give equal ids and
pixels. Their inputs are multiples of 1/64, so that the cell means (sums
of 16 x 16 or 4 x 4 values) are exact in fp32 in any summation order: the
ids truncate those means, and a mean one ulp apart could truncate to
another id. The VQGAN presets reach the same modules as in JAX, and the
factory refuses the names JAX refuses.
"""

import base64
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from unidisc_tpu.serving import engine as jax_engine
from unidisc_tpu.tokenizers import image_codecs as J
from unidisc_tpu_torch.serving.engine import (decode_image_b64,
                                              encode_image_b64)
from unidisc_tpu_torch.tokenizers import image_codecs as T
from unidisc_tpu_torch.tokenizers.vqgan import (load_torch_state_dict,
                                                state_dict_from_jax)
from unidisc_tpu_torch.utils.png import decode_png, encode_png
from test_torch_vqgan import random_params
from test_vqgan import TINY, build_torch_vqmodel
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

PIXEL_ATOL = 1e-5


def images(b=2, size=64, seed=1):
    return np.random.RandomState(seed).uniform(
        -1, 1, (b, size, size, 3)).astype(np.float32)


def dyadic_images(b=2, size=64, seed=1):
    return (np.random.RandomState(seed).randint(-64, 65, (b, size, size, 3))
            / 64.0).astype(np.float32)


def carried(jcodec, name, **kw):
    """The port's codec with the JAX codec's weights, on the CPU."""
    codec = T.get_codec(name, device="cpu", **kw)
    if jcodec.params:
        codec.module.load_state_dict(state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, jcodec.params)))
    return codec


TRUNK = {"lfq": dict(bits=10, ch=8), "bsq": dict(bits=10, ch=8),
         "cosmos-fsq": dict(levels=(8, 5, 5), ch=8)}


def random_trunk(enc, dec, rng, image_size, latent_dim):
    """J._init_trunk with the weights drawn from the abstract shapes (a
    traced init compiles every layer)."""
    grid = image_size // 16
    return {"enc": random_params(enc, np.zeros((1, image_size, image_size,
                                                3), np.float32), seed=1),
            "dec": random_params(dec, np.zeros((1, grid, grid, latent_dim),
                                               np.float32), seed=2)}


@pytest.mark.parametrize("name", sorted(TRUNK))
def test_trunk_codecs_match_jax(name, monkeypatch):
    kw = TRUNK[name]
    monkeypatch.setattr(J, "_init_trunk", random_trunk)
    jcodec = J.get_codec(name, image_size=64, **kw)
    codec = carried(jcodec, name, image_size=64, **kw)
    imgs = images()
    want_ids = np.asarray(jcodec.encode(jcodec.params, jnp.asarray(imgs)))
    ids = codec.encode(imgs)
    assert ids.dtype == torch.int64
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    # every id of the vocabulary decodes as in JAX, not only those drawn
    grid_ids = np.arange(32).reshape(2, 16) * (jcodec.vocab_size // 32)
    for probe in (want_ids, grid_ids):
        want = np.asarray(jcodec.decode(jcodec.params, jnp.asarray(probe)))
        got = codec.decode(probe).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=PIXEL_ATOL, rtol=0)
    assert (codec.vocab_size, codec.downsample, codec.name) == (
        jcodec.vocab_size, jcodec.downsample, jcodec.name)


@pytest.mark.parametrize("name,size", [("pixels", 64), ("dummy", 64),
                                       ("pixels", 256)])
def test_pixel_and_dummy_codecs_match_jax(name, size):
    jcodec = J.get_codec(name, image_size=size)
    codec = T.get_codec(name, image_size=size, device="cpu")
    imgs = dyadic_images(size=size)
    want_ids = np.asarray(jcodec.encode(jcodec.params, jnp.asarray(imgs)))
    ids = codec.encode(imgs)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    want = np.asarray(jcodec.decode(jcodec.params, jnp.asarray(want_ids)))
    np.testing.assert_allclose(codec.decode(ids).numpy(), want,
                               atol=PIXEL_ATOL, rtol=0)
    assert (codec.vocab_size, codec.downsample) == (jcodec.vocab_size,
                                                    jcodec.downsample)


VQ_NAMES = ["llamagen-vq16", "vq16", "llamagen", "llamagen-vq8", "vq8",
            "taming", "maskgit-vqgan", "maskgit", "chameleon-vqgan",
            "anole", "lumina"]


@pytest.mark.parametrize("name", VQ_NAMES)
def test_vqgan_names_pick_the_jax_presets(name, monkeypatch):
    """Each name picks the preset and the codec name that JAX picks
    (J._make_vqgan is replaced, so nothing is initialised)."""
    monkeypatch.setattr(J, "_make_vqgan",
                        lambda cfg, rng, size, canonical: (cfg, canonical))
    want_cfg, want_name = J.get_codec(name, ch=64)
    preset, canonical = T._vq_preset(name)
    assert canonical == want_name
    assert dataclasses.asdict(preset(ch=64)) == dataclasses.asdict(want_cfg)
    assert T.codec_downsample(name) == want_cfg.downsample


def test_vqgan_codec_matches_the_jax_module():
    """The factory's VQGAN codec (taming preset, tiny widths) encodes and
    decodes as the flax module with the same weights."""
    from unidisc_tpu.tokenizers.vqgan import VQGAN
    kw = dict(codebook_size=64, codebook_dim=32, ch=32, ch_mult=(1, 2),
              num_res_blocks=1, z_channels=32)
    imgs = images(size=16)
    fm = VQGAN(J.taming_config(**kw))
    params = random_params(fm, imgs)
    codec = T.get_codec("taming", image_size=16, device="cpu", **kw)
    codec.module.load_state_dict(state_dict_from_jax(params))
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(imgs),
                               method=VQGAN.encode))
    ids = codec.encode(imgs)
    np.testing.assert_array_equal(ids.numpy(), want)
    np.testing.assert_allclose(
        codec.decode(ids).numpy(),
        np.asarray(fm.apply({"params": params}, jnp.asarray(want), 8,
                            method=VQGAN.decode)), atol=1e-4, rtol=1e-3)
    assert (codec.vocab_size, codec.downsample) == (64, 2)


def test_codec_downsample_needs_no_weights():
    for name, size in (("lfq", 256), ("bsq", 256), ("fsq", 256),
                       ("dummy", 256), ("pixels", 256), ("pixels", 64)):
        assert T.codec_downsample(name, image_size=size) == \
            T.get_codec(name, image_size=size, device="cpu").downsample
    assert T.codec_downsample("taming") == 16
    assert T.codec_downsample("llamagen-vq8") == 8


# the MAGVITv2 and TiTok names at small widths (the preset's other fields
# kept): the factories' wiring, not the modules (tests/test_torch_magvit.py,
# tests/test_torch_titok.py hold those)
SMALL = {"magvit": dict(bits=6, ch=32, ch_mult=(1, 2), num_res_blocks=1),
         "titok": dict(hidden_size=32, n_layers=1, n_heads=2,
                       codebook_dim=4)}


@pytest.mark.parametrize("name", ["showo", "show-o", "magvit", "magvitv2",
                                  "titok64", "titok128", "titok256",
                                  "titok-s-128"])
def test_magvit_and_titok_names_match_jax(name, monkeypatch):
    """Each name builds the codec JAX's get_codec builds (its name,
    vocabulary and downsample at 256 px, the size build_engine probes);
    titok-s-128 raises ValueError in both. JAX's module inits are
    skipped (what is compared comes from the configs)."""
    from unidisc_tpu.tokenizers import magvit as JM, titok as JT
    for cls in (JM.MagvitLFQ, JT.TiTok):
        monkeypatch.setattr(cls, "init", lambda self, rng, x: {"params": {}})
    kw = SMALL["titok" if name.startswith("titok") else "magvit"]
    try:
        want = J.get_codec(name, **kw)
    except ValueError as e:
        assert "unknown titok preset" in str(e)
        for build in (lambda: T.get_codec(name, device="cpu", **kw),
                      lambda: T.codec_downsample(name)):
            with pytest.raises(ValueError, match="unknown titok preset"):
                build()
        return
    got = T.get_codec(name, device="cpu", **kw)
    assert (got.name, got.vocab_size, got.downsample, got.image_size) == (
        want.name, want.vocab_size, want.downsample, 256)
    assert T.codec_downsample(name, **kw) == want.downsample
    # the published widths, without building the port's weights
    assert T.codec_downsample(name) == J.get_codec(name).downsample


def test_magvit_codec_matches_jax_codec(monkeypatch):
    """get_codec("showo") at a tiny width with JAX's codec's weights
    carried over: the decode of a grid of ids agrees within the VQGAN's
    bound, and the ids of that decode are equal where the latents' signs
    are clear."""
    from unidisc_tpu.tokenizers import magvit as JM
    from unidisc_tpu_torch.tokenizers.magvit import magvit_state_dict_from_jax
    kw = SMALL["magvit"]
    params = random_params(JM.MagvitLFQ(JM.MagvitConfig(**kw)),
                           np.zeros((1, 32, 32, 3), np.float32))
    monkeypatch.setattr(JM.MagvitLFQ, "init",
                        lambda self, rng, x: {"params": params})
    want = J.get_codec("showo", image_size=32, **kw)
    got = T.get_codec("showo", image_size=32, device="cpu", **kw)
    got.module.load_state_dict(magvit_state_dict_from_jax(params))
    ids = np.arange(2 * 256).reshape(2, 256) % 64
    rec = np.asarray(want.decode(params, jnp.asarray(ids)))
    np.testing.assert_allclose(got.decode(ids).numpy(), rec, atol=1e-4,
                               rtol=1e-3)
    with torch.no_grad():
        z = got.module.latents(torch.from_numpy(rec)).numpy()
    clear = (np.abs(z).min(-1) > 1e-4).reshape(2, -1)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(
        got.encode(rec).numpy()[clear],
        np.asarray(want.encode(params, jnp.asarray(rec)))[clear])


@pytest.mark.parametrize("name,match", [("sd-vae", "continuous"),
                                        ("klvae", "continuous"),
                                        ("video-vqvae", "clips"),
                                        ("video", "clips"),
                                        ("chameleon", "STREAM"),
                                        ("nope", "unknown codec")])
def test_factory_refuses_what_jax_refuses(name, match):
    with pytest.raises(ValueError, match=match):
        J.get_codec(name)
    with pytest.raises(ValueError, match=match):
        T.get_codec(name, device="cpu")


def test_continuous_codec_matches_jax():
    """get_continuous_codec("sd-vae") encodes (posterior mean) and decodes
    as the flax KLVAE with the same weights."""
    from unidisc_tpu.tokenizers.vqgan import KLVAE, KLVAEConfig
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4,
              embed_dim=5)
    imgs = images(size=16)
    fm = KLVAE(KLVAEConfig(**kw))
    params = random_params(fm, imgs)
    codec = T.get_continuous_codec("sd-vae", image_size=16, device="cpu",
                                   **kw)
    codec.module.load_state_dict(state_dict_from_jax(params))
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(imgs),
                               method=KLVAE.encode))
    z = codec.encode(imgs)
    np.testing.assert_allclose(z.numpy(), want, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(
        codec.decode(want).numpy(),
        np.asarray(fm.apply({"params": params}, jnp.asarray(want), 8,
                            method=KLVAE.decode)), atol=1e-4, rtol=1e-3)
    assert (codec.name, codec.latent_dim, codec.downsample) == (
        "sd-vae", 5, 2)
    with pytest.raises(ValueError, match="unknown continuous codec"):
        T.get_continuous_codec("vq16", device="cpu")


def test_load_vqgan_torch_checkpoint(tmp_path):
    """A LlamaGen checkpoint file (under "model", as published) loads into
    a llamagen codec as load_torch_state_dict renames it."""
    from unidisc_tpu.tokenizers.vqgan import VQConfig
    torch.manual_seed(0)
    sd = build_torch_vqmodel(VQConfig(**TINY)).state_dict()
    path = tmp_path / "vq_ds16_c2i.pt"
    torch.save({"model": sd}, path)
    codec = T.get_codec("llamagen-vq16", image_size=16, device="cpu", **TINY)
    assert T.load_vqgan_torch_checkpoint(codec, str(path)) is codec
    want = load_torch_state_dict(codec.module, sd)
    for key, value in codec.module.state_dict().items():
        assert torch.equal(value, want[key]), key


# ---------------------------------------------------------------------------
# PNG on the standard library
# ---------------------------------------------------------------------------

def pil_png(img, mode="RGB"):
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, format="PNG")
    return buf.getvalue()


def pil_pixels(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def png_images():
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:64, 0:48]
    smooth = np.stack([xx * 5, yy * 4, (xx + yy) * 2], -1).astype(np.uint8)
    return {"noise": rng.randint(0, 256, (33, 17, 3), dtype=np.uint8),
            "smooth": smooth, "pixel": np.full((1, 1, 3), 7, np.uint8)}


@pytest.mark.parametrize("kind", ["noise", "smooth", "pixel"])
def test_png_encoder_decodes_in_pil(kind):
    img = png_images()[kind]
    data = encode_png(img)
    np.testing.assert_array_equal(pil_pixels(data), img)
    np.testing.assert_array_equal(decode_png(data), img)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_png_decoder_reads_pil_files(kind, mode):
    """PIL picks its filters adaptively (all five types on the smooth
    image): the decoder undoes each, and drops alpha as PIL's RGB
    conversion does."""
    img = png_images()[kind]
    data = pil_png(img, mode)
    np.testing.assert_array_equal(decode_png(data), pil_pixels(data))


def test_png_decoder_refuses_what_it_cannot_read():
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + bytes(20))
    buf = io.BytesIO()
    Image.fromarray(png_images()["noise"]).convert("P").save(buf, "PNG")
    with pytest.raises(ValueError, match="unsupported PNG"):
        decode_png(buf.getvalue())
    data = bytearray(encode_png(png_images()["pixel"]))
    data[20] ^= 1                                 # inside IHDR
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(data))


def test_image_b64_helpers_match_the_jax_engine():
    img = images(1, 32)[0] * 1.1              # some values clip
    ours, theirs = encode_image_b64(img), jax_engine.encode_image_b64(img)
    np.testing.assert_array_equal(
        decode_image_b64(ours), jax_engine.decode_image_b64(theirs))
    np.testing.assert_array_equal(
        decode_image_b64(theirs), jax_engine.decode_image_b64(ours))
    assert decode_image_b64(ours).dtype == np.float32
    # uint8 images are taken as they are
    u8 = png_images()["noise"]
    np.testing.assert_array_equal(
        pil_pixels(base64.b64decode(encode_image_b64(u8))), u8)
