"""The port's MAGVITv2 LFQ codec (unidisc_tpu_torch/tokenizers/magvit.py)
against the flax module of unidisc_tpu/tokenizers/magvit.py.

The same weights (flax parameters drawn with numpy, carried over by
magvit_state_dict_from_jax) and the same images go through both sides at
a tiny config (ch 32, ch_mult (1, 2), 6 bits, 32 px): the encoder latents,
the decode of JAX's ids and the straight-through round trip agree within
atol 1e-4 / rtol 1e-3 (the VQGAN's bound: fp32 convolutions in another
summation order, GroupNorm's variance taken two ways). An id is a sign
pattern, so ids are compared where the smallest |z| over the bits exceeds
ID_MARGIN, and that share is asserted. The mirror loader gives the JAX
loader's weights exactly, and at full width the module tree equals the
flax tree name for name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.tokenizers import magvit as J
from unidisc_tpu_torch.tokenizers import magvit as T
from test_magvit import TMirror
from test_torch_vqgan import random_params, to_np
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

ATOL, RTOL = 1e-4, 1e-3
ID_MARGIN = 1e-4          # |z| under which a sign may flip between orders
CLEAR_SHARE = 0.9         # the share of positions that must be clear
CFG = dict(bits=6, ch=32, ch_mult=(1, 2), num_res_blocks=1)
SIZE = 32


def images(b=2, size=SIZE, seed=0):
    return np.random.RandomState(seed).uniform(
        -1, 1, (b, size, size, 3)).astype(np.float32)


def both(kw=CFG, seed=0):
    """(flax params, flax module, the port's module with those weights)."""
    fm = J.MagvitLFQ(J.MagvitConfig(**kw))
    params = random_params(fm, images(1), seed)
    model = T.MagvitLFQ(T.MagvitConfig(**kw)).eval()
    model.load_state_dict(T.magvit_state_dict_from_jax(params))
    return params, fm, model


def reference(fm, params, x, decode_args=()):
    """JAX's encoder latents, ids, the decode of those ids and the
    autoencode round trip, as one jitted program (a traced apply of each
    method compiles every layer op by op)."""
    @jax.jit
    def run(p, x):
        apply = lambda *a, **k: fm.apply({"params": p}, *a, **k)  # noqa
        ids = apply(x, method=type(fm).encode)
        return (apply(x, method=lambda m, y: m.encoder(y)), ids,
                apply(ids, *decode_args, method=type(fm).decode), apply(x))
    return jax.tree_util.tree_map(np.asarray, run(params, jnp.asarray(x)))


def test_magvit_matches_flax():
    params, fm, model = both()
    imgs = images()
    grid = SIZE // 2
    want_z, want_ids, want_rec, (want_auto, want_auto_ids) = reference(
        fm, params, imgs, (grid,))
    x = torch.from_numpy(imgs)
    with torch.no_grad():
        z = model.latents(x).numpy()
        ids = model.encode(x).numpy()
        rec = model.decode(torch.from_numpy(want_ids)).numpy()
        auto, auto_ids = model(x)
    np.testing.assert_allclose(z, want_z, atol=ATOL, rtol=RTOL)
    clear = (np.abs(want_z).min(-1) > ID_MARGIN).reshape(2, -1)
    assert clear.mean() >= CLEAR_SHARE, clear.mean()
    np.testing.assert_array_equal(ids[clear], want_ids[clear])
    np.testing.assert_array_equal(auto_ids.numpy()[clear],
                                  np.asarray(want_auto_ids)[clear])
    np.testing.assert_allclose(rec, want_rec, atol=ATOL, rtol=RTOL)
    if (auto_ids.numpy() == np.asarray(want_auto_ids)).all():
        np.testing.assert_allclose(auto.numpy(), np.asarray(want_auto),
                                   atol=ATOL, rtol=RTOL)
    assert ids.shape == (2, grid * grid) and ids.dtype == np.int64


def test_quantize_and_lookup_are_jax_bit_arithmetic():
    """Every id of the codebook unpacks to JAX's +-1 bits, and quantize
    packs them back; an id past the codebook raises (JAX wraps it)."""
    cfg = J.MagvitConfig(**CFG)
    fm, model = J.MagvitLFQ(cfg), T.MagvitLFQ(T.MagvitConfig(**CFG))
    ids = np.arange(cfg.codebook_size).reshape(8, 8)
    want = np.asarray(fm.apply({}, jnp.asarray(ids),
                               method=J.MagvitLFQ.lookup))
    got = model.lookup(torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(model.quantize(got).numpy(), ids)
    z = np.random.RandomState(1).randn(2, 4, 4, CFG["bits"]).astype(
        np.float32)
    np.testing.assert_array_equal(
        model.quantize(torch.from_numpy(z)).numpy(),
        np.asarray(fm.apply({}, jnp.asarray(z), method=J.MagvitLFQ.quantize)))
    for bad in (cfg.codebook_size, -1):
        with pytest.raises(ValueError, match="outside the codebook"):
            model.lookup(torch.tensor([[bad]]))


def test_straight_through_estimator_passes_the_gradient():
    _, _, model = both()
    x = torch.from_numpy(images()).requires_grad_(True)
    recon, _ = model(x)
    recon.sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
    assert model.encoder.conv_in.weight.grad.abs().sum() > 0


def mirror_sd(kw=CFG):
    torch.manual_seed(0)
    return {k: v.detach().numpy() for k, v in
            TMirror(J.MagvitConfig(**kw)).eval().state_dict().items()}


def test_mirror_loader_equals_the_jax_loader():
    params, _, model = both()
    sd = mirror_sd()
    want = T.magvit_state_dict_from_jax(
        to_np(J.load_torch_state_dict(params, sd)))
    got = T.load_torch_state_dict(model, sd)
    assert list(got) == list(model.state_dict())
    for key in want:
        torch.testing.assert_close(got[key], want[key], atol=0, rtol=0)
    model.load_state_dict(got)
    missing = dict(sd)
    missing.pop("decoder.conv_out.bias")
    with pytest.raises(KeyError, match="decoder.conv_out.bias"):
        T.load_torch_state_dict(model, missing)
    with pytest.raises(KeyError, match="no place"):
        T.load_torch_state_dict(model, {**sd, "encoder.extra.weight":
                                        np.zeros(3, np.float32)})


def test_full_width_module_tree_equals_flax(monkeypatch):
    """MagvitConfig() (the published widths): the port's state_dict has
    the flax tree's names and shapes (flax traced abstractly, the port on
    the meta device with its draws skipped)."""
    monkeypatch.setattr(T.MagvitLFQ, "reset_parameters",
                        lambda self, g: None)
    with torch.device("meta"):
        model = T.MagvitLFQ(T.MagvitConfig())
    tree = jax.eval_shape(J.MagvitLFQ(J.MagvitConfig()).init,
                          jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    want = {k: tuple(v.shape) for k, v in T.magvit_state_dict_from_jax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               tree["params"])).items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert T.MagvitConfig().codebook_size == 8192


def test_build_engine_serves_pngs_through_magvitv2(monkeypatch):
    """build_engine(codec_name="magvitv2") on the CPU: the codec sized to
    the tiny model's 4 x 4 grid (64 px), its PNGs the decode of the
    returned ids; the model's image vocabulary is the codec's 8,192 codes,
    as a model trained on its tokens has. The codec runs at narrow widths
    with the preset's downsample and bits (phase 4h of chip_smoke.py
    serves the published widths on the card)."""
    import base64
    from unidisc_tpu_torch.serving.engine import build_engine
    from unidisc_tpu_torch.tokenizers import image_codecs
    from unidisc_tpu_torch.utils.png import decode_png
    make = image_codecs.get_codec
    monkeypatch.setattr(image_codecs, "get_codec", lambda n, **k: make(
        n, ch=32, ch_mult=(1, 1, 1, 1, 1), num_res_blocks=1, **k))
    eng = build_engine(preset="tiny", device="cpu", codec_name="magvitv2",
                       steps=2, overrides={"model.length": 32,
                                           "model.img_length": 16,
                                           "model.image_vocab_size": 8192})
    codec = eng.codec
    assert (codec.name, codec.vocab_size, codec.image_size,
            codec.downsample) == ("magvitv2", 8192, 64, 16)
    r = eng.run_batch([eng.prepare(text="a cat")], seed=0)[0]
    # the tiny model does not force image ids into the codebook: clamp
    ids = torch.from_numpy(r["image_ids"].clip(0, 8191))
    want = ((codec.decode(ids) + 1) * 127.5).clamp(0, 255).to(torch.uint8)
    got = decode_png(base64.b64decode(r["images_b64"][0]))
    assert got.shape == (64, 64, 3)
    assert np.abs(got.astype(np.int16) - want[0].numpy()).max() <= 1
