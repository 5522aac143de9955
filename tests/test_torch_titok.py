"""The port's TiTok 1D tokenizer (unidisc_tpu_torch/tokenizers/titok.py)
against the flax module of unidisc_tpu/tokenizers/titok.py.

The same weights (flax parameters drawn with numpy, the scanned blocks
unstacked by titok_state_dict_from_jax) and the same images go through
both sides at a tiny config (hidden 64, 4 heads, 2 layers, K 16, 64 px):
the L2-normalised latents, the decode of JAX's ids and the straight-through
round trip agree within atol 1e-4 / rtol 1e-3 (fp32 products in another
summation order); ids are compared where the top-2 margin of the
codebook scores exceeds ID_MARGIN, and that share is asserted. The mirror
loader gives the JAX loader's weights exactly; the presets are JAX's; at
titok256's published widths the module tree is the flax tree's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.tokenizers import titok as J
from unidisc_tpu_torch.tokenizers import titok as T
from test_titok import TTiTok, _torch_sd
from test_torch_vqgan import random_params, to_np
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

ATOL, RTOL = 1e-4, 1e-3
ID_MARGIN = 1e-4
CLEAR_SHARE = 0.9
KW = dict(num_latent_tokens=16, codebook_size=64, codebook_dim=8,
          hidden_size=64, n_layers=2, n_heads=4, patch_size=16,
          image_size=64)


def images(b=2, seed=0):
    return np.random.RandomState(seed).uniform(
        -1, 1, (b, 64, 64, 3)).astype(np.float32)


def both(seed=0):
    fm = J.TiTok(J.TiTokConfig(**KW))
    params = random_params(fm, images(1), seed)
    model = T.TiTok(T.TiTokConfig(**KW)).eval()
    model.load_state_dict(T.titok_state_dict_from_jax(params))
    return params, fm, model


def test_titok_matches_flax():
    params, fm, model = both()
    imgs = images()

    @jax.jit
    def reference(p, x):
        # one jitted program (a traced apply of each method compiles every
        # layer op by op)
        apply = lambda *a, **k: fm.apply({"params": p}, *a, **k)  # noqa
        ids = apply(x, method=J.TiTok.encode)
        # an id past the codebook
        bad = ids.at[0, 3].set(KW["codebook_size"])
        return (apply(x, method=J.TiTok._encode_latents), ids,
                apply(ids, method=J.TiTok.decode), apply(x),
                apply(bad, method=J.TiTok.decode), bad)

    want_z, want_ids, want_rec, (want_auto, want_auto_ids), want_bad, bad \
        = jax.tree_util.tree_map(np.asarray,
                                 reference(params, jnp.asarray(imgs)))
    # an id past the codebook: JAX's jnp.take fills NaN, the port raises
    assert np.isnan(want_bad).any()
    with pytest.raises(ValueError, match="outside the codebook"):
        model.decode(torch.from_numpy(bad))
    x = torch.from_numpy(imgs)
    with torch.no_grad():
        z = model.latents(x)
        ids = model.encode(x).numpy()
        rec = model.decode(torch.tensor(want_ids)).numpy()
        auto, auto_ids = model(x)
        cb = model._codes()
        top = (2.0 * (z @ cb.T) - (cb ** 2).sum(-1)).topk(2, -1).values
    np.testing.assert_allclose(z.numpy(), want_z, atol=ATOL, rtol=RTOL)
    clear = (top[..., 0] - top[..., 1]).numpy() > ID_MARGIN
    assert clear.mean() >= CLEAR_SHARE, clear.mean()
    np.testing.assert_array_equal(ids[clear], want_ids[clear])
    np.testing.assert_array_equal(auto_ids.numpy()[clear],
                                  np.asarray(want_auto_ids)[clear])
    np.testing.assert_allclose(rec, want_rec, atol=ATOL, rtol=RTOL)
    if (auto_ids.numpy() == np.asarray(want_auto_ids)).all():
        np.testing.assert_allclose(auto.numpy(), np.asarray(want_auto),
                                   atol=ATOL, rtol=RTOL)
    assert ids.shape == (2, 16) and rec.shape == (2, 64, 64, 3)


def test_straight_through_estimator_passes_the_gradient():
    _, _, model = both()
    x = torch.from_numpy(images()).requires_grad_(True)
    recon, _ = model(x)
    recon.sum().backward()
    assert x.grad.abs().sum() > 0
    assert model.encoder[0].attn.in_proj_weight.grad.abs().sum() > 0


def test_mirror_loader_equals_the_jax_loader():
    params, _, model = both()
    torch.manual_seed(0)
    sd = _torch_sd(TTiTok(J.TiTokConfig(**KW)).eval())
    want = T.titok_state_dict_from_jax(
        to_np(J.load_torch_state_dict(params, sd, KW["n_layers"])))
    got = T.load_torch_state_dict(model, sd)
    assert list(got) == list(model.state_dict())
    assert sorted(got) == sorted(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], atol=0, rtol=0)
    model.load_state_dict(got)
    with pytest.raises(KeyError, match="no place"):
        T.load_torch_state_dict(model, {**sd, "extra": np.zeros(3)})


@pytest.mark.parametrize("name", ["titok64", "titok128", "titok256",
                                  "titok-s-128"])
def test_presets_are_jax_presets(name):
    try:
        want = J.titok_preset(name, image_size=128, n_layers=3)
    except ValueError as e:
        with pytest.raises(ValueError, match="unknown titok preset"):
            T.titok_preset(name)
        assert "unknown titok preset" in str(e)
        return
    got = T.titok_preset(name, image_size=128, n_layers=3)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.grid == want.grid == 8


def test_titok256_module_tree_equals_flax(monkeypatch):
    """titok256 at its published widths (hidden 512, 8 layers, K 256,
    8,192 codes, 256 px): the port's state_dict has the names and shapes
    that titok_state_dict_from_jax gives the flax tree (flax traced
    abstractly, the port on the meta device with its draws skipped)."""
    monkeypatch.setattr(T.TiTok, "reset_parameters", lambda self, g: None)
    cfg = T.titok_preset("titok256")
    with torch.device("meta"):
        model = T.TiTok(cfg)
    tree = jax.eval_shape(J.TiTok(J.titok_preset("titok256")).init,
                          jax.random.PRNGKey(0),
                          jnp.zeros((1, 256, 256, 3)))["params"]
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), tree)
    want = {k: tuple(v.shape) for k, v in
            T.titok_state_dict_from_jax(zeros).items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert (cfg.hidden_size, cfg.n_layers, cfg.num_latent_tokens,
            cfg.codebook_size) == (512, 8, 256, 8192)


def test_build_engine_serves_pngs_through_titok256(monkeypatch):
    """build_engine(codec_name="titok256") on the CPU: titok256 at 256 px
    (its K 256 ids are the tiny model's 256 image tokens; downsample
    256 / sqrt(256) = 16, JAX's bookkeeping), its PNGs the decode of the
    returned ids. The ViT runs narrow (hidden 32, one layer), the preset's
    K, codebook and patches kept (phase 4h of chip_smoke.py serves the
    published widths on the card)."""
    import base64
    from unidisc_tpu_torch.serving.engine import build_engine
    from unidisc_tpu_torch.tokenizers import image_codecs
    from unidisc_tpu_torch.utils.png import decode_png
    make = image_codecs.get_codec
    monkeypatch.setattr(image_codecs, "get_codec", lambda n, **k: make(
        n, hidden_size=32, n_layers=1, n_heads=2, **k))
    eng = build_engine(preset="tiny", device="cpu", codec_name="titok256",
                       steps=2, overrides={"model.length": 272,
                                           "model.img_length": 256,
                                           "model.image_vocab_size": 8192})
    codec = eng.codec
    assert (codec.name, codec.vocab_size, codec.image_size,
            codec.downsample) == ("titok256", 8192, 256, 16)
    r = eng.run_batch([eng.prepare(text="a cat")], seed=0)[0]
    # the tiny model does not force image ids into the codebook: clamp
    ids = torch.from_numpy(r["image_ids"].clip(0, 8191))
    want = ((codec.decode(ids) + 1) * 127.5).clamp(0, 255).to(torch.uint8)
    got = decode_png(base64.b64decode(r["images_b64"][0]))
    assert got.shape == (256, 256, 3)
    assert np.abs(got.astype(np.int16) - want[0].numpy()).max() <= 1
