"""The port's VQGAN and KL-VAE (unidisc_tpu_torch/tokenizers/vqgan.py)
against the flax modules of unidisc_tpu/tokenizers/vqgan.py.

The same weights (the flax init, carried over by vqgan_state_dict_from_jax
/ klvae_state_dict_from_jax) and the same images go through both sides at
the tiny configs of tests/test_vqgan.py: encoder latents, decoded pixels
and the autoencode round trip agree within atol 1e-4 / rtol 1e-3 (the
bound tests/test_vqgan.py holds its torch mirror to; fp32 convolutions in
another summation order, and GroupNorm's variance taken two ways), and the
ids are equal. At full width the module trees equal the flax parameter
trees name for name. The published-name loaders give the JAX loaders'
weights exactly, on state_dicts of the torch mirrors of tests/test_vqgan.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.tokenizers import vqgan as J
from unidisc_tpu_torch.tokenizers import vqgan as T
from test_vqgan import (KL_TINY, TAMING_TINY, TINY, build_torch_klvae,
                        build_torch_taming, build_torch_vqmodel)
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

ATOL, RTOL = 1e-4, 1e-3
MASKGIT_TINY = dict(codebook_size=64, codebook_dim=32, ch=32, ch_mult=(1, 2),
                    num_res_blocks=1, z_channels=32, l2_norm_codes=False,
                    mid_attn=False, use_quant_conv=False)
LAYOUTS = {"llamagen": TINY, "taming": TAMING_TINY, "maskgit": MASKGIT_TINY}


def images(b=2, size=16, seed=0):
    return np.random.RandomState(seed).uniform(
        -1, 1, (b, size, size, 3)).astype(np.float32)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def random_params(module, imgs, seed=0):
    """A flax parameter tree for `module` drawn with numpy from its
    abstract shapes (a traced init would compile the whole forward):
    kernels of variance 1/fan_in, norm scales near 1, small biases, unit
    normal codes."""
    rng = np.random.RandomState(seed)
    tree = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                          jnp.asarray(imgs))["params"]

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.standard_normal(leaf.shape) / np.sqrt(fan_in)
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        if name == "bias":
            return 0.1 * rng.standard_normal(leaf.shape)
        return rng.standard_normal(leaf.shape)

    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: draw(path, leaf).astype(np.float32), tree)


def both(kw, imgs):
    """(flax params, flax module, the port's module with those weights)."""
    fm = J.VQGAN(J.VQConfig(**kw))
    params = random_params(fm, imgs)
    model = T.VQGAN(T.VQConfig(**kw)).eval()
    model.load_state_dict(T.vqgan_state_dict_from_jax(params))
    return params, fm, model


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_vqgan_matches_flax(layout):
    kw = LAYOUTS[layout]
    imgs = images()
    params, fm, model = both(kw, imgs)
    grid = 16 // J.VQConfig(**kw).downsample

    def latents(mdl, x):
        return mdl.quant_conv(mdl.encoder(x))

    want_z = np.asarray(fm.apply({"params": params}, jnp.asarray(imgs),
                                 method=latents))
    want_ids = np.asarray(fm.apply({"params": params}, jnp.asarray(imgs),
                                   method=J.VQGAN.encode))
    want_rec = np.asarray(fm.apply({"params": params},
                                   jnp.asarray(want_ids), grid,
                                   method=J.VQGAN.decode))
    want_auto, want_auto_ids = fm.apply({"params": params},
                                        jnp.asarray(imgs))
    x = torch.from_numpy(imgs)
    with torch.no_grad():
        z = T.nchw_to_nhwc(model.latents(x)).numpy()
        ids = model.encode(x).numpy()
        rec = model.decode(torch.from_numpy(want_ids), grid).numpy()
        auto, auto_ids = model(x)
    np.testing.assert_allclose(z, want_z, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(rec, want_rec, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(auto_ids.numpy(), np.asarray(want_auto_ids))
    np.testing.assert_allclose(auto.numpy(), np.asarray(want_auto),
                               atol=ATOL, rtol=RTOL)
    # the module tree is the one the config asks for
    names = set(model.state_dict())
    assert ("quant_conv.weight" in names) == (layout != "maskgit")
    assert ("encoder.mid_attn_1.q.weight" in names) == (layout != "maskgit")
    assert ("encoder.down_1_attn_0.q.weight" in names) == (
        layout == "taming")


def test_quantize_keeps_the_first_index_of_a_tie():
    kw = dict(TINY, l2_norm_codes=False)
    imgs = images(1)
    params, fm, model = both(kw, imgs)
    # duplicate codes: every latent is equally near entries i and i + 32
    cb = params["codebook"].copy()
    cb[32:] = cb[:32]
    params = dict(params, codebook=cb)
    model.codebook.data.copy_(torch.from_numpy(cb))
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(imgs),
                               method=J.VQGAN.encode))
    with torch.no_grad():
        got = model.encode(torch.from_numpy(imgs)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got < 32).all()


def test_straight_through_estimator_passes_the_gradient():
    _, _, model = both(TINY, images())
    x = torch.from_numpy(images()).requires_grad_(True)
    recon, _ = model(x)
    recon.sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
    assert model.encoder.conv_in.weight.grad.abs().sum() > 0


def test_klvae_matches_flax():
    cfg = J.KLVAEConfig(**KL_TINY)
    imgs = images()
    fm = J.KLVAE(cfg)
    params = random_params(fm, imgs)
    model = T.KLVAE(T.KLVAEConfig(**KL_TINY)).eval()
    model.load_state_dict(T.klvae_state_dict_from_jax(params))
    x = torch.from_numpy(imgs)
    apply = lambda *a, **k: fm.apply({"params": params}, *a, **k)  # noqa
    want_mean, want_logvar = apply(jnp.asarray(imgs), method=J.KLVAE.moments)
    rng = jax.random.PRNGKey(3)
    want_sampled = apply(jnp.asarray(imgs), rng, method=J.KLVAE.encode)
    # the JAX draw, replayed as the port's injected noise
    noise = np.asarray(jax.random.normal(rng, want_mean.shape))
    want_z = apply(jnp.asarray(imgs), method=J.KLVAE.encode)
    want_rec = apply(want_z, 8, method=J.KLVAE.decode)
    with torch.no_grad():
        mean, logvar = model.moments(x)
        z = model.encode(x)
        sampled = model.encode(x, noise=torch.from_numpy(noise))
        rec = model.decode(torch.from_numpy(np.asarray(want_z)), 8)
        other = model.encode(x, torch.Generator().manual_seed(1))
    for got, want in ((mean, want_mean), (logvar, want_logvar),
                      (z, want_z), (sampled, want_sampled), (rec, want_rec)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)
    assert not np.allclose(other.numpy(), z.numpy())


FULL_WIDTH = {"vq16": J.VQConfig, "vq8": J.vq8_config,
              "taming": J.taming_config, "maskgit": J.maskgit_config,
              "chameleon": J.chameleon_config}


@pytest.mark.parametrize("preset", sorted(FULL_WIDTH) + ["klvae"])
def test_full_width_module_trees_equal_flax(preset, monkeypatch):
    """The presets at their published widths: the port's state_dict has
    the flax tree's names and shapes (both built abstractly: flax traced,
    the port on the meta device with its draws skipped)."""
    for cls in (T.VQGAN, T.KLVAE):
        monkeypatch.setattr(cls, "reset_parameters", lambda self, g: None)
    x = jnp.zeros((1, 16, 16, 3))
    with torch.device("meta"):
        if preset == "klvae":
            fm, model = J.KLVAE(J.KLVAEConfig()), T.KLVAE(T.KLVAEConfig())
        else:
            fm = J.VQGAN(FULL_WIDTH[preset]())
            model = T.VQGAN(getattr(T, FULL_WIDTH[preset].__name__)())
    tree = jax.eval_shape(fm.init, jax.random.PRNGKey(0), x)["params"]
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    want = {}
    for path, leaf in flat:
        keys = [p.key for p in path]
        leaf_name = {"kernel": "weight", "scale": "weight"}.get(keys[-1],
                                                                keys[-1])
        shape = leaf.shape
        if keys[-1] == "kernel":            # HWIO -> OIHW
            shape = (shape[3], shape[2], shape[0], shape[1])
        want[".".join(keys[:-1] + [leaf_name])] = tuple(shape)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want


def mirror_state_dict(tmodel):
    return {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}


LOADERS = {
    # name: (torch mirror, config, the JAX loader, the port's loader)
    "llamagen": (build_torch_vqmodel, TINY, J.load_torch_state_dict,
                 T.load_torch_state_dict),
    "taming": (build_torch_taming, TAMING_TINY,
               J.load_taming_torch_state_dict,
               T.load_taming_torch_state_dict),
    "klvae": (build_torch_klvae, KL_TINY, J.load_klvae_torch_state_dict,
              T.load_klvae_torch_state_dict),
}


def loader_case(name):
    mirror, kw, jax_load, port_load = LOADERS[name]
    torch.manual_seed(0)
    if name == "klvae":
        jcfg = J.KLVAEConfig(**kw)
        fm = J.KLVAE(jcfg)
        model = T.KLVAE(T.KLVAEConfig(**kw))
    else:
        jcfg = J.VQConfig(**kw)
        fm = J.VQGAN(jcfg)
        model = T.VQGAN(T.VQConfig(**kw))
    sd = mirror_state_dict(mirror(jcfg).eval())
    return sd, fm, model, jax_load, port_load


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_published_name_loaders_equal_the_jax_loaders(name):
    sd, fm, model, jax_load, port_load = loader_case(name)
    params = random_params(fm, images())
    want = T.state_dict_from_jax(to_np(jax_load(params, sd)))
    got = port_load(model, sd)
    assert sorted(got) == sorted(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], atol=0, rtol=0)
    model.load_state_dict(got)           # every name, every shape
    # torch tensors load as they are (torch.load gives tensors)
    again = port_load(model, {k: torch.from_numpy(v) for k, v in sd.items()})
    for key in got:
        assert torch.equal(again[key], got[key])


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_published_name_loaders_check_every_name(name):
    sd, _, model, _, port_load = loader_case(name)
    # training-only weights outside the autoencoder are ignored
    port_load(model, {**sd, "loss.discriminator.main.0.weight":
                      np.zeros(3, np.float32)})
    missing = dict(sd)
    missing.pop("decoder.conv_out.bias")
    with pytest.raises(KeyError, match="decoder.conv_out.bias"):
        port_load(model, missing)
    wrong = dict(sd, **{"encoder.conv_in.weight":
                        sd["encoder.conv_in.weight"][:1]})
    with pytest.raises(ValueError, match="shape"):
        port_load(model, wrong)
    with pytest.raises(KeyError, match="no place"):
        port_load(model, {**sd, "encoder.extra.weight":
                          np.zeros(3, np.float32)})
