"""The port's Chameleon stream tokenizer and structural remap
(unidisc_tpu_torch/tokenizers/{chameleon,remap}.py) against
unidisc_tpu/tokenizers/{chameleon,remap}.py.

Chameleon: the spec's token layout, the streams of encode_document /
batch_encode, decode_stream and the crop-size lists are JAX's exactly;
crops drawn from numpy Generators of one seed pick the same sizes and
offsets and leave both Generators in one state, their pixels within
CROP_ATOL (jax.image.resize against F.interpolate with antialiasing, fp32);
tokenize_t2i_batch gives JAX's streams exactly on images whose crops are
exact (area halving to the crop, then a resize of scale 1) through the
dummy codec on dyadic pixels.

Remap: auto_remap gives JAX's report (mapping, section pairs, skipped and
unmatched keys, in order) for each template on a foreign-named state_dict,
and the foreign loaders give the weights of JAX's, exactly. JAX's conv
template reads the flax tree that model.init returns (creation order),
which is the port module's state_dict order; a key-sorted tree does not
align.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.tokenizers import chameleon as J
from unidisc_tpu.tokenizers import image_codecs as JC
from unidisc_tpu.tokenizers import remap as JR
from unidisc_tpu.tokenizers.text import get_tokenizer as jax_tokenizer
from unidisc_tpu_torch.tokenizers import chameleon as T
from unidisc_tpu_torch.tokenizers import image_codecs as TC
from unidisc_tpu_torch.tokenizers import remap as TR
from unidisc_tpu_torch.tokenizers.text import get_tokenizer
from test_magvit import TMirror
from test_remap import _foreignize
from test_titok import TTiTok, _torch_sd
from test_torch_vqgan import random_params, to_np
from test_vqgan import TINY as VQ_TINY, build_torch_vqmodel
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

CROP_ATOL = 1e-5
SPEC = dict(text_vocab=1000, img_vocab=4096, patch_size=16, max_grids=64)


def docs(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        parts = []
        for k in range(int(rng.integers(1, 5))):
            if k % 2:
                parts.append(rng.integers(0, 4096, size=(
                    int(rng.integers(1, 5)), int(rng.integers(1, 7)))))
            else:
                parts.append(rng.integers(0, 1000, size=int(
                    rng.integers(0, 9))))
        out.append(parts)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_streams_equal_jax(seed):
    js, ts = J.ChameleonSpec(**SPEC), T.ChameleonSpec(**SPEC)
    for name in ("image_start", "image_end", "new_line",
                 "image_placeholder", "vocab_size"):
        assert getattr(ts, name) == getattr(js, name)
    assert [ts.grid_token(n) for n in (1, 7, 64)] == \
        [js.grid_token(n) for n in (1, 7, 64)]
    for bad in (0, 65):
        with pytest.raises(ValueError):
            ts.grid_token(bad)
    batch = docs(seed)
    for parts in batch:
        stream = T.encode_document(ts, parts)
        np.testing.assert_array_equal(stream, J.encode_document(js, parts))
        # whole, and cut inside the last image span
        for ids in (stream, stream[:-2]):
            text, grids = T.decode_stream(ts, ids)
            jtext, jgrids = J.decode_stream(js, ids)
            np.testing.assert_array_equal(text, jtext)
            assert len(grids) == len(jgrids)
            for g, jg in zip(grids, jgrids):
                np.testing.assert_array_equal(g, jg)
    for length in (5, 40, 120):
        for got, want in zip(T.batch_encode(ts, batch, length, pad_id=3),
                             J.batch_encode(js, batch, length, pad_id=3)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("args", [(16, 576, 4.0), (16, 64, 4.0),
                                  (8, 100, 2.0), (32, 7, 10.0)])
def test_crop_size_lists_equal_jax(args):
    assert T.build_crop_size_list(*args) == J.build_crop_size_list(*args)


# (image h, w, top_k): shrinking by area halving and an antialiased
# resize, enlarging, and a draw among the 3 best sizes
CROPS = [(300, 150, 1), (150, 300, 3), (40, 90, 1), (516, 334, 3),
         (64, 64, 2)]


@pytest.mark.parametrize("h,w,top_k", CROPS)
def test_var_center_crop_draws_as_jax(h, w, top_k):
    sizes = J.build_crop_size_list(patch_size=16, max_grids=64)
    img = np.random.default_rng(h * w).random((h, w, 3)).astype(np.float32)
    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(2):              # a random crop, then one more draw
        want = J.var_center_crop(img, sizes, jrng, top_k)
        got = T.var_center_crop(img, sizes, trng, top_k)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=CROP_ATOL, rtol=0)
    assert jrng.integers(0, 1 << 30) == trng.integers(0, 1 << 30)
    np.testing.assert_allclose(T.var_center_crop(img, sizes),
                               J.var_center_crop(img, sizes),
                               atol=CROP_ATOL, rtol=0)


def test_odd_sides_fail_the_halving_as_in_jax():
    """The area halving reshapes (h // 2, 2, w // 2, 2): an odd side
    fails it in JAX, and the port keeps that."""
    img = np.zeros((517, 333, 3), np.float32)
    for crop in (J.center_crop_to, T.center_crop_to):
        with pytest.raises(ValueError, match="reshape"):
            crop(img, (128, 128))


def test_tokenize_t2i_batch_equals_jax():
    """Crops through the codec into streams: two 128 x 128 images crop
    exactly to (64, 64) (a halving, then a resize of scale 1), and the
    dummy codec's ids of dyadic pixels are exact (JAX's dummy codec takes
    square images only)."""
    sizes = T.build_crop_size_list(patch_size=16, max_grids=16)
    assert (64, 64) in sizes
    imgs = (np.random.default_rng(3).integers(-64, 65, (2, 128, 128, 3))
            / 64.0).astype(np.float32)
    jcodec = JC.get_codec("dummy", image_size=64)
    codec = TC.get_codec("dummy", image_size=64, device="cpu")
    spec = dict(text_vocab=300, img_vocab=codec.vocab_size, patch_size=16)
    caps = ["a cat on a mat", "ünïcødé <image> dog" * 20]
    want = J.tokenize_t2i_batch(J.ChameleonSpec(**spec), jax_tokenizer("byte"),
                                jcodec, imgs, caps, 400, sizes,
                                np.random.default_rng(0))
    got = T.tokenize_t2i_batch(T.ChameleonSpec(**spec), get_tokenizer("byte"),
                               codec, imgs, caps, 400, sizes,
                               np.random.default_rng(0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ids, mask = got
    _, grids = T.decode_stream(T.ChameleonSpec(**spec), ids[0][mask[0]])
    assert grids[0].shape == (4, 4)


# ---------------------------------------------------------------------------
# remap
# ---------------------------------------------------------------------------

def report_fields(report):
    return (list(report.mapping.items()), report.section_pairs,
            report.skipped_foreign, report.unmatched_mirror,
            report.complete, report.summary())


UNIT_CASES = {
    "shapes": ({"enc.c1.w": (8, 3, 3, 3), "enc.c1.b": (8,),
                "enc.c2.w": (16, 8, 3, 3), "dec.d1.w": (3, 16, 3, 3)},
               {"encoder.conv_in.weight": (8, 3, 3, 3),
                "encoder.conv_in.bias": (8,),
                "encoder.conv_out.weight": (16, 8, 3, 3),
                "decoder.conv_out.weight": (3, 16, 3, 3)}),
    "extras_and_missing": ({"encoder.a.weight": (4, 4),
                            "loss.disc.weight": (7, 7)},
                           {"encoder.a.weight": (4, 4),
                            "encoder.b.weight": (5, 5)}),
    "equal_shape_run": ({"m.n1.gamma": (4,), "m.n1.beta": (4,),
                         "m.c1.bias": (4,)},
                        {"mod.norm.weight": (4,), "mod.norm.bias": (4,),
                         "mod.conv.bias": (4,)}),
}


@pytest.mark.parametrize("case", sorted(UNIT_CASES))
def test_auto_remap_equals_jax(case):
    shapes, template = UNIT_CASES[case]
    rng = np.random.RandomState(0)
    foreign = {k: rng.standard_normal(s).astype(np.float32)
               for k, s in shapes.items()}
    renamed, report = TR.auto_remap(foreign, template)
    jrenamed, jreport = JR.auto_remap(foreign, template)
    assert report_fields(report) == report_fields(jreport)
    assert list(renamed) == list(jrenamed)
    # tensors are taken as they are
    _, treport = TR.auto_remap({k: torch.from_numpy(v)
                                for k, v in foreign.items()}, template)
    assert report_fields(treport) == report_fields(jreport)


MAGVIT_KW = dict(bits=6, ch=32, ch_mult=(1, 2), num_res_blocks=1)


def init_ordered(fm, shape, seed=0):
    """A flax parameter tree in the order model.init returns it (the
    modules' creation order), with normal values: the order is read while
    tracing init abstractly (a traced init compiles every layer), where
    the dicts are still built in order."""
    import flax
    rng = np.random.RandomState(seed)
    flat = {}

    def trace(key, x):
        tree = fm.init(key, x)["params"]
        for path, leaf in flax.traverse_util.flatten_dict(tree).items():
            flat[path] = (rng.standard_normal(leaf.shape) * 0.1).astype(
                np.float32)
        return tree

    jax.eval_shape(trace, jax.random.PRNGKey(0), jnp.zeros(shape))
    return flax.traverse_util.unflatten_dict(flat)


def test_magvit_foreign_remap_equals_jax():
    from unidisc_tpu.tokenizers import magvit as JM
    from unidisc_tpu_torch.tokenizers import magvit as TM
    jcfg = JM.MagvitConfig(**MAGVIT_KW)
    fm = JM.MagvitLFQ(jcfg)
    params = init_ordered(fm, (1, 16, 16, 3))
    model = TM.MagvitLFQ(TM.MagvitConfig(**MAGVIT_KW))
    template = TR.conv_mirror_template(model)
    assert list(template.items()) == list(
        JR.conv_mirror_template(params).items())
    torch.manual_seed(0)
    sd = {k: v.detach().numpy() for k, v in
          TMirror(jcfg).eval().state_dict().items()}
    foreign = {_foreignize(k): v for k, v in sd.items()}
    foreign["loss.discriminator.main.0.weight"] = np.zeros((64, 3, 4, 4),
                                                           np.float32)
    foreign["loss.discriminator.main.0.bias"] = np.zeros((64,), np.float32)
    _, report = TR.auto_remap(foreign, template)
    _, jreport = JR.auto_remap(foreign, JR.conv_mirror_template(params))
    assert report_fields(report) == report_fields(jreport)
    assert report.complete and len(report.skipped_foreign) == 2
    got, rep = TR.load_magvit_foreign(model, foreign)
    jparams, _ = JR.load_magvit_foreign(params, foreign)
    want = TM.magvit_state_dict_from_jax(to_np(jparams))
    assert report_fields(rep) == report_fields(report)
    for key in want:
        torch.testing.assert_close(got[key], want[key], atol=0, rtol=0)
    model.load_state_dict(got)
    # the same tree through jax.tree_util comes back key-sorted, and no
    # longer aligns: the order is part of the template
    _, sorted_report = JR.auto_remap(foreign, JR.conv_mirror_template(
        jax.tree_util.tree_map(lambda a: a, params)))
    assert not sorted_report.complete
    # a checkpoint of another architecture is refused, as in JAX
    torch.manual_seed(0)
    wide = {_foreignize(k): v.detach().numpy() for k, v in TMirror(
        JM.MagvitConfig(**{**MAGVIT_KW, "ch": 64})).state_dict().items()}
    with pytest.raises(ValueError, match="does not cover"):
        TR.load_magvit_foreign(model, wide)


def test_vqgan_foreign_remap_equals_jax():
    from unidisc_tpu.tokenizers import vqgan as JV
    from unidisc_tpu_torch.tokenizers import vqgan as TV
    cfg = JV.VQConfig(**VQ_TINY)
    assert list(TR.vqgan_mirror_template(TV.VQConfig(**VQ_TINY)).items()) \
        == list(JR.vqgan_mirror_template(cfg).items())
    torch.manual_seed(0)
    sd = {k: v.detach().numpy() for k, v in
          build_torch_vqmodel(cfg).state_dict().items()}

    def fz(k):                       # tests/test_remap.py's renaming
        k = k.replace("encoder.", "enc.").replace("decoder.", "dec.")
        k = k.replace("conv_blocks.", "down.") if k.startswith("enc") \
            else k.replace("conv_blocks.", "up.")
        k = k.replace(".res.", ".block.").replace("quantize.embedding",
                                                  "vq.codes")
        return k.replace("norm1.weight", "norm1.g").replace(
            "norm1.bias", "norm1.b")

    foreign = {fz(k): v for k, v in sd.items()}
    foreign["loss.disc.0.weight"] = np.zeros((8, 3, 4, 4), np.float32)
    fm = JV.VQGAN(cfg)
    params = random_params(fm, np.zeros((1, 16, 16, 3), np.float32))
    model = TV.VQGAN(TV.VQConfig(**VQ_TINY))
    got, report = TR.load_vqgan_foreign(model, foreign)
    jparams, jreport = JR.load_vqgan_foreign(params, foreign, cfg)
    assert report_fields(report) == report_fields(jreport)
    want = TV.vqgan_state_dict_from_jax(to_np(jparams))
    assert sorted(got) == sorted(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], atol=0, rtol=0)


def test_titok_foreign_remap_equals_jax():
    from unidisc_tpu.tokenizers import titok as JT
    from unidisc_tpu_torch.tokenizers import titok as TT
    kw = dict(num_latent_tokens=4, codebook_size=32, codebook_dim=8,
              hidden_size=32, n_layers=2, n_heads=2, patch_size=8,
              image_size=16)
    cfg = JT.TiTokConfig(**kw)
    assert list(TR.titok_mirror_template(TT.TiTokConfig(**kw)).items()) \
        == list(JR.titok_mirror_template(cfg).items())
    torch.manual_seed(0)
    sd = _torch_sd(TTiTok(cfg).eval())

    def fz(k):                       # tests/test_remap.py's renaming
        k = k.replace("encoder.", "enc.transformer.")
        k = k.replace("decoder.", "dec.transformer.")
        return k.replace("mlp_0", "mlp.fc1").replace(
            "mlp_2", "mlp.fc2").replace("to_pixels", "ffn_out")

    foreign = {fz(k): v for k, v in sd.items()}
    params = random_params(JT.TiTok(cfg), np.zeros((1, 16, 16, 3),
                                                   np.float32))
    model = TT.TiTok(TT.TiTokConfig(**kw))
    got, report = TR.load_titok_foreign(model, foreign)
    jparams, jreport = JR.load_titok_foreign(params, foreign, cfg)
    assert report_fields(report) == report_fields(jreport)
    want = TT.titok_state_dict_from_jax(to_np(jparams))
    assert list(got) == list(model.state_dict())
    for key in want:
        torch.testing.assert_close(got[key], want[key], atol=0, rtol=0)
