"""The port's DIT against the JAX DIT at identical weights.

A tiny flagship-shaped config (2 blocks, hidden 128, head_dim 64, rms,
QK-norm, sandwich norm, modality embedding, 2D rope on a 4x4 image grid,
time conditioning). The JAX init zeroes the adaLN tables and the head, so
every parameter is redrawn from a numpy seed before it is carried over
with `dit_state_dict_from_jax`; both sides compute in fp32.

Tolerance atol 2e-4, rtol 1e-3, as in tests/test_port.py: fp32 on both
sides, differing only in summation order through two blocks and the head.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from unidisc_tpu.config import Config as JaxConfig
from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.models.dit import init_dit
from unidisc_tpu.models.port import port_dit_state_dict
from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.models.dit import DIT
from unidisc_tpu_torch.models.port import dit_state_dict_from_jax
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

B, TXT, IMG = 2, 8, 16
L = TXT + IMG
ATOL, RTOL = 2e-4, 1e-3

OVERRIDES = {
    "model.hidden_size": 128, "model.n_heads": 2, "model.n_blocks": 2,
    "model.cond_dim": 32, "model.length": L, "model.txt_length": TXT,
    "model.img_length": IMG, "model.text_vocab_size": 24,
    "model.image_vocab_size": 40, "model.time_conditioning": True,
    "model.qk_norm": True, "model.norm_type": "rms",
    "model.sandwich_normalization": True, "model.modality_embed": True,
    "model.rope_2d": True, "model.zero_linear_init": False,
    "model.dropout": 0.0,
}


def configs(**extra):
    over = {**OVERRIDES, **extra}
    return JaxConfig.make("tiny", **over), Config.make("tiny", **over)


def random_params(params, seed=0):
    """Every leaf redrawn: norm scales near 1, everything else small."""
    rng = np.random.RandomState(seed)
    flat = traverse_util.flatten_dict(params, sep="/")
    out = {}
    for k, v in flat.items():
        shape = np.shape(v)
        if k.endswith(("weight", "scale")):
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            fan = shape[-2] if len(shape) >= 2 else shape[-1]
            arr = rng.standard_normal(shape) / np.sqrt(fan)
        out[k] = jnp.asarray(arr, jnp.float32)
    return traverse_util.unflatten_dict(out, sep="/")


@functools.lru_cache(maxsize=None)
def param_tree(m, compute_dtype):
    """init_dit's parameter tree for a model config as shapes
    (``jax.eval_shape``: the init traced, not run), made once a process:
    random_params reads only its leaves' names, order and shapes. The
    leaves keep the init's order (eval_shape's output sorts dict keys)."""
    order = []

    def init(key):
        tree = init_dit(key, m, compute_dtype=compute_dtype)[1]
        order.extend(traverse_util.flatten_dict(tree, sep="/"))
        return tree
    flat = traverse_util.flatten_dict(
        jax.eval_shape(init, jax.random.PRNGKey(0)), sep="/")
    return traverse_util.unflatten_dict({k: flat[k] for k in order},
                                        sep="/")


def random_dit(m, seed=0, compute_dtype=jnp.bfloat16):
    """(the JAX DIT, random_params over its parameter tree)."""
    return (JaxDIT(m, compute_dtype=compute_dtype),
            random_params(param_tree(m, compute_dtype), seed=seed))


def inputs(m, seed=0):
    rng = np.random.RandomState(seed)
    ids = np.concatenate([rng.randint(0, m.text_vocab_size, (B, TXT)),
                          rng.randint(m.text_vocab_size, m.vocab_size,
                                      (B, IMG))], 1).astype(np.int32)
    modality = np.concatenate([np.zeros((B, TXT)), np.ones((B, IMG))],
                              1).astype(np.int32)
    sigma = np.asarray([0.3, 1.7], np.float32)
    return ids, sigma, modality


def port_model(tcfg, params):
    model = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    model.load_state_dict(dit_state_dict_from_jax(params))
    return model


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = configs()
    return random_dit(jcfg.model, compute_dtype=jnp.float32)[1]


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_logits_and_hidden_match_jax(jax_params, backend):
    jcfg, tcfg = configs(**{"model.attn_backend": backend})
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    ids, sigma, modality = inputs(jcfg.model)
    want_logits, want_hidden = jmodel.apply(
        {"params": jax_params}, jnp.asarray(ids), jnp.asarray(sigma),
        modality=jnp.asarray(modality), return_hidden=True)
    model = port_model(tcfg, jax_params)
    with torch.no_grad():
        logits, hidden = model(torch.from_numpy(ids).long(),
                               torch.from_numpy(sigma),
                               modality=torch.from_numpy(modality).long(),
                               return_hidden=True)
        only_hidden = model.hidden(torch.from_numpy(ids).long(),
                                   torch.from_numpy(sigma),
                                   modality=torch.from_numpy(
                                       modality).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_hidden),
                               atol=ATOL, rtol=RTOL)
    assert torch.equal(only_hidden, hidden)


def test_causal_layernorm_variant_matches_jax():
    extra = {"model.full_attention": False, "model.norm_type": "layernorm",
             "model.qk_norm": False, "model.sandwich_normalization": False,
             "model.rope_2d": False, "model.attn_backend": "pallas"}
    jcfg, tcfg = configs(**extra)
    jmodel, params = random_dit(jcfg.model, seed=1,
                                compute_dtype=jnp.float32)
    ids, sigma, modality = inputs(jcfg.model, seed=1)
    want = jmodel.apply({"params": params}, jnp.asarray(ids),
                        jnp.asarray(sigma), modality=jnp.asarray(modality))
    model = port_model(tcfg, params)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(sigma),
                    modality=torch.from_numpy(modality).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("doubled", [False, True])
def test_rope_index_matches_jax(jax_params, doubled):
    """Per-token rope rows: text indices clipped into the text table, image
    indices offset by txt_length into the image table; out-of-range
    indices clip on both sides. Doubled: the [corrupted || clean] rows of
    ar_inpainting, twice the model's length."""
    jcfg, tcfg = configs(**{"model.attn_backend": "xla"})
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    ids, sigma, modality = inputs(jcfg.model, seed=2)
    rng = np.random.RandomState(7)
    rope_index = rng.randint(-2, IMG + 3, (B, L)).astype(np.int32)
    if doubled:
        ids, modality, rope_index = (np.concatenate([a, a[:, ::-1]], 1)
                                     for a in (ids, modality, rope_index))
    want = jmodel.apply({"params": jax_params}, jnp.asarray(ids),
                        jnp.asarray(sigma), modality=jnp.asarray(modality),
                        rope_index=jnp.asarray(rope_index))
    model = port_model(tcfg, jax_params)
    with torch.no_grad():
        got = model(torch.from_numpy(ids.copy()).long(),
                    torch.from_numpy(sigma),
                    modality=torch.from_numpy(modality.copy()).long(),
                    rope_index=torch.from_numpy(rope_index.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_weight_carry_over_round_trips(jax_params):
    sd = dit_state_dict_from_jax(jax_params)
    jcfg, tcfg = configs()
    # the port's module has exactly these keys and shapes
    model = DIT(tcfg.model, compute_dtype=torch.float32)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    # and the JAX package's own torch->flax mapping restores the tree
    template = param_tree(jcfg.model, jnp.float32)
    back = port_dit_state_dict(template,
                               {k: v.numpy() for k, v in sd.items()})
    want = traverse_util.flatten_dict(jax_params, sep="/")
    got = traverse_util.flatten_dict(back, sep="/")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


VARIANTS = {
    # every DIT variant of the JAX package runs (held to JAX in
    # tests/test_torch_moe.py and tests/test_torch_img_cond.py)
    "label": {"model.cond_label": True, "model.time_conditioning": False},
    "x_cond": {"model.img_cond": True, "model.cond_image_vocab_size": 8,
               "model.cond_length": 4, "model.n_cond_blocks": 1,
               "model.qk_norm": False, "model.sandwich_normalization": False,
               "model.rope_2d": False},
    "split_embed": {"model.split_embed": True},
    "moe": {"model.moe_experts": 4},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_forwards_run(variant):
    _, tcfg = configs(**VARIANTS[variant])
    model = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    ids, sigma, modality = inputs(tcfg.model)
    kw = {}
    if variant == "label":
        kw["label"] = torch.tensor([0, 1000])
    if variant == "x_cond":
        kw["x_cond"] = torch.zeros((B, 4), dtype=torch.long)
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long(), torch.from_numpy(sigma),
                    modality=torch.from_numpy(modality).long(), **kw)
    assert out.shape == (B, L, tcfg.model.vocab_size)
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("variant", sorted(VARIANTS) + ["int8",
                                                       "img_count_embed"])
def test_empty_dit_is_filled_whole_by_reset_parameters(variant):
    """A DIT built with init=False (no draws) leaves every parameter and
    persistent buffer without a value; reset_parameters fills each of
    them (none is left NaN) with the values of a DIT built the usual way
    from the same seed."""
    over = {"int8": {"model.quant": "int8"},
            "img_count_embed": {"model.img_count_embed": True}
            }.get(variant) or VARIANTS[variant]
    _, tcfg = configs(**over)
    model = DIT(tcfg.model, torch.float32, init=False)
    with torch.no_grad():
        for t in model.state_dict().values():
            t.fill_(float("nan") if t.is_floating_point() else -1)
    model.reset_parameters(torch.Generator().manual_seed(5))
    want = DIT(tcfg.model, compute_dtype=torch.float32)
    want.reset_parameters(torch.Generator().manual_seed(5))
    got = model.state_dict()
    for name, value in want.state_dict().items():
        assert torch.equal(got[name], value), name
    for name, value in want.named_buffers():
        assert torch.equal(model.get_buffer(name), value), name


def test_unported_branches_raise():
    """No DIT branch is unported now; what the JAX DIT refuses (asserts)
    the port refuses: a cond_label forward without a label, img_cond with a
    KV cache, and an argument the DIT does not have."""
    _, tcfg = configs(**VARIANTS["label"])
    model = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    ids, sigma, modality = inputs(tcfg.model)
    args = (torch.from_numpy(ids).long(), torch.from_numpy(sigma))
    mod = torch.from_numpy(modality).long()
    with pytest.raises(ValueError, match="needs label"):
        model(*args, modality=mod)
    with pytest.raises(ValueError, match="generator"):
        model.train()(*args, modality=mod, label=torch.tensor([0, 1]))
    _, tcfg = configs(**VARIANTS["x_cond"])
    model = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    kv = torch.zeros((tcfg.model.n_blocks, B, L, 2, 64))
    with pytest.raises(ValueError, match="KV-cache"):
        model(*args, modality=mod, x_cond=torch.zeros((B, 4)).long(),
              kv_cache=(kv, kv.clone()), cache_index=0)
    with pytest.raises(TypeError, match="unexpected keyword"):
        model(*args, modality=mod, no_such_argument=1)


# ---------------------------------------------------------------------------
# training-mode dropout and remat
# ---------------------------------------------------------------------------

P_DROP = 0.25


def keep_mask(shape, seed):
    return np.random.RandomState(seed).rand(*shape) >= P_DROP


@pytest.mark.parametrize("gated,with_modality", [(True, True), (True, False),
                                                 (False, True)])
def test_gate_residual_dropout_matches_jax(gated, with_modality):
    """The same keep mask through JAX's own dropout_fn argument and the
    port's: image rows gate * dropped, text rows the raw branch output."""
    from unidisc_tpu.models import dit as jdit
    from unidisc_tpu_torch.models.dit import dropout_with, gate_residual
    rng = np.random.RandomState(3)
    x, out = (rng.standard_normal((B, L, 16)).astype(np.float32)
              for _ in range(2))
    gate = rng.standard_normal((B, 1, 16)).astype(np.float32) \
        if gated else None
    _, _, modality = inputs(configs()[0].model)
    modality = modality if with_modality else None
    keep = keep_mask((B, L, 16), 4)
    want = jdit.gate_residual(
        jnp.asarray(x), jnp.asarray(out),
        None if gate is None else jnp.asarray(gate),
        None if modality is None else jnp.asarray(modality),
        dropout_fn=lambda y: jnp.where(keep, y / (1.0 - P_DROP), 0.0))
    t = torch.from_numpy
    got = gate_residual(t(x), t(out), None if gate is None else t(gate),
                        None if modality is None else t(modality).long(),
                        dropout_fn=dropout_with(t(keep), P_DROP))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    if gated and with_modality:
        text = modality == 0
        np.testing.assert_array_equal(got.numpy()[text], (x + out)[text])


def test_dropout_masks_keep_share_and_scale():
    from unidisc_tpu_torch.models.dit import dropout_masks, dropout_with
    keep_a, keep_m = dropout_masks((8, 64, 128), P_DROP, 123, "cpu")
    for keep in (keep_a, keep_m):
        assert abs(keep.float().mean().item() - (1 - P_DROP)) < 0.01
    assert not torch.equal(keep_a, keep_m)
    again = dropout_masks((8, 64, 128), P_DROP, 123, "cpu")
    assert torch.equal(again[0], keep_a) and torch.equal(again[1], keep_m)
    y = dropout_with(keep_a, P_DROP)(torch.ones(8, 64, 128))
    assert set(torch.unique(y).tolist()) == {
        0.0, float(np.float32(1.0 / (1 - P_DROP)))}


@pytest.mark.parametrize("sandwich", [True, False])
def test_train_mode_forward_with_masks_matches_jax(jax_params, sandwich,
                                                   monkeypatch):
    """The whole model in training mode, the JAX side with one keep mask
    substituted for every dropout of every block (inside this test only:
    gate_residual's dropout_fn replaced), the port given the same mask for
    both branches of every block."""
    from unidisc_tpu.models import dit as jdit
    jcfg, tcfg = configs(**{"model.dropout": P_DROP,
                            "model.sandwich_normalization": sandwich,
                            "model.attn_backend": "xla"})
    jmodel, params = random_dit(jcfg.model, seed=5,
                                compute_dtype=jnp.float32)
    ids, sigma, modality = inputs(jcfg.model, seed=3)
    keep = keep_mask((B, L, jcfg.model.hidden_size), 6)
    orig = jdit.gate_residual

    def substituted(x_skip, out, gate, modality, *, dropout_fn=None):
        fn = None if dropout_fn is None else (
            lambda y: jnp.where(keep, y / (1.0 - P_DROP), 0.0))
        return orig(x_skip, out, gate, modality, dropout_fn=fn)
    monkeypatch.setattr(jdit, "gate_residual", substituted)
    want = jmodel.apply({"params": params}, jnp.asarray(ids),
                        jnp.asarray(sigma), modality=jnp.asarray(modality),
                        deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(0)})
    model = port_model(tcfg, params).train()
    k = torch.from_numpy(keep)
    got = model(torch.from_numpy(ids).long(), torch.from_numpy(sigma),
                modality=torch.from_numpy(modality).long(),
                dropout=[(k, k)] * tcfg.model.n_blocks)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    ref = port_model(tcfg, params).eval()(
        torch.from_numpy(ids).long(), torch.from_numpy(sigma),
        modality=torch.from_numpy(modality).long())
    assert not torch.allclose(got, ref, atol=1e-3)     # dropout acted


@pytest.mark.parametrize("backend", ["auto", "xla"])
@pytest.mark.parametrize("policy", ["none", "dots", "dots_all"])
def test_remat_gradients_bit_equal_with_dropout(jax_params, policy, backend):
    """Gradients with model.dropout 0.25 from one seed: bit-equal with and
    without activation checkpointing; the recomputed blocks draw the same
    masks. "auto": attention through the kernel's autograd function (its
    plain versions on the CPU), "xla": the plain attention (batched
    products, which "dots_all" saves)."""
    _, tcfg = configs(**{"model.dropout": P_DROP,
                         "model.remat_policy": policy,
                         "model.attn_backend": backend})
    ids, sigma, modality = inputs(tcfg.model, seed=4)
    grads = {}
    for remat in (False, True):
        model = DIT(tcfg.model, compute_dtype=torch.float32, remat=remat)
        model.load_state_dict(dit_state_dict_from_jax(jax_params))
        model.train()
        logits = model(torch.from_numpy(ids).long(), torch.from_numpy(sigma),
                       modality=torch.from_numpy(modality).long(),
                       dropout=1234)
        loss = (logits.float() ** 2).mean()
        grads[remat] = torch.autograd.grad(loss, list(model.parameters()))
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)
    assert any(g.abs().max() > 0 for g in grads[True])
