"""The port's OpenELM (models/elm.py), its int8 conversion
(ops/quant.py::quantize_elm_params) and its weight carry-over
(models/port.py::elm_state_dict_from_jax) against the JAX package's.

Both sides compute in fp32 at identical weights, drawn from a numpy seed
at the flax module's parameter shapes (tables N(0, 0.02), kernels
N(0, 1/fan_in), norm scales 1 + 0.05 N(0, 1)) and carried over with
`elm_state_dict_from_jax`; the JAX side runs jitted. Tolerances: fp32 logits
within atol 1e-4 (fp32 on both sides, summation order only). The int8
model and the int8 KV cache are held to JAX's at the int8 grain that
tests/test_torch_quant.py sets for the int8 DIT (its docstring says why:
the integer products are exact, but an activation within an ulp of a
rounding boundary lands one int8 step away): >= 75% of the rows within
1e-4 of the logits' scale, the largest difference <= 2.5e-2 of it, the
mean <= 3e-3 of the mean, top-1 agreement >= 99%. The int8 KV cache
quantizes q, k, v and p at every step, so more values sit near a
boundary: it is held as tests/test_torch_kv_cache.py holds the int8 DIT
with a KV cache, without the share of rows (the same largest, mean and
top-1 bounds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from unidisc_tpu.models.elm import ELM_PRESETS as JAX_PRESETS
from unidisc_tpu.models.elm import OpenELM as JaxELM
from unidisc_tpu.models.elm import init_elm_cache as jax_cache
from unidisc_tpu.ops.quant import quantize_elm_params as jax_quantize
from unidisc_tpu_torch.models.elm import (ELM_PRESETS, ELMConfig, OpenELM,
                                          init_elm_cache)
from unidisc_tpu_torch.models.port import elm_state_dict_from_jax
from unidisc_tpu_torch.ops.quant import quantize_elm_params
from test_torch_quant import MAX_TOL, MEAN_TOL, ROW_TOL, ROWS_AGREE, TOP1
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

ATOL = 1e-4
# a small ELM of the speculative tests' shape: GQA 4 groups, head 16
SMALL = dict(vocab_size=64, extra_tokens=0, model_dim=48, num_layers=2,
             head_dim=16, max_length=256)


class JaxSide:
    """A flax OpenELM with its apply jitted (one compile per shape)."""

    def __init__(self, cfg):
        self.module = JaxELM(cfg, compute_dtype=jnp.float32)
        self._apply = jax.jit(self.module.apply)

    def apply(self, variables, ids, **kw):
        return self._apply(variables, ids, **kw)


def random_elm_params(cfg: ELMConfig, seed: int = 0) -> dict:
    """numpy fp32 params at the flax module's shapes (from an abstract
    init: nothing is traced or compiled)."""
    shapes = jax.eval_shape(
        JaxELM(cfg, compute_dtype=jnp.float32).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in traverse_util.flatten_dict(shapes, sep="/").items():
        if k.endswith("weight"):
            arr = 1.0 + 0.05 * rng.standard_normal(v.shape)
        elif k.startswith("token_embeddings"):
            arr = 0.02 * rng.standard_normal(v.shape)
        else:
            arr = rng.standard_normal(v.shape) / np.sqrt(v.shape[0])
        out[k] = arr.astype(np.float32)
    return traverse_util.unflatten_dict(out, sep="/")


def elm_pair(cfg: ELMConfig, seed: int = 0):
    """(the jitted flax module, its params as numpy, the port's module) at
    the same fp32 weights."""
    params = random_elm_params(cfg, seed)
    model = OpenELM(cfg, compute_dtype=torch.float32).eval()
    model.load_state_dict(elm_state_dict_from_jax(params))
    return JaxSide(cfg), params, model


def int8_pair(cfg: ELMConfig, params):
    """JAX's int8 model and tree, and the port's int8 model carried over."""
    qcfg = dataclasses.replace(cfg, quant="int8")
    qparams = jax.tree_util.tree_map(np.asarray, jax_quantize(params, cfg))
    qmodel = OpenELM(qcfg, compute_dtype=torch.float32).eval()
    qmodel.load_state_dict(elm_state_dict_from_jax(qparams))
    return JaxSide(qcfg), qparams, qmodel


def assert_int8_grain(got, want, rows=True):
    """got, want (..., V): the int8 DIT's criterion over the rows (without
    the share of rows within 1e-4 when rows=False)."""
    got = got.reshape(-1, got.shape[-1])
    want = want.reshape(-1, want.shape[-1])
    diff = np.abs(got - want)
    scale = np.abs(want).max()
    if rows:
        assert (diff.max(-1) <= ROW_TOL * scale).mean() >= ROWS_AGREE
    assert diff.max() <= MAX_TOL * scale
    assert diff.mean() <= MEAN_TOL * np.abs(want).mean()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= TOP1


@pytest.fixture(scope="module")
def tiny():
    return elm_pair(ELM_PRESETS["tiny"])


def ids_of(cfg, shape, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.total_vocab, shape)


def run(model, ids, **kw):
    with torch.no_grad():
        return model(torch.from_numpy(np.asarray(ids)).long(), **kw)


@pytest.mark.parametrize("preset", ["270m", "450m", "1.1b", "tiny"])
def test_presets_and_layerwise_scaling_match_jax(preset):
    cfg, jcfg = ELM_PRESETS[preset], JAX_PRESETS[preset]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for fn in ("layer_q_heads", "layer_kv_heads", "layer_ffn_dims"):
        assert list(getattr(cfg, fn)()) == list(getattr(jcfg, fn)()), fn
    assert cfg.total_vocab == jcfg.total_vocab
    qh, kvh = cfg.layer_q_heads(), cfg.layer_kv_heads()
    assert qh[-1] > qh[0] and all(q % k == 0 for q, k in zip(qh, kvh))


def test_forward_logits_match_jax(tiny):
    jmodel, params, model = tiny
    cfg = model.cfg
    ids = ids_of(cfg, (2, 16))
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
    got = run(model, ids)
    assert got.dtype == torch.float32
    assert got.shape == (2, 16, cfg.total_vocab)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_causality(tiny):
    _, _, model = tiny
    ids = ids_of(model.cfg, (1, 16))
    base = run(model, ids).numpy()
    ids2 = ids.copy()
    ids2[0, 10] = (ids2[0, 10] + 1) % model.cfg.total_vocab
    pert = run(model, ids2).numpy()
    np.testing.assert_array_equal(base[0, :10], pert[0, :10])
    assert np.abs(base[0, 10:] - pert[0, 10:]).max() > 1e-4


def test_kv_cache_decode_matches_full_forward_and_jax(tiny):
    """Token-by-token cached decode (int cache_index) equals the full
    forward, and JAX's cached decode, in an fp32 cache."""
    jmodel, params, model = tiny
    cfg, L = model.cfg, 12
    ids = ids_of(cfg, (2, L))
    full = run(model, ids).numpy()
    cache = init_elm_cache(cfg, 2, L, dtype=torch.float32)
    jcache = jax_cache(cfg, 2, L, dtype=jnp.float32)
    steps, jsteps = [], []
    for i in range(L):
        logits, cache = run(model, ids[:, i:i + 1], kv_cache=cache,
                            cache_index=i)
        jl, jcache = jmodel.apply({"params": params},
                                  jnp.asarray(ids[:, i:i + 1]),
                                  kv_cache=jcache, cache_index=i)
        steps.append(logits[:, 0].numpy())
        jsteps.append(np.asarray(jl)[:, 0])
    np.testing.assert_allclose(np.stack(steps, 1), full, atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.stack(steps, 1), np.stack(jsteps, 1),
                               atol=ATOL, rtol=0)


def test_vector_cache_index_matches_scalar(tiny):
    """A multi-token prefill at per-row positions (rows at different
    depths of one bf16 cache) gives each row's lockstep logits, and JAX's
    per-row logits."""
    jmodel, params, model = tiny
    cfg, L = model.cfg, 16
    ids = ids_of(cfg, (2, L), seed=4)
    cache = init_elm_cache(cfg, 2, L)
    jcache = jax_cache(cfg, 2, L)
    run(model, ids[:, :6], kv_cache=cache, cache_index=0)
    _, jcache = jmodel.apply({"params": params}, jnp.asarray(ids[:, :6]),
                             kv_cache=jcache, cache_index=0)
    # row 0 advances 3 tokens at position 6, row 1 one token at 4 (its
    # slots 4, 5 are rewritten before they are read)
    tok = np.stack([ids[0, 6:9], np.r_[ids[1, 4], 0, 0]])
    ci = np.asarray([6, 4])
    got, _ = run(model, tok, kv_cache=cache,
                 cache_index=torch.from_numpy(ci).long())
    want, _ = jmodel.apply({"params": params}, jnp.asarray(tok),
                           kv_cache=jcache,
                           cache_index=jnp.asarray(ci, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    full = run(model, ids).numpy()
    np.testing.assert_allclose(got[0].numpy(), full[0, 6:9], atol=2e-2)
    np.testing.assert_allclose(got[1, 0].numpy(), full[1, 4], atol=2e-2)


def test_quantize_elm_params_matches_jax(tiny):
    """The port's conversion of the carried-over fp32 state_dict equals
    JAX's tree carried over: every int8 value and scale exactly, the head
    in the (V, D) layout of int8_matmul."""
    _, params, model = tiny
    mine = quantize_elm_params(model.state_dict())
    theirs = elm_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_quantize(params, model.cfg)))
    assert set(mine) == set(theirs)
    for name in theirs:
        assert mine[name].dtype == theirs[name].dtype, name
        assert torch.equal(mine[name], theirs[name]), name
    assert mine["lm_head_q"].shape == (model.cfg.total_vocab,
                                       model.cfg.model_dim)
    qmodel = OpenELM(dataclasses.replace(model.cfg, quant="int8"))
    assert set(qmodel.state_dict()) == set(mine)


def test_int8_elm_matches_jax_int8_and_tracks_fp(tiny):
    jmodel, params, model = tiny
    cfg = model.cfg
    jq, qparams, qmodel = int8_pair(cfg, params)
    ids = ids_of(cfg, (2, 16), seed=1)
    want = np.asarray(jq.apply({"params": qparams}, jnp.asarray(ids)))
    got = run(qmodel, ids).numpy()
    assert_int8_grain(got, want)
    lf = run(model, ids).numpy().reshape(-1).astype(np.float64)
    cos = lf @ got.reshape(-1) / (np.linalg.norm(lf)
                                  * np.linalg.norm(got) + 1e-9)
    assert cos > 0.99, cos


def test_int8_kv_cache_decode_matches_jax(tiny):
    """The int8 KV cache (GQA heads repeated into int8_kv_attention)
    decodes as JAX's, step by step at per-row positions."""
    jmodel, params, model = tiny
    cfg, L = model.cfg, 10
    ids = ids_of(cfg, (2, L), seed=3)
    cache = init_elm_cache(cfg, 2, L, quant=True)
    assert len(cache[0]) == 4 and cache[0][0].dtype == torch.int8
    jcache = jax_cache(cfg, 2, L, quant=True)
    got, want = [], []
    for i in range(L):
        ci = np.asarray([i, i])
        g, cache = run(model, ids[:, i:i + 1], kv_cache=cache,
                       cache_index=torch.from_numpy(ci).long())
        w, jcache = jmodel.apply({"params": params},
                                 jnp.asarray(ids[:, i:i + 1]),
                                 kv_cache=jcache,
                                 cache_index=jnp.asarray(ci, jnp.int32))
        got.append(g.numpy())
        want.append(np.asarray(w))
    assert_int8_grain(np.stack(got), np.stack(want), rows=False)


def test_small_gqa_config_matches_jax():
    """GQA with 4 groups and two layers of different head counts."""
    cfg = ELMConfig(**SMALL)
    jmodel, params, model = elm_pair(cfg, seed=3)
    ids = ids_of(cfg, (2, 9), seed=5)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
    np.testing.assert_allclose(run(model, ids).numpy(), want, atol=ATOL,
                               rtol=0)


def test_random_init_follows_the_jax_distributions():
    """reset_parameters: tables N(0, 0.02), projections lecun-normal
    (variance 1 / fan_in, truncated at two deviations), norms 1; int8
    projections round(127 U(+-1/sqrt(fan_in))) with scale 1/127."""
    cfg = dataclasses.replace(ELM_PRESETS["tiny"], model_dim=128)
    model = OpenELM(cfg, compute_dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(3))
    assert abs(model.token_embeddings.std().item() - 0.02) < 2e-3
    w = model.layers[0].proj_1.weight
    assert abs(w.var().item() * 128 - 1.0) < 0.1
    assert w.abs().max().item() <= 2 * (1 / 128) ** 0.5 / .8796 + 1e-6
    assert (model.norm.weight == 1).all()
    q = OpenELM(dataclasses.replace(cfg, quant="int8"))
    lin = q.layers[0].attn.qkv_proj
    assert lin.weight_q.dtype == torch.int8
    assert lin.weight_q.abs().max().item() <= round(127 / 128 ** 0.5)
    assert torch.all(lin.scale == 1 / 127.0)
    assert (q.lm_head_q == 0).all() and (q.lm_head_scale == 1).all()


def test_an_fp64_copy_computes_the_same_logits(tiny):
    """The fp64 form of a model (the reference computation of the chip
    check's speculative gate) keeps fp64 through the norms, scores and
    head, and gives the fp32 model's logits within fp32 rounding."""
    _, _, model = tiny
    wide = OpenELM(model.cfg, compute_dtype=torch.float64).eval()
    wide.load_state_dict(model.state_dict())
    ids = ids_of(model.cfg, (2, 12), seed=6)
    got = run(wide, ids)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), run(model, ids).numpy(),
                               atol=ATOL, rtol=0)
    cache = init_elm_cache(model.cfg, 2, 12, dtype=torch.float64)
    step, _ = run(wide, ids, kv_cache=cache, cache_index=0)
    np.testing.assert_allclose(step.numpy(), got.numpy(), atol=1e-10,
                               rtol=0)
