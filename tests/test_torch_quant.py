"""The port's int8 W8A8 quantization (ops/quant.py, the int8 DIT) against
the JAX package.

- The quantizers equal JAX's bit for bit, in both rounding forms: the
  dividing form of ops/quant.py (amax / 127, x / scale) and the multiplying
  form of the fused prologue (amax * (1/127), y * (1/s)), on inputs built
  to sit on rounding boundaries where the two forms disagree.
- quantize_dit_params equals JAX's (transposed to the port's (N, K)
  layout), and a quantized JAX tree carries over exactly: kernel_q becomes
  int8 weight_q, a QDense scale stays a scale, a LayerNorm scale becomes a
  weight.
- A tiny int8 DIT (L 256, so that every trunk product and the head tile
  for the Pallas kernels in interpret mode) matches the JAX int8 DIT under
  each quant_backend x quant_fused, fp32 compute on both sides. The int8
  products are exact on both sides, but the fp32 norms, softmax and GELU
  around them differ in summation order and ulp (the float DIT agrees to
  ~1e-6, tests/test_torch_dit.py); an activation that sits within that of
  a rounding boundary lands one int8 step (1/127 of its row's largest
  value) away, and its row then drifts at int8 grain through the later
  blocks. Measured at two weight seeds: 82-89% of the rows agree to 1e-4
  of the logits' scale, the largest difference is 0.9-1.2% of the scale,
  the mean 0.9-1.4e-3 of the mean, and the top-1 token agrees everywhere.
  Tolerances: >= 75% of the rows within 1e-4 x scale, max <= 2.5e-2 x
  scale, mean <= 3e-3 x mean, top-1 agreement >= 99%.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from unidisc_tpu.config import Config as JaxConfig
from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.ops import fused_qmm as jax_fused
from unidisc_tpu.ops import quant as jax_quant
from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.models import dit as dit_module
from unidisc_tpu_torch.models.dit import DIT, QLinear, randomize_
from unidisc_tpu_torch.models.port import dit_state_dict_from_jax
from unidisc_tpu_torch.ops import _build, fused_qmm, quant
from test_torch_dit import param_tree, random_params
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

ROW_TOL, ROWS_AGREE = 1e-4, 0.75     # of the logits' scale; share of rows
MAX_TOL, MEAN_TOL, TOP1 = 2.5e-2, 3e-3, 0.99


def borderline_rows(seed=0, rows=64, k=96):
    """Rows whose amax makes amax / 127 and amax * (1/127) differ by an
    ulp, with values at (j + 1/2) scale: the two rounding forms disagree on
    some of them."""
    rng = np.random.RandomState(seed)
    inv = np.float32(1.0) / np.float32(127.0)
    out = []
    while len(out) < rows:
        amax = np.float32(rng.uniform(0.5, 4.0))
        s_div = amax / np.float32(127.0)
        if s_div == amax * inv:
            continue
        j = rng.randint(-126, 126, k - 1).astype(np.float32)
        row = ((j + np.float32(0.5)) * s_div).astype(np.float32)
        out.append(np.concatenate([[amax], row]).astype(np.float32))
    x = np.stack(out)
    return x * np.where(rng.rand(*x.shape) < 0.5, -1, 1).astype(np.float32)


def test_rounding_forms_match_jax_on_borderline_values():
    x = borderline_rows()
    want_div = [np.asarray(a) for a in
                jax_quant.dynamic_quantize(jnp.asarray(x))]
    want_mul = [np.asarray(a) for a in jax_fused._quantize(jnp.asarray(x))]
    want_mul[0] = want_mul[0].astype(np.int8)
    got_div = quant.dynamic_quantize(torch.from_numpy(x))
    got_mul = fused_qmm.fused_quantize(torch.from_numpy(x), mode="none")
    for want, got in ((want_div, got_div), (want_mul, got_mul)):
        assert got[0].dtype == torch.int8
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
    # the inputs do sit where the two forms disagree
    assert (want_div[0] != want_mul[0]).any()
    # and weights take the dividing form per output channel, (N, K)
    w_q, w_s = jax_quant.quantize_per_channel(jnp.asarray(x.T), axis=0)
    got_q, got_s = quant.quantize_per_channel(torch.from_numpy(x), axis=1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(w_q).T)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(w_s))


def dq_input(case):
    """x (numpy fp32) and its dtype for the dynamic_quantize cases: rows
    at the serve path's widths, rows of zeros among them, and rows built
    to sit on the dividing form's rounding boundaries."""
    rng = np.random.RandomState(len(case))
    if case == "borderline":
        return borderline_rows(seed=5), torch.float32
    if case == "zero_rows":
        x = (rng.randn(16, 768) * 0.7).astype(np.float32)
        x[[0, 5, 15]] = 0.0
        x[7] = 0.0
        x[7, 100] = -3.0
        return x, torch.bfloat16
    k, dtype = case.split("_")
    x = (rng.randn(32, int(k[1:])) * rng.uniform(0.1, 4.0, (32, 1)))
    return x.astype(np.float32), getattr(torch, {"bf16": "bfloat16",
                                                 "fp32": "float32"}[dtype])


@pytest.mark.parametrize("case", ["k768_bf16", "k768_fp32", "k3072_bf16",
                                  "k3072_fp32", "zero_rows", "borderline"])
def test_dynamic_quantize_reference_matches_jax(case):
    # the kernel's plain version, bit for bit against JAX's dividing form;
    # on a CPU tensor dynamic_quantize is that plain version
    x, dtype = dq_input(case)
    xt = torch.from_numpy(x).to(dtype)
    jx = jnp.asarray(xt.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want_q, want_s = (np.asarray(a) for a in jax_quant.dynamic_quantize(jx))
    for fn in (quant.dynamic_quantize_reference, quant.dynamic_quantize):
        q, s = fn(xt)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), want_q)
        np.testing.assert_array_equal(s.numpy(), want_s)


def test_dynamic_quantize_on_the_cpu_launches_no_kernel():
    x = torch.from_numpy(dq_input("k768_bf16")[0])
    w_q, w_s = quant.quantize_per_channel(torch.randn(64, 768), axis=1)
    before = dict(_build.launch_counts)
    q, s = quant.dynamic_quantize(x.reshape(4, 8, 768))
    assert q.shape == (4, 8, 768) and s.shape == (4, 8, 1)
    quant.qdot(x, w_q, w_s, backend="pallas")
    assert dict(_build.launch_counts) == before
    with pytest.raises(ValueError, match="device"):
        quant.dynamic_quantize(torch.empty((2, 8), device="meta"))


def test_zero_rows_and_channels_get_scale_one():
    x = torch.zeros((3, 32))
    x[1, 3] = -2.0
    x_q, s = quant.dynamic_quantize(x)
    assert s[:, 0].tolist() == [1.0, np.float32(2) / np.float32(127), 1.0]
    assert x_q[1, 3].item() == -127 and x_q.abs().sum().item() == 127
    w_q, w_s = quant.quantize_per_channel(x, axis=1)
    assert torch.equal(w_q, x_q) and torch.equal(w_s, s[:, 0])


# the tiny flagship-shaped model of the int8 comparisons: L 256 (112 text
# + a 12 x 12 image grid) so that rows_per_batch % 128 == 0 and M, N, K of
# every product (the head's vocab 128 too) tile for the Pallas kernels
OVERRIDES = {
    "model.hidden_size": 128, "model.n_heads": 2, "model.n_blocks": 2,
    "model.cond_dim": 32, "model.length": 256, "model.txt_length": 112,
    "model.img_length": 144, "model.text_vocab_size": 40,
    "model.image_vocab_size": 88, "model.time_conditioning": True,
    "model.qk_norm": True, "model.norm_type": "rms",
    "model.sandwich_normalization": True, "model.modality_embed": True,
    "model.rope_2d": True, "model.zero_linear_init": False,
    "model.dropout": 0.0,
}
B = 2


def configs(**extra):
    over = {**OVERRIDES, **extra}
    return JaxConfig.make("tiny", **over), Config.make("tiny", **over)


@pytest.fixture(scope="module")
def trees():
    jcfg, _ = configs()
    params = random_params(param_tree(jcfg.model, jnp.float32), seed=3)
    return params, jax_quant.quantize_dit_params(params)


def test_quantize_dit_params_matches_jax_and_carries_over(trees):
    params, qparams = trees
    want = dit_state_dict_from_jax(qparams)
    got = quant.quantize_dit_params(dit_state_dict_from_jax(params))
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name
    # the carried tree fits the port's int8 DIT exactly ...
    _, tcfg = configs(**{"model.quant": "int8"})
    model = DIT(tcfg.model, compute_dtype=torch.float32)
    assert {k: (tuple(v.shape), v.dtype)
            for k, v in model.state_dict().items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in want.items()}
    model.load_state_dict(want)
    # ... leaf for leaf: int8 kernels transposed, the per-channel scale
    # kept as a scale, the LayerNorm scale of QK-norm become a weight
    flat = traverse_util.flatten_dict(qparams, sep="/")
    stacked = np.asarray(flat["blocks/attention/attn_qkv/kernel_q"])
    assert stacked.dtype == np.int8 and stacked.ndim == 3
    for i in range(stacked.shape[0]):
        blk = f"blocks.{i}"
        for jname, tname in (("attention/attn_qkv", "attn_qkv"),
                             ("attention/attn_out", "attn_out"),
                             ("mlp_0", "mlp.0"), ("mlp_2", "mlp.2")):
            kq = np.asarray(flat[f"blocks/{jname}/kernel_q"])[i]
            np.testing.assert_array_equal(
                want[f"{blk}.{tname}.weight_q"].numpy(), kq.T)
            np.testing.assert_array_equal(
                want[f"{blk}.{tname}.scale"].numpy(),
                np.asarray(flat[f"blocks/{jname}/scale"])[i])
            assert f"{blk}.{tname}.weight" not in want
        np.testing.assert_array_equal(
            want[f"{blk}.q_norm.weight"].numpy(),
            np.asarray(flat["blocks/attention/q_norm/scale"])[i])
    np.testing.assert_array_equal(
        want["output_layer.linear.weight_q"].numpy(),
        np.asarray(flat["output_layer/linear/kernel_q"]).T)
    assert isinstance(model.output_layer.linear, QLinear)


def inputs(m, seed=0):
    rng = np.random.RandomState(seed)
    lt, li = m.txt_length, m.img_length
    ids = np.concatenate([rng.randint(0, m.text_vocab_size, (B, lt)),
                          rng.randint(m.text_vocab_size, m.vocab_size,
                                      (B, li))], 1).astype(np.int32)
    ids[:, lt + 5::3] = m.mask_index
    modality = np.concatenate([np.zeros((B, lt)), np.ones((B, li))],
                              1).astype(np.int32)
    return ids, np.asarray([0.4, 1.3], np.float32), modality


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_int8_dit_matches_jax(trees, backend, fused):
    _, qparams = trees
    extra = {"model.quant": "int8", "model.quant_backend": backend,
             "model.quant_fused": fused}
    jcfg, tcfg = configs(**extra)
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    ids, sigma, modality = inputs(jcfg.model)
    want = np.asarray(jax.jit(lambda p: jmodel.apply(
        {"params": p}, jnp.asarray(ids), jnp.asarray(sigma),
        modality=jnp.asarray(modality)))(qparams))
    model = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    model.load_state_dict(dit_state_dict_from_jax(qparams))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(sigma),
                    modality=torch.from_numpy(modality).long()).numpy()
    diff, scale = np.abs(got - want), np.abs(want).max()
    assert (diff.max(-1) <= ROW_TOL * scale).mean() >= ROWS_AGREE
    assert diff.max() <= MAX_TOL * scale
    assert diff.mean() <= MEAN_TOL * np.abs(want).mean()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= TOP1


def test_int8_dit_tracks_the_float_model(trees):
    """As tests/test_quant.py holds the JAX int8 DIT to its fp model:
    cosine > 0.99 and top-1 agreement > 0.9 over positions."""
    params, qparams = trees
    _, tcfg = configs(**{"model.quant_fused": True})
    fp = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    fp.load_state_dict(dit_state_dict_from_jax(params))
    qcfg, q = quant.quantize_model(tcfg, fp)
    assert qcfg.model.quant == "int8" and q.cfg is qcfg.model
    ids, sigma, modality = inputs(tcfg.model, seed=1)
    args = (torch.from_numpy(ids).long(), torch.from_numpy(sigma))
    mod = torch.from_numpy(modality).long()
    with torch.no_grad():
        a = fp(*args, modality=mod).double()
        b = q(*args, modality=mod).double()
    cos = (a * b).sum() / (a.norm() * b.norm())
    assert cos > 0.99
    assert (a.argmax(-1) == b.argmax(-1)).double().mean() > 0.9


def test_quantize_model_takes_the_one_rank_model():
    """The weights are quantized whole, then laid out on a mesh: a laid-out
    model's per-channel scales would be maxima over a shard, so
    quantize_model refuses one."""
    from unidisc_tpu_torch.parallel.mesh import MeshShards
    _, tcfg = configs()
    model = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    model.mesh_shards = MeshShards()
    with pytest.raises(ValueError, match="before parallel/mesh.py"):
        quant.quantize_model(tcfg, model)


@pytest.mark.parametrize("rows", ["per_batch_row", "per_token"])
def test_fused_block_path_needs_per_batch_row_adaln(rows, monkeypatch):
    """A quant_fused block takes the fused quantize kernel only with one
    adaLN row per batch element, as the JAX block does
    (unidisc_tpu/models/dit.py:475-477); with per-token rows, from a
    (B, L, cond_dim) conditioning, it keeps qdot and equals the unfused
    block."""
    _, tcfg = configs(**{"model.quant": "int8", "model.quant_fused": True})
    m = tcfg.model
    model = DIT(m, compute_dtype=torch.float32).eval()
    randomize_(model, seed=4)
    unfused = DIT(dataclasses.replace(m, quant_fused=False),
                  compute_dtype=torch.float32).eval()
    unfused.load_state_dict(model.state_dict())
    calls = []
    real = dit_module.fused_qmm
    monkeypatch.setattr(dit_module, "fused_qmm",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    rng = np.random.RandomState(6)
    l = m.length
    x = torch.from_numpy(rng.randn(B, l, m.hidden_size).astype(np.float32))
    shape = (B, m.cond_dim) if rows == "per_batch_row" \
        else (B, l, m.cond_dim)
    c = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    modality = torch.from_numpy(inputs(m)[2]).long()
    args = (x, c, model.rope_cos[:l], model.rope_sin[:l], modality)
    with torch.no_grad():
        got = model.blocks[0](*args)
        want = unfused.blocks[0](*args)
    assert got.shape == (B, l, m.hidden_size)
    assert bool(torch.isfinite(got).all())
    if rows == "per_batch_row":
        # attn_qkv and mlp.0, each behind its norm + adaLN prologue
        assert [kw["mode"] for kw in calls] == ["adaln_norm"] * 2
        assert all(kw["shift"].shape == (B, m.hidden_size) for kw in calls)
    else:
        assert calls == []
        assert torch.equal(got, want)
