"""The port's KV-cache paths against the JAX package.

- The DIT's cached forward: a prefill and three one-token decode steps of
  a causal tiny model, with a scalar and with a per-row (B,) cache_index
  (rows at different depths), logits and cache within atol 2e-4 / rtol
  1e-3 of JAX, as tests/test_torch_dit.py holds the DIT (fp32 on both
  sides and an fp32 cache, so that no bf16 rounding of the cache enters).
- frozen_kv (the conditioning-frozen t2i forward): image rows against a
  read-only text prefix, with the same tolerance.
- The return forms (logits, new_cache), (logits, hidden, new_cache) and
  hidden(...) -> (hidden, new_cache).
- quantize_kv bit for bit; int8_kv_attention within 2e-2 of the output's
  scale everywhere (its integer products are exact on both sides; a
  softmax value an ulp apart can move one int8 step of p, 1/127 of its
  row's largest weight) and within 1e-5 of it on >= 99% of the elements
  (measured: at most 3e-7, the softmax's ulps), also over a cache longer
  than the 1,040 keys one fp32 sum can hold exactly, and equal there to
  its own int64 reference.
- A quant_fused int8 model with a kv_cache leaves the fused block path
  (the repair): no fused_qmm call, logits equal to the unfused model's and
  at int8 grain of JAX's; under frozen_kv it keeps the fused path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.models.dit import DIT as JaxDIT
from unidisc_tpu.ops import quant as jax_quant
from unidisc_tpu.sampling.ar_sampler import init_kv_cache as jax_init_kv
from unidisc_tpu_torch.models import dit as dit_module
from unidisc_tpu_torch.models.dit import DIT
from unidisc_tpu_torch.models.port import dit_state_dict_from_jax
from unidisc_tpu_torch.ops import quant
from unidisc_tpu_torch.sampling.ar_sampler import (init_kv_cache,
                                                   init_kv_cache_for)
from test_torch_dit import (ATOL, B, RTOL, TXT, configs, param_tree,
                            port_model, random_dit, random_params)
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

CAUSAL = {"model.full_attention": False, "model.attn_backend": "xla"}
PREFILL = 10


def model_pair(seed, **extra):
    jcfg, tcfg = configs(**extra)
    jmodel, params = random_dit(jcfg.model, seed=seed,
                                compute_dtype=jnp.float32)
    return jmodel, params, port_model(tcfg, params), tcfg.model


def tokens(m, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, m.vocab_size - 1, (B, m.length)).astype(np.int32)
    modality = np.concatenate([np.zeros((B, TXT)),
                               np.ones((B, m.length - TXT))],
                              1).astype(np.int32)
    sigma = np.asarray([0.3, 1.7], np.float32)
    return ids, modality, sigma


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("index", ["scalar", "per_row"])
def test_prefill_and_decode_match_jax(index):
    jmodel, params, model, m = model_pair(2, **CAUSAL)
    ids, modality, sigma = tokens(m, seed=3)
    shape = (m.n_blocks, B, m.length, m.n_heads, m.head_dim)
    jkv = jax_init_kv(m.n_blocks, B, m.length, m.n_heads, m.head_dim,
                      dtype=jnp.float32)
    tkv = init_kv_cache(m.n_blocks, B, m.length, m.n_heads, m.head_dim,
                        dtype=torch.float32)
    assert tuple(tkv[0].shape) == shape
    apply = jax.jit(lambda p, x, s, mod, kv, ci: jmodel.apply(
        {"params": p}, x, s, modality=mod, kv_cache=kv, cache_index=ci))

    def step(lo, hi, ci_jax, ci_torch):
        nonlocal jkv
        x, mod = ids[:, lo:hi], modality[:, lo:hi]
        want, jkv = apply(params, jnp.asarray(x), jnp.asarray(sigma),
                          jnp.asarray(mod), jkv, ci_jax)
        with torch.no_grad():
            got, new = model(torch.from_numpy(x).long(),
                             torch.from_numpy(sigma),
                             modality=torch.from_numpy(mod).long(),
                             kv_cache=tkv, cache_index=ci_torch)
        assert new[0] is tkv[0] and new[1] is tkv[1]     # written in place
        close(got.numpy(), want)
        for a, b in zip(new, jkv):
            close(a.numpy(), b)

    step(0, PREFILL, 0, 0)
    for j in range(3):
        pos = PREFILL + j
        if index == "scalar":
            step(pos, pos + 1, pos, pos)
        else:
            # row 1 runs one position behind row 0 and rewrites its slot
            ci = np.asarray([pos, pos - 1], np.int32)
            step(pos, pos + 1, jnp.asarray(ci), torch.from_numpy(ci).long())


def test_frozen_kv_and_return_forms_match_jax():
    jmodel, params, model, m = model_pair(4)
    ids, modality, sigma = tokens(m, seed=5)
    rng = np.random.RandomState(6)
    fshape = (m.n_blocks, B, TXT, m.n_heads, m.head_dim)
    fk, fv = (rng.standard_normal(fshape).astype(np.float32)
              for _ in range(2))
    x, mod = ids[:, TXT:], modality[:, TXT:]
    want_logits, want_hidden = jmodel.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(sigma),
        modality=jnp.asarray(mod), frozen_kv=(jnp.asarray(fk),
                                              jnp.asarray(fv)),
        cache_index=TXT, return_hidden=True)
    args = (torch.from_numpy(x).long(), torch.from_numpy(sigma))
    kw = dict(modality=torch.from_numpy(mod).long(), cache_index=TXT,
              frozen_kv=(torch.from_numpy(fk), torch.from_numpy(fv)))
    with torch.no_grad():
        logits, hidden = model(*args, return_hidden=True, **kw)
        assert torch.equal(model.hidden(*args, **kw), hidden)
    close(logits.numpy(), want_logits)
    close(hidden.numpy(), want_hidden)

    # the cached forward's return forms, over the whole sequence
    jkv = jax_init_kv(m.n_blocks, B, m.length, m.n_heads, m.head_dim,
                      dtype=jnp.float32)
    want_l, want_h, want_kv = jmodel.apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(sigma),
        modality=jnp.asarray(modality), kv_cache=jkv, cache_index=0,
        return_hidden=True)
    tkv = init_kv_cache(m.n_blocks, B, m.length, m.n_heads, m.head_dim,
                        dtype=torch.float32)
    args = (torch.from_numpy(ids).long(), torch.from_numpy(sigma))
    kw = dict(modality=torch.from_numpy(modality).long(), kv_cache=tkv,
              cache_index=0)
    with torch.no_grad():
        got_l, got_h, got_kv = model(*args, return_hidden=True, **kw)
        only_h, only_kv = model.hidden(*args, **kw)
    close(got_l.numpy(), want_l)
    close(got_h.numpy(), want_h)
    assert torch.equal(only_h, got_h)
    for a, b in zip(got_kv, want_kv):
        close(a.numpy(), b)


def test_cache_allocation_matches_jax():
    from unidisc_tpu.sampling.ar_sampler import \
        init_kv_cache_for as jax_init_for
    for dtype in ("bf16", "int8"):
        jcfg, tcfg = configs(**{"model.kv_cache_dtype": dtype})
        want = jax_init_for(jcfg.model, 3, 20)
        got = init_kv_cache_for(tcfg.model, 3, 20)
        assert len(got) == len(want) == (4 if dtype == "int8" else 2)
        for a, b in zip(got, want):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))


def test_quantize_kv_matches_jax_bit_for_bit():
    rng = np.random.RandomState(7)
    x = (rng.standard_normal((3, 9, 4, 64))
         * rng.uniform(1e-3, 8.0, (3, 9, 4, 1))).astype(np.float32)
    x[0, 2] = 0.0                                   # zero rows: scale 1
    x[1, :, :, ::5] *= 40.0
    want_q, want_s = (np.asarray(a) for a in
                      jax_quant.quantize_kv(jnp.asarray(x)))
    got_q, got_s = quant.quantize_kv(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    # and from bf16 input, as the cache writes see it on the card
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want_q, want_s = (np.asarray(a) for a in jax_quant.quantize_kv(xb))
    got_q, got_s = quant.quantize_kv(
        torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16())
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


def int8_operands(b, l, lk, h, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((b, l, h, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, lk, h, d)).astype(np.float32)
    kq, ks = jax_quant.quantize_kv(jnp.asarray(k))
    vq, vs = jax_quant.quantize_kv(jnp.asarray(v))
    return q, *(np.asarray(a) for a in (kq, ks, vq, vs))


INT8_ATTN_TOL = 2e-2    # of max |out|: one int8 step of p in a row


@pytest.mark.parametrize("case", ["decode_causal", "full", "long_cache"])
def test_int8_kv_attention_matches_jax(case):
    b, l, lk, h, d = {"decode_causal": (2, 3, 40, 2, 64),
                      "full": (2, 16, 24, 2, 64),
                      "long_cache": (1, 3, 1100, 2, 16)}[case]
    q, kq, ks, vq, vs = int8_operands(b, l, lk, h, d, seed=lk)
    mask = None
    if case == "decode_causal":
        mask = (np.arange(lk)[None, :] <= 30 + np.arange(l)[:, None])
        mask = mask[None, None]
    want = np.asarray(jax_quant.int8_kv_attention(
        jnp.asarray(q), *(jnp.asarray(a) for a in (kq, ks, vq, vs)),
        mask=None if mask is None else jnp.asarray(mask)))
    got = quant.int8_kv_attention(
        torch.from_numpy(q), *(torch.from_numpy(a) for a in (kq, ks, vq, vs)),
        mask=None if mask is None else torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32 and got.shape == (b, l, h, d)
    diff, scale = np.abs(got - want), np.abs(want).max()
    assert diff.max() <= INT8_ATTN_TOL * scale
    # where no step moved, the two differ by the fp32 ulps of the softmax
    assert (diff <= 1e-5 * scale).mean() >= 0.99
    if case == "long_cache":
        # the chunked value product equals the int64 one exactly
        qt = torch.from_numpy(q)
        q_q, q_s = quant.quantize_kv(qt)
        acc = torch.einsum("blhd,bkhd->bhlk", q_q.double(),
                           torch.from_numpy(kq).double()).float()
        scores = (acc * q_s.permute(0, 2, 1, 3)
                  * torch.from_numpy(ks).permute(0, 2, 3, 1) * d ** -0.5)
        p = torch.softmax(scores, -1) * torch.from_numpy(vs).permute(
            0, 2, 3, 1)
        p_q, p_s = quant.quantize_kv(p)
        exact = torch.einsum("bhlk,bkhd->bhld", p_q.long(),
                             torch.from_numpy(vq).long())
        ref = (exact.float() * p_s).permute(0, 2, 1, 3)
        assert torch.equal(torch.from_numpy(got), ref)


def test_fused_int8_model_leaves_the_fused_path_with_a_kv_cache(
        monkeypatch):
    extra = {"model.quant": "int8", "model.quant_backend": "pallas",
             "model.quant_fused": True}
    jcfg, tcfg = configs(**extra)
    qparams = jax_quant.quantize_dit_params(random_params(
        param_tree(configs()[0].model, jnp.float32), seed=8))
    jmodel = JaxDIT(jcfg.model, compute_dtype=jnp.float32)
    m = tcfg.model
    ids, modality, sigma = tokens(m, seed=9)
    jkv = jax_init_kv(m.n_blocks, B, m.length, m.n_heads, m.head_dim,
                      dtype=jnp.float32)
    want, _ = jmodel.apply({"params": qparams}, jnp.asarray(ids),
                           jnp.asarray(sigma),
                           modality=jnp.asarray(modality), kv_cache=jkv,
                           cache_index=0)
    want = np.asarray(want)
    sd = dit_state_dict_from_jax(qparams)
    fused = DIT(m, compute_dtype=torch.float32).eval()
    fused.load_state_dict(sd)
    unfused = DIT(dataclasses.replace(m, quant_fused=False),
                  compute_dtype=torch.float32).eval()
    unfused.load_state_dict(sd)
    calls = []
    real = dit_module.fused_qmm
    monkeypatch.setattr(dit_module, "fused_qmm",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    args = (torch.from_numpy(ids).long(), torch.from_numpy(sigma))
    mod = torch.from_numpy(modality).long()

    def cache():
        return init_kv_cache(m.n_blocks, B, m.length, m.n_heads, m.head_dim,
                             dtype=torch.float32)

    with torch.no_grad():
        got, _ = fused(*args, modality=mod, kv_cache=cache(), cache_index=0)
        plain, _ = unfused(*args, modality=mod, kv_cache=cache(),
                           cache_index=0)
    assert calls == []
    assert torch.equal(got, plain)
    got = got.numpy()
    diff, scale = np.abs(got - want), np.abs(want).max()
    assert diff.max() <= 2.5e-2 * scale
    assert diff.mean() <= 3e-3 * np.abs(want).mean()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99
    # the frozen-prefix forward writes no cache and keeps the fused path
    fk = torch.zeros((m.n_blocks, B, TXT, m.n_heads, m.head_dim))
    with torch.no_grad():
        fused(args[0][:, TXT:], args[1], modality=mod[:, TXT:],
              frozen_kv=(fk, fk), cache_index=TXT)
    assert [kw["mode"] for kw in calls] == ["adaln_norm"] * (2 * m.n_blocks)


def test_cache_arguments_are_checked():
    _, tcfg = configs()
    model = DIT(tcfg.model, compute_dtype=torch.float32).eval()
    m = tcfg.model
    ids = torch.zeros((B, m.length), dtype=torch.long)
    sigma = torch.ones((B,))
    mod = torch.zeros_like(ids)
    kv = init_kv_cache_for(m, B)
    with pytest.raises(ValueError, match="cache_index"):
        model(ids, sigma, modality=mod, kv_cache=kv)
    with pytest.raises(ValueError, match="not both"):
        model(ids, sigma, modality=mod, kv_cache=kv, cache_index=0,
              frozen_kv=kv)
