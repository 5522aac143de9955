"""The port's speculative and prompt-lookup decoding
(serving/speculative.py, and their rounds in serving/continuous.py)
against the JAX package's.

- accept_window equals JAX's on the same logits, draft log-probs and
  injected u / residual Gumbel / bonus tokens: greedy, stochastic and per
  row mixed (the windows and counts exactly).
- lookup_proposals equals JAX's: the documented cases and random buffers.
- Greedy speculative decoding over two small OpenELMs (the target and an
  unrelated draft, fp32, tests/test_torch_elm.py's weights) and greedy
  prompt lookup give plain greedy's tokens exactly: the port's own
  token-by-token decode and JAX's, for several gamma and n-gram lengths;
  a draft equal to the target accepts everything; EOS stops a row.
- Stochastic rounds draw the port's keyed noise: deterministic by seed,
  seed-sensitive.
- In the continuous batcher, speculative and lookup rounds give the plain
  batcher's greedy tokens (with slot reuse and a prompt past the stop
  cap), and the engines' routes (build_engine(preset="elm:tiny",
  speculative=...), the DIT-AR's speculative and lookup) do too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.serving import speculative as jax_spec
from unidisc_tpu_torch.models.elm import ELMConfig
from unidisc_tpu_torch.serving.continuous import elm_continuous_batcher
from unidisc_tpu_torch.serving.engine import build_engine
from unidisc_tpu_torch.serving.speculative import (accept_window,
                                                   elm_lookup_decoder,
                                                   lookup_proposals,
                                                   speculative_decode)
from test_torch_continuous import elm_greedy
from test_torch_elm import SMALL, elm_pair
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

TIMEOUT = 120


@pytest.fixture(scope="module")
def models():
    """(jitted flax target, its params, port target, port draft)."""
    jtarget, params, target = elm_pair(ELMConfig(**SMALL), seed=0)
    _, _, draft = elm_pair(ELMConfig(**{**SMALL, "num_layers": 1,
                                        "model_dim": 32}), seed=7)
    return jtarget, params, target, draft


def jax_greedy(jside, params, prompt, n):
    """JAX's token-by-token greedy decode (its tests' oracle), jitted."""
    kv = jax_spec_cache(jside, len(prompt) + n)
    logits, kv = jside.apply({"params": params}, jnp.asarray([prompt]),
                             kv_cache=kv,
                             cache_index=jnp.zeros((1,), jnp.int32))
    out, pos = [], len(prompt)
    tok = jnp.argmax(logits[:, -1], -1)
    for _ in range(n):
        out.append(int(tok[0]))
        logits, kv = jside.apply({"params": params},
                                 tok[:, None].astype(jnp.int32),
                                 kv_cache=kv,
                                 cache_index=jnp.full((1,), pos, jnp.int32))
        tok = jnp.argmax(logits[:, 0], -1)
        pos += 1
    return out


def jax_spec_cache(jside, length):
    from unidisc_tpu.models.elm import init_elm_cache
    return init_elm_cache(jside.module.cfg, 1, length)


def window_inputs(stoch, seed=0, b=3, gamma=4, v=11):
    rng = np.random.RandomState(seed)
    lg_t = rng.standard_normal((b, gamma + 1, v)).astype(np.float32) * 2
    lg_d = lg_t[:, :gamma] + rng.standard_normal((b, gamma, v)).astype(
        np.float32)
    lp_t = lg_t - np.log(np.exp(lg_t).sum(-1, keepdims=True))
    lp_d = lg_d - np.log(np.exp(lg_d).sum(-1, keepdims=True))
    # drafts: the target's argmax on some slots, others random
    drafted = lg_t[:, :gamma].argmax(-1)
    flip = rng.rand(b, gamma) < 0.4
    drafted = np.where(flip, rng.randint(0, v, (b, gamma)), drafted)
    kw = {}
    if stoch is not False:
        kw = dict(u=rng.uniform(1e-6, 1, (b, gamma)).astype(np.float32),
                  g_corr=rng.gumbel(size=(b, gamma, v)).astype(np.float32),
                  bonus=rng.randint(0, v, (b,)))
    return drafted, lp_d, lg_t, lp_t, kw


@pytest.mark.parametrize("stoch", ["greedy", "stochastic", "per_row"])
def test_accept_window_matches_jax(stoch):
    flag = {"greedy": False, "stochastic": True,
            "per_row": np.asarray([True, False, True])}[stoch]
    for seed in range(4):
        drafted, lp_d, lg_t, lp_t, kw = window_inputs(flag, seed)
        jw, jn = jax_spec.accept_window(
            jnp.asarray(drafted, jnp.int32), jnp.asarray(lp_d),
            jnp.asarray(lg_t), jnp.asarray(lp_t),
            stoch=flag if isinstance(flag, bool) else jnp.asarray(flag),
            **{k: jnp.asarray(v) for k, v in kw.items()})
        t = lambda a: torch.from_numpy(np.asarray(a))
        w, n = accept_window(
            t(drafted).long(), t(lp_d), t(lg_t), t(lp_t),
            stoch=flag if isinstance(flag, bool) else t(flag),
            **{k: (t(v).long() if k == "bonus" else t(v))
               for k, v in kw.items()})
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))


def test_lookup_proposals_semantics_match_jax():
    """The latest usable earlier n-gram match wins, its continuation
    comes from committed tokens only, rows without one repeat their last
    token (found False), as in JAX's own test."""
    x = np.asarray([[5, 6, 7, 9, 5, 6, 0, 0, 0, 0, 0, 0],
                    [1, 2, 3, 4, 7, 8, 0, 0, 0, 0, 0, 0],
                    [5, 6, 1, 5, 6, 2, 9, 5, 6, 0, 0, 0]])
    pos = np.asarray([5, 5, 8])
    drafted, found = lookup_proposals(torch.from_numpy(x),
                                      torch.from_numpy(pos), gamma=2,
                                      ngram=2)
    assert found.tolist() == [True, False, True]
    assert drafted.tolist() == [[7, 9], [8, 8], [2, 9]]
    d3, f3 = lookup_proposals(torch.tensor([[3, 0, 0, 0, 0, 0]]),
                              torch.tensor([0]), gamma=2, ngram=2)
    assert not bool(f3[0]) and d3.tolist() == [[3, 3]]


@pytest.mark.parametrize("gamma,ngram", [(2, 2), (4, 3), (3, 1)])
def test_lookup_proposals_match_jax_on_random_buffers(gamma, ngram):
    rng = np.random.RandomState(gamma * 10 + ngram)
    x = rng.randint(0, 4, (6, 24))       # a small alphabet: many matches
    pos = rng.randint(0, 24, 6)
    jd, jf = jax_spec.lookup_proposals(jnp.asarray(x, jnp.int32),
                                       jnp.asarray(pos, jnp.int32),
                                       gamma=gamma, ngram=ngram)
    d, f = lookup_proposals(torch.from_numpy(x), torch.from_numpy(pos),
                            gamma=gamma, ngram=ngram)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))


PROMPTS = [[1, 2, 3, 4], [5, 6], [9, 8, 7, 6, 5]]


@pytest.mark.parametrize("gamma", [1, 3, 4])
def test_greedy_spec_is_plain_greedy(models, gamma):
    jtarget, params, target, draft = models
    outs, res = speculative_decode(target, draft, PROMPTS,
                                   max_new_tokens=13, gamma=gamma)
    for p, got in zip(PROMPTS, outs):
        assert got == elm_greedy(target, p, 13), (gamma, p)
    assert got == jax_greedy(jtarget, params, PROMPTS[-1], 13)
    assert res.rounds >= 1 and (res.emitted == 13).all()
    assert 0 <= res.accepted <= res.drafted


def test_self_draft_accepts_everything(models):
    _, _, target, _ = models
    gamma, n = 4, 20
    outs, res = speculative_decode(target, target, PROMPTS[:2],
                                   max_new_tokens=n, gamma=gamma)
    assert res.rounds == -(-n // (gamma + 1))
    assert res.accepted == res.drafted
    assert outs == [elm_greedy(target, p, n) for p in PROMPTS[:2]]
    # at a temperature too the ratio p_t / p_d is 1 everywhere
    outs, res = speculative_decode(target, target, PROMPTS[:2],
                                   max_new_tokens=12, gamma=3,
                                   temperature=1.0, seed=11)
    assert res.accepted == res.drafted
    assert all(len(o) == 12 for o in outs)


def test_stochastic_is_deterministic_and_seed_sensitive(models):
    _, _, target, draft = models
    kw = dict(max_new_tokens=10, gamma=3, temperature=3.0)
    a1, _ = speculative_decode(target, draft, [[1, 2, 3]], seed=5, **kw)
    a2, _ = speculative_decode(target, draft, [[1, 2, 3]], seed=5, **kw)
    b, _ = speculative_decode(target, draft, [[1, 2, 3]], seed=6, **kw)
    assert a1 == a2 and a1 != b


def test_eos_stops_row(models):
    _, _, target, draft = models
    first = elm_greedy(target, PROMPTS[0], 1)[0]
    outs, _ = speculative_decode(target, draft, PROMPTS[:2],
                                 max_new_tokens=12, gamma=3, eos_id=first)
    assert outs[0] == [first]
    want = elm_greedy(target, PROMPTS[1], 12)
    cut = want.index(first) + 1 if first in want else 12
    assert outs[1] == want[:cut]


@pytest.mark.parametrize("gamma,ngram", [(2, 2), (4, 2), (8, 3)])
def test_lookup_decoder_is_plain_greedy(models, gamma, ngram):
    _, _, target, _ = models
    prompts = [[1, 2, 3, 1, 2, 3, 1, 2], [7, 7, 7, 7], [4, 9, 4, 9, 4]]
    decode = elm_lookup_decoder(target, gamma=gamma, ngram=ngram)
    plen = torch.tensor([len(p) for p in prompts])
    buf = torch.zeros((3, 8), dtype=torch.long)
    for i, p in enumerate(prompts):
        buf[i, :len(p)] = torch.tensor(p)
    res = decode(buf, plen, torch.arange(3), 14)
    for i, p in enumerate(prompts):
        got = res.tokens[i, len(p):len(p) + 14].tolist()
        assert got == elm_greedy(target, p, 14), (i, gamma, ngram)
    assert res.accepted <= res.drafted


def batcher(model, **kw):
    return elm_continuous_batcher(model, slots=2, chunk=8, length=64, **kw)


@pytest.mark.parametrize("mode", ["draft", "lookup"])
def test_continuous_rounds_are_plain_greedy(models, mode):
    """More requests than slots, so slots are reused mid-run."""
    _, _, target, draft = models
    prompts = [[1, 2, 3], [4, 5], [9, 8, 7, 6], [2, 2, 2, 2, 2, 2],
               [5, 1, 4]]
    kw = dict(draft=draft, gamma=3) if mode == "draft" \
        else dict(lookup_ngram=2, gamma=3)
    plain, spec = batcher(target), batcher(target, **kw)
    try:
        want = [plain.submit(p, max_new_tokens=11) for p in prompts]
        got = [spec.submit(p, max_new_tokens=11) for p in prompts]
        for w, g in zip(want, got):
            assert g.result(timeout=TIMEOUT)["tokens"] == \
                w.result(timeout=TIMEOUT)["tokens"]
        assert spec.decoder.speculative and spec.decoder.rounds == 2
    finally:
        plain.shutdown()
        spec.shutdown()


def test_continuous_speculative_stochastic_seeded(models):
    _, _, target, draft = models
    spec = elm_continuous_batcher(target, slots=3, chunk=8, length=64,
                                  draft=draft, gamma=2)
    try:
        a = spec.submit([1, 2, 3], max_new_tokens=10, temperature=3.0,
                        seed=42)
        b = spec.submit([6, 5], max_new_tokens=10, temperature=3.0,
                        seed=43)
        ra, rb = (f.result(timeout=TIMEOUT)["tokens"] for f in (a, b))
        again = spec.submit([1, 2, 3], max_new_tokens=10, temperature=3.0,
                            seed=42).result(timeout=TIMEOUT)["tokens"]
        assert again == ra and ra != rb
    finally:
        spec.shutdown()


def test_continuous_speculative_prompt_near_buffer_end(models):
    """A prompt past the stop cap L - (gamma + 1) retires after its first
    token without its window clobbering committed tokens; its neighbour
    and a prompt just under the cap decode as plain greedy."""
    _, _, target, draft = models
    spec = elm_continuous_batcher(target, slots=2, chunk=8, length=24,
                                  draft=draft, gamma=3)
    try:
        long_p, short_p, edge = list(range(1, 22)), [4, 5, 6], \
            list(range(1, 18))
        f_long = spec.submit(long_p, max_new_tokens=8)
        f_short = spec.submit(short_p, max_new_tokens=8)
        r_long = f_long.result(timeout=TIMEOUT)["tokens"]
        assert 1 <= len(r_long) <= 8
        assert r_long == elm_greedy(target, long_p, 8)[:len(r_long)]
        assert f_short.result(timeout=TIMEOUT)["tokens"] == \
            elm_greedy(target, short_p, 8)
        r_edge = spec.submit(edge, max_new_tokens=8).result(
            timeout=TIMEOUT)["tokens"]
        assert len(r_edge) >= 3
        assert r_edge == elm_greedy(target, edge, 8)[:len(r_edge)]
    finally:
        spec.shutdown()


def shut(*engines):
    for e in engines:
        if e._continuous is not None:
            e._continuous.shutdown()


@pytest.mark.parametrize("spec", ["tiny", "lookup"])
def test_elm_engine_speculative_routes(spec):
    eng = build_engine(preset="elm:tiny", speculative=spec, spec_gamma=3,
                       device="cpu")
    plain = build_engine(preset="elm:tiny", device="cpu")
    try:
        kw = dict(max_new_tokens=6, seed=5)
        got = eng.complete_text("\x01\x02\x03", **kw).result(TIMEOUT)
        assert got == plain.complete_text("\x01\x02\x03",
                                          **kw).result(TIMEOUT)
        assert isinstance(got["text"], str) and len(got["tokens"]) <= 6
        assert (eng._draft is not None) == (spec == "tiny")
    finally:
        shut(eng, plain)


@pytest.mark.parametrize("spec", ["tiny", "lookup:3"])
def test_dit_ar_engine_speculative_routes(spec):
    eng = build_engine(preset="tiny", speculative=spec, spec_gamma=2,
                       experiments=["ar_baseline"], device="cpu")
    plain = build_engine(preset="tiny", experiments=["ar_baseline"],
                         device="cpu")
    try:
        kw = dict(max_new_tokens=6, seed=3)
        got = eng.complete_text("\x01\x02\x03", **kw).result(TIMEOUT)
        assert got["tokens"] == plain.complete_text(
            "\x01\x02\x03", **kw).result(TIMEOUT)["tokens"]
        assert eng._lookup_ngram == (3 if spec == "lookup:3" else None)
    finally:
        shut(eng, plain)
    with pytest.raises(ValueError, match="scaffold"):
        build_engine(preset="tiny", speculative="tiny", device="cpu")
