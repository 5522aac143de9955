"""The port's continuous AR batching (serving/continuous.py) against the
JAX package's, and against the lockstep decode loop.

A tiny causal text-only DIT (the flagship-shaped config of
tests/test_torch_dit.py at L 32, 24 text ids, no image span), its weights
random_params moved by 0.5 N(0, 1) (tests/test_torch_ar_sampler.py), fp32
on both sides. Greedy rows must give, token for token, the lockstep
decode loop's tokens (sampling/ar_sampler.py, held to JAX's in its own
test) and JAX's continuous decoder's, whatever the admission order, the
slot, the prompt lengths beside them, or whether the prompt's K/V came
from a prefix-cache donor. Stochastic rows draw the port's keyed noise: a
seeded request reproduces alone and under load, with and without the
prefix cache (at temperatures of 4-5, where the draws change the tokens:
the perturbed model's top-2 logit margin averages ~4). The threaded
batcher: futures, streaming (the deltas are the tokens, each once), EOS,
the worker surviving an injected device error, shutdown. The OpenELM batcher (per-layer GQA caches, batch axis 0, bf16
and int8 caches) against its own token-by-token decode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidisc_tpu.serving.continuous import \
    build_continuous_decoder as jax_decoder
from unidisc_tpu_torch.models.elm import ELMConfig, init_elm_cache
from unidisc_tpu_torch.sampling.ar_sampler import (build_ar_sampler,
                                                   make_apply_token)
from unidisc_tpu_torch.serving.continuous import (ContinuousBatcher,
                                                  build_continuous_decoder,
                                                  elm_continuous_batcher)
from test_torch_ar_sampler import ar_models
from test_torch_elm import SMALL, elm_pair
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

L = 32
TEXT = {"model.length": L, "model.txt_length": L, "model.img_length": 0,
        "model.rope_2d": False, "model.text_vocab_size": 24,
        "model.image_vocab_size": 0, "model.time_conditioning": False,
        "sampling.cfg": None, "sampling.temperature": 0.0}
TIMEOUT = 120


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg, jmodel, params, model = ar_models(**TEXT)
    sampler = build_ar_sampler(make_apply_token(model), tcfg, chunk=8,
                               device="cpu")
    refs = {}

    def greedy(prompt, n):
        """The lockstep decode loop's greedy continuation."""
        key = (tuple(prompt), n)
        if key not in refs:
            x0 = np.zeros((1, L), np.int64)
            x0[0, :len(prompt)] = prompt
            unmask = np.zeros((1, L), bool)
            unmask[0, :len(prompt)] = True
            refs[key] = sampler(x0, unmask).tokens[
                0, len(prompt):len(prompt) + n].tolist()
        return refs[key]

    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, params=params,
                model=model, greedy=greedy)


def padded(prompt, bucket=16):
    out = np.zeros((1, bucket), np.int64)
    out[0, :len(prompt)] = prompt
    return out


def admit(dec, state, slot, prompt, n, temp=0.0, seed=0):
    dec.insert_many(state, [slot], padded(prompt),
                    np.zeros((1, L), np.int64), [len(prompt)], [n],
                    np.asarray([temp], np.float32), [seed])


def run_raw(model, tcfg, jobs, slots, chunk=4, stagger=False):
    """The decoder state machine driven synchronously: admit, chunk,
    retire, reuse the slot."""
    dec = build_continuous_decoder(model, tcfg, slots=slots, chunk=chunk,
                                   device="cpu")
    state = dec.init_state()
    pending = list(enumerate(jobs))
    owner, results = {}, {}
    for s in range(1 if stagger else min(slots, len(pending))):
        idx, (p, n) = pending.pop(0)
        admit(dec, state, s, p, n, seed=100 + idx)
        owner[s] = (idx, len(p))
    while owner:
        dec.step_chunk(state)
        for s in list(owner):
            if bool(state.active[s]):
                continue
            idx, plen = owner.pop(s)
            results[idx] = state.x[s, plen:int(state.pos[s]) + 1].tolist()
            if pending:
                nidx, (p, n) = pending.pop(0)
                admit(dec, state, s, p, n, seed=100 + nidx)
                owner[s] = (nidx, len(p))
    return results


JOBS = [([3, 7, 1, 9, 2], 8), ([5, 5, 11, 2, 8, 4, 6, 1, 13, 10, 2], 6),
        ([14], 12)]


def test_single_row_matches_lockstep_and_jax(setup):
    p, n = JOBS[0]
    got = run_raw(setup["model"], setup["tcfg"], [(p, n)], slots=1)[0]
    assert got == setup["greedy"](p, n)
    # JAX's continuous decoder on the same weights
    init, make_insert, decode, *_ = jax_decoder(
        setup["jmodel"], setup["jcfg"], slots=1, chunk=4)
    st = init()
    st = make_insert(16)(setup["params"], st, 0,
                         jnp.asarray(padded(p)[0], jnp.int32),
                         jnp.zeros(L, jnp.int32), len(p), n, 0.0, 0)
    while bool(np.asarray(st.active)[0]):
        st = decode(setup["params"], st)
    want = np.asarray(st.x)[0, len(p):int(np.asarray(st.pos)[0]) + 1]
    assert got == want.tolist()


def test_mixed_prompt_lengths_decode_together(setup):
    got = run_raw(setup["model"], setup["tcfg"], JOBS, slots=3)
    for i, (p, n) in enumerate(JOBS):
        assert got[i] == setup["greedy"](p, n), i


@pytest.mark.parametrize("slots,stagger", [(1, False), (2, True)])
def test_staggered_admission_and_slot_reuse(setup, slots, stagger):
    jobs = [([3, 7, 1], 6), ([9, 2, 4, 4, 8], 5), ([6, 1], 7)]
    got = run_raw(setup["model"], setup["tcfg"], jobs, slots=slots,
                  stagger=stagger)
    for i, (p, n) in enumerate(jobs):
        assert got[i] == setup["greedy"](p, n), i


def test_eos_terminates_row(setup):
    p = [3, 7, 1, 9, 2]
    ref = setup["greedy"](p, 10)
    j = next(k for k in range(1, len(ref)) if ref[k] not in ref[:k])
    dec = build_continuous_decoder(setup["model"], setup["tcfg"], slots=1,
                                   chunk=4, eos_id=ref[j], device="cpu")
    state = dec.init_state()
    admit(dec, state, 0, p, 10)
    for _ in range(4):
        dec.step_chunk(state)
    gen = state.x[0, len(p):int(state.pos[0]) + 1].tolist()
    assert not bool(state.active[0])
    assert gen == ref[:j + 1]


def test_batcher_threads_streaming_and_host_reads(setup):
    jobs = [([3, 7, 1, 9, 2], 8), ([5, 5, 11], 6), ([14], 9), ([6, 1], 5)]
    b = ContinuousBatcher(setup["model"], setup["tcfg"], slots=2, chunk=4)
    try:
        streamed = {i: [] for i in range(len(jobs))}
        futs = [b.submit(p, max_new_tokens=n,
                         stream_cb=(lambda i: lambda t:
                                    streamed[i].extend(t))(i))
                for i, (p, n) in enumerate(jobs)]
        for i, f in enumerate(futs):
            res = f.result(timeout=TIMEOUT)
            assert res["tokens"] == setup["greedy"](*jobs[i]), i
            assert res["prompt_len"] == len(jobs[i][0])
            assert streamed[i] == res["tokens"]
        # streaming requests drain once a chunk: one host read each
        assert 0 < b.host_reads <= b.chunks
    finally:
        b.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        b.submit([1, 2], max_new_tokens=2)


def test_batcher_eos_with_drain_skipping(setup):
    p = [3, 7, 1, 9, 2]
    ref = setup["greedy"](p, 12)
    cut = next(k for k in range(1, len(ref)) if ref[k] not in ref[:k])
    b = ContinuousBatcher(setup["model"], setup["tcfg"], slots=2, chunk=4,
                          eos_id=ref[cut])
    try:
        f1 = b.submit(p, max_new_tokens=12)
        f2 = b.submit([14, 2], max_new_tokens=5)
        assert f1.result(timeout=TIMEOUT)["tokens"] == ref[:cut]
        assert len(f2.result(timeout=TIMEOUT)["tokens"]) <= 5
    finally:
        b.shutdown()


def test_seeded_request_reproduces_under_concurrent_load(setup):
    def run(load, prefix_min=16):
        b = ContinuousBatcher(setup["model"], setup["tcfg"], slots=4,
                              chunk=4, prefix_min=prefix_min)
        try:
            futs = [b.submit([5, 11, 2], max_new_tokens=7, temperature=5.0,
                             seed=777 + i) for i in range(load)]
            res = b.submit([3, 7, 1, 9], max_new_tokens=9, temperature=4.0,
                           seed=1234).result(timeout=TIMEOUT)
            return res["tokens"], [f.result(timeout=TIMEOUT)["tokens"]
                                   for f in futs]
        finally:
            b.shutdown()

    solo, _ = run(0)
    loaded, others = run(2)
    assert solo == loaded
    assert run(2) == (loaded, others)
    assert others[0] != others[1]      # the seeds differ
    assert solo != setup["greedy"]([3, 7, 1, 9], 9)


def prefix_jobs():
    rng = np.random.RandomState(3)
    shared = rng.randint(1, 20, 18).tolist()
    return [shared + [4, 5], shared + [9], shared[:17] + [2, 2, 2],
            rng.randint(1, 20, 6).tolist()]


@pytest.mark.parametrize("temp", [0.0, 4.0])
def test_prefix_cache_is_lossless_with_hits(setup, temp):
    """The same requests, one after another, with and without the prefix
    cache: the same tokens (greedy: the lockstep loop's), and hits."""
    def run(prefix_min):
        b = ContinuousBatcher(setup["model"], setup["tcfg"], slots=4,
                              chunk=4, prefix_min=prefix_min)
        try:
            out = [b.submit(p, max_new_tokens=6, temperature=temp,
                            seed=50 + i).result(timeout=TIMEOUT)["tokens"]
                   for i, p in enumerate(prefix_jobs())]
            return out, b.prefix_hits
        finally:
            b.shutdown()

    cached, hits = run(16)
    plain, none = run(0)
    assert hits >= 2 and none == 0
    assert cached == plain
    if temp == 0.0:
        assert cached == [setup["greedy"](p, 6) for p in prefix_jobs()]


def test_prefix_cache_donor_invalidated_on_reuse(setup):
    """One slot: a donor's slot reused by an unrelated prompt is no
    longer a donor, and a later sharer prefills in full (and still gets
    the greedy tokens)."""
    a, b_, c = prefix_jobs()[0], prefix_jobs()[3], prefix_jobs()[1]
    b = ContinuousBatcher(setup["model"], setup["tcfg"], slots=1, chunk=4,
                          prefix_min=16)
    try:
        b.submit(a, max_new_tokens=4).result(timeout=TIMEOUT)
        b.submit(b_, max_new_tokens=4).result(timeout=TIMEOUT)
        assert b._find_prefix_donor(c) is None
        got = b.submit(c, max_new_tokens=5).result(timeout=TIMEOUT)
        assert b.prefix_hits == 0
        assert got["tokens"] == setup["greedy"](c, 5)
    finally:
        b.shutdown()


def test_worker_survives_device_error(setup):
    b = ContinuousBatcher(setup["model"], setup["tcfg"], slots=2, chunk=4,
                          prefix_min=2)
    try:
        orig, fail = b._decode, [True]

        def flaky(state):
            if fail[0]:
                fail[0] = False
                raise RuntimeError("injected device error")
            return orig(state)

        b._decode = flaky
        f1 = b.submit([3, 7, 1], max_new_tokens=6)
        with pytest.raises(RuntimeError, match="injected"):
            f1.result(timeout=TIMEOUT)
        # the reset drops the resident prompts: no donor survives it
        assert b._find_prefix_donor([3, 7, 1, 5]) is None
        res = b.submit([9, 2, 4], max_new_tokens=5).result(timeout=TIMEOUT)
        assert res["tokens"] == setup["greedy"]([9, 2, 4], 5)
    finally:
        b.shutdown()


def test_bad_prompts_fail_their_futures(setup):
    b = ContinuousBatcher(setup["model"], setup["tcfg"], slots=2, chunk=4)
    try:
        too_long = b.submit(list(range(1, 20)) * 2, max_new_tokens=2)
        with pytest.raises(ValueError, match="prompt length"):
            too_long.result(timeout=TIMEOUT)
        assert b.submit([4], max_new_tokens=1).result(
            timeout=TIMEOUT)["tokens"] == setup["greedy"]([4], 1)
    finally:
        b.shutdown()


def elm_greedy(model, prompt, n, quant=False):
    """Token-by-token greedy decode of an OpenELM (the oracle)."""
    cache = init_elm_cache(model.cfg, 1, len(prompt) + n, quant=quant)
    with torch.no_grad():
        logits, _ = model(torch.tensor([prompt]), kv_cache=cache,
                          cache_index=torch.zeros(1, dtype=torch.long))
        out, pos = [], len(prompt)
        tok = logits[:, -1].argmax(-1)
        for _ in range(n):
            out.append(int(tok))
            logits, _ = model(tok[:, None], kv_cache=cache,
                              cache_index=torch.full((1,), pos))
            tok = logits[:, 0].argmax(-1)
            pos += 1
    return out


@pytest.mark.parametrize("quant", [False, True])
def test_elm_batcher_matches_step_decode(quant):
    _, _, model = elm_pair(ELMConfig(**SMALL), seed=1)
    jobs = [([1, 2, 3, 4], 7), ([5, 6], 9), ([9, 8, 7, 6, 5], 5)]
    b = elm_continuous_batcher(model, slots=2, chunk=4, length=64,
                               quant_cache=quant)
    try:
        assert b.decoder.axis == 0
        futs = [b.submit(p, max_new_tokens=n) for p, n in jobs]
        for (p, n), f in zip(jobs, futs):
            assert f.result(timeout=TIMEOUT)["tokens"] == \
                elm_greedy(model, p, n, quant)
    finally:
        b.shutdown()
