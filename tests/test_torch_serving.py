"""The port's serving front door (serving/server.py, batcher.py, client.py,
utils/resize.py) and scaffold decoding (sampling/scaffold.py) against the
JAX package's.

Two servers run side by side over the same tiny model (the flagship-shaped
DIT of tests/test_torch_dit.py, L 24 = 8 text + 16 image tokens, a 4 x 4
grid) and the same tiny VQGAN (tests/test_torch_engine.py, 8 px): the JAX
one and the port's. For text->image, caption (a data-URL image), infill
with an is_mask attachment, a cached repeat, a streamed request, /health,
/metrics and the web UI, the port's response has the JAX server's schema,
``usage.nfe`` and content types (the tokens differ: the two draw from
different generators). The interleaved route answers 500 naming its
ROADMAP item. The AR route answers: a JAX server and the port's over the
same tiny OpenELM (fp32, greedy) give the same completion, plain and
streamed (the streamed deltas concatenate to the final text); a DIT-AR
engine answers plain and streamed requests with the engine's own
completion; /metrics shows the continuous batcher's gauges. Every request
and future has a timeout, and the servers and batchers are shut down in a
finally.

Scaffold: the port's per-step trunk choice equals JAX's sigma dispatch for
steps {4, 8, 32} and every split, and its sampler gives JAX's
build_scaffold_sampler tokens under injected noise.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from unidisc_tpu.diffusion.noise import get_noise as jax_get_noise
from unidisc_tpu.sampling import scaffold as jax_scaffold
from unidisc_tpu.serving import server as jax_server
from unidisc_tpu.serving.engine import InferenceEngine as JaxEngine
from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.models.dit import DIT, randomize_
from unidisc_tpu_torch.sampling.scaffold import (big_steps,
                                                 build_scaffold_sampler,
                                                 sigma_boundary)
from unidisc_tpu_torch.serving import client, server
from unidisc_tpu_torch.serving.batcher import (PAD_SIZES, RequestBatcher,
                                               batch_seed)
from unidisc_tpu_torch.serving.engine import (InferenceEngine, build_engine,
                                              downscale_bool_mask)
from unidisc_tpu_torch.utils.resize import resize_mask, resize_uint8
from test_torch_dit import OVERRIDES, configs, port_model, random_dit
from test_torch_engine import tiny_codecs
from unidisc_tpu_torch.device import cap_test_threads

cap_test_threads()

TIMEOUT = 60
# the tiny codec's 64 codes are the model's image vocabulary
OVER = {"sampling.predictor": "maskgit", "sampling.steps": 4,
        "sampling.cfg": 2.0, "model.text_vocab_size": 300,
        "model.image_vocab_size": 64,
        "model.force_argmax_valid_indices": True}


def png_data_url(img: np.ndarray) -> str:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()
                                                       ).decode()


def start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


def stop(srv):
    srv.shutdown()
    srv.server_close()
    srv.batcher.shutdown()


def post(url, req, raw=False):
    r = urllib.request.urlopen(urllib.request.Request(
        f"{url}/v1/chat/completions", data=json.dumps(req).encode(),
        headers={"Content-Type": "application/json"}), timeout=TIMEOUT)
    return (r.headers.get("Content-Type"), r.read().decode()) if raw \
        else json.load(r)


def get(url, path):
    r = urllib.request.urlopen(f"{url}{path}", timeout=TIMEOUT)
    return r.status, r.headers.get("Content-Type"), r.read()


def schema(x):
    """The keys and value types of a JSON document, recursively."""
    if isinstance(x, dict):
        return {k: schema(v) for k, v in sorted(x.items())}
    if isinstance(x, list):
        return [schema(v) for v in x]
    return type(x).__name__


def content_types(resp):
    return [item["type"] for item in resp["choices"][0]["message"]["content"]]


@pytest.fixture(scope="module")
def servers():
    """The JAX server and the port's over the same weights and codec."""
    jcfg, tcfg = configs(**OVER)
    jmodel, params = random_dit(jcfg.model, compute_dtype=jnp.float32)
    jcodec, codec = tiny_codecs()
    jeng = JaxEngine(jcfg, jmodel, params, codec=jcodec)
    eng = InferenceEngine(tcfg, port_model(tcfg, params), codec=codec,
                          device="cpu")
    jsrv = jax_server.make_server(jeng, port=0)
    psrv = server.make_server(eng, port=0)
    try:
        yield {"jax": start(jsrv), "port": start(psrv), "engine": eng,
               "server": psrv}
    finally:
        stop(jsrv)
        stop(psrv)


def both(servers, req):
    return post(servers["jax"], req), post(servers["port"], req)


def test_parse_messages_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (6, 5, 3)).astype(np.uint8)
    mask = np.zeros((6, 5, 3), np.uint8)
    mask[:3] = 255
    cases = [
        [{"role": "user", "content": "a cat"}],
        [{"role": "system", "content": "be brief"},
         {"role": "assistant", "content": "ignored"},
         {"role": "user", "content": [{"type": "text", "text": "two"},
                                      {"type": "text", "text": ""}]}],
        [{"role": "user", "content": [
            {"type": "text", "text": "fill it"},
            {"type": "image_url", "image_url": {"url": png_data_url(img)}},
            {"type": "image_url", "image_url": {"url": png_data_url(mask)},
             "is_mask": True},
            {"type": "image_url", "image_url": {"url": "http://x/y.png"}}]}],
        [],
    ]
    for messages in cases:
        want = jax_server.parse_messages(messages)
        got = server.parse_messages(messages)
        assert got["text"] == want["text"]
        for key in ("image", "mask"):
            if want[key] is None:
                assert got[key] is None
            else:
                np.testing.assert_array_equal(got[key], want[key])


def test_t2i_request_matches_the_jax_servers_response(servers):
    req = {"messages": [{"role": "user", "content": "a red cube"}],
           "seed": 7, "steps": 4}
    want, got = both(servers, req)
    assert schema(got) == schema(want)
    assert got["object"] == want["object"] == "chat.completion"
    assert got["usage"]["nfe"] == want["usage"]["nfe"]
    assert content_types(got) == content_types(want) == ["text",
                                                         "image_url"]
    url = got["choices"][0]["message"]["content"][1]["image_url"]["url"]
    png = Image.open(io.BytesIO(base64.b64decode(url.split(",", 1)[1])))
    assert png.size == (8, 8)
    # the prompt, cut to the 8-token text span, is kept as given
    text = [r["choices"][0]["message"]["content"][0]["text"]
            for r in (got, want)]
    assert text[0] == text[1] == "a red c"


def test_caption_and_masked_infill_match_the_jax_server(servers):
    """A caption (image only) and an infill whose mask attachment marks
    the region to regenerate; the image is 12 px, resized to the codec's 8
    px by each server's resize."""
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (12, 12, 3)).astype(np.uint8)
    mask = np.zeros((12, 12, 3), np.uint8)
    mask[:6, :6] = 255
    caption = {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": png_data_url(img)}}]}],
        "seed": 3}
    infill = {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "a <mask:2> cat"},
        {"type": "image_url", "image_url": {"url": png_data_url(img)}},
        {"type": "image_url", "image_url": {"url": png_data_url(mask)},
         "is_mask": True}]}], "seed": 4, "no_batch": True}
    for req, types in ((caption, ["text"]), (infill, ["text", "image_url"])):
        want, got = both(servers, req)
        assert schema(got) == schema(want)
        assert got["usage"]["nfe"] == want["usage"]["nfe"]
        assert content_types(got) == content_types(want) == types


def test_cache_and_streaming_match_the_jax_server(servers):
    req = {"messages": [{"role": "user", "content": "a boat"}], "seed": 9}
    first = post(servers["port"], req)
    again = post(servers["port"], req)
    assert again == first                                  # from the cache
    stream = {**req, "stream": True}
    events = {}
    # the first run streams the fresh payload, the second the cached one
    for name in ("jax", "port", "jax", "port"):
        ctype, body = post(servers[name], stream, raw=True)
        assert ctype == "text/event-stream"
        lines = [ln[len("data: "):] for ln in body.split("\n\n") if ln]
        assert lines[-1] == "[DONE]"
        chunks = [json.loads(ln) for ln in lines[:-1]]
        events[name] = [(c["object"], sorted(c["choices"][0]["delta"]),
                         c["choices"][0]["finish_reason"]) for c in chunks]
        deltas = [c["choices"][0]["delta"] for c in chunks]
        assert deltas[0] == {"role": "assistant"}
    assert events["port"] == events["jax"]
    assert [e[1] for e in events["port"]] == [["role"], ["content"],
                                              ["content"], []]


def test_health_metrics_and_web_ui(servers):
    for path, ctype in (("/health", "application/json"),
                        ("/metrics", "text/plain; version=0.0.4; "
                                     "charset=utf-8"),
                        ("/", "text/html; charset=utf-8")):
        for name in ("jax", "port"):
            status, got_type, body = get(servers[name], path)
            assert (status, got_type) == (200, ctype), (name, path)
    _, _, body = get(servers["port"], "/health")
    assert json.loads(body) == {"status": "ok"}
    _, _, page = get(servers["port"], "/")
    assert b"/v1/chat/completions" in page
    req = {"messages": [{"role": "user", "content": "metrics"}], "seed": 2}
    post(servers["port"], req)
    post(servers["port"], req)
    _, _, text = get(servers["port"], "/metrics")
    lines = text.decode().splitlines()
    assert "# TYPE unidisc_requests_total counter" in lines
    assert any(ln.startswith('unidisc_requests_total{route="diffusion"} ')
               for ln in lines)
    assert any(ln.startswith("unidisc_cache_hits_total ") for ln in lines)
    assert any(ln.startswith('unidisc_request_seconds{route="cached",'
                             'quantile="0.95"} ') for ln in lines)
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(urllib.request.Request(
            f"{servers['port']}/v1/nope", data=b"{}"), timeout=TIMEOUT)
    assert err.value.code == 404


AR = {"trainer.parameterization": "ar", "trainer.ar_shift": True,
      "model.full_attention": False}


def test_interleaved_and_ar_requests_answer_500_naming_their_items(servers):
    """The interleaved and AR routes, later slices when this test was
    written, now answer (the interleaved route's parity is in tests/
    test_torch_interleaved.py); an interleaved document longer than the
    model answers 500 with the engine's error, as JAX's server does."""
    with pytest.raises(urllib.error.HTTPError) as err:
        post(servers["port"], {"segments": [{"kind": "text",
                                             "generate": 10_000}]})
    assert err.value.code == 500
    assert "exceeds model.length" in json.load(err.value)["error"]
    _, tcfg = configs(**OVER, **AR)
    eng = InferenceEngine(tcfg, DIT(tcfg.model), device="cpu")
    srv = server.make_server(eng, port=0)
    url = start(srv)
    try:
        resp = post(url, {"messages": [{"role": "user", "content": "hi"}],
                          "max_tokens": 3})
        assert resp["object"] == "chat.completion"
        assert isinstance(resp["choices"][0]["message"]["content"], str)
    finally:
        stop(srv)
        eng.continuous.shutdown()


def sse_events(body: str) -> list:
    """The JSON events of an SSE body, [DONE] last."""
    events = [line[len("data: "):] for line in body.splitlines()
              if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    return [json.loads(e) for e in events[:-1]]


def streamed_text(events) -> str:
    text = ""
    for e in events[1:-1]:
        delta = e["choices"][0]["delta"]
        text = delta["content"] if delta.get("replace") \
            else text + delta["content"]
    return text


@pytest.fixture(scope="module")
def elm_servers():
    """A JAX ELM server and the port's over the same tiny OpenELM, fp32."""
    from unidisc_tpu.models.elm import OpenELM as JaxELM
    from unidisc_tpu.serving.engine import ElmEngine as JaxElmEngine
    from unidisc_tpu_torch.models.elm import ELM_PRESETS
    from unidisc_tpu_torch.serving.engine import ElmEngine
    from test_torch_elm import elm_pair
    cfg = ELM_PRESETS["tiny"]
    _, params, model = elm_pair(cfg, seed=2)
    jeng = JaxElmEngine(cfg, JaxELM(cfg, compute_dtype=jnp.float32), params,
                        slots=4, chunk=4)
    eng = ElmEngine(cfg, model, slots=4, chunk=4, device="cpu")
    jsrv = jax_server.make_server(jeng, port=0)
    psrv = server.make_server(eng, port=0)
    try:
        yield {"jax": start(jsrv), "port": start(psrv), "engine": eng}
    finally:
        stop(jsrv)
        stop(psrv)
        for e in (jeng, eng):
            if e._continuous is not None:
                e._continuous.shutdown()


# the tiny ELM's 64 ids hold the byte tokenizer's bytes below 60
ELM_REQ = {"messages": [{"role": "user", "content": "1+2 3, 4*5"}],
           "max_tokens": 12, "temperature": 0.0}


def test_elm_completion_matches_the_jax_server(elm_servers):
    want = post(elm_servers["jax"], ELM_REQ)
    got = post(elm_servers["port"], ELM_REQ)
    assert schema(got) == schema(want)
    assert got["choices"] == want["choices"]
    assert got["usage"] == want["usage"]
    # a repeat comes from the response cache
    assert post(elm_servers["port"], ELM_REQ) == got


def test_elm_stream_matches_the_jax_server(elm_servers):
    req = {**ELM_REQ, "stream": True, "max_tokens": 10,
           "messages": [{"role": "user", "content": "(7-3)/2"}]}
    jtype, jbody = post(elm_servers["jax"], req, raw=True)
    ptype, pbody = post(elm_servers["port"], req, raw=True)
    assert ptype == jtype == "text/event-stream"
    jev, pev = sse_events(jbody), sse_events(pbody)
    assert pev[0]["choices"][0]["delta"] == {"role": "assistant"}
    assert pev[-1]["choices"][0]["finish_reason"] == "stop"
    assert streamed_text(pev) == streamed_text(jev)
    final = post(elm_servers["port"], {**req, "stream": False})
    assert streamed_text(pev) == final["choices"][0]["message"]["content"]


def test_dit_ar_server_answers_plain_and_streamed_with_gauges():
    eng = build_engine(preset="tiny", device="cpu",
                       overrides={**OVERRIDES, **OVER, **AR})
    randomize_(eng.model, 0)
    srv = server.make_server(eng, port=0)
    url = start(srv)
    try:
        want = eng.complete_text("hello", max_new_tokens=8).result(TIMEOUT)
        req = {"messages": [{"role": "user", "content": "hello"}],
               "max_tokens": 8}
        resp = post(url, req)
        assert resp["choices"][0]["message"]["content"] == want["text"]
        assert resp["usage"] == {"completion_tokens": len(want["tokens"])}
        ctype, body = post(url, {**req, "stream": True}, raw=True)
        assert ctype == "text/event-stream"
        assert streamed_text(sse_events(body)) == want["text"]
        _, _, text = get(url, "/metrics")
        lines = text.decode().splitlines()
        assert "unidisc_slots 8" in lines
        assert "unidisc_queue_depth 0" in lines
        assert any(ln.startswith("unidisc_active_slots ") for ln in lines)
        assert any(ln.startswith('unidisc_requests_total{route="ar"} ')
                   for ln in lines)
    finally:
        stop(srv)
        eng.continuous.shutdown()


def test_client_talks_to_the_ports_server(servers, tmp_path, capsys,
                                         monkeypatch):
    resp = client.chat(servers["port"], "a lighthouse", steps=4, seed=5)
    assert resp["object"] == "chat.completion"
    client.render(resp, save_prefix=str(tmp_path / "sample"))
    out = capsys.readouterr().out
    assert "a light\n" in out and "[nfe: 4]" in out     # 8 text tokens
    assert Image.open(tmp_path / "sample_0.png").size == (8, 8)
    (tmp_path / "cli").mkdir()
    monkeypatch.chdir(tmp_path / "cli")        # the CLI saves in the cwd
    client.main(["--url", servers["port"], "--prompt", "a lighthouse",
                 "--steps", "4", "--seed", "5"])
    assert "[image saved: sample_0.png]" in capsys.readouterr().out
    assert (tmp_path / "cli" / "sample_0.png").exists()


def test_server_over_a_rolling_engine():
    """Concurrent requests through the RequestBatcher into the rolling
    batchers: each answers with nfe = steps + 1."""
    eng = build_engine(preset="tiny", device="cpu", rolling=4,
                       overrides={**OVERRIDES, **OVER})
    srv = server.make_server(eng, port=0, max_wait_ms=200)
    url = start(srv)
    try:
        out = [None] * 3

        def ask(i):
            out[i] = post(url, {"messages": [{"role": "user",
                                              "content": f"p{i}"}],
                                "seed": i, "steps": 3 if i else 4})

        threads = [threading.Thread(target=ask, args=(i,), daemon=True)
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        assert [r["usage"]["nfe"] for r in out] == [5, 4, 4]
        assert set(eng._rolling) == {"t2i"}
    finally:
        stop(srv)
        for b in eng._rolling.values():
            b.shutdown()


# ---------------------------------------------------------------------------
# the request batcher
# ---------------------------------------------------------------------------

def tiny_engine():
    return build_engine(preset="tiny", device="cpu",
                        overrides={**OVERRIDES, **OVER})


def test_batcher_coalesces_concurrent_requests():
    eng = tiny_engine()
    batcher = RequestBatcher(eng, max_batch=8, max_wait_ms=300)
    try:
        futures = [batcher.submit(text=f"c{i}", seed=i) for i in range(6)]
        results = [f.result(timeout=TIMEOUT) for f in futures]
        assert [r["text"] for r in results] == [f"c{i}" for i in range(6)]
        assert all(r["task"] == "gen_image" for r in results)
        assert batcher.batches_run < 6 and batcher.requests_served == 6
        # every batch was padded to a pad size (6 requests at once: 8)
        assert set(eng._samplers[("t2i", 4)]._plans) <= set(PAD_SIZES)
    finally:
        batcher.shutdown()


def test_batcher_no_batch_runs_alone_and_reproduces():
    eng = tiny_engine()
    batcher = RequestBatcher(eng, max_batch=8, max_wait_ms=50)
    try:
        a = batcher.submit(text="solo", seed=3, no_batch=True)
        b = batcher.submit(text="solo", seed=3, no_batch=True)
        ra, rb = a.result(timeout=TIMEOUT), b.result(timeout=TIMEOUT)
        np.testing.assert_array_equal(ra["image_ids"], rb["image_ids"])
        assert batcher.batches_run == 2
        # a run alone is the engine's run at the request's own seed
        np.testing.assert_array_equal(
            ra["image_ids"], eng.run(text="solo", seed=3)["image_ids"])
    finally:
        batcher.shutdown()
    with pytest.raises(ValueError, match="max_batch"):
        RequestBatcher(eng, max_batch=3)


def test_batch_seed_matches_the_jax_derivation():
    seeds = [7, 3, 2 ** 31 - 5, 0]
    want = seeds[0]
    for i, g in enumerate(seeds[1:], 1):
        want = (want * 1_000_003 + g + i) % (2 ** 31)
    assert batch_seed(seeds) == want and batch_seed([11]) == 11


# ---------------------------------------------------------------------------
# the resize of attached images
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape, size", [((12, 12), 8), ((100, 80), 64),
                                         ((37, 53), 64), ((30, 30), 256),
                                         ((64, 64), 64)])
def test_resize_is_within_one_step_of_pil(shape, size):
    rng = np.random.RandomState(sum(shape))
    img = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize((size, size)))
    got = resize_uint8(img, size)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    if shape == (size, size):
        np.testing.assert_array_equal(got, img)


def test_mask_grid_equals_the_jax_servers():
    """The mask path of the JAX server (PIL resize, mean > 127, any-pool)
    and the port's give the same token grid for block masks."""
    from unidisc_tpu.serving.engine import \
        downscale_bool_mask as jax_downscale
    rng = np.random.RandomState(0)
    for _ in range(8):
        m = np.zeros((24, 24, 3), np.uint8)
        r0, c0 = rng.randint(0, 16, 2)
        m[r0:r0 + rng.randint(4, 9), c0:c0 + rng.randint(4, 9)] = 255
        mask = m.astype(np.float32) / 127.5 - 1
        pil = Image.fromarray(((mask + 1) * 127.5).clip(0, 255)
                              .astype("uint8")).resize((16, 16))
        want = jax_downscale(np.asarray(pil).mean(-1) > 127, 2)
        got = downscale_bool_mask(resize_mask(mask, 16), 2)
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# scaffold decoding
# ---------------------------------------------------------------------------

def jax_dispatch(jcfg, split, steps):
    """Which trunk JAX's scaffold forward picks at each forward of a
    steps-step sampler: the sigma the sampler passes (its float32
    timesteps, sampling_eps for the noise removal), through the lax.cond."""
    noise = jax_get_noise(jcfg.noise)
    fwd = jax_scaffold.build_scaffold_forward(
        lambda p, x, s, m: jnp.ones(()), lambda p, x, s, m: jnp.zeros(()),
        jcfg, split=split, num_steps=steps)
    eps = jcfg.sampling.sampling_eps
    timesteps = jnp.linspace(1.0, eps, steps + 1)

    @jax.jit
    def pick(i):
        t = jnp.where(i == steps, jnp.full((2,), eps),
                      jnp.full((2,), timesteps[i]))
        return fwd((None, None), None, noise.total(t), None)

    return [bool(pick(i)) for i in range(steps + 1)]


@pytest.mark.parametrize("steps", [4, 8, 32])
def test_scaffold_step_choice_equals_jax_sigma_dispatch(steps):
    jcfg, tcfg = configs(**OVER)
    for split in range(steps + 1):
        assert big_steps(tcfg, split, steps) == jax_dispatch(jcfg, split,
                                                             steps), split
        # torch's and XLA's float32 log1p may differ by one ulp
        assert sigma_boundary(tcfg, split, steps) == pytest.approx(
            jax_scaffold.sigma_boundary(jcfg, split, steps), rel=2 ** -23)


@pytest.mark.parametrize("split", [0, 2, 4])
def test_scaffold_sampler_matches_jax_token_for_token(split):
    steps = 4
    jcfg, tcfg = configs(**OVER)
    jsmall_cfg, small_cfg = configs(**OVER, **{"model.n_blocks": 1,
                                               "model.hidden_size": 64})
    jbig, pbig = random_dit(jcfg.model, 0, compute_dtype=jnp.float32)
    jsmall, psmall = random_dit(jsmall_cfg.model, 1,
                                compute_dtype=jnp.float32)
    m = tcfg.model
    rng = np.random.RandomState(split)
    b = 2
    x0 = np.zeros((b, m.length), np.int32)
    x0[:, :m.txt_length] = rng.randint(1, m.mask_index, (b, m.txt_length))
    unmask = np.zeros((b, m.length), bool)
    unmask[:, :m.txt_length] = True
    unmask[1, :m.txt_length] = False           # a joint row
    modality = (np.arange(m.length)[None].repeat(b, 0)
                >= m.txt_length).astype(np.int32)
    shape = (steps, b, m.length)
    injected = {"exp": rng.exponential(size=shape + (m.vocab_size,))
                .astype(np.float32),
                "gumbel": rng.gumbel(size=shape).astype(np.float32)}
    jsample = jax.jit(jax_build_scaffold_injected(jbig, jsmall, jcfg, split,
                                                  steps))
    want = jsample((pbig, psmall), jax.random.PRNGKey(0), jnp.asarray(x0),
                   jnp.asarray(unmask), jnp.asarray(modality),
                   injected={k: jnp.asarray(v) for k, v in injected.items()})
    sample = build_scaffold_sampler(
        port_model(tcfg, pbig), port_model(small_cfg, psmall), tcfg,
        split=split, num_steps=steps, inject_noise=True, device="cpu")
    got = sample(torch.from_numpy(x0), torch.from_numpy(unmask),
                 torch.from_numpy(modality),
                 injected={k: torch.from_numpy(v)
                           for k, v in injected.items()})
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.nfe == int(want.nfe)


def jax_build_scaffold_injected(jbig, jsmall, jcfg, split, steps):
    """JAX's scaffold sampler with the injected-noise contract: the
    build_sampler of build_scaffold_sampler, over its scaffold forward."""
    from unidisc_tpu.sampling.sampler import build_sampler

    def fwd(model):
        return lambda p, x, s, m: model.apply({"params": p}, x, s,
                                              modality=m)

    forward = jax_scaffold.build_scaffold_forward(
        fwd(jbig), fwd(jsmall), jcfg, split=split, num_steps=steps)
    return build_sampler(forward, jcfg, num_steps=steps, inject_noise=True)


def test_engine_scaffold_bypasses_rolling_and_the_t2i_path():
    """build_engine(scaffold="tiny") and rolling together: requests run
    the whole-batch scaffold sampler (the generic one), as in JAX."""
    eng = build_engine(preset="tiny", device="cpu", rolling=4,
                       scaffold="tiny", scaffold_split=2,
                       overrides={**OVERRIDES, **OVER})
    small, split = eng._scaffold
    assert split == 2 and small.cfg.length == eng.m.length
    assert small.cfg.n_blocks == Config.make("tiny").model.n_blocks
    r = eng.run(text="a cat", seed=1)
    assert r["task"] == "gen_image" and r["nfe"] in (4, 5)
    assert not eng._rolling and list(eng._samplers) == [("generic", 4)]
    assert eng._samplers[("generic", 4)].big == [True, True, False, False,
                                                 False]
    with pytest.raises(ValueError, match="AR"):
        ar = InferenceEngine(configs(**OVER, **{
            "trainer.parameterization": "ar"})[1], eng.model, device="cpu")
        ar.enable_scaffold(small, 2)
