"""OpenAI-compatible HTTP server over the port's inference engine (port of
``unidisc_tpu/serving/server.py``).

``POST /v1/chat/completions`` (with ``stream: true`` as server-sent
events, and a response cache by request hash), ``GET /health``, ``GET
/metrics`` (Prometheus text format) and ``GET /`` (the web UI). Concurrent
requests coalesce into one device batch through ``serving/batcher.py``;
with ``--rolling N`` the engine admits them into its rolling batchers.
One process, the standard library's ThreadingHTTPServer. Every device
call of a handler thread (the codec's encode of an attached image) runs
under the engine's device lock. An AR model (a DIT with
``trainer.parameterization=ar``, or ``--model elm[:size]``, the OpenELM
baseline) answers text requests through the engine's continuous batcher,
and with ``stream: true`` streams the text as it decodes. A request with
``segments`` is an interleaved document (``engine.run_interleaved``),
answered as an ``interleaved.completion``; any engine error answers 500
with its message.

On a device mesh (``--mesh``, under torchrun: one process per device)
rank 0 serves HTTP and leads, and the other ranks replay its device calls
(``engine.follow``): whole batches, and with ``--rolling N`` or an AR
model every op of the rolling and continuous batchers' workers. Their
slots are the global batch split over the data-parallel ranks (N, or the
continuous batcher's 8, rounded up to the mesh granule), and "seq" runs
them replicated, without the ring, as in JAX. AR decoding on "tensor",
"pp" or "ep", or of an MoE model on a data-parallel mesh, raises
NotImplementedError naming ROADMAP queue 1, item 9. On the way out the
batchers' workers stop before the followers do (``close_server``).

Run: python -m unidisc_tpu_torch.serving.server --port 8000 [--ckpt DIR]
         [--codec llamagen-vq16] [--rolling 8] [--quantize int8]
         [--scaffold tiny --scaffold-split 8] [--device cpu]
     python -m unidisc_tpu_torch.serving.server --model elm [--quantize int8
         --kv-cache int8] [--speculative 270m|lookup [--gamma 4]]
     torchrun --nproc-per-node 4 -m unidisc_tpu_torch.serving.server
         --mesh fsdp=2,seq=2 --rolling 8 [--device cpu --model tiny
         --experiments fid_eval]
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import math
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from unidisc_tpu_torch.serving.batcher import RequestBatcher
from unidisc_tpu_torch.serving.engine import (InferenceEngine,
                                              decode_image_b64,
                                              downscale_bool_mask)
from unidisc_tpu_torch.utils.resize import resize_image, resize_mask


def parse_messages(messages: list) -> dict:
    """OpenAI chat messages -> engine arguments: the user and system text
    joined by newlines, the last image, and the last image flagged
    is_mask (a spatial edit mask over the image)."""
    text_parts = []
    image = None
    mask = None
    for msg in messages:
        if msg.get("role") not in ("user", "system"):
            continue
        content = msg.get("content", "")
        if isinstance(content, str):
            text_parts.append(content)
        else:
            for item in content:
                if item.get("type") == "text":
                    text_parts.append(item["text"])
                elif item.get("type") == "image_url":
                    url = item["image_url"]["url"]
                    if url.startswith("data:"):
                        decoded = decode_image_b64(url.split(",", 1)[1])
                        if item.get("is_mask"):
                            mask = decoded
                        else:
                            image = decoded
    text = "\n".join(p for p in text_parts if p) or None
    return {"text": text, "image": image, "mask": mask}


class ServerMetrics:
    """Serving metrics in the Prometheus text exposition format at GET
    /metrics (standard library only). Counters are cumulative; latency
    quantiles are over the last WINDOW requests of each route; live gauges
    are read from the engine at scrape time."""

    WINDOW = 512

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = collections.Counter()
        self._lat = collections.defaultdict(
            lambda: collections.deque(maxlen=self.WINDOW))

    def count(self, name: str, n: int = 1):
        with self._lock:
            self._counts[name] += n

    def observe(self, route: str, seconds: float):
        with self._lock:
            self._counts['requests_total{route="%s"}' % route] += 1
            self._lat[route].append(seconds)

    @staticmethod
    def _pct(xs, q):
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    def render(self, engine) -> str:
        # one TYPE header a metric family: the format forbids interleaving
        lines = []
        with self._lock:
            fams = {}
            for name, v in sorted(self._counts.items()):
                base, _, label = name.partition("{")
                lab = "{" + label if label else ""
                fams.setdefault(base, []).append(f"unidisc_{base}{lab} {v}")
            for base, samples in sorted(fams.items()):
                lines.append(f"# TYPE unidisc_{base} counter")
                lines.extend(samples)
            for route, xs in sorted(self._lat.items()):
                if not xs:
                    continue
                for q, tag in ((0.5, "0.5"), (0.95, "0.95"), (0.99, "0.99")):
                    lines.append(
                        'unidisc_request_seconds{route="%s",quantile='
                        '"%s"} %.4f' % (route, tag, self._pct(xs, q)))
        # the AR continuous batcher's gauges, where the engine has one
        cont = getattr(engine, "_continuous", None)
        if cont is not None:
            lines.append("unidisc_queue_depth %d" % cont._queue.qsize())
            lines.append("unidisc_active_slots %d" % sum(
                r is not None for r in cont._slot_req))
            lines.append("unidisc_slots %d" % cont.slots)
        return "\n".join(lines) + "\n"


class Handler(BaseHTTPRequestHandler):
    engine: InferenceEngine = None
    batcher: RequestBatcher = None
    cache: dict = {}
    metrics: ServerMetrics = None

    def log_message(self, fmt, *args):  # quiet
        pass

    def _json(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self, body: bytes, content_type: str):
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/health":
            self._json(200, {"status": "ok"})
        elif self.path == "/metrics":
            self._body(self.metrics.render(self.engine).encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif self.path in ("/", "/index.html"):
            page = os.path.join(os.path.dirname(__file__), "webui.html")
            with open(page, "rb") as f:
                self._body(f.read(), "text/html; charset=utf-8")
        else:
            self._json(404, {"error": "not found"})

    def do_POST(self):
        # the route starts as "other" (404s, parse failures); cache replays
        # record as "cached" so their ~0 ms never skew the sampler routes
        t0 = time.perf_counter()
        self._route = "other"
        try:
            self._post_inner()
        finally:
            self.metrics.observe(self._route, time.perf_counter() - t0)

    def _encode(self, parsed: dict):
        """(image ids, token-grid edit mask) of the attachments, the image
        resized to the codec's size (PIL's resize, ported) and encoded on
        the device under the engine's lock; (None, None) without an image
        or a codec."""
        codec = self.engine.codec
        if parsed["image"] is None or codec is None:
            return None, None
        size = math.isqrt(self.engine.m.img_length) * codec.downsample
        img = torch.from_numpy(resize_image(parsed["image"], size)[None])
        with self.engine._device_lock:
            ids = codec.encode(img.to(self.engine.device))[0].cpu().numpy()
        mask = None
        if parsed["mask"] is not None:
            mask = downscale_bool_mask(resize_mask(parsed["mask"], size),
                                       codec.downsample).reshape(-1)
        return ids, mask

    def _post_inner(self):
        if self.path != "/v1/chat/completions":
            self._json(404, {"error": "not found"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length))
            key = hashlib.sha256(
                json.dumps(req, sort_keys=True).encode()).hexdigest()
            if key in self.cache:
                self._route = "cached"
                self.metrics.count("cache_hits_total")
                # a cached stream:true request still comes back as SSE
                if req.get("stream"):
                    self._stream(self.cache[key])
                else:
                    self._json(200, self.cache[key])
                return

            if "segments" in req:
                self._route = "interleaved"
                self._interleaved(req, key)
                return

            parsed = parse_messages(req.get("messages", []))
            if (self.engine.config.trainer.parameterization == "ar"
                    and parsed["image"] is None):
                # the request joins the continuous batcher's device batch
                # at once; stream:true sends the text as it decodes
                self._route = "ar"
                self._ar_completion(req, parsed, key)
                return

            self._route = "diffusion"
            image_ids, image_mask = self._encode(parsed)
            kwargs = dict(
                text=parsed["text"], image_ids=image_ids,
                image_mask=image_mask, steps=req.get("steps"),
                seed=req.get("seed", int(time.time()) % 2 ** 31),
                task=req.get("task", "auto"))
            # concurrent requests coalesce into one device batch
            if self.batcher is not None:
                result = self.batcher.run(
                    no_batch=bool(req.get("no_batch", False)), **kwargs)
            else:
                result = self.engine.run(**kwargs)

            content = [{"type": "text", "text": result["text"]}]
            for b64 in result.get("images_b64", []):
                content.append({"type": "image_url", "image_url": {
                    "url": f"data:image/png;base64,{b64}"}})
            payload = {
                "id": f"unidisc-{key[:12]}",
                "object": "chat.completion",
                "model": "unidisc-tpu",
                "choices": [{"index": 0, "finish_reason": "stop",
                             "message": {"role": "assistant",
                                         "content": content}}],
                "usage": {"nfe": result["nfe"]},
            }
            self.cache[key] = payload
            if req.get("stream"):
                self._stream(payload)
            else:
                self._json(200, payload)
        except Exception as e:  # noqa: BLE001 — any engine error is a 500
            self.metrics.count("errors_total")
            self._json(500, {"error": f"{type(e).__name__}: {e}"})

    def _interleaved(self, req: dict, key: str):
        """An interleaved document (``engine.run_interleaved``): image_b64
        segments are encoded by the codec on the device (400 without a
        codec), pixel masks become bool arrays; the request bypasses the
        batcher (one document a row) and runs under the engine's lock."""
        codec = self.engine.codec
        if codec is None and any("image_b64" in s for s in req["segments"]):
            self._json(400, {"error": "image_b64 segments need a codec "
                                      "(--codec) for pixel I/O"})
            return
        segs = []
        for s in req["segments"]:
            s = dict(s)
            if s.get("kind") == "image" and "image_b64" in s:
                img = torch.from_numpy(decode_image_b64(s.pop("image_b64")))
                with self.engine._device_lock:
                    s["ids"] = codec.encode(
                        img[None].to(self.engine.device))[0].cpu().numpy()
            if s.get("pixel_mask") is not None:
                s["pixel_mask"] = np.asarray(s["pixel_mask"], bool)
            segs.append(s)
        result = self.engine.run_interleaved(
            segs, steps=req.get("steps"),
            seed=req.get("seed", int(time.time()) % 2 ** 31))
        out = []
        for s in result["segments"]:
            if s["kind"] == "text":
                out.append({"kind": "text", "text": s["text"]})
                continue
            o = {"kind": "image", "grid": s["grid"],
                 "ids": [int(i) for i in s["ids"]]}
            if "image_b64" in s:
                o["image_b64"] = s["image_b64"]
            out.append(o)
        self._json(200, {"id": f"unidisc-{key[:12]}",
                         "object": "interleaved.completion",
                         "segments": out, "usage": {"nfe": result["nfe"]}})

    def _ar_completion(self, req: dict, parsed: dict, key: str):
        """An AR text completion; with stream:true, SSE deltas of the text
        as the batcher hands tokens to the host."""
        kw = dict(max_new_tokens=int(req.get("max_tokens", 64)),
                  temperature=float(req.get("temperature", 0.0)),
                  seed=req.get("seed"))
        text = parsed["text"] or ""
        if not req.get("stream"):
            res = self.engine.complete_text(text, **kw).result(timeout=600)
            payload = {
                "id": f"unidisc-{key[:12]}",
                "object": "chat.completion",
                "model": "unidisc-tpu",
                "choices": [{"index": 0, "finish_reason": "stop",
                             "message": {"role": "assistant",
                                         "content": res["text"]}}],
                "usage": {"completion_tokens": len(res["tokens"])},
            }
            self.cache[key] = payload
            self._json(200, payload)
            return
        tok = self.engine.tokenizer
        deltas: "queue.Queue" = queue.Queue()
        acc: list = []

        def on_tokens(ids):
            acc.extend(ids)
            deltas.put(tok.decode(acc))   # the text so far

        fut = self.engine.complete_text(text, stream_cb=on_tokens, **kw)
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()

        def chunk(delta, finish=None):
            body = {"id": f"unidisc-{key[:12]}",
                    "object": "chat.completion.chunk",
                    "model": "unidisc-tpu",
                    "choices": [{"index": 0, "delta": delta,
                                 "finish_reason": finish}]}
            self.wfile.write(f"data: {json.dumps(body)}\n\n".encode())
            self.wfile.flush()

        def stable(text):
            # a character whose bytes are split across drains decodes to a
            # trailing U+FFFD until the rest arrives: hold it back, so that
            # every delta extends a prefix of the final text
            return text.rstrip("\ufffd")

        chunk({"role": "assistant"})
        sent = ""
        while True:
            try:
                text_now = stable(deltas.get(timeout=0.1))
            except queue.Empty:
                if fut.done():
                    break
                continue
            if text_now.startswith(sent) and len(text_now) > len(sent):
                chunk({"content": text_now[len(sent):]})
                sent = text_now
        res = fut.result(timeout=600)
        if res["text"] != sent:
            if res["text"].startswith(sent):
                chunk({"content": res["text"][len(sent):]})
            else:
                # the detokenization rewrote earlier text: a full
                # replacement makes the client's transcript converge
                chunk({"content": res["text"], "replace": True})
        chunk({}, finish="stop")
        self.wfile.write(b"data: [DONE]\n\n")

    def _stream(self, payload: dict):
        """OpenAI-style SSE chunks: the role, each content item, the stop,
        then [DONE]."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()

        def chunk(delta, finish=None):
            body = {"id": payload["id"], "object": "chat.completion.chunk",
                    "model": payload["model"],
                    "choices": [{"index": 0, "delta": delta,
                                 "finish_reason": finish}]}
            self.wfile.write(f"data: {json.dumps(body)}\n\n".encode())

        chunk({"role": "assistant"})
        for item in payload["choices"][0]["message"]["content"]:
            chunk({"content": [item]})
        chunk({}, finish="stop")
        self.wfile.write(b"data: [DONE]\n\n")


def make_server(engine: InferenceEngine, port: int = 8000,
                host: str = "127.0.0.1", *,
                batcher: Optional[RequestBatcher] = None,
                max_batch: int = 16,
                max_wait_ms: float = 25.0) -> ThreadingHTTPServer:
    """A server bound to (host, port) (port 0: any free port) whose handler
    threads share `engine`, a RequestBatcher over it (``srv.batcher``), a
    response cache and the metrics (``srv.metrics``). Call
    ``serve_forever`` in a thread; ``shutdown`` and ``close_server`` stop
    it."""
    if batcher is None:
        batcher = RequestBatcher(engine, max_batch=max_batch,
                                 max_wait_ms=max_wait_ms)
    metrics = ServerMetrics()
    handler = type("BoundHandler", (Handler,),
                   {"engine": engine, "batcher": batcher, "cache": {},
                    "metrics": metrics})
    srv = ThreadingHTTPServer((host, port), handler)
    srv.daemon_threads = True
    srv.batcher = batcher
    srv.metrics = metrics
    srv.engine = engine
    return srv


def close_server(srv: ThreadingHTTPServer) -> None:
    """Close a server of ``make_server`` whose loop has stopped: its
    socket, its request batcher, then the engine's batchers' workers and,
    on a mesh, its followers, in that order (a worker's late op must find
    the followers still replaying)."""
    srv.server_close()
    srv.batcher.shutdown()
    srv.engine.shutdown()


def main(argv: Optional[list] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--ckpt", default=None,
                        help="run dir with checkpoints/ (EMA params used)")
    parser.add_argument("--reference-ckpt", default=None,
                        help="published reference checkpoint file "
                        "(model.safetensors or a torch .pt); the "
                        "architecture is inferred from the weights, --model "
                        "supplies the sequence layout and sampling defaults")
    parser.add_argument("--model", default="small",
                        help="a config preset, or elm[:tiny|270m|450m|1.1b] "
                        "for the OpenELM baseline")
    parser.add_argument("--steps", type=int, default=32)
    parser.add_argument("--codec", default=None,
                        help="image codec for pixel I/O (e.g. llamagen-vq16)")
    parser.add_argument("--quantize", default=None, choices=[None, "int8"],
                        help="serve with int8 W8A8 matmuls")
    parser.add_argument("--lora", default=None,
                        help="LoRA adapter to merge (not in the port yet)")
    parser.add_argument("--kv-cache", default=None, choices=[None, "int8"],
                        help="KV cache dtype (model.kv_cache_dtype)")
    parser.add_argument("--experiments", default=None,
                        help="comma-separated experiment overlays (e.g. "
                        "fast_nfe)")
    parser.add_argument("--mesh", default=None,
                        help="serving mesh spec, e.g. 'fsdp=2,seq=2', under "
                        "torchrun (one process per device): rank 0 serves "
                        "HTTP, the other ranks replay its device calls")
    parser.add_argument("--rolling", type=int, default=0,
                        help="serve diffusion requests through the rolling "
                        "batchers with N slots (per-row denoise steps, "
                        "mid-flight admission; serving/rolling.py)")
    parser.add_argument("--scaffold", default=None,
                        help="scaffold decoding: 'preset[=run_dir]' of a "
                        "smaller trunk that runs the late denoise steps "
                        "(sampling/scaffold.py)")
    parser.add_argument("--scaffold-split", type=int, default=8,
                        help="denoise steps run on the main model before "
                        "the scaffold trunk takes over")
    parser.add_argument("--speculative", default=None,
                        help="AR models only: the draft preset of "
                        "speculative decoding (the draft proposes --gamma "
                        "tokens a target forward; greedy output is plain "
                        "greedy's), or 'lookup[:N]' for prompt lookup")
    parser.add_argument("--gamma", type=int, default=4,
                        help="speculative draft length per round")
    args = parser.parse_args(argv)

    from unidisc_tpu_torch.serving.engine import build_engine

    engine = build_engine(preset=args.model, checkpoint=args.ckpt,
                          reference_ckpt=args.reference_ckpt,
                          codec_name=args.codec, steps=args.steps,
                          quantize=args.quantize, lora=args.lora,
                          kv_cache=args.kv_cache, mesh=args.mesh,
                          rolling=args.rolling, scaffold=args.scaffold,
                          scaffold_split=args.scaffold_split,
                          speculative=args.speculative,
                          spec_gamma=args.gamma, device=args.device,
                          experiments=(args.experiments.split(",")
                                       if args.experiments else None))
    if engine.mesh is not None:
        from unidisc_tpu_torch.utils.dist import rank
        if rank() != 0:
            engine.follow()
            return
        engine.lead()
    server = make_server(engine, args.port, args.host)
    print(f"[serve] listening on {args.host}:{args.port}")
    try:
        server.serve_forever()
    finally:
        close_server(server)


if __name__ == "__main__":
    main()
