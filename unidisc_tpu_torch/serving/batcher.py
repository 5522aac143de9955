"""Request batcher: coalesce concurrent requests into one device batch
(port of ``unidisc_tpu/serving/batcher.py``).

A background worker drains a queue, groups compatible requests (same
sampler kind and step count), pads the group to the next batch size of
``PAD_SIZES`` (on the card each is one captured program a sampler), runs
the engine once and resolves each request's Future with its row.

Seed semantics: a batched run draws from one generator seeded from the
first request's seed and the batch composition, so exact per-seed
reproducibility holds only for batches of one; requests that need it pass
no_batch=True and run alone.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional

PAD_SIZES = (1, 2, 4, 8, 16)


@dataclass
class _Pending:
    prepared: dict
    steps: Optional[int]
    seed: int
    solo: bool = False
    future: Future = field(default_factory=Future)

    @property
    def group_key(self):
        return (bool(self.prepared["fastpath"]), self.steps)


def batch_seed(seeds: List[int]) -> int:
    """The seed of a batch: the first request's, folded with the others'
    and their positions."""
    seed = seeds[0]
    for i, s in enumerate(seeds[1:], 1):
        seed = (seed * 1_000_003 + s + i) % (2 ** 31)
    return seed


class RequestBatcher:
    """Submit requests; a worker thread micro-batches them into the engine.

    Args:
      engine: InferenceEngine.
      max_batch: largest device batch (one of PAD_SIZES).
      max_wait_ms: how long the worker waits to fill a batch once the first
        request of a group arrives.
    """

    def __init__(self, engine, *, max_batch: int = 16,
                 max_wait_ms: float = 25.0):
        if max_batch not in PAD_SIZES:
            raise ValueError(f"max_batch {max_batch} not in {PAD_SIZES}")
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self.batches_run = 0          # stats for tests and monitoring
        self.requests_served = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, *, text=None, image_ids=None, image_mask=None,
               task="auto", steps=None, seed=0,
               no_batch: bool = False) -> Future:
        prepared = self.engine.prepare(text=text, image_ids=image_ids,
                                       image_mask=image_mask, task=task)
        item = _Pending(prepared, steps, seed, solo=no_batch)
        self._q.put(item)
        return item.future

    def run(self, **kw) -> dict:
        """Blocking convenience wrapper."""
        return self.submit(**kw).result()

    def shutdown(self):
        """Stop the worker; requests still queued fail instead of
        hanging."""
        self._stop.set()
        self._thread.join(timeout=30)
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if not item.future.done():
                item.future.set_exception(RuntimeError("batcher shut down"))

    def _worker(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            group: List[_Pending] = [first]
            leftovers: List[_Pending] = []
            deadline = time.monotonic() + self.max_wait
            while (not first.solo and len(group) < self.max_batch
                   and time.monotonic() < deadline):
                try:
                    nxt = self._q.get(timeout=max(
                        deadline - time.monotonic(), 0.001))
                except queue.Empty:
                    break
                if nxt.solo or nxt.group_key != first.group_key:
                    leftovers.append(nxt)   # another group: requeue
                else:
                    group.append(nxt)
            for item in leftovers:
                self._q.put(item)

            pad_to = next(p for p in PAD_SIZES if p >= len(group))
            try:
                results = self.engine.run_batch(
                    [g.prepared for g in group], steps=first.steps,
                    seed=batch_seed([g.seed for g in group]), pad_to=pad_to)
                self.batches_run += 1
                self.requests_served += len(group)
                for g, r in zip(group, results):
                    g.future.set_result(r)
            except Exception as e:  # noqa: BLE001 — fail the group's futures
                for g in group:
                    if not g.future.done():
                        g.future.set_exception(e)
