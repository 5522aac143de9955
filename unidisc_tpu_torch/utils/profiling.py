"""Profiling utilities (port of ``unidisc_tpu/utils/profiling.py``).

The JAX package traces with ``jax.profiler``; the port traces with
``torch.profiler`` (CPU and, where there is one, CUDA activity) and writes
each window as a Chrome trace (``trace_<step>.json``, viewable in
Perfetto or chrome://tracing) into ``log_dir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class Profiler:
    """Trace a span of steps to a directory: steps [warmup_steps,
    warmup_steps + active_steps) of the ``step()`` calls."""

    def __init__(self, log_dir: str, *, active_steps: int = 5,
                 warmup_steps: int = 2):
        self.log_dir = log_dir
        self.active = active_steps
        self.warmup = warmup_steps
        self._step = 0
        self._prof = None
        self.trace_path: Optional[str] = None

    def _start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()

    def _stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        self.trace_path = os.path.join(self.log_dir,
                                       f"trace_{self._step}.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None

    def step(self):
        """Call once per train step; starts/stops the trace window."""
        if self._step == self.warmup:
            self._start()
        if self._step == self.warmup + self.active and self._prof:
            self._stop()
        self._step += 1

    def close(self):
        if self._prof is not None:
            self._stop()


@contextlib.contextmanager
def annotate(name: str):
    """Named range in the profile (reference StepTrace/NVTX analogue)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def wall_timer(label: str, results: Optional[dict] = None):
    """Host-side phase timing (reference per-phase wall-times,
    model.py:1392,1435,1548)."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = results.get(label, 0.0) + dt


def memory_stats() -> dict:
    """Device memory snapshot of each visible card (empty without one):
    bytes in use, peak bytes in use, the card's total bytes."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[str(i)] = {
            "bytes_in_use": s.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory}
    return out
