"""Throughput / MFU monitoring (port of ``unidisc_tpu/utils/monitor.py``).

The peak table holds one entry: the H100 SXM's published dense bf16 rate.
A device of another name has no peak, and no MFU is reported for it.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from typing import Optional

import torch

# peak dense bf16 FLOP/s per device, by a substring of the device name
PEAK_FLOPS = {
    "h100": 989e12,   # NVIDIA H100 SXM data sheet, bf16 dense
}


def device_peak_flops(device=None) -> Optional[float]:
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(dev).lower()
    for key, flops in PEAK_FLOPS.items():
        if key in name:
            return flops
    return None


def flops_per_token(n_params: int) -> float:
    """6N per token (forward + backward), the standard estimate."""
    return 6.0 * n_params


class ThroughputMonitor:
    """Windowed samples/s, tokens/s and MFU. Each step() is stamped with
    the host clock; the caller decides whether the device has finished."""

    def __init__(self, n_params: int, window: int = 50, device=None,
                 warmup: int = 1):
        self.n_params = n_params
        self.peak = device_peak_flops(device)
        self._events = deque(maxlen=window)
        self._skip = warmup   # the first steps include build and warm-up

    def step(self, samples: int, tokens: int, now: Optional[float] = None):
        if self._skip > 0:
            self._skip -= 1
            return
        self._events.append((now if now is not None else time.perf_counter(),
                             samples, tokens))

    def stats(self) -> dict:
        if len(self._events) < 2:
            return {}
        events = list(self._events)
        dt = max(events[-1][0] - events[0][0], 1e-9)
        samples = sum(s for _, s, _ in events[1:])
        tokens = sum(tk for _, _, tk in events[1:])
        out = {"samples_per_sec": samples / dt, "tokens_per_sec": tokens / dt}
        if self.peak:
            out["mfu"] = flops_per_token(self.n_params) * tokens / dt \
                / self.peak
        return out


class PhaseTimer:
    """Windowed per-phase host wall time of the train loop; stats() gives
    the mean ms of each phase. Device work is asynchronous, so a phase that
    only enqueues work measures the enqueue.

    Usage: with timer("data"): batch = next(it)
    """

    def __init__(self, window: int = 50):
        self._times = defaultdict(lambda: deque(maxlen=window))

    @contextlib.contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._times[phase].append(time.perf_counter() - t0)

    def stats(self) -> dict:
        return {f"{phase}_ms": round(1e3 * sum(xs) / len(xs), 3)
                for phase, xs in self._times.items() if xs}
