"""Metric logging to a JSONL file and the console (port of
``unidisc_tpu/utils/logging.py``; wandb is not in the port and raises)."""

from __future__ import annotations

import json
import os
import time


class MetricLogger:
    def __init__(self, run_dir: str, *, use_wandb: bool = False,
                 console_every: int = 1, filename: str = "metrics.jsonl"):
        if use_wandb:
            raise NotImplementedError("wandb logging is not in the port; "
                                      "metrics go to metrics.jsonl")
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, filename)
        self._f = open(self.path, "a", buffering=1)
        self.console_every = console_every

    def log(self, metrics: dict, step: int):
        record = {"step": int(step), "time": time.time(),
                  **{k: (float(v) if hasattr(v, "__float__") else v)
                     for k, v in metrics.items()}}
        self._f.write(json.dumps(record) + "\n")
        if self.console_every and step % self.console_every == 0:
            parts = " ".join(f"{k}={v:.4g}" if isinstance(v, float)
                             else f"{k}={v}" for k, v in record.items()
                             if k != "time")
            print(f"[{time.strftime('%H:%M:%S')}] {parts}", flush=True)

    def close(self):
        self._f.close()
