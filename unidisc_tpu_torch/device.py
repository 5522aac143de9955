"""Device selection shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU; a request
for CUDA on a machine without it raises instead of running elsewhere.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the CPU with the kernels' plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def cap_test_threads(ranks: int = 1) -> None:
    """Share the CPU's cores among pytest-xdist workers: with
    PYTEST_XDIST_WORKER_COUNT set, set torch's intra-op threads to
    cpu_count // workers // ranks (at least 1); `ranks`: the processes of
    a multi-rank test world, which share their worker's cores. Without the
    variable, ranks > 1 take cpu_count // ranks and one process keeps its
    threads. The CPU test files call it when they are imported."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    if workers or ranks > 1:
        cores = (os.cpu_count() or 1) // max(workers, 1)
        torch.set_num_threads(max(1, cores // ranks))
