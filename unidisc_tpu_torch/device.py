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


def cap_test_threads() -> None:
    """Share the CPU's cores among pytest-xdist workers: with
    PYTEST_XDIST_WORKER_COUNT set, set torch's intra-op threads to
    cpu_count // workers (at least 1). Without it nothing changes. The
    CPU test files call it when they are imported."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))
