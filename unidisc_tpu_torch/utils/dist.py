"""Multi-process helpers (port of ``unidisc_tpu/utils/dist.py``).

One process per device, joined by ``torch.distributed``. ``initialize``
joins the process group from explicit arguments or from the environment
``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``); without either it does nothing, so a single process runs
as before. Unlike the JAX helper, which swallows every error of
``jax.distributed.initialize``, a failure here raises.

The backend follows the device: NCCL when every rank has a card of its
own, gloo otherwise (the CPU, or several ranks sharing one card, which
NCCL refuses). Over gloo a CUDA tensor goes through host memory
(``parallel/comm.py``).

Nothing here compiles: the JAX helper's ``enable_compile_cache`` is XLA's
persistent cache; the port's kernels are built once into ``build/`` by the
hash of their source and flags (``ops/_build.py``), which serves the same
purpose, so it has no counterpart.
"""

from __future__ import annotations

import hashlib
import os
from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist


def default_backend(device: torch.device, world: int) -> str:
    """"nccl" when `device` is a card and there is one card per rank,
    else "gloo"."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device: str = "cuda") -> bool:
    """Join the default process group: at `coordinator` ("host:port") with
    `num_processes` and `process_id`, or from torchrun's environment.
    Returns whether a group is up. Already initialized: nothing to do.
    On a card each rank takes the card of its local rank (LOCAL_RANK, or
    the one card when there is one card for several ranks)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator is None and not ("RANK" in env and "WORLD_SIZE" in env):
        return False
    world = num_processes if coordinator else int(env["WORLD_SIZE"])
    rank = process_id if coordinator else int(env["RANK"])
    if world is None or rank is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    dev = torch.device(device)
    backend = default_backend(dev, world)
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local if backend == "nccl" else 0)
    init = f"tcp://{coordinator}" if coordinator else "env://"
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return rank() == 0


def rprint(*args, **kw):
    """Rank-0-only print."""
    if is_main_process():
        print(*args, **kw, flush=True)


def gprint(*args, **kw):
    """All-rank print with a rank prefix."""
    print(f"[rank {rank()}/{world_size()}]", *args, **kw, flush=True)


def barrier(name: str = "barrier"):
    """Wait for every rank (`name` labels the call site, as in JAX)."""
    if world_size() > 1:
        dist.barrier()


def host_local_batch_size(global_batch: int) -> int:
    """The rows each rank feeds: the global batch over the ranks."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} ranks")
    return global_batch // n


def host_batch_to_global(batch: Mapping, group=None) -> dict:
    """Each rank's slice of the global batch (numpy arrays or tensors,
    rank-major along dim 0) -> the whole global batch, on every rank, as
    the type it came in (tensors on their device)."""
    from unidisc_tpu_torch.parallel.comm import all_gather
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)) \
            if isinstance(v, np.ndarray) else v
        g = all_gather(t, group, dim=0)
        out[k] = g.numpy() if isinstance(v, np.ndarray) else g
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    to_local = getattr(t, "to_local", None)
    return to_local() if to_local is not None else t


def param_hash(params: Mapping[str, torch.Tensor], group=None) -> str:
    """A hash of a parameter dict: each rank hashes its own shards (the
    local part of a sharded tensor), by name; the digests of all ranks are
    gathered in rank order and hashed again, so every rank prints the same
    value, and it changes when any rank's shards change."""
    h = hashlib.sha256()
    for name in sorted(params):
        t = _local(params[name]).detach().cpu().contiguous()
        h.update(name.encode())
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel()
                 else b"")
    digest = h.digest()[:8]
    if world_size() == 1:
        return digest.hex()
    from unidisc_tpu_torch.parallel.comm import all_gather
    mine = torch.frombuffer(bytearray(digest), dtype=torch.uint8)
    gathered = all_gather(mine, group, dim=0)
    return hashlib.sha256(gathered.numpy().tobytes()).hexdigest()[:16]
