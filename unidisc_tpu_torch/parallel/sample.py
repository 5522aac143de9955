"""SPMD sampling and serving on a device mesh (port of
``unidisc_tpu/parallel/sample.py``).

Every rank calls the wrapped sampler with the same global batch. Each
data-parallel rank (the "dcn" x "fsdp" axes) samples its rows; a "seq"
group runs the sampler replicated, the DIT taking its L-chunk, running
the ring and gathering the hidden states over L before the vocab head
(``models/dit.py``), so the maskgit top-k and the confidences are taken
over the whole sequence and every rank of the group picks the same tokens.
The rows come back together on every rank.

The weights: ``shard_params`` lays them out by the mesh rule (FSDP2, which
all-gathers each block in every forward). The engine keeps a whole copy
on each rank instead, so a data-parallel step holds no collective and
stays a captured CUDA-graph program; a "seq" group's steps hold the ring's
collectives and run eager (``InferenceEngine``).

The injected noise of a sampler (``sampling/sampler.py``,
``sampling/t2i_fast.py``) is (steps, B, ...): each rank takes its rows of
dim 1. A call's ``seed`` is offset per data-parallel rank (``dp_seed``), so
the ranks' rows draw different noise (rank 0 keeps the seed).
"""

from __future__ import annotations

from typing import Callable

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.parallel.mesh import check_ported_axes


def batch_multiple(config: Config, layout) -> int:
    """Smallest batch the mesh runs: the data-parallel width."""
    check_ported_axes(layout.sizes)
    return layout.dp_size


def validate_mesh(config: Config, layout) -> None:
    check_ported_axes(layout.sizes)
    seq = layout.seq_size
    if seq > 1 and config.model.length % seq != 0:
        raise ValueError(f"model.length={config.model.length} not divisible "
                         f"by seq={seq}")


def shard_params(model, mesh):
    """The model's parameters laid out on `mesh` by the rule: the JAX
    package's name for ``parallel/mesh.py::params_shardings``, kept so a
    sampling caller reads as it does there."""
    from unidisc_tpu_torch.parallel.mesh import params_shardings
    return params_shardings(model, mesh)


def dp_seed(seed: int, dp_rank: int) -> int:
    """The seed data-parallel rank `dp_rank` samples its rows with: a
    one-rank call on those rows with this seed draws the same noise."""
    return (seed + dp_rank * 0x9E3779B1) & 0x7FFFFFFF


def spmd_sampler(sample_fn: Callable, config: Config, layout) -> Callable:
    """Wrap `sample_fn(*batch_args, seed= / generator=, injected=)` (a
    built sampler, or the engine's program) for the mesh: call(*args,
    **kw) with the global batch (every arg's dim 0 the batch, a multiple
    of ``batch_multiple``) returns the SampleResult of the global batch
    on every rank."""
    from unidisc_tpu_torch.parallel.seq_parallel import sequence_parallel
    from unidisc_tpu_torch.sampling.sampler import SampleResult
    validate_mesh(config, layout)
    mult = batch_multiple(config, layout)

    def call(*args, injected=None, **kw):
        b = args[0].shape[0]
        if b % mult:
            raise ValueError(f"batch {b} not a multiple of the mesh granule "
                             f"{mult} (the data-parallel width); pad with "
                             f"batch_multiple()")
        n = b // mult
        lo = layout.dp_rank * n
        local = [a[lo:lo + n] for a in args]
        if injected is not None:
            kw["injected"] = {k: v[:, lo:lo + n]
                              for k, v in injected.items()}
        if "seed" in kw:
            kw["seed"] = dp_seed(kw["seed"], layout.dp_rank)
        with sequence_parallel(layout):
            out = sample_fn(*local, **kw)
        return SampleResult(tokens=layout.gather_rows(out.tokens),
                            nfe=out.nfe)

    return call
