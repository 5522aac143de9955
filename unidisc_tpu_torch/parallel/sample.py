"""SPMD sampling and serving on a device mesh (port of
``unidisc_tpu/parallel/sample.py``).

Every rank calls the wrapped sampler with the same global batch. Each
data-parallel rank (the "dcn" x "fsdp" axes) samples its rows; a "seq"
group runs the sampler replicated, the DIT taking its L-chunk, running
the ring and gathering the hidden states over L before the vocab head
(``models/dit.py``), so the maskgit top-k and the confidences are taken
over the whole sequence and every rank of the group picks the same tokens.
Under "pp" the DIT's block stack runs as a GPipe pipeline over the
rank's rows in ``mesh.pp_microbatches`` microbatches (the batch granule is
then the data-parallel width x the microbatches); "tensor" and "ep" ranks
run their parts of each block and of each MoE layer. The rows come back
together on every rank.

The weights: ``shard_params`` lays them out by the mesh rule (FSDP2, which
all-gathers each block in every forward, over ``shard_model``'s "pp" /
"tensor" / "ep" parts). The engine keeps the "pp" / "tensor" / "ep" parts
only (``shard_model``) and no FSDP, so a data-parallel step holds no
collective and stays a captured CUDA-graph program; steps that hold
collectives (the ring, the pipeline, the tensor-parallel sums, an MoE
layer's global routing) run eager (``InferenceEngine``).

The noise: a rank's draws are those of the global batch
(``sampling/sampler.py::global_rows``): each is made at the global batch's
rows and the rank keeps its own, so a seed gives the tokens of one rank
sampling the whole batch, as JAX's replicated rng does. The injected noise
of a sampler (``sampling/sampler.py``, ``sampling/t2i_fast.py``) is
(steps, B, ...): each rank takes its rows of dim 1.
"""

from __future__ import annotations

from typing import Callable

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.parallel.mesh import check_mesh_model


def batch_multiple(config: Config, layout) -> int:
    """Smallest batch the mesh runs: the data-parallel width, times the
    microbatches when pipelining."""
    if layout.sizes.get("pp", 1) > 1:
        return layout.dp_size * config.mesh.pp_microbatches
    return layout.dp_size


def validate_mesh(config: Config, layout) -> None:
    check_mesh_model(config.model, layout.sizes)
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


def has_collectives(config: Config, layout) -> bool:
    """Whether a sampler step on this mesh holds collectives (and so runs
    eager: a CUDA graph cannot hold a gloo collective, and NCCL capture
    waits for a card per rank, ROADMAP queue 1, item 9)."""
    s = layout.sizes
    return (max(s["seq"], s["pp"], s["tensor"], s["ep"]) > 1
            or (config.model.moe_experts > 0 and layout.dp_size > 1))


def spmd_sampler(sample_fn: Callable, config: Config, layout) -> Callable:
    """Wrap `sample_fn(*batch_args, seed= / generator=, injected=)` (a
    built sampler, or the engine's program) for the mesh: call(*args,
    **kw) with the global batch (every arg's dim 0 the batch, a multiple
    of ``batch_multiple``) returns the SampleResult of the global batch
    on every rank."""
    from unidisc_tpu_torch.parallel.pipeline import pipeline_parallel
    from unidisc_tpu_torch.parallel.seq_parallel import sequence_parallel
    from unidisc_tpu_torch.sampling.sampler import SampleResult, global_rows
    validate_mesh(config, layout)
    mult = batch_multiple(config, layout)

    def call(*args, injected=None, **kw):
        b = args[0].shape[0]
        if b % mult:
            raise ValueError(f"batch {b} not a multiple of the mesh granule "
                             f"{mult} (the data-parallel width x the "
                             f"pipeline's microbatches); pad with "
                             f"batch_multiple()")
        n = b // layout.dp_size
        lo = layout.dp_rank * n
        local = [a[lo:lo + n] for a in args]
        if injected is not None:
            kw["injected"] = {k: v[:, lo:lo + n]
                              for k, v in injected.items()}
        with sequence_parallel(layout), \
                pipeline_parallel(layout, config.mesh.pp_microbatches), \
                global_rows(layout.dp_rank, layout.dp_size):
            out = sample_fn(*local, **kw)
        return SampleResult(tokens=layout.gather_rows(out.tokens),
                            nfe=out.nfe)

    return call
