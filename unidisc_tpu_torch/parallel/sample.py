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

The batchers' slots (``SlotSplit``): the rolling batchers and the
continuous AR batcher keep one persistent device batch of S slots, the
global batch of a mesh: S is rounded up to the granule (``batch_multiple``)
and data-parallel rank r owns slots [r S / dp, (r + 1) S / dp). Their
chunks run outside ``sequence_parallel``, as JAX jits them outside
``spmd_sampler``'s contexts: a "seq" group runs its rows replicated,
without the ring, so on dcn / fsdp / seq meshes a chunk holds no
collective; under "pp" the chunk's forward runs in ``pipeline_parallel``
over the rank's rows, and "tensor" and "ep" ranks run their parts. A
batcher's host reads become one gather over rank 0's data-parallel group
(``SlotSplit.gather``), to which only the ranks whose other indices are 0
contribute. AR decoding (the KV-cache paths) runs on dcn, fsdp and seq
only: on "tensor", "pp" or "ep", or for an MoE model on a data-parallel
mesh, ``check_ar_mesh`` raises naming ROADMAP queue 1, item 9.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Mapping, Optional

import numpy as np
import torch

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


def has_collectives(config: Config, layout, ring: bool = True) -> bool:
    """Whether a sampler step on this mesh holds collectives (and so runs
    eager: a CUDA graph cannot hold a gloo collective, and NCCL capture
    waits for a card per rank, ROADMAP queue 1, item 9). ring=False: a
    batcher's chunk, which runs a "seq" group replicated (module
    docstring), so "seq" adds none."""
    s = layout.sizes
    return (max(s["seq"] if ring else 1, s["pp"], s["tensor"], s["ep"]) > 1
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


def check_ar_mesh(config: Config, sizes: Mapping[str, int]) -> None:
    """Raise NotImplementedError (ROADMAP queue 1, item 9) where AR
    decoding cannot run on a mesh of axis sizes `sizes`: under "tensor" or
    "pp" (a rank holds a part of each block, or one stage's blocks, and the
    KV cache is not split with them), under "ep", and for an MoE model on a
    data-parallel mesh (its routing spans the ranks inside each decode
    step)."""
    if config.trainer.parameterization != "ar":
        return
    big = lambda a: sizes.get(a, 1) > 1
    later = [what for what, bad in (
        ("AR decoding on tensor or pp", big("tensor") or big("pp")),
        ("AR decoding on ep", big("ep")),
        ("an MoE AR model on a data-parallel mesh",
         config.model.moe_experts > 0 and (big("dcn") or big("fsdp"))),
    ) if bad]
    if later:
        raise NotImplementedError(f"{', '.join(later)} is not in the port "
                                  f"yet (ROADMAP queue 1, item 9)")


class SlotSplit:
    """The S slots of a batcher's persistent device batch on a mesh
    (module docstring): ``slots`` the global count (the request rounded up
    to the granule), ``local`` this rank's, ``lo`` its first global slot.
    Without a layout, one rank owns every slot."""

    def __init__(self, slots: int, config: Optional[Config] = None,
                 layout=None):
        self.layout = layout
        mult = 1 if layout is None else batch_multiple(config, layout)
        self.slots = -(-slots // mult) * mult
        dp = 1 if layout is None else layout.dp_size
        self.local = self.slots // dp
        self.lo = 0 if layout is None else layout.dp_rank * self.local
        self.microbatches = 1 if config is None \
            else config.mesh.pp_microbatches
        # the ranks of rank 0's data-parallel group gather the host reads
        self.reports = layout is None or (
            layout.seq_rank == 0 and layout.tensor.rank == 0
            and layout.pp.rank == 0 and layout.ep.rank == 0)

    def owner(self, slot: int) -> int:
        """The data-parallel rank that owns global slot `slot`."""
        return slot // self.local

    def own(self, slots_v) -> np.ndarray:
        """Global slot ids -> this rank's local ones; a slot of another
        rank, or past the global count (padding), becomes ``local`` (the
        state machines drop it)."""
        v = np.asarray(torch.as_tensor(slots_v).cpu()).astype(np.int64)
        mine = (v >= self.lo) & (v < self.lo + self.local)
        return np.where(mine, v - self.lo, self.local)

    def forward(self):
        """The context a chunk's forward runs in: the pipeline over "pp"
        (no "seq" ring: a seq group runs its rows replicated)."""
        if self.layout is None:
            return contextlib.nullcontext()
        from unidisc_tpu_torch.parallel.pipeline import pipeline_parallel
        return pipeline_parallel(self.layout, self.microbatches)

    def gather(self, t: torch.Tensor) -> Optional[np.ndarray]:
        """This rank's (local, ...) rows -> the global (S, ...) rows as a
        host array on rank 0, None elsewhere: one gather over rank 0's
        data-parallel group (``parallel/comm.py::gather``); the other
        ranks take no part."""
        if self.layout is None:
            return t.cpu().numpy()
        if not self.reports:
            return None
        from unidisc_tpu_torch.parallel.comm import gather
        out = gather(t, self.layout.dp_group, 0)
        return None if out is None else out.cpu().numpy()
