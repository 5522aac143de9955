"""Sequence-parallel context (port of ``unidisc_tpu/parallel/
seq_parallel.py``).

Under ``sequence_parallel(layout)`` with a "seq" axis larger than 1 the
DIT (``models/dit.py``) takes its rank's L-chunk of every per-token input
(the tokens, modality, sample ids, rope rows at the chunk's global
positions) and runs its self-attention as the ring over the "seq" group
(``parallel/ring_attention.py``). Everything else in the model is
pointwise along L.

``gather``: whether the DIT gathers its final hidden states over L before
the vocab head, so that every rank of the group gets the whole
sequence's output (the samplers, which pick tokens over the whole
sequence); without it the DIT returns the chunk's output (the train step,
which gathers the per-token losses instead).

The state is thread-local and read when the model runs.

The JAX package's ``parallel/compat.py`` (``vary``) is a typing shim for
shard_map's varying axes and has no counterpart here.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional

_STATE = threading.local()


@dataclass(frozen=True)
class SeqContext:
    group: object      # the "seq" process group
    rank: int          # this rank's index in it
    size: int          # its size
    gather: bool       # gather the hidden states over L before the head


@contextlib.contextmanager
def sequence_parallel(layout, gather: bool = True):
    """Enable the ring over `layout`'s "seq" group (a
    ``parallel/mesh.py::MeshLayout``) for model calls inside the context.
    No layout, or a "seq" size of 1, is a no-op."""
    if layout is None or layout.seq_size <= 1:
        yield
        return
    prev = getattr(_STATE, "value", None)
    _STATE.value = SeqContext(layout.seq_group, layout.seq_rank,
                              layout.seq_size, gather)
    try:
        yield
    finally:
        _STATE.value = prev


def current_seq_mesh() -> Optional[SeqContext]:
    """The active SeqContext, or None."""
    return getattr(_STATE, "value", None)
