"""Device mesh and sharding rules (port of ``unidisc_tpu/parallel/mesh.py``).

One process per device. ``make_mesh`` lays the world out as a
``DeviceMesh`` with the JAX package's six axis names ("dcn", "fsdp",
"tensor", "seq", "pp", "ep"), reshaped plainly as JAX does off the TPU.

``param_spec`` is the JAX rule itself, a pure function of the flax path,
the flax shape and the axis sizes: shard the largest dimension that
divides the "fsdp" size, keep parameters under ``MIN_SHARD_SIZE``
replicated, skip the scan-stacked layer axis of block leaves, and the
"tensor" / "pp" / "ep" rules. ``param_specs`` reads it for each torch
parameter through ``training/layout.py`` (a flax kernel is (in, out), a
torch weight (out, in)).

``params_shardings`` turns the rule into FSDP2: ``fully_shard`` on every
DIT block and then at the root, over the ("dcn", "fsdp") sub-mesh, with
``shard_placement_fn`` putting each parameter's shard on the torch
dimension the rule names. With dcn > 1 that is HSDP: replicated over
"dcn", sharded over "fsdp", as JAX's batch spec P(("dcn", "fsdp")) lays
the data. A parameter the rule leaves replicated (under
``MIN_SHARD_SIZE``, or with no dimension that divides) is one of
``fully_shard``'s ``ignored_params``: every rank keeps it whole, and the
train step sums its gradient over the world itself.

``MeshLayout`` is the rank's place on the mesh: its data-parallel index
and size over ("dcn", "fsdp"), its "seq" group, and the rank-local slicing
and gathering that JAX's ``batch_sharding``, ``replicated`` and
``logits_constraint`` stand for: a (B, L) batch's rows are split over the
data-parallel ranks and L over "seq".

"tensor", "pp" and "ep" larger than 1 raise ``NotImplementedError``
(ROADMAP queue 1, item 9): their compute is not in the port.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from unidisc_tpu_torch.config import MeshConfig

AXES = ("dcn", "fsdp", "tensor", "seq", "pp", "ep")
# parameters smaller than this stay replicated
MIN_SHARD_SIZE = 2 ** 14
LATER_AXES = ("tensor", "pp", "ep")


def resolve_mesh_shape(cfg: MeshConfig, n_devices: int) -> tuple:
    sizes = (cfg.dcn, cfg.fsdp, cfg.tensor, getattr(cfg, "seq", 1),
             getattr(cfg, "pp", 1), getattr(cfg, "ep", 1))
    known = [d for d in sizes if d != -1]
    prod = math.prod(known) if known else 1
    remaining = n_devices // max(prod, 1)
    shape = tuple(remaining if d == -1 else d for d in sizes)
    if math.prod(shape) != n_devices:
        raise ValueError(
            f"mesh {shape} does not cover {n_devices} devices")
    return shape


def check_ported_axes(sizes: Mapping[str, int]) -> None:
    """Raise for the axes whose compute is a later slice."""
    later = {a: sizes.get(a, 1) for a in LATER_AXES if sizes.get(a, 1) > 1}
    if later:
        raise NotImplementedError(
            f"mesh axes {later} are not in the port yet: pipeline, tensor-"
            f"parallel and expert-parallel compute are ROADMAP queue 1, "
            f"item 9")


def make_mesh(cfg: MeshConfig, device_type: Optional[str] = None):
    """The ("dcn", "fsdp", "tensor", "seq", "pp", "ep") DeviceMesh over the
    default process group's ranks (one device each). device_type: "cuda"
    or "cpu" (default: "cuda" on an NCCL group, else "cpu"; a gloo world
    of ranks sharing one card takes "cpu", its collectives being host
    ones)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(utils/dist.py::initialize)")
    shape = resolve_mesh_shape(cfg, dist.get_world_size())
    check_ported_axes(dict(zip(AXES, shape)))
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


def mesh_sizes(mesh) -> Dict[str, int]:
    return {a: mesh.size(mesh.mesh_dim_names.index(a)) for a in AXES}


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

# megatron-style 2D rules for the tensor axis: column-parallel
# up-projections put the output dim on 'tensor', row-parallel
# down-projections the input dim
_TP_COL = ("attn_qkv/kernel", "mlp_0/kernel", "adaLN_modulation/kernel")
_TP_ROW = ("attn_out/kernel", "mlp_2/kernel")


def param_spec(path: str, shape: tuple, sizes: Mapping[str, int]) -> tuple:
    """The JAX rule for one flax leaf: the entries of its PartitionSpec
    (() for a replicated leaf), from the flax path ("blocks/attention/
    attn_qkv/kernel"), the flax shape (block leaves scan-stacked) and the
    axis sizes."""
    fsdp = sizes["fsdp"]
    tensor = sizes.get("tensor", 1)
    if math.prod(shape) < MIN_SHARD_SIZE:
        return ()

    dims = list(range(len(shape)))
    pp = sizes.get("pp", 1)
    pp_dim = None
    if "blocks" in path and len(shape) > 1:
        dims = dims[1:]  # skip the stacked layer axis for fsdp/tensor
        if pp > 1 and shape[0] % pp == 0:
            pp_dim = 0
    ep = sizes.get("ep", 1)
    ep_dim = None
    if ep > 1 and "/moe/" in f"/{path}" and len(dims) >= 2 \
            and path.rsplit("/", 1)[-1] in ("w1", "w2", "b1", "b2"):
        e_dim = dims[0]
        if shape[e_dim] % ep == 0:
            ep_dim = e_dim
            dims = dims[1:]

    def finish(spec):
        if pp_dim is not None:
            spec[pp_dim] = "pp"
        if ep_dim is not None:
            spec[ep_dim] = "ep"
        return tuple(spec)

    if tensor > 1 and len(dims) == 2:
        d_in, d_out = dims
        col = any(path.endswith(s) for s in _TP_COL)
        row = any(path.endswith(s) for s in _TP_ROW)
        if col and shape[d_out] % tensor == 0:
            spec = [None] * len(shape)
            spec[d_out] = "tensor"
            if fsdp > 1 and shape[d_in] % fsdp == 0:
                spec[d_in] = "fsdp"
            return finish(spec)
        if row and shape[d_in] % tensor == 0:
            spec = [None] * len(shape)
            spec[d_in] = "tensor"
            if fsdp > 1 and shape[d_out] % fsdp == 0:
                spec[d_out] = "fsdp"
            return finish(spec)

    if fsdp <= 1:
        return finish([None] * len(shape))
    best = None
    for d in sorted(dims, key=lambda d: -shape[d]):
        if shape[d] % fsdp == 0:
            best = d
            break
    if best is None:
        return finish([None] * len(shape))
    spec = [None] * len(shape)
    spec[best] = "fsdp"
    return finish(spec)


def param_specs(params: Mapping[str, torch.Tensor],
                sizes: Mapping[str, int]) -> Dict[str, tuple]:
    """The rule for each torch parameter: one entry per torch dimension (a
    block tensor drops the stacked axis; a kernel's two dims swap)."""
    from unidisc_tpu_torch.training.layout import ParamLayout
    out = {}
    for leaf in ParamLayout(dict(params)).leaves:
        spec = param_spec(leaf.key, leaf.shape, sizes)
        spec = list(spec) + [None] * (len(leaf.shape) - len(spec))
        for name in leaf.names:
            nd = params[name].dim()
            mine = spec[len(spec) - nd:]
            if leaf.transposed:
                mine[-2:] = mine[-2:][::-1]
            out[name] = tuple(mine)
    return out


def params_shardings(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """FSDP2 over the ("dcn", "fsdp") sub-mesh (HSDP with dcn > 1): each
    DIT block (and img_cond trunk block) its own group, then the root;
    the rule picks each parameter's shard dimension, and the parameters it
    leaves replicated are ignored by FSDP. Returns the model (sharded in
    place). A mesh with fsdp == 1 leaves the model as it is."""
    from torch.distributed.fsdp import (fully_shard,
                                        register_fsdp_forward_method)
    from torch.distributed.tensor import Shard
    sizes = mesh_sizes(mesh)
    check_ported_axes(sizes)
    if sizes["fsdp"] == 1:
        return model
    specs = param_specs(dict(model.named_parameters()), sizes)
    by_param = {p: specs[n] for n, p in model.named_parameters()}
    ignored = {p for p, s in by_param.items() if "fsdp" not in s}
    dp_mesh = mesh["dcn", "fsdp"] if sizes["dcn"] > 1 else mesh["fsdp"]

    def placement(p):
        return Shard(by_param[p].index("fsdp"))

    kw = dict(mesh=dp_mesh, shard_placement_fn=placement,
              ignored_params=ignored)
    for stack in ("blocks", "img_cond_blocks"):
        for blk in getattr(model, stack, ()):
            fully_shard(blk, **kw)
    fully_shard(model, **kw)
    # the samplers' trunk-only entry unshards like forward
    register_fsdp_forward_method(model, "hidden")
    return model


# ---------------------------------------------------------------------------
# The rank's place on the mesh
# ---------------------------------------------------------------------------

@dataclass
class MeshLayout:
    """dp_rank / dp_size: the rank's index and the size of the
    ("dcn", "fsdp") data-parallel axes; seq_rank / seq_size and seq_group:
    its "seq" axis; dp_group: its data-parallel group (the ranks with the
    same "seq" index); fsdp_rank / fsdp_group: its "fsdp" index and axis
    (the ranks that hold the other shards of its parameters)."""
    sizes: Dict[str, int]
    dp_rank: int = 0
    dp_size: int = 1
    seq_rank: int = 0
    seq_size: int = 1
    fsdp_rank: int = 0
    dp_group: object = None
    seq_group: object = None
    fsdp_group: object = None
    mesh: object = None

    @classmethod
    def of(cls, mesh) -> "MeshLayout":
        sizes = mesh_sizes(mesh)
        check_ported_axes(sizes)
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        return cls(sizes=sizes,
                   dp_rank=coord["dcn"] * sizes["fsdp"] + coord["fsdp"],
                   dp_size=sizes["dcn"] * sizes["fsdp"],
                   seq_rank=coord["seq"], seq_size=sizes["seq"],
                   fsdp_rank=coord["fsdp"],
                   dp_group=mesh["dcn", "fsdp"]._flatten().get_group()
                   if sizes["dcn"] > 1 else mesh["fsdp"].get_group(),
                   seq_group=mesh["seq"].get_group(),
                   fsdp_group=mesh["fsdp"].get_group(), mesh=mesh)

    @property
    def sharded(self) -> bool:
        """Whether the parameters are FSDP-sharded (fsdp > 1)."""
        return self.sizes["fsdp"] > 1

    def rows(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's rows of a global batch tensor (JAX's
        batch_sharding on the leading dim)."""
        if x is None or self.dp_size == 1:
            return x
        b = x.shape[0]
        if b % self.dp_size:
            raise ValueError(f"batch {b} not divisible by the data-parallel "
                             f"width {self.dp_size}")
        n = b // self.dp_size
        return x[self.dp_rank * n:(self.dp_rank + 1) * n]

    def chunk_bounds(self, length: int) -> Tuple[int, int]:
        """[start, end) of this rank's chunk of a length-L sequence."""
        if length % self.seq_size:
            raise ValueError(f"sequence {length} not divisible by seq axis "
                             f"size {self.seq_size}")
        lc = length // self.seq_size
        return self.seq_rank * lc, (self.seq_rank + 1) * lc

    def local(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's block of a (B, L, ...) global tensor: its rows and
        its L-chunk (JAX's logits_constraint)."""
        if x is None:
            return None
        x = self.rows(x)
        if self.seq_size == 1:
            return x
        lo, hi = self.chunk_bounds(x.shape[1])
        return x[:, lo:hi]

    def gather_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's (b, lc, ...) block back into the global (B, L, ...)
        tensor on every rank, for a consumer every rank runs alike (the
        loss); differentiable: the backward keeps this rank's block."""
        from unidisc_tpu_torch.parallel.comm import GatherReplicated
        if self.seq_size > 1:
            x = GatherReplicated.apply(x, self.seq_group, 1)
        if self.dp_size > 1:
            x = GatherReplicated.apply(x, self.dp_group, 0)
        return x

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows back into the global batch on every rank."""
        from unidisc_tpu_torch.parallel.comm import all_gather
        return all_gather(x, self.dp_group, 0) if self.dp_size > 1 else x
