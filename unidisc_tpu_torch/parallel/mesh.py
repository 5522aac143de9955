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

``shard_model`` keeps on each rank only its part of the parameters
that "tensor", "pp" and "ep" split, where JAX's rule puts those axes:

* "pp": a rank keeps the DIT blocks of its stage, contiguous groups of
  n_blocks / pp (the rule's "pp" on the stacked layer axis); the other
  blocks' parameters become empty tensors;
* "tensor": a main block keeps its head shard of each megatron leaf:
  ``attn_qkv`` the rank's heads' rows of each of q, k and v (the weight's
  3 x dim rows are [q | k | v], each head-major, so the shard is three
  blocks, not the contiguous block the rule names), ``mlp.0`` and
  ``adaLN_modulation`` a contiguous block of rows (column-parallel),
  ``attn_out`` and ``mlp.2`` a block of columns (row-parallel). The rule
  also names ``sigma_map``'s ``mlp_0`` and the head's
  ``adaLN_modulation``; the port keeps those two whole on every tensor
  rank, which computes them alike;
* "ep": an MoE block keeps its experts' ``w1``, ``b1``, ``w2``, ``b2``
  (E / ep of them).

An int8 W8A8 model (``model.quant="int8"``) is quantized whole, before
``shard_model`` (``ops/quant.py::quantize_model`` refuses a laid-out
model): a row-parallel weight's per-channel scale is a max over the whole
K, so a rank's ``weight_q`` and ``scale`` are slices of the one-device
tensors. ``shard_model`` then splits ``QLinear``'s buffers as it splits
parameters: a pp rank drops the other stages' ``weight_q`` and ``scale``;
under "tensor" ``attn_qkv`` keeps its heads' rows of q, k and v and
``mlp.0`` its rows (``weight_q``, ``scale`` and the bias), ``attn_out``
and ``mlp.2`` the columns of their K-slice (``weight_q``; their scale and
bias stay whole); under "ep" only the experts split, which stay in floating
point as in JAX, and the int8 attention and head stay whole. The blocks run
the int8 products split so (``models/dit.py::DDiTBlock``).

It also tells the modules the groups they compute over (the blocks'
tensor group, the MoE layers' data-parallel and "ep" groups), and records
on the model what it kept (``MeshShards``), which the train state reads to
gather a whole state dict and to take a rank's part of one.

``params_shardings`` is ``shard_model`` and then FSDP2: ``fully_shard``
on every DIT block the rank keeps and then at the root, over the ("dcn",
"fsdp") sub-mesh, with ``shard_placement_fn`` putting each parameter's
shard on the torch dimension the rule names. With dcn > 1 that is HSDP:
replicated over "dcn", sharded over "fsdp", as JAX's batch spec
P(("dcn", "fsdp")) lays the data. A parameter the rule leaves unsharded
over "fsdp" (under ``MIN_SHARD_SIZE``, or with no dimension that
divides) is one of ``fully_shard``'s ``ignored_params``: the rank keeps
its part whole, and the train step sums its gradient itself.

``MeshLayout`` is the rank's place on the mesh: its data-parallel index
and size over ("dcn", "fsdp"), its "seq", "tensor", "pp" and "ep" indices
and groups, and the rank-local slicing and gathering that JAX's
``batch_sharding``, ``replicated`` and ``logits_constraint`` stand for: a
(B, L) batch's rows are split over the data-parallel ranks and L over
"seq"; "tensor", "pp" and "ep" ranks hold the same rows.

What the port does not run on a mesh raises ``NotImplementedError``
naming ROADMAP queue 1, item 9 (``check_mesh_model``): img_cond under
"tensor" (item 9c; under "pp" JAX's and the port's ``Config.validate``
refuse it with a ``ValueError``); "ep" inside a pipeline stage; an MoE
model under "seq" inside a pipeline stage.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from unidisc_tpu_torch.config import MeshConfig
from unidisc_tpu_torch.parallel.comm import Axis

AXES = ("dcn", "fsdp", "tensor", "seq", "pp", "ep")
# parameters smaller than this stay replicated
MIN_SHARD_SIZE = 2 ** 14


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
    """Raise for the axis combinations whose compute is a later slice."""
    if sizes.get("pp", 1) > 1 and sizes.get("ep", 1) > 1:
        raise NotImplementedError(
            "expert parallelism inside a pipeline stage (pp > 1 with ep > "
            "1) is not in the port yet (ROADMAP queue 1, item 9)")


def check_mesh_model(m, sizes: Mapping[str, int]) -> None:
    """Raise for a model configuration `m` (a ModelConfig) the mesh of
    axis sizes `sizes` cannot run (module docstring)."""
    check_ported_axes(sizes)
    tensor, pp, ep = (sizes.get(a, 1) for a in ("tensor", "pp", "ep"))
    later = [what for what, bad in (
        ("img_cond under tensor (item 9c)", m.img_cond and tensor > 1),
        ("MoE under seq inside a pipeline stage",
         m.moe_experts > 0 and pp > 1 and sizes.get("seq", 1) > 1),
    ) if bad]
    if later:
        raise NotImplementedError(f"{', '.join(later)} is not in the port "
                                  f"yet (ROADMAP queue 1, item 9)")
    if pp > 1 and m.n_blocks % pp:
        raise ValueError(f"model.n_blocks={m.n_blocks} not divisible by "
                         f"pp={pp}")
    if tensor > 1 and m.n_heads % tensor:
        raise ValueError(f"model.n_heads={m.n_heads} not divisible by "
                         f"tensor={tensor}")
    if ep > 1 and (m.moe_experts == 0 or m.moe_experts % ep):
        raise ValueError(f"ep={ep} needs model.moe_experts a multiple of "
                         f"it (got {m.moe_experts})")


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


@dataclass(frozen=True)
class Part:
    """A rank's part of a parameter that "tensor" or "ep" splits: the
    parameter is `parts` equal blocks along torch dim `dim` (3 for
    attn_qkv's [q | k | v]) and the rank keeps its 1 / size of each."""
    axis: str
    dim: int
    parts: int = 1

    def take(self, full: torch.Tensor, rank: int, size: int) -> torch.Tensor:
        return torch.cat([b.chunk(size, self.dim)[rank]
                          for b in full.chunk(self.parts, self.dim)],
                         self.dim)

    def join(self, shards: List[torch.Tensor]) -> torch.Tensor:
        """The whole parameter from every rank's part, in rank order."""
        each = [t.chunk(self.parts, self.dim) for t in shards]
        return torch.cat([each[r][i] for i in range(self.parts)
                          for r in range(len(shards))], self.dim)


# the parts of a main block's parameters under "tensor" and "ep"
_TENSOR_PARTS = {"attn_qkv.weight": Part("tensor", 0, 3),
                 "mlp.0.weight": Part("tensor", 0),
                 "adaLN_modulation.weight": Part("tensor", 0),
                 "attn_out.weight": Part("tensor", 1),
                 "mlp.2.weight": Part("tensor", 1)}
# an int8 block's parts under "tensor": its QLinear leaves split as the
# weights they replace (a row-parallel scale stays whole) and mlp.0's bias
# with its columns (a QLinear adds its own bias); adaLN_modulation stays
# floating point
_TENSOR_INT8_PARTS = {**_TENSOR_PARTS,
                      "attn_qkv.weight_q": Part("tensor", 0, 3),
                      "attn_qkv.scale": Part("tensor", 0, 3),
                      "mlp.0.weight_q": Part("tensor", 0),
                      "mlp.0.scale": Part("tensor", 0),
                      "mlp.0.bias": Part("tensor", 0),
                      "attn_out.weight_q": Part("tensor", 1),
                      "mlp.2.weight_q": Part("tensor", 1)}
_EP_PARTS = {f"moe.{n}": Part("ep", 0) for n in ("w1", "b1", "w2", "b2")}


@dataclass
class MeshShards:
    """What ``shard_model`` kept on a rank: `parts` the parameters (and
    an int8 model's ``QLinear`` buffers) it holds a "tensor" / "ep" part
    of, `stage_of` each block tensor's pipeline stage under pp > 1 (only
    its stage's ranks hold it), `shapes` every parameter's and int8
    buffer's whole shape."""
    parts: Dict[str, Part] = field(default_factory=dict)
    stage_of: Dict[str, int] = field(default_factory=dict)
    shapes: Dict[str, tuple] = field(default_factory=dict)

    def held(self, name: str, layout: "MeshLayout") -> bool:
        return self.stage_of.get(name, layout.pp.rank) == layout.pp.rank

    def gather(self, local: Mapping[str, torch.Tensor], layout: "MeshLayout",
               fsdp_dims: Mapping[str, int]) -> Dict[str, torch.Tensor]:
        """Every parameter whole, on every rank, from each rank's `local`
        tensors by name (its FSDP shards along `fsdp_dims`)."""
        from unidisc_tpu_torch.parallel.comm import all_gather, broadcast
        out = {}
        for name, t in local.items():
            t = t.detach()
            if name in fsdp_dims:
                t = all_gather(t, layout.fsdp_group, fsdp_dims[name])
            part = self.parts.get(name)
            if part is not None:
                t = part.join(list(all_gather(
                    t[None], layout.axis(part.axis).group, 0)))
            out[name] = t
        if layout.pp.size > 1:
            like = next(iter(local.values()))
            for stage in range(layout.pp.size):
                names = sorted(n for n, s in self.stage_of.items()
                               if s == stage)
                if stage == layout.pp.rank:
                    flat = torch.cat([out[n].reshape(-1) for n in names])
                else:
                    flat = like.new_empty(sum(math.prod(self.shapes[n])
                                              for n in names))
                flat = broadcast(flat, layout.pp.group, stage)
                for n, piece in zip(names, flat.split(
                        [math.prod(self.shapes[n]) for n in names])):
                    out[n] = piece.view(self.shapes[n])
        return out

    def scatter(self, whole: Mapping[str, torch.Tensor],
                layout: "MeshLayout", fsdp_dims: Mapping[str, int]
                ) -> Dict[str, torch.Tensor]:
        """The rank's tensors of a whole state (the inverse of gather),
        for the parameters it holds."""
        out = {}
        for name, t in whole.items():
            if not self.held(name, layout):
                continue
            part = self.parts.get(name)
            if part is not None:
                ax = layout.axis(part.axis)
                t = part.take(t, ax.rank, ax.size)
            if name in fsdp_dims:
                d, f = fsdp_dims[name], layout.sizes["fsdp"]
                t = t.narrow(d, layout.fsdp_rank * t.shape[d] // f,
                             t.shape[d] // f)
            out[name] = t
        return out


def _held_tensors(module: torch.nn.Module):
    """(name, tensor) of `module`'s parameters and its int8 ``QLinear``
    buffers (``weight_q``, ``scale``): what ``shard_model`` lays out."""
    from unidisc_tpu_torch.models.dit import QLinear
    yield from module.named_parameters()
    for prefix, sub in module.named_modules():
        if isinstance(sub, QLinear):
            for n, b in sub.named_buffers(recurse=False):
                yield (f"{prefix}.{n}" if prefix else n), b


def shard_model(model: torch.nn.Module, layout: "MeshLayout"):
    """Keep on this rank only its "pp" / "tensor" / "ep" part of `model`'s
    parameters and int8 buffers (module docstring), in place; set the
    blocks' tensor group and the MoE layers' data-parallel and "ep" groups;
    record ``model.mesh_shards``. Returns the model."""
    if getattr(model, "mesh_shards", None) is not None:
        raise ValueError("the model is already laid out on a mesh")
    check_mesh_model(model.cfg, layout.sizes)
    shards = MeshShards(shapes={n: tuple(p.shape)
                                for n, p in _held_tensors(model)})
    per = len(model.blocks) // layout.pp.size
    tp, ep = layout.tensor, layout.ep
    dp = Axis(layout.dp_group, layout.dp_rank, layout.dp_size)
    tensor_parts = _TENSOR_INT8_PARTS if model.cfg.quant == "int8" \
        else _TENSOR_PARTS
    with torch.no_grad():
        for i, blk in enumerate(model.blocks):
            for n, p in _held_tensors(blk):
                name = f"blocks.{i}.{n}"
                if layout.pp.size > 1:
                    shards.stage_of[name] = i // per
                    if i // per != layout.pp.rank:
                        p.data = p.data.new_empty(0)
                        continue
                part = (tensor_parts.get(n) if tp.size > 1 else None) \
                    or (_EP_PARTS.get(n) if ep.size > 1 else None)
                if part is not None:
                    shards.parts[name] = part
                    ax = layout.axis(part.axis)
                    p.data = part.take(p.data, ax.rank, ax.size).contiguous()
            if tp.size > 1:
                blk.tp = tp
            if model.cfg.moe_experts > 0 and (dp.size > 1 or ep.size > 1):
                blk.moe.dp, blk.moe.ep = dp, ep
    model.mesh_shards = shards
    return model


def params_shardings(model: torch.nn.Module, mesh,
                     layout: Optional["MeshLayout"] = None
                     ) -> torch.nn.Module:
    """``shard_model``, then FSDP2 over the ("dcn", "fsdp") sub-mesh (HSDP
    with dcn > 1): each DIT block the rank holds (and img_cond trunk
    block) its own group, then the root; the rule picks each parameter's
    shard dimension, and the parameters it leaves unsharded over "fsdp"
    are ignored by FSDP. Returns the model (sharded in place). A mesh with
    fsdp == 1 takes no FSDP."""
    from torch.distributed.fsdp import (fully_shard,
                                        register_fsdp_forward_method)
    from torch.distributed.tensor import Shard
    sizes = mesh_sizes(mesh)
    # the rule reads the whole shapes: before shard_model
    specs = param_specs(dict(model.named_parameters()), sizes)
    shard_model(model, layout if layout is not None else MeshLayout.of(mesh))
    if sizes["fsdp"] == 1:
        return model
    by_param = {p: specs[n] for n, p in model.named_parameters()}
    ignored = {p for p, s in by_param.items()
               if "fsdp" not in s or p.numel() == 0}
    dp_mesh = mesh["dcn", "fsdp"] if sizes["dcn"] > 1 else mesh["fsdp"]

    def placement(p):
        return Shard(by_param[p].index("fsdp"))

    kw = dict(mesh=dp_mesh, shard_placement_fn=placement,
              ignored_params=ignored)
    for stack in ("blocks", "img_cond_blocks"):
        for blk in getattr(model, stack, ()):
            if any(p.numel() for p in blk.parameters()):
                fully_shard(blk, **kw)
    fully_shard(model, **kw)
    # the samplers' trunk-only entry unshards like forward
    register_fsdp_forward_method(model, "hidden")
    return model


# ---------------------------------------------------------------------------
# The rank's place on the mesh
# ---------------------------------------------------------------------------

def _group(mesh, sizes, axes):
    """The process group over `axes` of `mesh` (flattened when several
    are larger than 1)."""
    big = tuple(a for a in axes if sizes[a] > 1)
    if len(big) > 1:
        return mesh[big]._flatten().get_group()
    return mesh[big[0] if big else axes[-1]].get_group()


@dataclass
class MeshLayout:
    """dp_rank / dp_size: the rank's index and the size of the
    ("dcn", "fsdp") data-parallel axes; seq_rank / seq_size and seq_group:
    its "seq" axis; dp_group: its data-parallel group (the ranks with the
    same other indices); fsdp_rank / fsdp_group: its "fsdp" index and axis
    (the ranks that hold the other shards of its parameters); tensor, pp
    and ep: its "tensor", "pp" and "ep" axes (``comm.Axis``); grad_group: the
    ("dcn", "fsdp", "seq") ranks, whose parts of the loss differ (the
    train step sums the gradients over it)."""
    sizes: Dict[str, int]
    dp_rank: int = 0
    dp_size: int = 1
    seq_rank: int = 0
    seq_size: int = 1
    fsdp_rank: int = 0
    tensor: Axis = Axis(None, 0, 1)
    pp: Axis = Axis(None, 0, 1)
    ep: Axis = Axis(None, 0, 1)
    dp_group: object = None
    seq_group: object = None
    fsdp_group: object = None
    grad_group: object = None
    mesh: object = None

    @classmethod
    def of(cls, mesh) -> "MeshLayout":
        sizes = mesh_sizes(mesh)
        check_ported_axes(sizes)
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))

        def axis(name):
            return Axis(mesh[name].get_group(), coord[name], sizes[name])
        return cls(sizes=sizes,
                   dp_rank=coord["dcn"] * sizes["fsdp"] + coord["fsdp"],
                   dp_size=sizes["dcn"] * sizes["fsdp"],
                   seq_rank=coord["seq"], seq_size=sizes["seq"],
                   fsdp_rank=coord["fsdp"],
                   tensor=axis("tensor"), pp=axis("pp"), ep=axis("ep"),
                   dp_group=_group(mesh, sizes, ("dcn", "fsdp")),
                   seq_group=mesh["seq"].get_group(),
                   fsdp_group=mesh["fsdp"].get_group(),
                   grad_group=_group(mesh, sizes, ("dcn", "fsdp", "seq")),
                   mesh=mesh)

    def axis(self, name: str) -> Axis:
        """The "tensor", "pp" or "ep" axis."""
        return {"tensor": self.tensor, "pp": self.pp, "ep": self.ep}[name]

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
