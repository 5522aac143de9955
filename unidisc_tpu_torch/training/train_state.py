"""Train state, loss and the train step (port of
``unidisc_tpu/training/train_state.py``; the optimizers are in
``training/optimizers.py``).

One step: t-sampling, corruption, forward, SUBS, NELBO, backward, clip,
the optimizer, the non-finite-loss skip and the EMA. The optimizers follow
optax's semantics, not ``torch.optim``'s (``training/optimizers.py``): a
step whose loss is not finite leaves the parameters and the whole optimizer
state, counts included, as they were (``TrainState.step`` still advances
and the EMA still moves toward the unchanged parameters).

The step updates the state in place. The parameters are the model's own
``nn.Parameter``s (or, for LoRA, the adapter's), made views of one flat
buffer; the moments and the EMA are flat buffers too (one element per
parameter element, in the parameters' order), so the update and the EMA
run on whole buffers. The skip is a ``torch.where`` on the device; nothing
is read back to the host.

Random numbers: the JAX step derives its draws from a key; here they come
from a ``torch.Generator`` passed to the step, or are injected as tensors
(``draws``, the names listed in ``diffusion/forward_process.py``), which
is how the tests feed both packages the same numbers. The dropout masks
of a step (``model.dropout`` > 0) are drawn from the generator's seed, a
host integer (``initial_seed()``; the Trainer seeds the generator each
step), or injected as ``draws["dropout"]`` (``models/dit.py``).

Ported: the ``subs`` parameterization with importance sampling, change of
variables, joint AR+NAR and the AR-LLM loss; ``ar`` with the row flip,
``ar_inpainting`` (and its forced rate) and the modality dropout, over a
per-token ``rope_index``; the legacy ``sedd`` and ``d3pm`` losses
(``diffusion/legacy.py``); label tokens (``trainer.add_label``, with
``first_token_dropout``); the five optimizers with the four LR schedules
and muP; remat (``trainer.use_gradient_checkpointing``); training-mode
dropout; gradient accumulation; low-precision params with an fp32 EMA; a
``param_map`` (the LoRA merge, ``training/lora.py``); packed interleaved
batches (``data/interleaved.py``: ``sample_ids`` and ``rope_index`` go to
the DIT, and under ``trainer.interleaved`` the CFG masking takes whole
blocks of a sample); MoE models (in training, every objective's loss
plus ``trainer.moe_aux_weight`` x the balance auxiliary, as in JAX) and
``img_cond`` models (the ``x_cond`` batch key goes to the forward). A
``cond_label`` model has no train step: the JAX step passes no ``label``
to the DIT, which asserts one, so the port raises a ``ValueError``.

On a device mesh (``make_train_step(..., mesh=)``, a
``parallel/mesh.py::MeshLayout``; one process per device) every rank holds
the whole global batch (``utils/dist.py::host_batch_to_global``) and
computes everything before the model on it, draws included, so each rank
sees the draws of the one-rank step. The model runs on the rank's rows
(the "dcn" x "fsdp" axes) and, with a "seq" axis, its L-chunk under
``parallel/seq_parallel.py`` (the attention a ring), and returns the
logits of the rank's block. Every objective takes its per-token quantity
on that block against the global tensors cut to it (``_block``,
``_rows``) and gathers it back into the global (B, L) tensor
(``_gathered``): subs' log-probability, sedd's score entropy, d3pm's
per-token loss, the AR-LLM and joint AR+NAR cross-entropy, and ``ar``'s
next-token loss, whose targets are the whole sequence shifted by one
before the cut (``next_token_targets``: under "seq" a chunk's last
position predicts the next chunk's first token). So the loss and the
metrics are the one-rank step's, normalized by global counts, on every
rank. Under "pp" the DIT's blocks run as a GPipe pipeline over the
rank's rows (``parallel/pipeline.py``), under "tensor" megatron-style,
and under "ep" (or any data-parallel or "seq" width) an MoE model routes
over the global batch (``models/moe.py``). The gradient of a rank is then
its part of the whole, summed over the axes whose ranks compute different
parts of the loss (``_mesh_grad_parts``): by FSDP2's reduce-scatter (an
average over the data-parallel ranks, scaled back by their count) and a
sum over "seq" for the FSDP-sharded parameters, by one all-reduce over
the ("dcn", "fsdp", "seq") ranks for the rest; never over "tensor",
"pp" or "ep". The gradient norm of the clip is that of the whole
gradient, and the skip agrees on every rank, the loss being the same
everywhere. The state (the moments, the EMA) is over the parameters the
rank holds (its FSDP shards, its stage's blocks, its head shards and
experts); the optimizers' rules that read a whole leaf run on those
parts through ``training/leaf_shards.py`` (Adafactor's statistics as
partial sums, Muon's matrices gathered, muP's whole shapes).
``state_dict`` gathers the state whole (the one-rank checkpoint format,
Adafactor's factored moments and the flat buffers included) and
``load_state_dict`` takes the rank's part of a whole one, so a run dir
resumes on one rank or on a mesh. With ``low_precision_params`` the
parameters are bf16 before FSDP2 lays them out (``shard_train_step``).
LoRA on a mesh: the base is laid out and frozen, the adapter whole on
every rank, the merge written into each rank's part of the base
(``training/lora.py::LoraParamMap``) and the adapter's gradient summed
from the parts (``_lora_mesh_grads``). Under "pp" the MoE balance
auxiliary is zero, as in JAX (the stage body does not carry it out).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import (TYPE_CHECKING, Dict, List, NamedTuple, Optional,
                    Sequence, Union)

import torch
import torch.nn as nn
from torch.func import functional_call

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.diffusion.forward_process import (Draws,
                                                         draw_uniform,
                                                         q_xt, sample_t)
from unidisc_tpu_torch.diffusion.legacy import (d3pm_loss,
                                                d3pm_parameterization,
                                                score_entropy,
                                                sedd_parameterization)
from unidisc_tpu_torch.diffusion.loss import (LossOutput, ar_llm_token_nll,
                                              ar_loss_from_nll, nelbo_loss,
                                              nelbo_weighting)
from unidisc_tpu_torch.diffusion.noise import get_noise
from unidisc_tpu_torch.diffusion.subs import subs_log_p_at
from unidisc_tpu_torch.training.leaf_shards import LeafShards
from unidisc_tpu_torch.training.optimizers import (  # noqa: F401
    AdamState, ClippedAdamW, GenericOptState, OptState, flat_views,
    make_lr_schedule, make_optimizer)

if TYPE_CHECKING:
    from unidisc_tpu_torch.parallel.mesh import MeshLayout

Params = Dict[str, torch.Tensor]


def flatten(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


@torch.no_grad()
def flat_parameters(params: Params) -> torch.Tensor:
    """Moves the tensors of `params` into one flat buffer, in their order,
    and makes each a view of it; returns the buffer."""
    dtypes = {p.dtype for p in params.values()}
    if len(dtypes) != 1:
        raise ValueError(f"parameters of one dtype expected, got {dtypes}")
    flat = flatten(params.values())
    for p, view in zip(params.values(), flat_views(flat, params).values()):
        p.data = view
    return flat


@dataclass
class TrainState:
    step: torch.Tensor    # () int64
    params: Params        # the trained parameters, views of `flat`
    flat: torch.Tensor    # the parameters, updated in place
    opt_state: Union[OptState, GenericOptState]
    ema: torch.Tensor     # flat fp32 EMA in the order of params
    # on a mesh: the rank's place, and the torch dim of each FSDP-sharded
    # parameter's shard; `params` are then the rank's shards (FSDP's own
    # storage, which `flat` is copied into after each update)
    mesh: Optional["MeshLayout"] = None
    shard_dims: Optional[Dict[str, int]] = None
    # on a mesh: what parallel/mesh.py::shard_model kept on the rank (its
    # "tensor" / "ep" parts, its pipeline stage's blocks); `params` are
    # then the parameters the rank holds
    shards: Optional["MeshShards"] = None

    @property
    def ema_params(self) -> Params:
        return flat_views(self.ema, self.params)

    def _local_state_dict(self) -> dict:
        sd = {"step": self.step, "params": dict(self.params),
              "ema_params": self.ema_params}
        opt = self.opt_state
        if isinstance(opt, OptState):
            sd.update({"adam_count": opt.adam.count,
                       "mu": flat_views(opt.adam.mu, self.params),
                       "nu": flat_views(opt.adam.nu, self.params),
                       "schedule_count": opt.schedule_count})
        else:
            sd["opt_state"] = opt.tensors()
        return sd

    def state_dict(self) -> dict:
        """Tensors by parameter name (views of the flat buffers). AdamW's
        moments are saved by parameter name; the other optimizers' state
        under "opt_state" by buffer name (flat buffers whole, Adafactor's
        factored moments by flax leaf). On a mesh every rank calls it: the
        shards are gathered whole."""
        sd = self._local_state_dict()
        if self.shards is None:
            return sd
        for key in ("params", "ema_params", "mu", "nu"):
            if key in sd:
                sd[key] = self.shards.gather(sd[key], self.mesh,
                                             self.shard_dims or {})
        if "opt_state" in sd:
            sd["opt_state"] = {k: self._opt_tensor(k, t, whole=True)
                               for k, t in sd["opt_state"].items()}
        return sd

    def _opt_tensor(self, name: str, t: torch.Tensor,
                    whole: bool) -> torch.Tensor:
        """On a mesh: an optimizer state tensor of the rank made whole
        (whole=True), or the rank's part of a whole one. A flat buffer
        goes by parameter (the one-rank order, ``shards.shapes``), a
        factored moment by the splits of its flax leaf."""
        from unidisc_tpu_torch.training.optimizers import buffer_dims
        if t.dim() == 0:
            return t
        kind, _, key = name[len("buffer/"):].partition("/")
        if key:
            leaves = self.opt_state.leaves
            dims = buffer_dims(kind, leaves.shapes[key])
            return (leaves.gather if whole else leaves.take)(t, key, dims)
        shard_dims = self.shard_dims or {}
        if whole:
            parts = self.shards.gather(flat_views(t, self.params), self.mesh,
                                       shard_dims)
            return flatten(parts[n] for n in self.shards.shapes)
        views = flat_views(t, {n: torch.empty(s, device="meta")
                               for n, s in self.shards.shapes.items()})
        mine = self.shards.scatter(views, self.mesh, shard_dims)
        return flatten(mine[n] for n in self.params)

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Copy a state_dict into this state's tensors, in place (on a
        mesh, the rank's shard of each whole tensor)."""
        if self.shards is not None:
            sd = dict(sd)
            for key in ("params", "ema_params", "mu", "nu"):
                if key in sd:
                    missing = set(self.shards.shapes) - set(sd[key])
                    if missing:
                        raise KeyError(f"{key}: missing {sorted(missing)}")
                    sd[key] = self.shards.scatter(sd[key], self.mesh,
                                                  self.shard_dims or {})
            if "opt_state" in sd:
                sd["opt_state"] = {k: self._opt_tensor(k, t, whole=False)
                                   for k, t in sd["opt_state"].items()}
        self._load_local(sd)
        if self.shard_dims:
            # the parameters were written in place (FSDP's storage): the
            # flat buffer follows them
            self.flat.copy_(flatten(self.params.values()))

    @torch.no_grad()
    def sync_shards(self) -> None:
        """FSDP: copy `flat` into the shards the model runs with."""
        views = flat_views(self.flat, self.params)
        torch._foreach_copy_([self.params[n] for n in views],
                             list(views.values()))

    def _load_local(self, sd: dict) -> None:
        mine = self._local_state_dict()
        for key in ("step", "adam_count", "schedule_count"):
            if key in mine:
                mine[key].copy_(sd[key])
        for key in ("params", "ema_params", "mu", "nu", "opt_state"):
            if key not in mine:
                continue
            if key not in sd:
                raise KeyError(f"the state_dict has no {key!r} (saved by "
                               f"another optimizer?)")
            have, got = set(mine[key]), set(sd[key])
            if have != got:
                raise KeyError(f"{key}: missing {sorted(have - got)}, "
                               f"unexpected {sorted(got - have)}")
            for name, dst in mine[key].items():
                dst.copy_(sd[key][name])


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    txt_loss: torch.Tensor
    img_loss: torch.Tensor
    nll_sum: torch.Tensor
    token_count: torch.Tensor
    grad_norm: torch.Tensor
    nll_txt_sum: torch.Tensor
    txt_count: torch.Tensor
    nll_img_sum: torch.Tensor
    img_count: torch.Tensor


def _split_metrics(out: LossOutput, modality, loss, grad_norm) -> StepMetrics:
    mask = out.token_mask
    if modality is None:
        txt_mask = mask
        img_mask = torch.zeros_like(mask)
    else:
        if modality.shape[-1] < mask.shape[-1]:
            # ar_inpainting's doubled rows; the JAX step fails here
            modality = torch.cat([modality, modality], dim=-1)
        if modality.shape[-1] != mask.shape[-1]:
            modality = modality[..., -mask.shape[-1]:]
        txt_mask = mask & (modality == 0)
        img_mask = mask & (modality == 1)
    return StepMetrics(
        loss=loss, txt_loss=out.txt_loss, img_loss=out.img_loss,
        nll_sum=(out.nlls * mask).sum(), token_count=mask.sum(),
        grad_norm=grad_norm,
        nll_txt_sum=(out.nlls * txt_mask).sum(), txt_count=txt_mask.sum(),
        nll_img_sum=(out.nlls * img_mask).sum(), img_count=img_mask.sum())


@torch.no_grad()
def init_train_state(config: Config,
                     model: Union[nn.Module, Params],
                     mesh=None) -> TrainState:
    """The train state over `model`'s own parameters (move the model to its
    device first), or over a dict of tensors (a LoRA adapter: they become
    ``nn.Parameter``s). With low_precision_params the parameters (and so
    the moments) become bf16 in place; the EMA stays fp32, because at
    decay 0.9999 the increment is far below bf16's resolution. mesh: the
    rank's MeshLayout, the model already sharded by
    ``parallel/mesh.py::params_shardings`` when fsdp > 1: the state is then
    over the rank's shards."""
    shards = None
    if mesh is not None:
        shards = model.mesh_shards
    if mesh is not None and mesh.sharded:
        # low_precision_params: shard_train_step made the parameters bf16
        # before FSDP2 laid them out
        params, shard_dims = {}, {}
        for name, p in model.named_parameters():
            if not shards.held(name, mesh):
                continue
            if hasattr(p, "to_local"):
                shard_dims[name] = p.placements[-1].dim
                params[name] = p.to_local()
            else:
                params[name] = p
        flat = flatten(params.values())
        leaves = LeafShards(params, shards, mesh, shard_dims)
        return TrainState(step=torch.zeros((), dtype=torch.int64,
                                           device=flat.device),
                          params=params, flat=flat,
                          opt_state=make_optimizer(config).init(
                              flat, params, leaves=leaves),
                          ema=flat.to(torch.float32, copy=True), mesh=mesh,
                          shard_dims=shard_dims, shards=shards)
    if mesh is not None:
        params = {n: p for n, p in model.named_parameters()
                  if shards.held(n, mesh)}
    elif isinstance(model, nn.Module):
        params = dict(model.named_parameters())
    else:
        params = {k: v if isinstance(v, nn.Parameter) else nn.Parameter(v)
                  for k, v in model.items()}
    if config.trainer.low_precision_params:
        for p in params.values():
            if p.is_floating_point():
                p.data = p.data.to(torch.bfloat16)
    flat = flat_parameters(params)
    leaves = None if mesh is None else LeafShards(params, shards, mesh, {})
    return TrainState(step=torch.zeros((), dtype=torch.int64,
                                       device=flat.device),
                      params=params, flat=flat,
                      opt_state=make_optimizer(config).init(
                          flat, params, leaves=leaves),
                      ema=flat.to(torch.float32, copy=True), mesh=mesh,
                      shards=shards)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _block(mesh, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The rank's block of a global (B, L, ...) tensor on a mesh (its rows
    and its L-chunk, the block its logits cover); `x` itself on one
    rank."""
    return x if mesh is None or x is None else mesh.local(x)


def _rows(mesh, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The rank's rows of a per-row (B, ...) tensor on a mesh."""
    return x if mesh is None or x is None else mesh.rows(x)


def _gathered(mesh, x: torch.Tensor) -> torch.Tensor:
    """A per-token quantity of the rank's block back in the global (B, L)
    tensor on every rank (differentiable); `x` itself on one rank."""
    return x if mesh is None else mesh.gather_tokens(x)


def next_token_targets(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """x (B, L) shifted left by one along the whole sequence, cut to the
    rank's block: position i holds token i + 1, the last position its own
    token (a target the loss drops). Under "seq" the last position of
    chunk r so pairs with the first token of chunk r + 1."""
    return _block(mesh, torch.cat([x[:, 1:], x[:, -1:]], 1))


def _ar_batch_loss(config: Config, apply_fn, params, x0, modality,
                   attention_mask, extra, *, train, draws,
                   generator, mesh=None) -> LossOutput:
    """The ``ar`` parameterization: the optional row flip, ar_inpainting's
    [corrupted || clean] doubling or the modality dropout, then the
    next-token loss: the logits at position i against token i + 1, taken
    per token on the logits' block (``next_token_targets``) and gathered,
    the last position dropped."""
    t_cfg = config.trainer
    m_cfg = config.model
    b, dev = x0.shape[0], x0.device
    flip_rows = train and t_cfg.rand_flip_ar_prob is not None
    if (t_cfg.ar_inpainting or flip_rows) and "rope_index" not in extra \
            and m_cfg.img_resolutions is None:
        # flipped or doubled rows leave the fixed [txt | img] layout: each
        # token keeps its position within its block (JAX defines the
        # doubled path so; the reference's reads NaN-padded rope rows)
        base = torch.cat([torch.arange(m_cfg.txt_length, device=dev),
                          torch.arange(max(m_cfg.img_length, 0),
                                       device=dev)])
        extra["rope_index"] = base[None, :].expand(b, -1)
        if modality is None:
            modality = torch.zeros_like(x0)
    if flip_rows:
        flip = draw_uniform(draws, "flip", (b,), generator,
                            dev) < t_cfg.rand_flip_ar_prob
        tl = m_cfg.txt_length

        def _flip(a):
            return torch.where(flip[:, None],
                               torch.cat([a[:, tl:], a[:, :tl]], 1), a)
        x0 = _flip(x0)
        if modality is not None:
            modality = _flip(modality)
        if attention_mask is not None:
            attention_mask = _flip(attention_mask)
        if "rope_index" in extra:
            extra["rope_index"] = _flip(extra["rope_index"])
    if t_cfg.ar_inpainting:
        # [corrupted || clean] at an antithetic per-row rate; the loss
        # covers only the clean half
        u = draw_uniform(draws, "t", (b,), generator, dev)
        offset = torch.arange(b, dtype=torch.float32, device=dev) / b
        t_inp = torch.remainder(u / b + offset, 1.0)
        if t_cfg.ar_inpainting_force_val is not None:
            t_inp = torch.full_like(t_inp, t_cfg.ar_inpainting_force_val)
        half = x0.shape[1]
        x0 = torch.cat([x0, x0], dim=1)
        move = draw_uniform(draws, "inpaint", tuple(x0.shape), generator,
                            dev) < t_inp[:, None]
        move[:, half:] = False
        x0 = torch.where(move, m_cfg.mask_index, x0)
        if modality is not None:
            modality = torch.cat([modality, modality], dim=1)
        if "rope_index" in extra:
            extra["rope_index"] = torch.cat([extra["rope_index"]] * 2, 1)
        base_mask = attention_mask if attention_mask is not None else \
            torch.ones((b, half), dtype=torch.bool, device=dev)
        attention_mask = torch.cat([torch.zeros_like(base_mask),
                                    torch.ones_like(base_mask)], dim=1)
    elif train and t_cfg.rand_ar_modality_dropout is not None:
        # mask the row's first modality and drop it from the loss: the AR
        # counterpart of CFG's unconditional rows
        if modality is None:
            raise ValueError("rand_ar_modality_dropout needs modality")
        drop = draw_uniform(draws, "ar_drop", (b,), generator,
                            dev) < t_cfg.rand_ar_modality_dropout
        first = (modality == modality[:, :1]) & drop[:, None]
        x0 = torch.where(first, m_cfg.mask_index, x0)
        if attention_mask is None:
            attention_mask = torch.ones(x0.shape, dtype=torch.bool,
                                        device=dev)
        attention_mask = torch.where(first, False, attention_mask)
    logits = apply_fn(params, x0, None, modality, train, **extra)
    restrict = m_cfg.force_argmax_valid_indices
    nll = _gathered(mesh, ar_llm_token_nll(
        logits, next_token_targets(x0, mesh), m_cfg.mask_index,
        modality=None if modality is None
        else next_token_targets(modality, mesh),
        text_vocab_size=m_cfg.text_vocab_size if restrict else None))
    return ar_loss_from_nll(nll[:, :-1], None if attention_mask is None
                            else attention_mask[:, 1:])


def _legacy_loss(loss_tok, attention_mask) -> LossOutput:
    """The sedd and d3pm losses: the per-token loss averaged over the
    attended tokens."""
    if attention_mask is None:
        attention_mask = torch.ones_like(loss_tok, dtype=torch.bool)
    total = (loss_tok * attention_mask).sum() \
        / attention_mask.sum().clamp(min=1)
    zero = torch.zeros_like(total)
    return LossOutput(loss=total, nlls=loss_tok * attention_mask,
                      token_mask=attention_mask, txt_loss=zero,
                      img_loss=zero)


def dropout_arg(config: Config, train: bool, draws: Draws,
                generator: Optional[torch.Generator], micro: int = 0):
    """The DIT's ``dropout=`` for one forward: the injected masks
    (draws["dropout"]), or a seed from the generator's seed and the
    microbatch index (host integers: nothing is read from the device), or
    None (no dropout, or the model draws its own seed)."""
    if not train or config.model.dropout <= 0:
        return None
    if draws is not None and "dropout" in draws:
        return draws["dropout"]
    if generator is not None:
        return (generator.initial_seed() * 1_000_033 + micro) % (2 ** 63)
    return None


def compute_batch_loss(config: Config, apply_fn, params, batch, *,
                       train: bool = True, step=None,
                       generator: Optional[torch.Generator] = None,
                       draws: Draws = None, micro: int = 0,
                       mesh=None) -> LossOutput:
    """t-sample -> corrupt -> backbone -> SUBS -> NELBO (or the sedd / d3pm
    loss); for ``ar``, the next-token loss (``_ar_batch_loss``). A MoE
    model's training loss adds ``trainer.moe_aux_weight`` x its balance
    auxiliary (the eval loss does not).

    batch: dict with input_ids (B, L) and optionally modality (B, L),
    attention_mask (B, L), rope_index (B, L), sample_ids (B, L) (a packed
    batch, -1 on padding), label (B,) (the class id that
    ``trainer.add_label`` writes at position 0) and x_cond (B, Lc) (the
    conditioning image of an img_cond model), as tensors on the model's
    device. params: the parameters apply_fn runs with (None: the model's
    own). micro: the microbatch index (it varies the dropout seed).
    mesh: the rank's MeshLayout, with apply_fn from ``mesh_apply_fn``
    (module docstring).
    """
    m_cfg = config.model
    if m_cfg.cond_label:
        raise ValueError("model.cond_label has no train step: the JAX step "
                         "passes no label to the DIT, which asserts one")
    if m_cfg.img_cond and "x_cond" not in batch:
        raise ValueError("model.img_cond=True but the batch has no "
                         "'x_cond' stream")
    auxes = []
    if m_cfg.moe_experts > 0 and train:
        forward = apply_fn

        def apply_fn(*args, **kw):
            logits, aux = forward(*args, return_moe_aux=True, **kw)
            auxes.append(aux)
            return logits
    out = _batch_loss(config, apply_fn, params, batch, train=train,
                      step=step, generator=generator, draws=draws,
                      micro=micro, mesh=mesh)
    if auxes:
        out = out._replace(loss=out.loss + config.trainer.moe_aux_weight
                           * auxes[-1])
    return out


def _batch_loss(config: Config, apply_fn, params, batch, *, train, step,
                generator, draws, micro, mesh=None) -> LossOutput:
    t_cfg = config.trainer
    m_cfg = config.model
    noise = get_noise(config.noise)
    x0 = batch["input_ids"].long()
    modality = batch.get("modality")
    if modality is not None:
        modality = modality.long()
    attention_mask = batch.get("attention_mask")
    if attention_mask is not None:
        attention_mask = attention_mask.bool()
    extra = {}
    if "sample_ids" in batch:
        extra["sample_ids"] = batch["sample_ids"].to(torch.int32)
    if "rope_index" in batch:
        extra["rope_index"] = batch["rope_index"].long()
    if "x_cond" in batch:
        extra["x_cond"] = batch["x_cond"].long()
    drop = dropout_arg(config, train, draws, generator, micro)
    if drop is not None:
        extra["dropout"] = drop
    b = x0.shape[0]
    dev = x0.device
    if t_cfg.add_label and "label" in batch:
        # label-as-token conditioning: the class id + label_shift at
        # position 0, left out of the loss through the attention mask;
        # q_xt never corrupts it (first_token_dropout re-masks it)
        x0 = x0.clone()
        x0[:, 0] = batch["label"].long() + m_cfg.label_shift
        if attention_mask is None:
            attention_mask = torch.ones(x0.shape, dtype=torch.bool,
                                        device=dev)
        attention_mask = attention_mask.clone()
        attention_mask[:, 0] = False
    if t_cfg.parameterization == "ar":
        return _ar_batch_loss(config, apply_fn, params, x0, modality,
                              attention_mask, extra, train=train,
                              draws=draws, generator=generator, mesh=mesh)

    t = sample_t(b, antithetic=t_cfg.antithetic_sampling,
                 sampling_eps=t_cfg.sampling_eps,
                 force_timestep=t_cfg.force_timestep, draws=draws,
                 generator=generator, device=dev)
    if t_cfg.importance_sampling and hasattr(
            noise, "importance_sampling_transformation"):
        t = noise.importance_sampling_transformation(t)
    cov_weight = None
    if t_cfg.change_of_variables:
        f_T = math.log1p(-math.exp(-float(noise.sigma_max)))
        f_0 = math.log1p(-math.exp(-float(noise.sigma_min)))
        move_chance = torch.exp(f_0 + t * (f_T - f_0))
        sigma = t
        dsigma = noise.rate(t)
    else:
        sigma = noise.total(t)
        dsigma = noise.rate(t)
        move_chance = 1 - torch.exp(-sigma)
    if t_cfg.change_of_variables or t_cfg.importance_sampling:
        cov_weight = math.log1p(-math.exp(-float(noise.sigma_min)))

    restrict = m_cfg.force_argmax_valid_indices
    corrupted = q_xt(
        x0, move_chance, m_cfg.mask_index, modality=modality,
        mask_entire_modality=t_cfg.mask_entire_modality if train else None,
        multimodal=t_cfg.multimodal_batches,
        # interleaved batches mask whole blocks of a sample for CFG
        sample_ids=extra.get("sample_ids") if t_cfg.interleaved else None,
        protect_first=t_cfg.add_label,
        first_token_dropout=t_cfg.first_token_dropout if train else None,
        diffusion_mode=t_cfg.discrete_diffusion_mode,
        text_vocab_size=m_cfg.text_vocab_size if restrict else None,
        vocab_size=m_cfg.vocab_size, draws=draws, generator=generator)

    xt = corrupted.xt
    batch_ignore = corrupted.batch_ignore
    joint_mask = None
    if train and t_cfg.joint_ar_nar_prob is not None:
        p_final = t_cfg.joint_ar_nar_prob
        w = t_cfg.joint_ar_nar_prob_warmup_steps
        if w and step is not None:
            step_t = torch.as_tensor(step, device=dev).float()
            frac = torch.clamp(step_t / max(1, w), max=1.0)
            p_cur = 1.0 + (p_final - 1.0) * frac
        else:
            p_cur = p_final
        joint_mask = draw_uniform(draws, "joint", (b,), generator,
                                  dev) < p_cur
        xt = torch.where(joint_mask[:, None], x0, xt)
        batch_ignore = batch_ignore | joint_mask

    # on a mesh the logits are the rank's block: each per-token quantity
    # is taken on the block and gathered, so the loss below is the global
    # one on every rank
    logits = apply_fn(params, xt, sigma, modality, train, **extra)
    xt_b, x0_b = _block(mesh, xt), _block(mesh, x0)
    if t_cfg.parameterization == "sedd":
        xc_b, sigma_b = _block(mesh, corrupted.xt), _rows(mesh, sigma)
        log_score = sedd_parameterization(logits.float(), xc_b, sigma_b)
        ent = _gathered(mesh, score_entropy(log_score, sigma_b, xc_b, x0_b,
                                            m_cfg.mask_index))
        return _legacy_loss(dsigma[:, None] * ent, attention_mask)
    if t_cfg.parameterization == "d3pm":
        log_p = d3pm_parameterization(logits.float())
        return _legacy_loss(_gathered(mesh, d3pm_loss(
            log_p, _block(mesh, corrupted.xt), x0_b, _rows(mesh, t), T=1000,
            mask_index=m_cfg.mask_index)), attention_mask)
    log_p_theta = _gathered(mesh, subs_log_p_at(
        logits, xt_b, x0_b, m_cfg.mask_index,
        modality=_block(mesh, modality) if restrict else None,
        text_vocab_size=m_cfg.text_vocab_size))
    out = nelbo_loss(
        log_p_theta, x0, sigma, dsigma, attention_mask=attention_mask,
        modality=modality, batch_ignore=batch_ignore, cov_weight=cov_weight,
        no_ce_weighting=t_cfg.no_ce_weighting,
        softmin_snr=t_cfg.softmin_snr,
        text_loss_weight=None if joint_mask is not None
        else t_cfg.text_loss_weight,
        img_loss_weight=None if joint_mask is not None
        else t_cfg.img_loss_weight)

    if joint_mask is not None or t_cfg.ar_llm_loss:
        ar_tok = _gathered(mesh, ar_llm_token_nll(
            logits.float(), x0_b, m_cfg.mask_index,
            modality=_block(mesh, modality) if restrict else None,
            text_vocab_size=m_cfg.text_vocab_size))
        attn = attention_mask if attention_mask is not None else \
            torch.ones(x0.shape, dtype=torch.bool, device=dev)
        if joint_mask is not None:
            if t_cfg.no_ce_weighting:
                nar_tok = -log_p_theta
            else:
                nar_tok = -log_p_theta * nelbo_weighting(
                    sigma, dsigma, t_cfg.softmin_snr)[:, None]
            ar_w = joint_mask.float().mean()
            mixed = torch.where(joint_mask[:, None], ar_tok * ar_w,
                                nar_tok * (1.0 - ar_w))
            loss = (mixed * attn).sum() / attn.sum().clamp(min=1)
        else:
            valid = (xt == m_cfg.mask_index) & attn
            loss = (ar_tok * valid).sum() / valid.sum().clamp(min=1)
        out = out._replace(loss=loss)
    return out


# ---------------------------------------------------------------------------
# Train / eval steps
# ---------------------------------------------------------------------------

def make_apply_fn(config: Config, model: nn.Module):
    """fn(params, x, sigma, modality, train, **extra) -> logits: the model
    run with `params` (a name -> tensor mapping; None for its own
    parameters), in train or eval mode; sigma None means zeros; extra
    carries rope_index and dropout. Remat is the model's own setting
    (``DIT(remat=)``, which the Trainer takes from
    trainer.use_gradient_checkpointing, as JAX's ``init_dit(remat=)``)."""

    def apply_fn(params, x, sigma, modality, train, **extra):
        model.train(train)
        if sigma is None:
            sigma = torch.zeros((x.shape[0],), dtype=torch.float32,
                                device=x.device)
        if params is None:
            return model(x, sigma, modality=modality, **extra)
        return functional_call(model, params, (x, sigma),
                               {"modality": modality, **extra})
    return apply_fn


def _chunks(batch: dict, accum: int) -> List[dict]:
    b = batch["input_ids"].shape[0]
    if b % accum:
        raise ValueError(f"batch {b} not divisible by grad_accum_steps "
                         f"{accum}")
    mb = b // accum
    return [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            for i in range(accum)]


def check_mesh_step(config: Config, param_map=None) -> None:
    """Raise for what the mesh step cannot take. The step takes every
    objective, optimizer and mode of the one-rank step; a param_map must
    say how it changes the model's parameters (the LoRA map,
    ``training/lora.py::LoraParamMap``: the merge is written into each
    rank's part of the base)."""
    if param_map is not None and not hasattr(param_map, "bind"):
        raise ValueError("a param_map on a mesh must be a training/lora.py::"
                         "LoraParamMap (its additive delta is laid out as "
                         "the base is)")


def mesh_apply_fn(config: Config, model: nn.Module, mesh):
    """apply_fn for the mesh step: takes the global batch's tensors, runs
    the model on the rank's rows (and, with "seq", its L-chunk, the
    attention a ring) and returns the logits of the rank's block. Dropout
    masks are the global draw's slice: a seed draws each block's global
    masks (``models/dit.py::dropout_masks``, the one-rank draw) and keeps
    the rank's block; an img_cond trunk block's masks are (B, Lc, D), of
    which the rank keeps its rows (the trunk is not L-sharded); given masks
    are sliced alike."""
    from unidisc_tpu_torch.models.dit import block_dropout_seed, dropout_masks
    from unidisc_tpu_torch.parallel.pipeline import pipeline_parallel
    from unidisc_tpu_torch.parallel.seq_parallel import sequence_parallel
    base = make_apply_fn(config, model)
    m_cfg = config.model
    n_main = len(model.blocks)

    def apply_fn(params, x, sigma, modality, train, **extra):
        drop = extra.pop("dropout", None)
        cross = m_cfg.img_cond and extra.get("x_cond") is not None
        if isinstance(drop, int):
            seed, d = drop, m_cfg.hidden_size
            drop = [dropout_masks(tuple(x.shape) + (d,), m_cfg.dropout,
                                  block_dropout_seed(seed, i), x.device,
                                  3 if cross else 2) for i in range(n_main)]
            if cross:
                shape = tuple(extra["x_cond"].shape) + (d,)
                drop += [dropout_masks(shape, m_cfg.dropout,
                                       block_dropout_seed(seed, n_main + j),
                                       x.device)
                         for j in range(len(model.img_cond_blocks))]
        if drop is not None:
            extra["dropout"] = [
                tuple((mesh.local(k) if i < n_main else mesh.rows(k))
                      .contiguous() for k in masks)
                for i, masks in enumerate(drop)]
        for k in ("sample_ids", "rope_index", "x_cond"):
            if k in extra:
                extra[k] = mesh.rows(extra[k])
        with sequence_parallel(mesh, gather=False), \
                pipeline_parallel(mesh, config.mesh.pp_microbatches):
            return base(params, mesh.rows(x), mesh.rows(sigma),
                        mesh.rows(modality), train, **extra)
    return apply_fn


def _counted(name: str, mesh, shards, shard_dims) -> bool:
    """Whether this rank counts its part of parameter `name` once over the
    world: it is at index 0 of every axis that does not split the
    parameter (the ranks of such an axis hold the same part)."""
    from unidisc_tpu_torch.parallel.mesh import AXES
    split = {"fsdp"} if name in shard_dims else set()
    if name in shards.parts:
        split.add(shards.parts[name].axis)
    if name in shards.stage_of:
        split.add("pp")
    coord = {"dcn": mesh.dp_rank // mesh.sizes["fsdp"],
             "fsdp": mesh.fsdp_rank, "tensor": mesh.tensor.rank,
             "seq": mesh.seq_rank, "pp": mesh.pp.rank, "ep": mesh.ep.rank}
    return all(coord[a] == 0 for a in AXES if a not in split)


@torch.no_grad()
def _mesh_grad_parts(model: nn.Module, names: Sequence[str], mesh,
                     shard_dims: Dict[str, int]) -> Dict[str, torch.Tensor]:
    """The rank's gradient of the whole loss for each of `names` (model
    parameters the rank holds), summed over the axes whose ranks compute
    different parts of the loss, the data-parallel rows and the "seq"
    chunks: FSDP2 has averaged the sharded parameters' over the
    data-parallel ranks (scaled back to a sum, then summed over "seq");
    the rest are summed over the ("dcn", "fsdp", "seq") ranks. It is not
    summed over "tensor", "pp" or "ep", whose ranks hold the same rows:
    where such a rank computes a part of a parameter's gradient (a
    column-parallel input, a pipeline's input, the MoE exchange), the
    model's ``comm.copy_to`` has summed it already, and the parameters
    they split are each rank's own."""
    from unidisc_tpu_torch.parallel.comm import all_reduce
    named = dict(model.named_parameters())

    def grad(n):
        g = named[n].grad
        if g is None:
            p = named[n]
            return torch.zeros_like(p.to_local() if n in shard_dims else p)
        return g.to_local() * mesh.dp_size if n in shard_dims else g

    grads = {n: grad(n) for n in names}
    parts = {}
    for sh, group in ((True, mesh.seq_group), (False, mesh.grad_group)):
        mine = [n for n in names if (n in shard_dims) == sh]
        if mine:
            flat = all_reduce(flatten([grads[n] for n in mine]), group)
            for n, t in zip(mine, flat.split([grads[n].numel()
                                              for n in mine])):
                parts[n] = t.view_as(grads[n])
    return {n: parts[n] for n in names}


@torch.no_grad()
def _reduce_mesh_grads(state: TrainState, model: nn.Module):
    """The rank's flat gradient of the whole loss, in the order of
    state.params (``_mesh_grad_parts``), and the norm of the whole
    gradient: it counts each parameter's elements once, on the ranks at
    index 0 of every axis that does not split it (``_counted``)."""
    import torch.distributed as dist

    from unidisc_tpu_torch.parallel.comm import all_reduce
    mesh, shards = state.mesh, state.shards
    shard_dims = state.shard_dims or {}
    names = list(state.params)
    parts = _mesh_grad_parts(model, names, mesh, shard_dims)
    sq = torch.zeros((), dtype=torch.float32, device=state.flat.device)
    for n in names:
        if _counted(n, mesh, shards, shard_dims):
            sq = sq + parts[n].float().square().sum()
    sq = all_reduce(sq, dist.group.WORLD)
    return torch.cat([parts[n].reshape(-1) for n in names]), torch.sqrt(sq)


def _lora_mesh_grads(state: TrainState, model: nn.Module, param_map,
                     deltas: Dict[str, torch.Tensor], mesh) -> torch.Tensor:
    """The flat gradient of the adapter (state.params, whole on every
    rank) from a mesh backward through the merged base. Each rank holds
    its part of every merged weight (``LoraParamMap.write``), so the
    chain rule from its part of the weight's gradient (``_mesh_grad_parts``)
    to the adapter gives the rank's part of the adapter's gradient; the
    parts are summed over the world, each counted once (``_counted``).
    So, unlike ``_reduce_mesh_grads``, the sum runs over "tensor" and
    "pp" too: a tensor rank's split delta (its heads' rows of B @ A) and
    a pp stage's blocks give only a part of the adapter's gradient, where a
    parameter those axes split is each rank's own. The sum is the
    gradient of the one-rank step on every rank."""
    import torch.distributed as dist

    from unidisc_tpu_torch.parallel.comm import all_reduce
    shards, shard_dims = model.mesh_shards, param_map.shard_dims
    parts = _mesh_grad_parts(model, list(deltas), mesh, shard_dims)
    mine = [n for n in deltas if _counted(n, mesh, shards, shard_dims)]
    adapter = list(state.params.values())
    grads = [None] * len(adapter)
    if mine:
        grads = torch.autograd.grad(
            [deltas[n] for n in mine],
            adapter, grad_outputs=[parts[n].view_as(deltas[n])
                                   .to(deltas[n].dtype) for n in mine],
            allow_unused=True)
    flat = flatten(torch.zeros_like(p) if g is None else g
                   for p, g in zip(adapter, grads))
    return all_reduce(flat, dist.group.WORLD)


def make_train_step(config: Config, model: nn.Module, param_map=None,
                    mesh=None):
    """The train step fn(state, batch, generator=None, draws=None) ->
    (state, metrics). It updates `state` in place and returns it.

    With grad_accum_steps > 1 the batch is split into that many equal
    microbatches whose gradients are averaged; `draws` is then a sequence
    with one mapping per microbatch.

    param_map: fn(state.params) -> the parameters the model runs with
    (the LoRA merge, ``training/lora.py``): state.params are then the
    adapter's and only they get gradients. On a mesh the LoRA map writes
    each rank's part of the merged weights into the model before the
    forward (``LoraParamMap.write``) and the adapter's gradient comes from
    theirs (``_lora_mesh_grads``).

    mesh: the rank's MeshLayout (module docstring); every rank calls the
    step with the same global batch and draws."""
    opt = make_optimizer(config)
    if mesh is not None:
        check_mesh_step(config, param_map)
        apply_fn = mesh_apply_fn(config, model, mesh)
    else:
        apply_fn = make_apply_fn(config, model)
    ema_decay = config.trainer.ema_decay
    accum = config.trainer.grad_accum_steps
    # on a mesh the model runs with its own parameters: the LoRA merge is
    # written into them
    maps = param_map is not None and mesh is None

    def grads_of(state, batch, generator, draws, micro=0):
        run_with = param_map(state.params) if maps else None
        out = compute_batch_loss(config, apply_fn, run_with, batch,
                                 train=True, step=state.step,
                                 generator=generator, draws=draws,
                                 micro=micro, mesh=mesh)
        if mesh is not None:
            # FSDP2 reduces its shards' gradients in the backward, hooked
            # on .grad accumulation: the mesh step accumulates .grad
            out.loss.backward()
            return out, None
        return out, flatten(torch.autograd.grad(out.loss,
                                                list(state.params.values())))

    def train_step(state: TrainState, batch: dict,
                   generator: Optional[torch.Generator] = None,
                   draws: Union[Draws, Sequence[Draws]] = None):
        deltas = None
        if mesh is not None:
            model.zero_grad(set_to_none=True)
            if param_map is not None:
                deltas = param_map.write(state.params)
        if accum > 1:
            micro = _chunks(batch, accum)
            per = draws if draws is not None else [None] * accum
            outs, grads = [], None
            for i, (chunk, d) in enumerate(zip(micro, per)):
                out, g = grads_of(state, chunk, generator, d, i)
                outs.append(out)
                if g is not None:
                    grads = g if grads is None else grads + g
            if grads is not None:
                grads = grads / accum
            loss = sum(o.loss.detach() for o in outs) / accum
            out = LossOutput(
                loss=loss,
                nlls=torch.cat([o.nlls for o in outs]),
                token_mask=torch.cat([o.token_mask for o in outs]),
                txt_loss=torch.stack([o.txt_loss for o in outs]).mean(),
                img_loss=torch.stack([o.img_loss for o in outs]).mean())
        else:
            out, grads = grads_of(state, batch, generator, draws)
            loss = out.loss.detach()
        g_norm = None
        if deltas is not None:
            grads = _lora_mesh_grads(state, model, param_map, deltas, mesh)
            if accum > 1:
                grads = grads / accum
        elif mesh is not None:
            grads, g_norm = _reduce_mesh_grads(state, model)
            if accum > 1:
                grads, g_norm = grads / accum, g_norm / accum
        ok = torch.isfinite(loss)
        grad_norm = opt.apply(state.flat, grads, state.opt_state, ok,
                              params=state.params, g_norm=g_norm)
        if state.shard_dims:
            state.sync_shards()
        with torch.no_grad():
            state.ema.copy_(state.ema * ema_decay
                            + state.flat.to(state.ema.dtype)
                            * (1 - ema_decay))
            state.step += 1
        out = LossOutput(*(x.detach() for x in out))
        return state, _split_metrics(out, batch.get("modality"), loss,
                                     grad_norm)

    return train_step


def shard_train_step(config: Config, model: nn.Module, mesh,
                     param_map=None, adapter=None):
    """The train step on a DeviceMesh (``parallel/mesh.py::make_mesh``):
    the model (on its device) laid out by the rule (FSDP2 where fsdp > 1),
    the train state over the rank's shards and the mesh step. Returns
    (train_step, state, the rank's MeshLayout), as JAX's shard_train_step
    returns (the jitted step, the sharded state, the batch sharding).

    With low_precision_params the model's parameters become bf16 before
    the layout (FSDP2 then shards bf16 parameters; the EMA stays fp32).
    LoRA: `param_map` a ``training/lora.py::LoraParamMap`` over the model's
    (whole) base and `adapter` its adapter (drawn from the whole base):
    the base is laid out and frozen, the map bound to the rank's part of
    it, and the state is the adapter's, whole on every rank."""
    from unidisc_tpu_torch.parallel.mesh import MeshLayout, params_shardings
    layout = MeshLayout.of(mesh)
    if config.trainer.low_precision_params:
        with torch.no_grad():
            for p in model.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(torch.bfloat16)
    params_shardings(model, mesh, layout)
    if param_map is not None:
        if adapter is None:
            raise ValueError("LoRA on a mesh needs the adapter")
        param_map.bind(model, layout, adapter)
        state = init_train_state(config, adapter)
    else:
        state = init_train_state(config, model, mesh=layout)
    return (make_train_step(config, model, param_map, mesh=layout), state,
            layout)


def make_eval_step(config: Config, model: nn.Module, use_ema: bool = True,
                   param_map=None, mesh=None):
    """fn(state, batch, generator=None, draws=None) -> StepMetrics with the
    eval loss (no entire-modality masking), under no_grad, with the EMA
    parameters (or the live ones), through param_map when given. On a mesh
    (the rank's MeshLayout) the model runs as in the mesh step, the EMA
    copied into its parameters for the call (with LoRA, the merge of the
    adapter's EMA written into the base)."""
    if mesh is not None:
        return _mesh_eval_step(config, model, use_ema, mesh, param_map)
    apply_fn = make_apply_fn(config, model)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict,
                  generator: Optional[torch.Generator] = None,
                  draws: Draws = None) -> StepMetrics:
        params = state.ema_params if use_ema else \
            (None if param_map is None else state.params)
        if param_map is not None:
            params = param_map(params)
        out = compute_batch_loss(config, apply_fn, params, batch,
                                 train=False, generator=generator,
                                 draws=draws)
        return _split_metrics(out, batch.get("modality"), out.loss,
                              torch.zeros((), device=out.loss.device))
    return eval_step


def _mesh_eval_step(config: Config, model: nn.Module, use_ema: bool, mesh,
                    param_map=None):
    apply_fn = mesh_apply_fn(config, model, mesh)
    if param_map is not None:
        check_mesh_step(config, param_map)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict,
                  generator: Optional[torch.Generator] = None,
                  draws: Draws = None) -> StepMetrics:
        if param_map is not None:
            # the merge is written anew before every train step
            param_map.write(state.ema_params if use_ema else state.params)
        live = state.flat.clone() if use_ema and param_map is None else None
        if live is not None:
            state.flat.copy_(state.ema.to(state.flat.dtype))
            if state.shard_dims:
                state.sync_shards()
        try:
            out = compute_batch_loss(config, apply_fn, None, batch,
                                     train=False, generator=generator,
                                     draws=draws, mesh=mesh)
        finally:
            if live is not None:
                state.flat.copy_(live)
                if state.shard_dims:
                    state.sync_shards()
        return _split_metrics(out, batch.get("modality"), out.loss,
                              torch.zeros((), device=out.loss.device))
    return eval_step
