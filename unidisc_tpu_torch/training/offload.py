"""Host-offloaded fp32-master training (port of
``unidisc_tpu/training/offload.py``).

The working weights live on the card in bf16; everything the forward and
backward never touch (the fp32 master copy, the optimizer moments, the
EMA) lives in pinned host memory, as ``host_offload_chunks`` flat fp32
chunks of C elements each (C rounded up to a multiple of 128; the last
chunk zero-padded). The master keeps the fp32 update quality that
``low_precision_params`` gives up.

One step:

  1. the forward and backward on the bf16 weights; the global norm of the
     bf16 gradients in fp32 and the clip scale (clip / norm when norm >
     clip), on the card;
  2. per chunk k: its master, moments and EMA copied host -> card on a
     side stream, the chunk's gradient fragment (its slice of the
     gradients, in fp32, times the clip scale), the fused AdamW or Lion
     update (``fused_update``: elementwise torch ops, exact optax
     semantics; the JAX package runs it outside any Pallas kernel too),
     the non-finite skip as a device ``torch.where``, the EMA of the new
     master, the new bf16 working weights written into the parameters'
     flat buffer, and the chunk copied card -> host on the side stream.
     Two staging slots on the card alternate: chunk k + 1's upload runs
     while chunk k updates, chunk k's download while chunk k + 1 updates;
     events order each copy after what it needs, so no staging slot is
     overwritten before its download has left and the host buffers are
     only read (checkpointing) after a synchronize.
  3. the optimizer count advances where the loss was finite (it drives
     the LR and the bias correction, as optax's count does).

Only the chunks cross PCIe: ~16 bytes a parameter each way a step. The
card holds the bf16 weights and gradients and two staging slots (8 x C x
4 bytes).

Exclusions, as in JAX (``config.py`` validates them): Adafactor and Muon
(per-leaf shapes), muP (per-leaf multipliers), LoRA, low_precision_params
and gradient accumulation.

On the CPU (the tests) the "host" chunks are plain CPU tensors and the
same arithmetic runs without streams.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.diffusion.loss import LossOutput
from unidisc_tpu_torch.training.optimizers import (flat_views,
                                                   make_lr_schedule)
from unidisc_tpu_torch.training.train_state import (_split_metrics,
                                                    compute_batch_loss,
                                                    flat_parameters,
                                                    make_apply_fn)

SUPPORTED_OPTIMIZERS = ("adamw", "lion")
_FIELDS = ("masters", "mus", "nus", "emas")


@dataclass(frozen=True)
class FlatSpec:
    """The parameters <-> flat chunks mapping: the parameters' names and
    shapes in their order, K chunks of C elements (K * C >= total)."""
    names: tuple
    shapes: tuple
    chunks: int
    chunk_size: int

    @property
    def total(self) -> int:
        return sum(int(torch.Size(s).numel()) for s in self.shapes)

    def bounds(self, k: int):
        lo = k * self.chunk_size
        return lo, min(lo + self.chunk_size, self.total)

    def to_dict(self) -> dict:
        return {"names": list(self.names),
                "shapes": [list(s) for s in self.shapes],
                "chunks": self.chunks, "chunk_size": self.chunk_size}

    @staticmethod
    def from_dict(d: dict) -> "FlatSpec":
        return FlatSpec(tuple(d["names"]), tuple(tuple(s) for s in
                                                 d["shapes"]),
                        int(d["chunks"]), int(d["chunk_size"]))


def make_flat_spec(params: Dict[str, torch.Tensor], chunks: int) -> FlatSpec:
    total = sum(p.numel() for p in params.values())
    size = -(-total // chunks)
    size = -(-size // 128) * 128
    return FlatSpec(tuple(params), tuple(tuple(p.shape)
                                         for p in params.values()),
                    chunks, size)


def fused_update(config: Config, m, mu, nu, g32, count):
    """One flat chunk's optimizer update at optax count `count` (the
    applied updates so far), in the JAX offload's own arithmetic. Returns
    (new master, new mu, new nu)."""
    t = config.trainer
    lr = make_lr_schedule(config)(count)
    s1 = (count + 1).float()
    if t.optimizer == "adamw":
        mu2 = t.beta1 * mu + (1.0 - t.beta1) * g32
        nu2 = t.beta2 * nu + (1.0 - t.beta2) * g32 * g32
        mu_hat = mu2 / (1.0 - torch.pow(t.beta1, s1))
        nu_hat = nu2 / (1.0 - torch.pow(t.beta2, s1))
        upd = mu_hat / (torch.sqrt(nu_hat) + t.opt_eps) + t.weight_decay * m
        return m - lr * upd, mu2, nu2
    if t.optimizer == "lion":
        direction = torch.sign(t.beta1 * mu + (1.0 - t.beta1) * g32)
        mu2 = t.beta2 * mu + (1.0 - t.beta2) * g32
        upd = direction + t.weight_decay * m
        return m - lr * upd, mu2, nu
    raise ValueError(f"host offload supports {SUPPORTED_OPTIMIZERS}, not "
                     f"{t.optimizer!r} (flat chunks hold no per-leaf "
                     f"shapes)")


@dataclass
class OffloadTrainState:
    step: torch.Tensor        # () int64, every attempted step
    opt_count: torch.Tensor   # () int32, the applied updates
    params: Dict[str, nn.Parameter]   # the bf16 working weights
    work: torch.Tensor        # their flat buffer, on the card
    masters: List[torch.Tensor]       # K x fp32 (C,), host
    mus: List[torch.Tensor]
    nus: List[torch.Tensor]
    emas: List[torch.Tensor]
    spec: FlatSpec

    def sync(self) -> None:
        """Wait for the chunks' downloads before the host reads them."""
        if self.work.is_cuda:
            torch.cuda.synchronize(self.work.device)

    def state_dict(self) -> dict:
        self.sync()
        sd = {"step": self.step, "opt_count": self.opt_count,
              "offload_spec": self.spec.to_dict()}
        for f in _FIELDS:
            sd[f] = {str(k): t for k, t in enumerate(getattr(self, f))}
        return sd

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Copy a state_dict in place: the chunks host to host (nothing of
        the fp32 state is staged on the card), then the working weights
        bf16(master), one chunk at a time."""
        if FlatSpec.from_dict(sd["offload_spec"]) != self.spec:
            raise ValueError("the checkpoint's flat layout differs from "
                             "this model's")
        self.sync()
        self.step.copy_(sd["step"])
        self.opt_count.copy_(sd["opt_count"])
        for f in _FIELDS:
            for k, t in enumerate(getattr(self, f)):
                t.copy_(sd[f][str(k)])
        for k in range(self.spec.chunks):
            lo, hi = self.spec.bounds(k)
            self.work[lo:hi].copy_(self.masters[k][:hi - lo].to(
                self.work.device, non_blocking=True))

    def gathered(self, field: str = "emas") -> Dict[str, torch.Tensor]:
        """The fp32 parameters of one host field (the EMA by default) by
        name, on the host."""
        self.sync()
        return gather(getattr(self, field), self.spec)

    @property
    def ema_params(self) -> Dict[str, torch.Tensor]:
        return self.gathered("emas")


def gather(chunks, spec: FlatSpec) -> Dict[str, torch.Tensor]:
    """fp32 parameters by name from K flat chunks (host tensors)."""
    flat = torch.cat([c.reshape(-1) for c in chunks])[:spec.total]
    return {n: v.clone() for n, v in flat_views(flat, dict(zip(
        spec.names, (torch.empty(s, device="meta")
                     for s in spec.shapes)))).items()}


def gather_state_dict(sd: dict, field: str = "emas") -> Dict[str,
                                                              torch.Tensor]:
    """``gather`` over a saved offload state_dict (serving reads the
    EMA of a run dir without building the state)."""
    spec = FlatSpec.from_dict(sd["offload_spec"])
    return gather([sd[field][str(k)] for k in range(spec.chunks)], spec)


def _host_buffer(n: int, device) -> torch.Tensor:
    pin = torch.device(device).type == "cuda"
    return torch.zeros(n, dtype=torch.float32, pin_memory=pin)


@torch.no_grad()
def init_offload_state(config: Config, model: nn.Module, device,
                       chunks: Optional[int] = None) -> OffloadTrainState:
    """`model` holds the fp32 initial parameters (on the host): they
    become the master and the EMA, in pinned host chunks; the model then
    becomes bf16 on `device` (the working weights)."""
    t = config.trainer
    if t.optimizer not in SUPPORTED_OPTIMIZERS:
        raise ValueError(f"host offload supports {SUPPORTED_OPTIMIZERS}; "
                         f"got {t.optimizer!r}")
    if config.model.mup:
        raise ValueError("host offload excludes model.mup")
    params = dict(model.named_parameters())
    spec = make_flat_spec(params, chunks or t.host_offload_chunks)
    flat32 = torch.cat([p.detach().float().cpu().reshape(-1)
                        for p in params.values()])
    fields = {f: [] for f in _FIELDS}
    for k in range(spec.chunks):
        lo, hi = spec.bounds(k)
        for f in _FIELDS:
            buf = _host_buffer(spec.chunk_size, device)
            if f in ("masters", "emas"):
                buf[:hi - lo].copy_(flat32[lo:hi])
            fields[f].append(buf)
    del flat32
    for p in params.values():
        p.data = p.data.to(torch.bfloat16)
    model.to(device)
    params = dict(model.named_parameters())
    work = flat_parameters(params)
    return OffloadTrainState(
        step=torch.zeros((), dtype=torch.int64, device=work.device),
        opt_count=torch.zeros((), dtype=torch.int32, device=work.device),
        params=params, work=work, spec=spec, **fields)


def _chunk_grad(grads: List[torch.Tensor], spec: FlatSpec, k: int,
                scale: torch.Tensor) -> torch.Tensor:
    """Chunk k's fp32 gradient row (C,), zero-padded, times the clip
    scale, built from the fragments of the gradients it covers."""
    lo, hi = spec.bounds(k)
    parts, off = [], 0
    for g in grads:
        n = g.numel()
        a, b = max(lo, off), min(hi, off + n)
        if a < b:
            parts.append(g.reshape(-1)[a - off:b - off].float())
        off += n
    row = torch.cat(parts)
    if row.numel() < spec.chunk_size:
        row = torch.cat([row, row.new_zeros(spec.chunk_size - row.numel())])
    return row * scale


def make_offload_train_step(config: Config, model: nn.Module):
    """fn(state, batch, generator=None, draws=None) -> (state, metrics),
    updating `state` in place (module docstring)."""
    t_cfg = config.trainer
    if t_cfg.grad_accum_steps != 1:
        raise ValueError("the offload step does not accumulate gradients")
    apply_fn = make_apply_fn(config, model)
    ema_decay, clip = t_cfg.ema_decay, t_cfg.gradient_clip_val
    slots = {}

    def update_chunk(state, k, stage, grads, scale, ok):
        m, mu, nu, e = stage
        g32 = _chunk_grad(grads, state.spec, k, scale)
        n_m, n_mu, n_nu = fused_update(config, m, mu, nu, g32,
                                       state.opt_count)
        n_m = torch.where(ok, n_m, m)
        n_mu = torch.where(ok, n_mu, mu)
        n_nu = torch.where(ok, n_nu, nu)
        n_e = torch.where(ok, e * ema_decay + n_m * (1.0 - ema_decay), e)
        for dst, src in zip(stage, (n_m, n_mu, n_nu, n_e)):
            dst.copy_(src)
        lo, hi = state.spec.bounds(k)
        state.work[lo:hi].copy_(n_m[:hi - lo].to(torch.bfloat16))

    def host_of(state, k):
        return [getattr(state, f)[k] for f in _FIELDS]

    def step_cpu(state, grads, scale, ok):
        for k in range(state.spec.chunks):
            update_chunk(state, k, host_of(state, k), grads, scale, ok)

    def step_cuda(state, grads, scale, ok):
        dev = state.work.device
        c = state.spec.chunk_size
        if c not in slots:
            slots[c] = {
                "stage": [[torch.empty(c, dtype=torch.float32, device=dev)
                           for _ in _FIELDS] for _ in range(2)],
                "stream": torch.cuda.Stream(dev)}
        stage, copy = slots[c]["stage"], slots[c]["stream"]
        compute = torch.cuda.current_stream(dev)
        # the copy stream starts after the gradients exist: nothing it
        # reads or writes is touched by the forward and backward, but the
        # staging slots are written by the previous step's updates
        copy.wait_stream(compute)
        uploaded = [torch.cuda.Event() for _ in range(state.spec.chunks)]
        updated = [torch.cuda.Event() for _ in range(state.spec.chunks)]

        def upload(k):
            with torch.cuda.stream(copy):
                for dst, src in zip(stage[k % 2], host_of(state, k)):
                    dst.copy_(src, non_blocking=True)
                uploaded[k].record(copy)

        upload(0)
        for k in range(state.spec.chunks):
            if k + 1 < state.spec.chunks:
                upload(k + 1)
            compute.wait_event(uploaded[k])
            update_chunk(state, k, stage[k % 2], grads, scale, ok)
            updated[k].record(compute)
            with torch.cuda.stream(copy):
                copy.wait_event(updated[k])
                for dst, src in zip(host_of(state, k), stage[k % 2]):
                    dst.copy_(src, non_blocking=True)
        compute.wait_stream(copy)

    def train_step(state: OffloadTrainState, batch: dict,
                   generator: Optional[torch.Generator] = None, draws=None):
        out = compute_batch_loss(config, apply_fn, None, batch, train=True,
                                 step=state.step, generator=generator,
                                 draws=draws)
        grads = torch.autograd.grad(out.loss, list(state.params.values()))
        loss = out.loss.detach()
        with torch.no_grad():
            grad_norm = torch.sqrt(sum(torch.sum(g.float() * g.float())
                                       for g in grads))
            scale = torch.where(grad_norm > clip, clip / grad_norm,
                                torch.ones_like(grad_norm))
            ok = torch.isfinite(loss)
            if state.work.is_cuda:
                step_cuda(state, grads, scale, ok)
            else:
                step_cpu(state, grads, scale, ok)
            del grads
            state.opt_count += ok.to(torch.int32)
            state.step += 1
        out = LossOutput(*(x.detach() for x in out))
        return state, _split_metrics(out, batch.get("modality"), loss,
                                     grad_norm)

    return train_step
