"""The step loop around the train step (port of
``unidisc_tpu/training/trainer.py``).

Host-side work is data feeding, metric logging and checkpointing. The port
trains on one device and computes in bf16, as the JAX trainer does.

* LoRA (``model.lora_rank`` > 0, ``training/lora.py``): the model holds
  the frozen base, from ``base_checkpoint`` (a port run dir: its EMA
  weights), ``base_params`` (a state_dict) or the seed; the train state is
  the adapter's, and every checkpoint also writes ``lora_adapter.npz`` in
  the JAX package's format (with the base run recorded in the meta).
* Host offload (``trainer.host_offload_optimizer``,
  ``training/offload.py``): bf16 working weights on the card, the fp32
  master, moments and EMA in pinned host chunks; validation runs on the
  working weights.
* SIGTERM or SIGUSR1 during ``fit`` sets a flag: the trainer checkpoints
  after the current step and stops (``fit`` then reports the signal, and
  the train CLI exits non-zero so that a supervisor relaunches it;
  ``training/supervisor.py``).

* A device mesh (``mesh=``, a ``DeviceMesh`` from ``parallel/mesh.py::
  make_mesh``; built from ``config.mesh`` when a process group of more
  than one rank is up): one process per device, every rank a Trainer.
  The loader of each rank yields its slice of the global batch
  (``utils/dist.py::host_local_batch_size`` rows), which
  ``host_batch_to_global`` assembles on every rank; the step is
  ``train_state.py``'s mesh step over every axis of ``config.mesh``
  (the model laid out by ``parallel/mesh.py::params_shardings``: a pp
  rank's stage, a tensor rank's head shards, an ep rank's experts, FSDP2
  over the rest when fsdp > 1).
  Validation is the mesh's too. Every rank gathers the state for a
  checkpoint and rank 0 writes it, in the one-rank format, so a run dir
  resumes on one rank or on a mesh; rank 0 logs ``metrics.jsonl``, rank
  r > 0 ``metrics.rank<r>.jsonl``. The start prints the parameters'
  ``param_hash``. fsdp > 1 on the card takes NCCL (a card per rank):
  FSDP2's collectives move device tensors, which a gloo group of ranks
  sharing one card cannot. LoRA on a mesh lays the frozen base out as the
  model is and keeps the adapter whole on every rank
  (``train_state.py::shard_train_step``); rank 0 writes
  ``lora_adapter.npz``, the file of the one-rank run. Host offload is a
  single-device mode, as in JAX: on a mesh it raises a ``ValueError``.

wandb raises.
"""

from __future__ import annotations

import json
import math
import os
import signal
import time
from typing import Iterator, Optional

import numpy as np
import torch

from unidisc_tpu_torch.config import Config
from unidisc_tpu_torch.device import resolve_device
from unidisc_tpu_torch.models.dit import DIT, count_params
from unidisc_tpu_torch.training.checkpoint import CheckpointManager
from unidisc_tpu_torch.training.train_state import (StepMetrics,
                                                    init_train_state,
                                                    make_eval_step,
                                                    make_train_step,
                                                    shard_train_step)
from unidisc_tpu_torch.utils import dist as udist
from unidisc_tpu_torch.utils.logging import MetricLogger
from unidisc_tpu_torch.utils.monitor import PhaseTimer, ThroughputMonitor

LN2 = math.log(2.0)


def metrics_to_host(metrics: StepMetrics) -> dict:
    """One device-to-host transfer for the whole metrics tuple."""
    vals = StepMetrics(*torch.stack(
        [m.detach().float().reshape(()) for m in metrics]).cpu().tolist())
    out = {"loss": vals.loss, "grad_norm": vals.grad_norm}
    nll = vals.nll_sum / max(vals.token_count, 1.0)
    out["nll"] = nll
    out["bpd"] = nll / LN2
    out["ppl"] = math.exp(min(nll, 50.0))
    if vals.txt_count > 0:
        t = vals.nll_txt_sum / vals.txt_count
        out["txt_nll"] = t
        out["txt_ppl"] = math.exp(min(t, 50.0))
    if vals.img_count > 0:
        i = vals.nll_img_sum / vals.img_count
        out["img_nll"] = i
        out["img_bpd"] = i / LN2
    return out


def _step_seed(base: int, step: int) -> int:
    """Seed of the generator for one step: the port's counterpart of
    fold_in(PRNGKey(base), step), so a resumed run draws what the
    uninterrupted run drew."""
    return (base * 1_000_003 + step) % (2 ** 63)


def validation_sums(eval_step, state, loader, max_batches: int, *,
                    seed: int, device, to_device,
                    draws=None) -> Optional[np.ndarray]:
    """The sums over up to max_batches loader batches (None for none) of
    (nll, tokens, text nll, text tokens, image nll, image tokens, loss, 1)
    under eval_step(state, to_device(batch), generator=, draws=): batch i
    draws from a generator seeded _step_seed(seed + 2, i), or from
    ``draws(i, rows)`` when given. Trainer.validate and eval_run share it,
    so the two read the same draws."""
    gen = torch.Generator(device=device)
    sums = None
    for i, batch in enumerate(loader):
        if i >= max_batches:
            break
        batch = to_device(batch)
        gen.manual_seed(_step_seed(seed + 2, i))
        m = eval_step(state, batch, generator=gen,
                      draws=None if draws is None else
                      draws(i, batch["input_ids"].shape[0]))
        cur = torch.stack([m.nll_sum.float(), m.token_count.float(),
                           m.nll_txt_sum.float(), m.txt_count.float(),
                           m.nll_img_sum.float(), m.img_count.float(),
                           m.loss.float()]).double().cpu().numpy()
        cur = np.append(cur, 1.0)
        sums = cur if sums is None else sums + cur
    return sums


def restore_base_params(run_dir: str, expect_like=None) -> dict:
    """A port run dir's EMA weights (CPU tensors by name), the frozen base
    of a LoRA run. The run must not itself be a LoRA run; with
    `expect_like` (a state_dict) the shapes must match it."""
    mgr = CheckpointManager(f"{run_dir}/checkpoints")
    snap = Config.from_json(json.dumps(mgr.read_meta()["config"]))
    if snap.model.lora_rank > 0:
        raise ValueError(f"{run_dir} is itself a LoRA run: point "
                         f"base_checkpoint at the full-parameter base run")
    sd = mgr.read_state()
    if snap.trainer.host_offload_optimizer:
        from unidisc_tpu_torch.training.offload import gather_state_dict
        params = gather_state_dict(sd)
    else:
        params = sd["ema_params"]
    if expect_like is not None:
        want = {k: tuple(v.shape) for k, v in expect_like.items()}
        got = {k: tuple(v.shape) for k, v in params.items()}
        if want != got:
            raise ValueError("the base checkpoint's architecture differs "
                             "from config.model: the LoRA run must use the "
                             "base run's model config")
    return params


class Trainer:
    def __init__(self, config: Config, run_dir: str, *, device="cuda",
                 log_every: int = 10, val_every: int = 0,
                 ckpt_every: int = 1000, max_ckpts: int = 3,
                 val_use_ema: bool = True, use_wandb: bool = False,
                 mesh=None, base_params=None,
                 base_checkpoint: Optional[str] = None):
        self.device = resolve_device(device)
        self.mesh, self.layout = self._mesh(config, mesh)
        self.config = config
        self.run_dir = run_dir
        self.log_every = log_every
        self.val_every = val_every
        self.ckpt_every = ckpt_every
        t_cfg, m_cfg = config.trainer, config.model

        model = DIT(m_cfg, compute_dtype=torch.bfloat16,
                    remat=t_cfg.use_gradient_checkpointing, init=False)
        model.reset_parameters(torch.Generator().manual_seed(config.seed))
        self.n_params = count_params(model)
        self.param_map = None
        self._lora_base_checkpoint = None
        self.host_offload = bool(t_cfg.host_offload_optimizer)
        if (base_params is not None or base_checkpoint is not None) \
                and m_cfg.lora_rank == 0:
            raise ValueError("base_params / base_checkpoint are the frozen "
                             "base of a LoRA run (model.lora_rank > 0)")
        if self.layout is not None:
            self.model = model.to(self.device)
            adapter = None
            if m_cfg.lora_rank > 0:
                # drawn from the whole base, then the base is laid out
                adapter = self._lora_init(base_params, base_checkpoint)
            self.train_step, self.state, _ = shard_train_step(
                config, self.model, self.mesh, param_map=self.param_map,
                adapter=adapter)
        elif self.host_offload:
            from unidisc_tpu_torch.training.offload import (
                init_offload_state, make_offload_train_step)
            self.state = init_offload_state(config, model, self.device)
            self.model = model
            self.train_step = make_offload_train_step(config, model)
            if val_use_ema:
                print("[trainer] host_offload_optimizer: validation uses "
                      "the live bf16 working weights (the EMA lives on the "
                      "host in chunks)")
            val_use_ema = False
        else:
            self.model = model.to(self.device)
            if m_cfg.lora_rank > 0:
                self.state = init_train_state(
                    config, self._lora_init(base_params, base_checkpoint))
            else:
                self.state = init_train_state(config, self.model)
            self.train_step = make_train_step(config, self.model,
                                              param_map=self.param_map)
        self.eval_step = make_eval_step(config, self.model,
                                        use_ema=val_use_ema,
                                        param_map=self.param_map,
                                        mesh=self.layout)
        self.generator = torch.Generator(device=self.device)
        self.ckpt = CheckpointManager(f"{run_dir}/checkpoints",
                                      max_to_keep=max_ckpts,
                                      save_interval_steps=ckpt_every)
        r = udist.rank()
        self.logger = MetricLogger(
            run_dir, use_wandb=use_wandb,
            console_every=log_every if r == 0 else 0,
            filename="metrics.jsonl" if r == 0 else f"metrics.rank{r}.jsonl")
        if self.layout is not None:
            udist.rprint(f"[trainer] mesh={self.layout.sizes} param_hash="
                         f"{udist.param_hash(self.state.params)}")
        self.monitor = ThroughputMonitor(self.n_params, device=self.device)
        self._last_saved = None
        self._stop = None

    def _mesh(self, config: Config, mesh):
        """(the DeviceMesh, the rank's MeshLayout), or (None, None) on one
        device."""
        if mesh is None and udist.world_size() > 1:
            from unidisc_tpu_torch.parallel.mesh import make_mesh
            mesh = make_mesh(config.mesh)
        if mesh is None:
            return None, None
        if config.trainer.host_offload_optimizer:
            # as the JAX Trainer asserts
            raise ValueError("host_offload_optimizer is a single-device "
                             "mode; use the FSDP mesh for multi-chip memory "
                             "scaling")
        from unidisc_tpu_torch.parallel.mesh import MeshLayout
        layout = MeshLayout.of(mesh)
        if layout.sharded and self.device.type == "cuda" \
                and torch.distributed.get_backend() != "nccl":
            raise ValueError("fsdp > 1 on the card needs NCCL, a card per "
                             "rank: FSDP2's collectives move device "
                             "tensors, which gloo cannot")
        return mesh, layout

    def _lora_init(self, base_params, base_checkpoint) -> dict:
        """Load the frozen base into self.model and return the adapter
        (on the device)."""
        from unidisc_tpu_torch.training.lora import (count_lora_params,
                                                     lora_from_config,
                                                     lora_param_map)
        cfg = self.config
        own = self.model.state_dict()
        if base_checkpoint is not None:
            if base_params is not None:
                raise ValueError("pass base_params or base_checkpoint, not "
                                 "both")
            base_params = restore_base_params(base_checkpoint,
                                              expect_like=own)
            self._lora_base_checkpoint = os.path.abspath(base_checkpoint)
        elif base_params is None and cfg.model.zero_linear_init:
            raise ValueError(
                "LoRA on a random-init base with zero_linear_init=True "
                "cannot learn: the frozen zero output head blocks every "
                "adapter gradient. Pass base_checkpoint= or base_params= (a "
                "pretrained base), or set model.zero_linear_init=False for "
                "a from-scratch smoke run.")
        elif base_params is None:
            print("[trainer] WARNING: LoRA over a RANDOM-INIT base (no "
                  "base_checkpoint/base_params): only rank-r directions "
                  "are trainable")
        if base_params is not None:
            self.model.load_state_dict(base_params)
        base = dict(self.model.named_parameters())
        for p in base.values():
            p.requires_grad_(False)
        adapter = lora_from_config(base, cfg.model, cfg.seed + 1)
        self.param_map = lora_param_map(base, alpha=cfg.model.lora_alpha,
                                        rank=cfg.model.lora_rank)
        print(f"[trainer] LoRA r={cfg.model.lora_rank}: "
              f"{count_lora_params(adapter):,} trainable / "
              f"{self.n_params:,} total params")
        return adapter

    def _to_device(self, batch: dict) -> dict:
        """A loader batch as device tensors; on a mesh the rank's slice
        assembled into the global batch first."""
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        if self.layout is not None:
            arrays = udist.host_batch_to_global(arrays)
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in arrays.items()}

    # ------------------------------------------------------------------
    def maybe_restore(self, loader=None) -> int:
        """Resume from the latest checkpoint if there is one; returns the
        step to continue from."""
        step = self.ckpt.latest_step()
        if step is None:
            return 0
        self.state, meta = self.ckpt.restore(self.state)
        if loader is not None and "loader" in meta and \
                hasattr(loader, "load_state_dict"):
            loader.load_state_dict(meta["loader"])
        print(f"[trainer] resumed from step {step}")
        return int(step)

    def _install_signal_handler(self):
        """SIGTERM / SIGUSR1 -> checkpoint after the current step, then
        stop. Returns the previous handlers (fit restores them)."""
        def handler(signum, frame):
            print(f"[trainer] signal {signum}: checkpointing then stopping",
                  flush=True)
            self._stop = signum
        old = {}
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                old[sig] = signal.signal(sig, handler)
            except (ValueError, OSError):
                pass      # not the main thread
        return old

    def fit(self, train_loader: Iterator, val_loader=None,
            max_steps: Optional[int] = None, *,
            overfit_first_batch: bool = False,
            print_hashes: bool = False) -> dict:
        """Train until max_steps (default trainer.max_steps), the loader
        ends or a SIGTERM / SIGUSR1 arrives (then the result has "signal").
        Every log_every steps the metrics come to the host (one sync) and
        are logged with the host seconds per step since the last log
        (step_s) and the throughput. print_hashes: print the parameters'
        hash (``utils/dist.py::param_hash``) once, after a resume and
        before the first step, on rank 0 (a determinism check, as JAX's
        ``train.py --print-hashes``). Returns the step and the last logged
        metrics."""
        old = self._install_signal_handler()
        try:
            return self._fit(train_loader, val_loader, max_steps,
                             overfit_first_batch, print_hashes)
        finally:
            for sig, h in old.items():
                signal.signal(sig, h)

    def _fit(self, train_loader, val_loader, max_steps, overfit_first_batch,
             print_hashes=False):
        cfg = self.config
        max_steps = max_steps or cfg.trainer.max_steps
        start = self.maybe_restore(train_loader)
        if print_hashes:
            # every rank hashes its shards (a collective on a mesh)
            udist.rprint(f"[trainer] param_hash="
                         f"{udist.param_hash(self.state.params)} "
                         f"(determinism check)")
        if overfit_first_batch:
            first = next(iter(train_loader))
            train_loader = iter(lambda: first, None)

        step = start
        last = {}
        phases = PhaseTimer()
        loader_it = iter(train_loader)
        t_log, step_log = time.perf_counter(), step
        # the step check comes before the fetch, so the saved loader state
        # is that of the last batch trained on (the JAX loop fetches one
        # batch more, which a resumed run would skip)
        while step < max_steps and self._stop is None:
            with phases("data"):
                batch = next(loader_it, None)
            if batch is None:
                break
            with phases("h2d"):
                tbatch = self._to_device(batch)
            with phases("dispatch"):
                self.generator.manual_seed(_step_seed(cfg.seed + 1, step))
                self.state, metrics = self.train_step(
                    self.state, tbatch, generator=self.generator)
            step += 1
            b, l = tbatch["input_ids"].shape
            self.monitor.step(b, b * l)

            if step % self.log_every == 0 or step == max_steps:
                last = metrics_to_host(metrics)
                now = time.perf_counter()
                last["step_s"] = (now - t_log) / (step - step_log)
                t_log, step_log = now, step
                last.update(self.monitor.stats())
                last.update(phases.stats())
                self.logger.log(last, step)

            if self.val_every and val_loader is not None and \
                    step % self.val_every == 0:
                self.validate(val_loader, step)

            if self.ckpt_every and step % self.ckpt_every == 0:
                self._save(step, train_loader)

        if self._last_saved != step:
            self._save(step, train_loader, force=True)
        if self._stop is not None:
            last["signal"] = self._stop
        return {"step": step, **last}

    # ------------------------------------------------------------------
    def validate(self, val_loader, step: int, max_batches: int = 16) -> dict:
        """Aggregate validation NLL / BPD / PPL over up to max_batches."""
        sums = validation_sums(self.eval_step, self.state, val_loader,
                               max_batches, seed=self.config.seed,
                               device=self.device, to_device=self._to_device)
        if sums is None:
            return {}
        nll = sums[0] / max(sums[1], 1)
        out = {"val/loss": sums[6] / sums[7], "val/nll": nll,
               "val/bpd": nll / LN2, "val/ppl": float(np.exp(min(nll, 50.0)))}
        if sums[3] > 0:
            out["val/txt_ppl"] = float(np.exp(min(sums[2] / sums[3], 50.0)))
        if sums[5] > 0:
            out["val/img_bpd"] = sums[4] / sums[5] / LN2
        self.logger.log(out, step)
        return out

    # ------------------------------------------------------------------
    def _save(self, step: int, loader, force: bool = False):
        extra = {}
        if hasattr(loader, "state_dict"):
            extra["loader"] = loader.state_dict()
        if self.param_map is not None:
            # how to rebuild the frozen base (serving a LoRA run dir), and
            # the live adapter for build_engine(lora=)
            if self._lora_base_checkpoint:
                extra["lora_base_checkpoint"] = self._lora_base_checkpoint
            from unidisc_tpu_torch.training.lora import save_lora
            if udist.is_main_process():
                # on a mesh the adapter is whole on every rank
                save_lora(f"{self.run_dir}/lora_adapter.npz",
                          self.state.params,
                          alpha=self.config.model.lora_alpha,
                          rank=self.config.model.lora_rank)
        if self.ckpt.save(step, self.state, self.config, extra=extra,
                          force=force, write=udist.is_main_process()):
            self._last_saved = step
        udist.barrier()

    def close(self):
        self.logger.close()
