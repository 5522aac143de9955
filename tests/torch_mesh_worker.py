"""A gloo world of CPU ranks for the port's mesh tests.

``run_world(job, world, tmp_path)`` starts `world` processes of this file,
each ``python tests/torch_mesh_worker.py JOB WORLD RANK DIR``, and
returns at once. They meet through a ``FileStore`` under `tmp_path` (no
port to pick, so several pytest-xdist workers can hold worlds at once),
run ``JOBS[JOB](rank, world)`` and write its result (a dict of numpy
arrays and numbers) to ``DIR/out{rank}.pt``; the returned ``World`` gives
them by rank, waiting for the ranks when first indexed, so a test file
computes its JAX references while the ranks run. Each rank takes its
share of the worker's cores (``device.cap_test_threads(ranks=)``).

The jobs use the port only: this file imports no JAX. The test files hold
what they return to the JAX package. Inputs come from numpy seeds, so a
test can rebuild them.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class World:
    """A started world of `n` ranks running JOBS[job]: indexing or iterating
    it waits for the ranks (at most `timeout` s from the start) and gives
    their results by rank. Each rank's output goes to a log file in the
    world's directory, read back if the rank fails."""

    def __init__(self, job: str, n: int, tmp_path, timeout: float, inputs):
        import tempfile
        import time

        import torch
        self.job, self.n, self._results = job, n, None
        self.dir = tempfile.mkdtemp(prefix=f"world_{job}_", dir=str(tmp_path))
        if inputs is not None:
            torch.save(inputs, os.path.join(self.dir, "inputs.pt"))
        env = dict(os.environ)
        env["MESH_WORKER_DIR"] = self.dir
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env["MESH_WORKER_TIMEOUT"] = str(timeout)
        self.deadline = time.monotonic() + timeout
        self.logs = [os.path.join(self.dir, f"log{r}.txt") for r in range(n)]
        self.procs = []
        for r in range(n):
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), job, str(n),
                     str(r), self.dir], env=env, cwd=REPO, stdout=log,
                    stderr=subprocess.STDOUT))

    def results(self) -> list:
        if self._results is None:
            import time

            import torch
            try:
                for p in self.procs:
                    p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            failed = [f"rank {r} (rc {p.returncode}):\n"
                      f"{open(self.logs[r]).read()[-4000:]}"
                      for r, p in enumerate(self.procs) if p.returncode]
            if failed:
                raise RuntimeError(f"job {self.job!r} failed on "
                                   + "\n".join(failed))
            self._results = [torch.load(os.path.join(self.dir,
                                                     f"out{r}.pt"),
                                        weights_only=False)
                             for r in range(self.n)]
        return self._results

    def __getitem__(self, rank):
        return self.results()[rank]

    def __iter__(self):
        return iter(self.results())


def run_world(job: str, world: int, tmp_path, timeout: float = 300.0,
              inputs=None) -> World:
    """Start JOBS[job] on `world` gloo ranks and return at once: the
    caller computes its references while the ranks run. inputs: any
    picklable object, which the job reads with ``load_inputs()``."""
    return World(job, world, tmp_path, timeout, inputs)


def _init(rank: int, world: int, out_dir: str):
    import torch.distributed as dist
    from torch.distributed import FileStore
    store = FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)


# ---------------------------------------------------------------------------
# ring attention (tests/test_torch_ring.py)
# ---------------------------------------------------------------------------

RING_SHAPE = (2, 64, 4, 16)       # B, L, H, D: Lc 16 over 4 ranks


def ring_inputs(seed):
    b, l, h, d = RING_SHAPE
    rng = np.random.RandomState(seed)
    return [rng.randn(b, l, h, d).astype(np.float32) for _ in range(4)]


def ring_cases():
    """name -> (causal, q ids, kv ids) over the global (B, L)."""
    b, l = RING_SHAPE[:2]
    packed = np.full((b, l), -1, np.int32)
    # documents across the chunk edges (16, 32, 48), then padding
    packed[0, :10], packed[0, 10:27], packed[0, 27:58] = 0, 1, 2
    packed[1, :40], packed[1, 40:61] = 0, 1
    kv = np.repeat(np.arange(4), l // 4)[None].repeat(b, 0).astype(np.int32)
    q_missing = kv.copy()
    q_missing[0, :16] = 99        # matches no key: zero rows
    q_missing[1, 20:24] = 7
    return {"full": (False, None, None), "causal": (True, None, None),
            "packed_full": (False, packed, None),
            "packed_causal": (True, packed, None),
            "distinct_full": (False, q_missing, kv),
            "distinct_causal": (True, q_missing, kv)}


def job_ring(rank, world):
    import torch
    from unidisc_tpu_torch.parallel import ring_attention as ra
    group = None
    lc = RING_SHAPE[1] // world
    sl = slice(rank * lc, (rank + 1) * lc)
    q, k, v, g = (torch.from_numpy(x) for x in ring_inputs(0))
    out = {}
    for name, (causal, qid, kvid) in ring_cases().items():
        qs = None if qid is None else torch.from_numpy(qid[:, sl].copy())
        ks = None if kvid is None else torch.from_numpy(kvid[:, sl].copy())
        for ring in ("plain", "flash"):
            fn = ra.ring_attention if ring == "plain" \
                else ra.ring_attention_flash
            qq, kk, vv = (x[:, sl].clone().requires_grad_()
                          for x in (q, k, v))
            o = fn(qq, kk, vv, qs, group=group, causal=causal,
                   kv_segment_ids=ks)
            o.backward(g[:, sl])
            out[f"{ring}/{name}"] = {
                "out": o.detach().numpy(), "dq": qq.grad.numpy(),
                "dk": kk.grad.numpy(), "dv": vv.grad.numpy()}
    # the global entry: every rank holds the global arrays
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    o = ra.ring_attention_sharded(qq, kk, vv, group, causal=True)
    o.backward(g)
    out["sharded"] = {"out": o.detach().numpy(), "dq": qq.grad.numpy(),
                      "dk": kk.grad.numpy(), "dv": vv.grad.numpy()}
    errors = {}
    for what, call in (
            ("indivisible", lambda: ra.ring_attention_sharded(
                q[:, :62], k[:, :62], v[:, :62], group)),
            ("kv_without_q", lambda: ra.ring_attention_sharded(
                q, k, v, group, kv_segment_ids=torch.zeros(
                    RING_SHAPE[:2], dtype=torch.int32)))):
        try:
            call()
        except ValueError as e:
            errors[what] = str(e)
    out["errors"] = errors
    return out


# ---------------------------------------------------------------------------
# the GPipe schedule (tests/test_torch_pipeline.py)
# ---------------------------------------------------------------------------

PIPE_B, PIPE_D, PIPE_LAYERS = 8, 16, 8


def pipe_stack(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(PIPE_LAYERS, PIPE_D, PIPE_D) / np.sqrt(PIPE_D),
            "b": rng.randn(PIPE_LAYERS, PIPE_D) * 0.1}


def pipe_inputs(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(PIPE_B, PIPE_D), rng.randn(PIPE_B, PIPE_D) * 0.3


def pipe_stage(params, a, mb_args, scale):
    """JAX tests/test_pipeline.py's stage: dense + GELU layers, each adding
    the microbatch's own bias."""
    import torch
    for w, b in zip(params["w"], params["b"]):
        a = torch.nn.functional.gelu(a @ w + b + 0.1 * mb_args["bias"],
                                     approximate="tanh") \
            * scale
    return a


def job_pipeline(rank, world):
    """pipeline_sharded on 4 stages: the forward at 1, 2, 4 and 8
    microbatches, the gradients at 4 (a loss every rank computes alike),
    and the refusals."""
    import torch
    from unidisc_tpu_torch.parallel.pipeline import pipeline_sharded
    group = None

    def t(a, grad=False):
        return torch.tensor(a, dtype=torch.float32, requires_grad=grad)
    params = {k: t(v) for k, v in pipe_stack(0).items()}
    x, bias = (t(a) for a in pipe_inputs(1))
    out = {"forward": {}}
    with torch.no_grad():
        for m in (1, 2, 4, 8):
            out["forward"][m] = pipeline_sharded(
                pipe_stage, params, x, group, 1.01, mb_args={"bias": bias},
                microbatches=m).numpy()
    params = {k: t(v, True) for k, v in pipe_stack(2).items()}
    x = t(pipe_inputs(3)[0], True)
    bias = t(pipe_inputs(3)[1])
    loss = torch.tanh(pipeline_sharded(pipe_stage, params, x, group, 0.99,
                                       mb_args={"bias": bias},
                                       microbatches=4)).sum()
    loss.backward()
    per = PIPE_LAYERS // world
    out["grads"] = {k: p.grad[rank * per:(rank + 1) * per].numpy()
                    for k, p in params.items()}
    out["dx"] = x.grad.numpy()
    out["loss"] = float(loss)
    errors = {}
    for what, call in (
            ("batch", lambda: pipeline_sharded(
                pipe_stage, params, x[:6], group, 1.0,
                mb_args={"bias": bias[:6]}, microbatches=4)),
            ("layers", lambda: pipeline_sharded(
                pipe_stage, {k: v[:6] for k, v in params.items()}, x, group,
                1.0, mb_args={"bias": bias}, microbatches=4))):
        try:
            call()
        except ValueError as e:
            errors[what] = str(e)
    out["errors"] = errors
    return out


# ---------------------------------------------------------------------------
# the train step on a mesh (tests/test_torch_seq_parallel.py,
# tests/test_torch_mesh.py)
# ---------------------------------------------------------------------------

def load_inputs():
    import torch
    return torch.load(os.path.join(os.environ["MESH_WORKER_DIR"],
                                   "inputs.pt"), weights_only=False)


def mesh_train(cfg, spec, sd0, batch, draws):
    """len(draws) steps of the mesh step on `spec` from the state dict sd0;
    (whole state dict (on every rank), metrics per step)."""
    import dataclasses

    import torch

    from unidisc_tpu_torch.models.dit import DIT
    from unidisc_tpu_torch.parallel.mesh import make_mesh
    from unidisc_tpu_torch.training import train_state as tts
    cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh,
                                                            **spec))
    model = DIT(cfg.model, compute_dtype=torch.float32)
    step, state, _ = tts.shard_train_step(cfg, model, make_mesh(cfg.mesh))
    state.load_state_dict(sd0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = []
    for d in draws:
        state, m = step(state, tb, draws=d)
        metrics.append({k: float(v) for k, v in m._asdict().items()})
    sd = state.state_dict()
    return ({k: {n: t.detach().clone() for n, t in v.items()}
             if isinstance(v, dict) else v.clone() for k, v in sd.items()},
            metrics)


def job_train(rank, world):
    """inputs: config, meshes (name -> MeshConfig fields), sd0, batch,
    draws (one mapping per step)."""
    inp = load_inputs()
    out = {}
    for name, spec in inp["meshes"].items():
        sd, metrics = mesh_train(inp["config"], spec, inp["sd0"],
                                 inp["batch"], inp["draws"])
        out[name] = {"metrics": metrics}
        if rank == 0:
            out[name]["state"] = sd
    return out


def t2i_mesh(cfg, sd, spec, txt, injected):
    """The t2i sampler under spmd_sampler on `spec`: its tokens."""
    import dataclasses

    import torch

    from unidisc_tpu_torch.models.dit import DIT
    from unidisc_tpu_torch.parallel.mesh import (MeshLayout, make_mesh,
                                                 shard_model)
    from unidisc_tpu_torch.parallel.sample import spmd_sampler
    from unidisc_tpu_torch.sampling.t2i_fast import build_t2i_sampler
    cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh,
                                                            **spec))
    layout = MeshLayout.of(make_mesh(cfg.mesh))
    model = DIT(cfg.model, compute_dtype=torch.float32).eval()
    model.load_state_dict(sd)
    shard_model(model, layout)
    sample = spmd_sampler(build_t2i_sampler(model, cfg, inject_noise=True,
                                            device="cpu"), cfg, layout)
    out = sample(torch.from_numpy(txt),
                 injected={k: torch.from_numpy(v)
                           for k, v in injected.items()})
    return out.tokens.numpy()


T2I_CASES = ("t2i", "moe_t2i", "int8_t2i", "int8_fused_t2i",
             "moe_int8_t2i")


def job_seq(rank, world):
    """The 4-rank world of tests/test_torch_seq_parallel.py: the train
    step on the dense meshes and the MoE step on its own, the t2i sampler
    (float and int8) on the dense meshes and the MoE one on its own, the
    row-parallel int8 product at tensor 2, the engine (float and int8)."""
    inp = load_inputs()
    out = {}
    for key in ("train", "moe"):
        t = inp[key]
        out[key] = {}
        for name, spec in t["meshes"].items():
            sd, metrics = mesh_train(t["config"], spec, t["sd0"],
                                     t["batch"], t["draws"])
            out[key][name] = {"metrics": metrics}
            if rank == 0:
                out[key][name]["state"] = sd
    for key in T2I_CASES:
        s = inp[key]
        out[key] = {name: t2i_mesh(s["config"], s["sd"], spec, s["txt"],
                                   s["injected"])
                    for name, spec in s["meshes"].items()}
    out["row_parallel"] = row_parallel_products(inp["row_parallel"])
    out["engine"] = engine_checks(rank, inp["engine"])
    return out


def row_parallel_products(c):
    """qdot_row_parallel on dcn 2 x tensor 2: each rank's K-slice of every
    case's x (M, K) and w_q (N, K); the whole (M, N) it returns, in the
    case's output dtype (as fp32)."""
    import torch

    from unidisc_tpu_torch.config import MeshConfig
    from unidisc_tpu_torch.ops.quant import qdot_row_parallel
    from unidisc_tpu_torch.parallel.mesh import MeshLayout, Part, make_mesh
    tp = MeshLayout.of(make_mesh(MeshConfig(dcn=2, fsdp=1,
                                            tensor=2))).tensor
    part = Part("tensor", 1)
    out = {}
    for name, x, dtype, w_q, w_scale, bias, out_dtype in c["cases"]:
        x = torch.from_numpy(x).to(getattr(torch, dtype))
        y = qdot_row_parallel(
            part.take(x, tp.rank, tp.size).contiguous(),
            part.take(torch.from_numpy(w_q), tp.rank, tp.size).contiguous(),
            torch.from_numpy(w_scale), tp.group,
            bias=None if bias is None else torch.from_numpy(bias),
            out_dtype=getattr(torch, out_dtype), backend="pallas")
        out[name] = y.float().numpy()
    return out


def engine_checks(rank, e):
    """build_engine on a mesh: run_batch SPMD, with a batch off the
    granule, and led from rank 0 with the others following (a call the
    leader refuses first). Each case is (spec, quantize, extra
    overrides)."""
    from unidisc_tpu_torch.serving.engine import build_engine
    out = {}
    for spec, quantize, extra in e["meshes"]:
        eng = build_engine(preset="tiny", device="cpu", mesh=spec,
                           overrides={**e["overrides"], **extra},
                           quantize=quantize)
        prepared = [eng.prepare(**r) for r in e["requests"]]
        res = eng.run_batch(prepared, seed=e["seed"])
        got = {"tokens": [r["image_ids"] for r in res],
               "texts": [r["text"] for r in res],
               "granule": eng._batch_multiple}
        if rank == 0:
            eng.lead()
            # a request the leader refuses never reaches the followers
            try:
                eng.run_batch(prepared, steps=-1, seed=e["seed"])
            except ValueError:
                got["refused"] = True
            led = eng.run_batch(prepared, seed=e["seed"])
            eng.stop_followers()
            got["led"] = [r["image_ids"] for r in led]
        else:
            eng.follow()
        out[(spec, quantize)] = got
    return out


TRAINER_OVER = {
    "model.length": 16, "model.txt_length": 8, "model.img_length": 8,
    "model.text_vocab_size": 40, "model.image_vocab_size": 24,
    "model.dropout": 0.0, "trainer.warmup_steps": 2,
    "trainer.max_steps": 3, "mesh.fsdp": 2}
TRAINER_BATCH = 8


def local_batches(seed, rank, world):
    """This rank's slice of a deterministic global batch (as
    tests/multihost_worker.py)."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 40, (TRAINER_BATCH, 16)).astype(np.int32)
    mod = np.zeros((TRAINER_BATCH, 16), np.int32)
    mod[:, 8:] = 1
    toks[:, 8:] = rng.randint(40, 64, (TRAINER_BATCH, 8))
    n = TRAINER_BATCH // world
    sl = slice(rank * n, (rank + 1) * n)
    return {"input_ids": toks[sl], "modality": mod[sl]}


class Loader:
    def __init__(self, seeds, rank, world):
        self.seeds, self.rank, self.world = list(seeds), rank, world

    def __iter__(self):
        return (local_batches(s, self.rank, self.world) for s in self.seeds)


def job_mesh2(rank, world):
    """The 2-rank world of tests/test_torch_mesh.py: the train step on
    fsdp 2; Trainer.fit + validate on fsdp 2; the train CLI on it."""
    import torch

    from unidisc_tpu_torch import train as train_cli
    from unidisc_tpu_torch.config import Config
    from unidisc_tpu_torch.training.trainer import Trainer
    from unidisc_tpu_torch.utils import dist as udist
    inp = load_inputs()
    out = {}
    sd, metrics = mesh_train(inp["config"], {"fsdp": 2}, inp["sd0"],
                             inp["batch"], inp["draws"])
    out["train"] = {"metrics": metrics}
    if rank == 0:
        out["train"]["state"] = sd
    cfg = Config.make("tiny", **TRAINER_OVER)
    assert udist.host_local_batch_size(TRAINER_BATCH) == TRAINER_BATCH // 2
    g = udist.host_batch_to_global(local_batches(0, rank, world))
    out["global_batch"] = g
    run_dir = os.path.join(inp["dir"], "run")
    trainer = Trainer(cfg, run_dir, device="cpu", log_every=100,
                      val_every=0, ckpt_every=0)
    out["sharded"] = sorted(trainer.state.shard_dims)
    fit = trainer.fit(Loader(range(100), rank, world), None, max_steps=3)
    out["fit_step"] = fit["step"]
    out["val"] = trainer.validate(Loader(range(50, 54), rank, world), 3,
                                  max_batches=4)
    out["param_hash"] = udist.param_hash(trainer.state.params)
    full = trainer.state.state_dict()
    if rank == 0:
        out["final"] = {k: {n: t.detach().clone() for n, t in full[k].items()}
                        for k in ("params", "ema_params")}
    trainer.close()
    # the Trainer on pp 2: a stage's blocks on each rank, the run dir in
    # the one-rank format
    pp_cfg = Config.make("tiny", **{**TRAINER_OVER, "mesh.fsdp": 1,
                                    "mesh.pp": 2, "mesh.pp_microbatches": 2})
    trainer = Trainer(pp_cfg, os.path.join(inp["dir"], "run_pp"),
                      device="cpu", log_every=100, val_every=0, ckpt_every=0)
    out["pp_held"] = sorted(trainer.state.params)
    out["pp_fit_step"] = trainer.fit(Loader(range(100), rank, world), None,
                                     max_steps=3)["step"]
    full = trainer.state.state_dict()
    if rank == 0:
        out["pp_final"] = {n: t.detach().clone()
                           for n, t in full["params"].items()}
    trainer.close()
    import contextlib
    import io
    for name, mesh in (("cli", ["mesh.fsdp=2"]),
                       ("cli_tensor", ["mesh.fsdp=1", "mesh.tensor=2",
                                       "--print-hashes"])):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            res = train_cli.main(["--device", "cpu", "--run-dir",
                                  os.path.join(inp["dir"], name),
                                  "--batch-size", "4", "--log-every", "1",
                                  "model=tiny", "model.length=16",
                                  "model.txt_length=8", "model.img_length=8",
                                  *mesh, "trainer.max_steps=2"])
        out[f"{name}_step"] = res["step"]
        out[f"{name}_loss"] = res["loss"]
        out[f"{name}_hash_lines"] = [
            ln for ln in printed.getvalue().splitlines()
            if ln.startswith("[trainer] param_hash=")]
    # the engine on fsdp 2 at a seed: the draws of the global batch
    from unidisc_tpu_torch.serving.engine import build_engine
    e = inp["engine"]
    eng = build_engine(preset="tiny", device="cpu", mesh="fsdp=2",
                       overrides=e["overrides"])
    out["engine"] = [r["image_ids"] for r in eng.run_batch(
        [eng.prepare(**r) for r in e["requests"]], seed=e["seed"])]
    del torch
    return out


# ---------------------------------------------------------------------------
# the mesh's other modes (tests/test_torch_mesh_modes.py)
# ---------------------------------------------------------------------------

def modes_run(c, rank):
    """One case of job "modes": its steps on its mesh from its start.
    c: config, mesh (MeshConfig fields), draws (one mapping per step),
    batch, and sd0 (a whole state dict) or base + adapter (LoRA); dtype
    (the DIT's compute dtype), resume (load the state after step 1 back
    and run step 2 again), in_chunk (the AR targets shifted inside each
    L-chunk). Returns the metrics per step, and on rank 0 the whole
    state after the last step."""
    import dataclasses
    from unittest import mock

    import torch

    from unidisc_tpu_torch.models.dit import DIT
    from unidisc_tpu_torch.parallel.mesh import make_mesh
    from unidisc_tpu_torch.training import lora as tlora
    from unidisc_tpu_torch.training import train_state as tts
    cfg = dataclasses.replace(c["config"], mesh=dataclasses.replace(
        c["config"].mesh, **c["mesh"]))
    model = DIT(cfg.model, compute_dtype=c.get("dtype", torch.float32))
    mesh = make_mesh(cfg.mesh)
    if "adapter" in c:
        m = cfg.model
        model.load_state_dict(c["base"])
        pmap = tlora.lora_param_map(dict(model.named_parameters()),
                                    alpha=m.lora_alpha, rank=m.lora_rank)
        step, state, _ = tts.shard_train_step(
            cfg, model, mesh, param_map=pmap,
            adapter={k: v.clone() for k, v in c["adapter"].items()})
    else:
        step, state, _ = tts.shard_train_step(cfg, model, mesh)
        state.load_state_dict(c["sd0"])
    tb = {k: torch.from_numpy(v) for k, v in c["batch"].items()}

    def whole():
        return {k: {n: t.detach().clone() for n, t in v.items()}
                if isinstance(v, dict) else v.clone()
                for k, v in state.state_dict().items()}
    def in_chunk(x, mesh=None):
        b = mesh.local(x)
        return torch.cat([b[:, 1:], b[:, -1:]], 1)
    out = {"metrics": []}
    patch = mock.patch.object(tts, "next_token_targets", in_chunk) \
        if c.get("in_chunk") else None
    if patch is not None:
        patch.start()
    for i, d in enumerate(c["draws"]):
        if c.get("resume") and i == 1:
            mid = whole()
        state, m = step(state, tb, draws=d)
        out["metrics"].append({k: float(v) for k, v in m._asdict().items()})
    if patch is not None:
        patch.stop()
    sd = whole()
    if c.get("resume"):
        # the mesh state after step 1, gathered whole, scattered back
        state.load_state_dict(mid)
        state, _ = step(state, tb, draws=c["draws"][1])
        again = whole()
        out["resumed_equal"] = all(
            torch.equal(again[k][n], sd[k][n]) if isinstance(sd[k], dict)
            else torch.equal(again[k], sd[k]) for k in sd for n in
            (sd[k] if isinstance(sd[k], dict) else [None]))
    if rank == 0:
        out["state"] = sd
    return out


def job_modes(rank, world):
    """The 4-rank world of tests/test_torch_mesh_modes.py: each case's
    steps (``modes_run``), then a LoRA Trainer on fsdp 2 x tensor 2."""
    import os

    from unidisc_tpu_torch.training.trainer import Trainer
    inp = load_inputs()
    out = {name: modes_run(c, rank) for name, c in inp["cases"].items()}
    t = inp["trainer"]
    trainer = Trainer(t["config"], os.path.join(inp["dir"], "lora_run"),
                      device="cpu", log_every=100, val_every=0, ckpt_every=0)
    batch = t["batch"]
    n = len(batch["input_ids"]) // world
    local = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
    trainer.fit(iter([local] * t["steps"]), None, max_steps=t["steps"])
    out["trainer_val"] = trainer.validate(iter([local]), t["steps"],
                                          max_batches=1)
    trainer.close()
    return out


# ---------------------------------------------------------------------------
# rolling admission and AR decoding on a mesh (tests/test_torch_mesh_serving.py)
# ---------------------------------------------------------------------------

def led(engine, rank, lead_fn):
    """Rank 0 leads `engine` through lead_fn(engine) and shuts it down;
    the other ranks follow until then, recording the batcher ops they
    replay. Every rank gives {"lead": lead_fn's result (rank 0), "ops":
    the (route, op) replayed (the followers), "states": its batchers'
    rows}."""
    out = {"lead": None, "ops": []}
    if rank == 0:
        engine.lead()
        try:
            out["lead"] = lead_fn(engine)
        finally:
            engine.shutdown()
    else:
        replay = engine._batcher_op

        def recorded(route, op, kw):
            out["ops"].append((route, op))
            return replay(route, op, kw)
        engine._batcher_op = recorded
        engine.follow()
    out["states"] = batcher_states(engine)
    return out


def batcher_states(engine) -> dict:
    """Each built batcher's rows on this rank: its first global slot, the
    tokens, steps or positions and activity of its slots."""
    out = {}
    batchers = {f"rolling:{k}": b for k, b in engine._rolling.items()}
    if engine._continuous is not None:
        batchers["continuous"] = engine._continuous
    for route, b in batchers.items():
        st = b.state
        out[route] = {"lo": b.split.lo, "x": st.x.numpy().copy(),
                      "active": st.active.numpy().copy(),
                      "at": (st.step if hasattr(st, "step")
                             else st.pos).numpy().copy()}
    return out


def staggered(engine, requests, gap_s=0.05):
    """Each (prepared, steps, seed) of `requests` through run_batch alone,
    started `gap_s` apart on threads: the results in request order."""
    import threading
    import time
    out = [None] * len(requests)

    def run(i, prepared, steps, seed):
        out[i] = engine.run_batch([prepared], steps=steps, seed=seed)[0]
    threads = []
    for i, (prepared, steps, seed) in enumerate(requests):
        t = threading.Thread(target=run, args=(i, prepared, steps, seed))
        t.start()
        threads.append(t)
        time.sleep(gap_s)
    for t in threads:
        t.join()
    return out


def served(results) -> list:
    return [{"text": r["text"], "image_ids": r["image_ids"][0]}
            for r in results]


def rolling_machine(rank, c):
    """The generic rolling state machine on c["mesh"] under injected
    noise, with c's staggered admissions (tests/test_torch_rolling.py's):
    this rank's rows and steps, and on rank 0 the gathered global rows."""
    import dataclasses

    import torch

    from unidisc_tpu_torch.models.dit import DIT
    from unidisc_tpu_torch.parallel.mesh import MeshLayout, make_mesh
    from unidisc_tpu_torch.serving.rolling import build_rolling_sampler
    cfg = dataclasses.replace(c["config"], mesh=dataclasses.replace(
        c["config"].mesh, **c["mesh"]))
    layout = MeshLayout.of(make_mesh(cfg.mesh))
    model = DIT(cfg.model, compute_dtype=torch.float32).eval()
    model.load_state_dict(c["sd"])
    built = build_rolling_sampler(model, cfg, slots=c["slots"], chunk=1,
                                  inject_noise=True, device="cpu",
                                  mesh=layout)
    noise = {k: torch.from_numpy(v) for k, v in c["noise"].items()}
    st = built.init_state()
    for group in c["groups"]:
        built.insert_many(st, *group)
        built.step_chunk(st, noise)
    for _ in range(32):
        if bool(((st.step >= st.row_steps + built.extra)
                 | ~st.active).all()):
            break
        built.step_chunk(st, noise)
    return {"lo": built.split.lo, "x": st.x.numpy(),
            "step": st.step.numpy(), "slots": built.slots,
            "gathered": built.split.gather(st.x)}


def rolling_engine_checks(rank, c):
    """The rolling engine on c["spec"] led by rank 0: c's requests
    staggered; a planted device error in the leader's chunk; the server
    over it answering c's chat requests concurrently; then shut down
    (the batchers first)."""
    from unidisc_tpu_torch.serving.engine import build_engine
    eng = build_engine(preset="tiny", device="cpu", mesh=c["spec"],
                       rolling=c["slots"], overrides=c["overrides"])

    def lead(eng):
        import json
        import threading
        import urllib.request
        from concurrent.futures import ThreadPoolExecutor

        from unidisc_tpu_torch.serving.server import (close_server,
                                                      make_server)
        out = rolling_lead(eng, c)
        reqs = [(eng.prepare(**r), steps, seed)
                for r, steps, seed in c["requests"]]
        # a device error in the leader's chunk: the futures fail, every
        # rank resets, the next request is served
        batcher = eng._rolling_batcher("generic")
        chunk, fail = batcher.step_chunk, [True]

        def planted(state):
            if fail[0]:
                fail[0] = False
                raise RuntimeError("planted device error")
            return chunk(state)
        batcher.step_chunk = planted
        prepared, steps, seed = reqs[c["after_error"]]
        try:
            eng.run_batch([prepared], steps=steps, seed=seed)
            out["error"] = None
        except RuntimeError as e:
            out["error"] = str(e)
        out["after_error"] = served(eng.run_batch([prepared], steps=steps,
                                                  seed=seed))
        out["counters"] = {k: (b.chunks, b.harvests, b.row_reads)
                           for k, b in eng._rolling.items()}
        srv = make_server(eng, 0)
        loop = threading.Thread(target=srv.serve_forever, daemon=True)
        loop.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"

        def chat(body):
            req = urllib.request.Request(
                url + "/v1/chat/completions", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read())
        with ThreadPoolExecutor(len(c["chats"])) as pool:
            answers = list(pool.map(chat, c["chats"]))
        out["chats"] = [a["choices"][0]["message"]["content"][0]["text"]
                        for a in answers]
        srv.shutdown()
        close_server(srv)
        out["stopped"] = all(b._thread is not None
                             and not b._thread.is_alive()
                             for b in eng._rolling.values())
        return out
    return led(eng, rank, lead)


def rolling_lead(eng, c):
    """c's requests through the rolling engine `eng`: each run_batch alone,
    started 10 ms apart (or, with c["together"], one run_batch of them
    all, admitted in one group); {"results"}."""
    import threading
    import time
    reqs = [(eng.prepare(**r), steps, seed)
            for r, steps, seed in c["requests"]]
    if not c.get("together"):
        return {"results": served(staggered(eng, reqs, gap_s=0.01))}
    prepared = [p for p, _, _ in reqs]
    batcher = eng._rolling_batcher(
        "t2i" if all(p["fastpath"] for p in prepared) else "generic")
    out = []
    # the worker admits the whole batch in one group: it waits for the
    # device lock until every request is queued
    with eng._device_lock:
        t = threading.Thread(target=lambda: out.extend(eng.run_batch(
            prepared, steps=reqs[0][1], seed=reqs[0][2])))
        t.start()
        while batcher._pending.qsize() < len(prepared):
            time.sleep(0.005)
    t.join()
    return {"results": served(out)}


def rolling_engine_run(rank, c):
    """The rolling engine on c["spec"] (int8 under c["quantize"]) led by
    rank 0 through ``rolling_lead``."""
    from unidisc_tpu_torch.serving.engine import build_engine
    eng = build_engine(preset="tiny", device="cpu", mesh=c["spec"],
                       rolling=c["slots"], overrides=c["overrides"],
                       quantize=c.get("quantize"))
    return led(eng, rank, lambda e: rolling_lead(e, c))


def ar_lead(eng, completions):
    """Each (text, max_new, temperature, seed) of `completions` through
    eng.complete_text: the first alone (its prompt then resident in slot
    0), the rest at once, the second streamed. Its tokens, the stream,
    and the batcher's counters."""
    def submit(text, n, temp, seed, stream_cb=None):
        return eng.complete_text(text, max_new_tokens=n, temperature=temp,
                                 seed=seed, stream_cb=stream_cb)
    res = [submit(*completions[0]).result(timeout=240)["tokens"]]
    streamed = []
    futs = [submit(*comp, stream_cb=streamed.extend if i == 0 else None)
            for i, comp in enumerate(completions[1:])]
    res += [f.result(timeout=240)["tokens"] for f in futs]
    b = eng.continuous
    return {"tokens": res, "streamed": list(streamed),
            "prefix_hits": b.prefix_hits, "drains": b.host_reads,
            "chunks": b.chunks, "slots": b.slots}


def ar_engine_run(rank, c):
    """An AR InferenceEngine of c's fp32 DIT on c["mesh"] led by rank 0
    through ``ar_lead``, for each decoding mode (plain, prompt lookup, a
    draft DIT)."""
    import dataclasses

    import torch

    from unidisc_tpu_torch.models.dit import DIT
    from unidisc_tpu_torch.parallel.mesh import make_mesh
    from unidisc_tpu_torch.serving.engine import InferenceEngine
    out = {}
    for mode in ("plain", "lookup", "draft"):
        cfg = c["config"].override(**{f"mesh.{k}": v
                                      for k, v in c["mesh"].items()})
        model = DIT(cfg.model, compute_dtype=torch.float32)
        model.load_state_dict(c["sd"])
        kw = {}
        if mode == "lookup":
            kw["lookup_ngram"] = 2
        elif mode == "draft":
            draft = DIT(c["draft_config"].model, compute_dtype=torch.float32)
            draft.load_state_dict(c["draft_sd"])
            kw["ar_draft"] = draft
        eng = InferenceEngine(cfg, model, device="cpu",
                              mesh=make_mesh(cfg.mesh), **kw)

        out[mode] = led(eng, rank,
                        lambda e: ar_lead(e, c["completions"]))
    return out


def job_serving(rank, world):
    """The 4-rank world of tests/test_torch_mesh_serving.py: the rolling
    state machine under injected noise, the rolling engines (fsdp 2 x seq
    2 with the planted error and the server, pp 2 x tensor 2 in bf16 and
    int8, the MoE on dcn 2 x ep 2) and the AR engines, each led by rank
    0."""
    inp = load_inputs()
    return {"machine": rolling_machine(rank, inp["machine"]),
            "rolling": rolling_engine_checks(rank, inp["rolling"]),
            "pp_tensor": rolling_engine_run(rank, inp["pp_tensor"]),
            "pp_tensor_int8": rolling_engine_run(rank,
                                                 inp["pp_tensor_int8"]),
            "moe": rolling_engine_run(rank, inp["moe"]),
            "ar": ar_engine_run(rank, inp["ar"])}


JOBS = {"ring": job_ring, "train": job_train, "seq": job_seq,
        "mesh2": job_mesh2, "pipeline": job_pipeline, "modes": job_modes,
        "serving": job_serving}


def main():
    job, world, rank, out_dir = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    sys.path.insert(0, REPO)
    import faulthandler
    faulthandler.dump_traceback_later(
        float(os.environ.get("MESH_WORKER_TIMEOUT", "300")) - 5, exit=True)
    import torch
    from unidisc_tpu_torch.device import cap_test_threads
    cap_test_threads(ranks=world)
    _init(rank, world, out_dir)
    result = JOBS[job](rank, world)
    torch.save(result, os.path.join(out_dir, f"out{rank}.pt"))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
