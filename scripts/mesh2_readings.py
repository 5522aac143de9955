#!/usr/bin/env python3
"""Phase 5i's, 5k's and 5l's mesh readings on the card, without their
limits.

    python3 scripts/mesh2_readings.py [--root DIR] [--runs R[,R...]]
                                      [--plain] [--plant FAULT]
                                      [--label NAME]

Runs ``chip_smoke.py``'s 5i world (MESH_RANKS ranks sharing card 0 over
gloo) from the tree at --root (default: this one; its kernels build into
DIR/build) for the runs named (default: ``MESH2_RUNS``, the three train
paths, ``mesh2_serve``, ``mesh2_dp_engine`` and ``mesh2_int8``), and
prints what 5i holds to its limits: for each train path against the
one-rank step, ``mesh2_train_readings`` (the
largest relative gap of any rank's losses and gradient norms, the trunk's
first moments' relative distance and the update's cosine); for
``mesh2_dp_engine`` the captured programs' token agreement with the
one-rank engine at the same seed; for ``mesh2_int8`` whether each
row-parallel int8 product equalled the one-rank qdot on every rank, and
each int8 engine's token agreement with the one-rank int8 engine
(``mesh2_int8_readings``). Runs named ``mesh3_*`` (``--runs 5k``:
all of them) run in 5k's world instead, read by
``mesh3_train_readings`` (the optimizer state's relative distance in
place of the trunk's first moments). Runs named ``mesh4_*`` (``--runs
5l``: all of them) run in 5l's world, read by ``mesh4_readings`` (each
path's token agreement with the one-rank engine, its unanswered
requests, its programs and launches). --plain runs the train paths in fp32
through the plain attention, to tell the bf16 paths' rounding from a
fault. --plant FAULT (one of PLANTS) runs a copy of the tree, made in a
temporary directory and removed after, with that one fault planted and
only the run that should see it: whether 5i's limits see the fault.
Prints the card line and one JSON line, and writes
chiprun_out/mesh2_readings_<label>.json beside this script's tree.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

# fault: (file, the text replaced, its replacement, the runs that see it)
PLANTS = {
    # the row-parallel product's partial sums left unsummed
    "no_row_reduce": (
        "unidisc_tpu_torch/models/dit.py",
        "y = reduce_from(_product_f32(x.to(dt), layer.weight.to(dt)),\n"
        "                        tp.group)",
        "y = _product_f32(x.to(dt), layer.weight.to(dt))",
        "mesh2_train_tensor"),
    # stage 0 reads the microbatches in reverse order
    "reversed_microbatches": (
        "unidisc_tpu_torch/parallel/pipeline.py",
        "            a = x_mb[t]\n",
        "            a = x_mb[m_micro - 1 - t]\n", "mesh2_train_pp"),
    # the MoE combine's partial outputs left unsummed over "ep"
    "no_ep_combine": (
        "unidisc_tpu_torch/models/moe.py",
        "                y = reduce_from(y, ep.group)\n",
        "                pass\n", "mesh2_train_moe"),
    # replicated leaves' gradients summed over every rank ("tensor" too)
    "world_grad_sum": (
        "unidisc_tpu_torch/training/train_state.py",
        "(False, mesh.grad_group)",
        "(False, torch.distributed.group.WORLD)",
        "mesh2_train_tensor"),
    # the engine's program captured outside global_rows
    "capture_local_rows": (
        "unidisc_tpu_torch/serving/engine.py",
        "            with rows:\n                run = captured(sampler, "
        "local)\n", "            run = captured(sampler, local)\n",
        "mesh2_dp_engine"),
    # 5k: the AR targets shifted inside each L-chunk
    "ar_in_chunk": (
        "unidisc_tpu_torch/training/train_state.py",
        "return _block(mesh, torch.cat([x[:, 1:], x[:, -1:]], 1))",
        "return (lambda b: torch.cat([b[:, 1:], b[:, -1:]], 1))("
        "_block(mesh, x))", "mesh3_ar"),
    # the per-token tensors of the loss cut from the wrong rows
    "block_rows_flipped": (
        "unidisc_tpu_torch/training/train_state.py",
        "else mesh.local(x)\n", "else mesh.local(x.flip(0))\n",
        "mesh3_joint"),
    # sedd's per-row sigma and d3pm's per-row t from the wrong rows
    "sedd_rows_flipped": (
        "unidisc_tpu_torch/training/train_state.py",
        "else mesh.rows(x)\n", "else mesh.rows(x.flip(0))\n",
        "mesh3_sedd"),
    "d3pm_rows_flipped": (
        "unidisc_tpu_torch/training/train_state.py",
        "else mesh.rows(x)\n", "else mesh.rows(x.flip(0))\n",
        "mesh3_d3pm"),
    # Adafactor's statistics over the rank's part only
    "adafactor_no_allsum": (
        "unidisc_tpu_torch/training/leaf_shards.py",
        "t = all_reduce(t.contiguous(), sp.axis.group)", "t = t",
        "mesh3_adafactor"),
    # Muon's Newton-Schulz on the rank's part of each matrix
    "muon_local_ns": (
        "unidisc_tpu_torch/training/optimizers.py",
        "            if state.leaves is not None:\n"
        "                # each (in, out) matrix whole over the axes that "
        "split it\n"
        "                o = state.leaves.gather(o, leaf.key, mat, "
        "mat[-2:])\n"
        "            o = newton_schulz(o, self.ns_steps, self.eps)\n"
        "            if state.leaves is not None:\n"
        "                o = state.leaves.take(o, leaf.key, mat, mat[-2:])\n",
        "            o = newton_schulz(o, self.ns_steps, self.eps)\n",
        "mesh3_muon"),
    # the adapter's gradient parts left unsummed over the world
    "lora_no_world_sum": (
        "unidisc_tpu_torch/training/train_state.py",
        "    return all_reduce(flat, dist.group.WORLD)\n",
        "    return flat\n", "mesh3_lora"),
    # an MoE rank under "seq" keeps another chunk's routing
    "moe_seq_wrong_chunk": (
        "unidisc_tpu_torch/models/moe.py",
        "u.view(b, seq_size, t, k)[:, seq.rank]",
        "u.view(b, seq_size, t, k)[:, 0]", "mesh3_moe"),
    # 5i: a tensor rank quantizes its K-slice of a row by the slice's own
    # amax, not the row's
    "int8_own_amax": (
        "unidisc_tpu_torch/ops/quant.py",
        "amax = all_reduce(row_amax(x2), group, op=dist.ReduceOp.MAX)",
        "amax = row_amax(x2)", "mesh2_int8"),
    # 5i: each tensor rank applies the epilogue and rounds to the output
    # dtype before the sum
    "int8_rounded_partials": (
        "unidisc_tpu_torch/ops/quant.py",
        "    acc = all_reduce(acc, group)\n"
        "    y = int8_epilogue(acc, x_scale, w_scale, bias=bias, "
        "out_dtype=out_dtype)\n",
        "    y = all_reduce(int8_epilogue(acc, x_scale, w_scale, "
        "out_dtype=out_dtype).float(), group)\n"
        "    y = (y if bias is None else y + bias.float()).to(out_dtype)\n",
        "mesh2_int8"),
    # 5l: a follower skips the first insert that holds rows of its slots
    "follower_drops_insert": (
        "unidisc_tpu_torch/serving/engine.py",
        '        return getattr(batcher, "op_" + op)(**kw)\n',
        '        if op == "insert" and not getattr(self, "_dropped", False) '
        'and (\n                batcher.split.own(kw["slots_v"])\n'
        '                < batcher.split.local).any():\n'
        '            self._dropped = True\n            return None\n'
        '        return getattr(batcher, "op_" + op)(**kw)\n',
        "mesh4_rolling,mesh4_rolling_pp,mesh4_ar"),
    # 5l: the harvest's gather gives rank 0's rows for every data-parallel
    # rank
    "harvest_rank0_rows": (
        "unidisc_tpu_torch/parallel/sample.py",
        "        out = gather(t, self.layout.dp_group, 0)\n",
        "        out = gather(t, self.layout.dp_group, 0)\n"
        "        if out is not None:\n"
        "            out = t.repeat(self.layout.dp_size, *([1] * (t.dim() - "
        "1)))\n", "mesh4_rolling,mesh4_ar"),
}


def planted(root: Path, fault: str) -> Path:
    """A copy of the tree at `root` in a new temporary directory, its
    kernels' build directory included, with `fault` planted."""
    path, old, new, _ = PLANTS[fault]
    dest = Path(tempfile.mkdtemp(prefix=f"mesh2_{fault}_")) / "tree"
    shutil.copytree(root, dest, ignore=shutil.ignore_patterns(
        ".git", "chiprun_out", "local", "__pycache__"))
    src = (dest / path).read_text()
    if src.count(old) != 1:
        raise ValueError(f"{fault}: the text to replace is not in {path} "
                         f"once")
    (dest / path).write_text(src.replace(old, new))
    return dest


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--runs", default="")
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--plant", choices=sorted(PLANTS))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    if args.plant:
        root = planted(root, args.plant)
        args.runs = PLANTS[args.plant][3]
    try:
        return run(root, args)
    finally:
        if args.plant:
            shutil.rmtree(root.parent, ignore_errors=True)


def run(root: Path, args) -> int:
    # the ranks are spawned: they import chip_smoke and the package from
    # `root` by this path
    sys.path.insert(0, str(root))
    os.chdir(root)
    import chip_smoke as cs
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    runs = tuple(args.runs.split(",")) if args.runs else cs.MESH2_RUNS
    if runs == ("5k",):
        runs = cs.MESH3_PATHS
    if runs == ("5l",):
        runs = cs.MESH4_RUNS
    mesh3 = tuple(r for r in runs if r.startswith("mesh3_"))
    mesh4 = tuple(r for r in runs if r.startswith("mesh4_"))
    runs = tuple(r for r in runs if r.startswith("mesh2_"))
    out = {"card": cs.card_line(), "label": args.label,
           "plain": args.plain, "plant": args.plant,
           "runs": list(runs + mesh3 + mesh4)}
    if mesh4:
        t0 = time.perf_counter()
        try:
            recs4, refs4 = cs.mesh4_world(args.seed, mesh4)
            out["5l"] = cs.mesh4_readings(recs4, refs4, mesh4)
        except AssertionError as e:   # a rank failed: report it
            out["error_5l"] = str(e)
        out["world_5l_s"] = time.perf_counter() - t0
    if mesh3:
        t0 = time.perf_counter()
        try:
            recs3 = cs.mesh3_world(args.seed, mesh3, args.plain)
            for name in mesh3:
                out[name] = {**cs.mesh3_train_readings(name, recs3),
                             **{k: recs3[0][name][k] for k in (
                                 "losses", "one_rank_losses", "grad_norms",
                                 "one_rank_grad_norms")}}
        except AssertionError as e:   # a rank failed: report it
            out["error_5k"] = str(e)
        out["world_5k_s"] = time.perf_counter() - t0
    recs = None
    t0 = time.perf_counter()
    try:
        if runs:
            recs = cs.mesh2_world(args.seed, runs, args.plain)
    except AssertionError as e:   # a rank failed: report it
        out["error"] = str(e)
        recs = None
    out["world_s"] = time.perf_counter() - t0
    if recs is not None:
        for name in cs.MESH2_TRAIN_MESHES:
            if name in runs:
                out[name] = {**cs.mesh2_train_readings(name, recs),
                             **{k: recs[0][name][k] for k in (
                                 "losses", "one_rank_losses", "grad_norms",
                                 "one_rank_grad_norms")}}
        cs.full_precision_gemms()
        if "mesh2_dp_engine" in runs:
            out["mesh2_dp_engine"] = cs.mesh2_dp_engine_readings(recs,
                                                                 args.seed)
        if "mesh2_int8" in runs:
            out["mesh2_int8"] = cs.mesh2_int8_readings(recs, args.seed)
        cs.full_precision_gemms(False)
    print(cs.card_line())
    print("mesh2_readings " + json.dumps(out))
    dest = HERE / "chiprun_out" / f"mesh2_readings_{args.label}.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
