#!/usr/bin/env python3
"""Time the MoE flagship's train step of one tree on the card.

    python3 scripts/moe_step_times.py [--root DIR] [--label NAME]
                                      [--steps N]

The model is phase 5g's MoE flagship (``chip_smoke.py``'s
``train_config`` with ``MOE_OVERRIDES``: 12 blocks, 8 experts, top-2) at
batch ``TRAIN_BATCH`` on a random [text | image] batch, trained from its
seeded init by ``make_train_step``. --root is the repository root whose
``unidisc_tpu_torch`` is timed (default: this one), e.g. a ``git archive``
of another commit unpacked into a git-ignored directory; its kernels build
into DIR/build. Run two trees in one call (parent, change, change,
parent) to compare them on one card. Prints the card line and one JSON
line (each step's seconds after 3 warm-up steps, their median, the peak
memory), and writes chiprun_out/moe_step_times_<label>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from attention_kernel_times import load_helpers  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    cs = load_helpers(root)
    import numpy as np
    import torch
    from unidisc_tpu_torch.models.dit import DIT
    from unidisc_tpu_torch.training.train_state import (init_train_state,
                                                        make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    os.chdir(root)
    cs.phase_build()
    cfg = cs.train_config(**cs.MOE_OVERRIDES)
    m, b = cfg.model, cs.TRAIN_BATCH
    model = DIT(m, compute_dtype=torch.bfloat16, init=False)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.cuda()
    state = init_train_state(cfg, model)
    step = make_train_step(cfg, model)
    rng = np.random.RandomState(0)
    ids = np.concatenate([
        rng.randint(0, m.text_vocab_size - 1, (b, m.txt_length)),
        rng.randint(m.text_vocab_size, m.vocab_size, (b, m.img_length))], -1)
    mod = np.concatenate([np.zeros((b, m.txt_length)),
                          np.ones((b, m.img_length))], -1)
    batch = {"input_ids": torch.from_numpy(ids).cuda(),
             "modality": torch.from_numpy(mod.astype(np.int64)).cuda()}
    gen = torch.Generator(device="cuda")
    secs = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(3 + args.steps):
        gen.manual_seed(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, generator=gen)
        torch.cuda.synchronize()
        if i >= 3:
            secs.append(time.perf_counter() - t0)
    rec = {"label": args.label, "root": str(root), "card": cs.card_line(),
           "batch": b, "length": m.length, "n_blocks": m.n_blocks,
           "experts": m.moe_experts, "top_k": m.moe_top_k,
           "step_s": secs, "median_step_s": statistics.median(secs),
           "final_loss": float(metrics.loss),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    print(rec["card"])
    print(json.dumps(rec))
    out = Path(__file__).resolve().parents[1] / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"moe_step_times_{args.label}.json").write_text(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
