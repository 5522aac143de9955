"""Training CLI (port of ``unidisc_tpu/train.py``) on synthetic data:

    python -m unidisc_tpu_torch.train [--device cpu] [--run-dir DIR]
        [--batch-size N] [--overfit] [--flagship] [key=value ...]

key=value arguments are dotted overrides of the Config; ``model=<preset>``
picks a size preset. ``--flagship`` starts from FLAGSHIP_TRAIN_OVERRIDES
(the flagship model and the production loss settings) before the
overrides. The model trains on the card unless ``--device cpu`` is given.
Token shards and streaming are not in the port yet.
"""

from __future__ import annotations

import argparse
import ast

from unidisc_tpu_torch.config import (FLAGSHIP_TRAIN_OVERRIDES,
                                      MODEL_PRESETS, Config)
from unidisc_tpu_torch.data.synthetic import SyntheticDataLoader
from unidisc_tpu_torch.training.trainer import Trainer


def parse_overrides(argv):
    model = "small"
    overrides = {}
    for arg in argv:
        if "=" not in arg:
            raise SystemExit(f"expected key=value, got {arg!r}")
        key, val = arg.split("=", 1)
        if key == "model" and val in MODEL_PRESETS:
            model = val
            continue
        try:
            overrides[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            overrides[key] = val
    return model, overrides


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="unidisc_tpu_torch trainer",
        usage="python -m unidisc_tpu_torch.train [--device cpu] "
              "[--run-dir DIR] [--flagship] [key=value ...]")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--run-dir", default="runs/dev")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="rows per step; default "
                             "trainer.global_batch_size")
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--val-every", type=int, default=0)
    parser.add_argument("--ckpt-every", type=int, default=1000)
    parser.add_argument("--overfit", action="store_true",
                        help="train on the first batch only (a loss-goes-"
                             "down smoke run)")
    parser.add_argument("--flagship", action="store_true",
                        help="start from FLAGSHIP_TRAIN_OVERRIDES")
    args, rest = parser.parse_known_args(argv)

    model, overrides = parse_overrides(rest)
    base = dict(FLAGSHIP_TRAIN_OVERRIDES) if args.flagship else {}
    config = Config.make(model, **{**base, **overrides}).validate()
    batch = args.batch_size or config.trainer.global_batch_size

    train_loader = SyntheticDataLoader(config, batch, seed=config.seed)
    val_loader = SyntheticDataLoader(config, batch, seed=config.seed + 777)
    trainer = Trainer(config, args.run_dir, device=args.device,
                      log_every=args.log_every, val_every=args.val_every,
                      ckpt_every=args.ckpt_every)
    print(f"[train] model={model} params={trainer.n_params / 1e6:.1f}M "
          f"device={trainer.device} batch={batch}")
    try:
        result = trainer.fit(train_loader, val_loader,
                             overfit_first_batch=args.overfit)
    finally:
        trainer.close()
    print(f"[train] done at step {result['step']}: "
          f"loss={result.get('loss', float('nan')):.4f}")
    return result


if __name__ == "__main__":
    main()
