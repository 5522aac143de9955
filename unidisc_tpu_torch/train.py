"""Training CLI (port of ``unidisc_tpu/train.py``):

    python -m unidisc_tpu_torch.train [--device cpu] [--run-dir DIR]
        [--batch-size N] [--data DIR[,DIR...] [--stream]] [--overfit]
        [--iterate-data-only N] [--print-hashes] [--flagship]
        [key=value ...]

key=value arguments are dotted overrides of the Config; ``model=<preset>``
picks a size preset. ``--flagship`` starts from FLAGSHIP_TRAIN_OVERRIDES
(the flagship model and the production loss settings) before the
overrides. The model trains on the card unless ``--device cpu`` is given.
``--base-checkpoint DIR`` names the frozen base of a LoRA run
(``model.lora_rank=16``): a port run dir, whose EMA weights are loaded.

Every training mode of the Trainer is reached through the overrides:
``trainer.optimizer=adafactor|lion|ademamix|muon``, ``model.mup=True``,
``trainer.use_gradient_checkpointing=True model.remat_policy=dots``,
``model.dropout=0.1``, ``trainer.add_label=True model.add_labels=N``,
``trainer.host_offload_optimizer=True``. A run stopped by SIGTERM or
SIGUSR1 checkpoints and exits with 128 + the signal's number, so that
``python -m unidisc_tpu_torch.training.supervisor -- <this command>``
relaunches it and it resumes.

Data: synthetic batches by default; ``--data`` names token-shard
directories (``data/token_shards.py``), sampled by
``data.dataset_weights`` (default: their sizes); with ``--stream`` one
directory of ``shard-*.npz`` files, or of ragged ``ishard-*.npz``
documents under ``trainer.interleaved`` (packed into rows of
``model.length`` as they stream), is streamed in order with exact
mid-epoch resume (``data/streaming.py``). The validation loader is the
same source at seed + 777. ``--iterate-data-only N`` reads N batches
without the model and reports the loader's host tok/s.

Under torchrun (``torchrun --nproc-per-node N -m unidisc_tpu_torch.train
mesh.fsdp=2 mesh.seq=2 ...``) every rank joins the process group
(``utils/dist.py::initialize``), the Trainer lays ``config.mesh`` over the
ranks, and each rank's loader yields its rows of the global batch
(``--batch-size`` stays the global batch).
"""

from __future__ import annotations

import argparse
import ast
import sys
import time

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


def make_loaders(config: Config, batch: int, data=None, stream=False):
    """(train loader, validation loader) of the CLI's data options."""
    if data and stream:
        from unidisc_tpu_torch.data.streaming import StreamingShardReader
        from unidisc_tpu_torch.models.rotary import rope_offsets
        packed = {}
        if config.trainer.interleaved:
            # ragged shards pack into rows of the model's length with EOS
            # 2 (JAX train.py); under img_resolutions the image tokens
            # index the combined rope table, so the packer takes its
            # offsets (JAX passes none: ROADMAP section 3)
            packed = dict(pack_length=config.model.length, eos_id=2,
                          rope_offsets=rope_offsets(config.model))
        return tuple(StreamingShardReader(data, batch_size=batch, seed=seed,
                                          **packed)
                     for seed in (config.seed, config.seed + 777))
    if data:
        from unidisc_tpu_torch.data.token_shards import (
            TokenShardDataset, WeightedDatasetSampler)
        dsets = [TokenShardDataset(d) for d in data.split(",")]
        length = dsets[0].meta.get("length")
        if length and length != config.model.length:
            print(f"[train] WARNING: model.length={config.model.length} but "
                  f"shard rows are {length} tokens; the model trains on "
                  f"the shard layout. Set model.length/txt_length/"
                  f"img_length to match.")
        weights = config.data.dataset_weights
        return (WeightedDatasetSampler(dsets, weights, batch_size=batch,
                                       seed=config.seed),
                WeightedDatasetSampler(dsets, weights, batch_size=batch,
                                       seed=config.seed + 777,
                                       shuffle=False))
    return (SyntheticDataLoader(config, batch, seed=config.seed),
            SyntheticDataLoader(config, batch, seed=config.seed + 777))


class RankRows:
    """The rows [rank * b, (rank + 1) * b) of a loader's global batches
    (b = the global batch over the ranks); its other attributes (state)
    are the loader's."""

    def __init__(self, loader, rank: int, world: int):
        self.loader, self.rank, self.world = loader, rank, world

    def __iter__(self):
        for batch in self.loader:
            out = {}
            for k, v in batch.items():
                n = v.shape[0] // self.world if hasattr(v, "shape") else 0
                out[k] = v[self.rank * n:(self.rank + 1) * n] if n else v
            yield out

    def __getattr__(self, name):
        if name == "loader":
            raise AttributeError(name)
        return getattr(self.loader, name)


def build_parser() -> argparse.ArgumentParser:
    """The CLI's flags: JAX's ``train.py`` flags but ``--wandb``, and the
    port's own (``--device``, ``--flagship``, ``--base-checkpoint``)."""
    parser = argparse.ArgumentParser(
        description="unidisc_tpu_torch trainer",
        usage="python -m unidisc_tpu_torch.train [--device cpu] "
              "[--run-dir DIR] [--data DIR[,DIR] [--stream]] [--flagship] "
              "[key=value ...]")
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
    parser.add_argument("--data", default=None,
                        help="comma-separated token-shard dirs; default "
                             "synthetic data")
    parser.add_argument("--stream", action="store_true",
                        help="stream one dir of shard-*.npz (or, under "
                             "trainer.interleaved, ishard-*.npz) files in "
                             "order, "
                             "with exact mid-epoch resume")
    parser.add_argument("--base-checkpoint", default=None,
                        help="a port run dir: the frozen base of a LoRA "
                             "run (its EMA weights)")
    parser.add_argument("--print-hashes", action="store_true",
                        help="print the parameters' hash before the first "
                             "step (determinism check)")
    parser.add_argument("--iterate-data-only", type=int, default=0,
                        help="read N batches without the model and report "
                             "the loader's host tok/s")
    return parser


def main(argv=None):
    args, rest = build_parser().parse_known_args(argv)

    from unidisc_tpu_torch.utils import dist as udist
    udist.initialize(device=args.device)
    model, overrides = parse_overrides(rest)
    base = dict(FLAGSHIP_TRAIN_OVERRIDES) if args.flagship else {}
    config = Config.make(model, **{**base, **overrides}).validate()
    batch = args.batch_size or config.trainer.global_batch_size
    train_loader, val_loader = make_loaders(config, batch, args.data,
                                            args.stream)
    if udist.world_size() > 1:
        udist.host_local_batch_size(batch)
        train_loader, val_loader = (
            RankRows(x, udist.rank(), udist.world_size())
            for x in (train_loader, val_loader))

    if args.iterate_data_only:
        t0 = time.perf_counter()
        n_tok = 0
        for i, b in enumerate(train_loader):
            if i >= args.iterate_data_only:
                break
            n_tok += b["input_ids"].size
        tok_s = n_tok / (time.perf_counter() - t0)
        print(f"[train] data-only: {args.iterate_data_only} batches, "
              f"{tok_s / 1e6:.2f}M tok/s host-side")
        return {"step": 0, "data_tok_per_s": tok_s}

    trainer = Trainer(config, args.run_dir, device=args.device,
                      log_every=args.log_every, val_every=args.val_every,
                      ckpt_every=args.ckpt_every,
                      base_checkpoint=args.base_checkpoint)
    print(f"[train] model={model} params={trainer.n_params / 1e6:.1f}M "
          f"device={trainer.device} batch={batch}")
    try:
        result = trainer.fit(train_loader, val_loader,
                             overfit_first_batch=args.overfit,
                             print_hashes=args.print_hashes)
    finally:
        trainer.close()
    if "signal" in result:
        print(f"[train] stopped by signal {result['signal']} at step "
              f"{result['step']} (checkpointed)", flush=True)
        sys.exit(128 + result["signal"])
    print(f"[train] done at step {result['step']}: "
          f"loss={result.get('loss', float('nan')):.4f}")
    return result


if __name__ == "__main__":
    main()
