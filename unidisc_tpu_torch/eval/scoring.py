"""Model scoring battery: generate inputs -> call model -> score -> analyze
(port of ``unidisc_tpu/eval/scoring.py``).

The reference's demo/scoring harness builds (image, caption, mask)
triplets, sweeps the server over conditioning modes, scores every output
with the reward stack and aggregates per mode. As in the JAX package:

  - inputs are procedural shape/color scenes with *derived* captions (the
    reference's own offline random-span masker, generate_input.py:74-84);
  - the model call is the in-process InferenceEngine (on the card its
    captured sampler programs);
  - rewards run through eval/rewards.py's registry.

PNGs are read and written through ``utils/png.py`` (the card's machine has
no PIL); an edit mask is written as an RGB image, which reads back as the
JAX package's grayscale one does after its RGB conversion.

CLI: python -m unidisc_tpu_torch.eval.scoring {generate-input,call-model,
generate-rewards,analyze-rewards} ... [--device cuda|cpu]
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

# Conditioning modes swept by the battery (reference:
# demo/scoring/call_model.py:287-293 iterate_over_modes — T2I, I2T,
# both-masked infill, caption-masked with full image, plain T2I).
MODES = {
    "cap": dict(use_image=False, use_img_mask=False,
                use_caption=True, use_cap_mask=False),       # T2I
    "img": dict(use_image=True, use_img_mask=False,
                use_caption=False, use_cap_mask=False),      # I2T
    "imgmask_capmask": dict(use_image=True, use_img_mask=True,
                            use_caption=True, use_cap_mask=True),
    "img_capmask": dict(use_image=True, use_img_mask=False,
                        use_caption=True, use_cap_mask=True),
}

_COLORS = {"red": (220, 40, 40), "green": (40, 200, 60),
           "blue": (50, 80, 230), "yellow": (230, 220, 50),
           "purple": (160, 60, 200), "white": (240, 240, 240)}
_SHAPES = ("square", "circle", "stripe")


def _render_scene(rng: np.random.Generator, size: int):
    """One procedural scene + its exact caption (the battery's ground
    truth; stands in for the reference's webdataset captions)."""
    names = list(_COLORS)
    bg, fg = rng.choice(names, 2, replace=False)
    shape = str(rng.choice(_SHAPES))
    img = np.ones((size, size, 3), np.float32) * \
        (np.asarray(_COLORS[bg], np.float32) / 255)
    c = np.asarray(_COLORS[fg], np.float32) / 255
    s = size // 4
    cx, cy = rng.integers(s, size - s, 2)
    if shape == "square":
        img[cy - s // 2:cy + s // 2, cx - s // 2:cx + s // 2] = c
    elif shape == "circle":
        yy, xx = np.mgrid[:size, :size]
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < (s // 2) ** 2] = c
    else:
        img[:, cx - s // 4:cx + s // 4] = c
    caption = f"a {fg} {shape} on a {bg} background"
    return img * 2 - 1, caption


def _render_scene_pos(rng: np.random.Generator, size: int, grid: int = 4):
    """Position-complete scene: the caption FULLY determines the image
    (the shape is drawn at a quantized grid cell named in the caption),
    so caption -> image tokens is a function and exact-token accuracy is
    well-posed. `_render_scene` omits the position — identical captions
    map to many images, capping exact-match accuracy regardless of model
    quality (round-3 A/B finding). Caption stays under 32 bytes."""
    names = list(_COLORS)
    bg, fg = rng.choice(names, 2, replace=False)
    shape = str(rng.choice(_SHAPES))
    row, col = int(rng.integers(0, grid)), int(rng.integers(0, grid))
    img = np.ones((size, size, 3), np.float32) * \
        (np.asarray(_COLORS[bg], np.float32) / 255)
    c = np.asarray(_COLORS[fg], np.float32) / 255
    s = size // 4
    cell = size // grid
    cy = row * cell + cell // 2
    cx = col * cell + cell // 2
    if shape == "square":
        img[max(cy - s // 2, 0):cy + s // 2,
            max(cx - s // 2, 0):cx + s // 2] = c
    elif shape == "circle":
        yy, xx = np.mgrid[:size, :size]
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < (s // 2) ** 2] = c
    else:
        img[:, max(cx - s // 4, 0):cx + s // 4] = c
    caption = f"{fg} {shape} r{row} c{col} on {bg}"
    return img * 2 - 1, caption


def mask_caption_spans(caption: str, rng: np.random.Generator,
                       mask_token: str = "<mask>") -> str:
    """Random contiguous word span -> mask tokens (the reference's offline
    masker, generate_input.py:74-84; percent drawn from 10..90)."""
    words = caption.split()
    if len(words) < 2:
        return mask_token
    frac = rng.choice([10, 20, 30, 40, 50, 60, 70, 80, 90]) / 100
    n = max(1, round(len(words) * frac))
    start = int(rng.integers(0, len(words) - n + 1))
    for i in range(start, start + n):
        words[i] = mask_token
    return " ".join(words)


def random_rect_mask(rng: np.random.Generator, size: int) -> np.ndarray:
    """Random rectangle bool mask (reference generate_input.py:86-99)."""
    w = int(rng.integers(max(1, size // 5), size * 9 // 10 + 1))
    h = int(rng.integers(max(1, size // 5), size * 9 // 10 + 1))
    x = int(rng.integers(0, size - w + 1))
    y = int(rng.integers(0, size - h + 1))
    out = np.zeros((size, size), bool)
    out[y:y + h, x:x + w] = True
    return out


def _save_png(path: Path, img: np.ndarray):
    from unidisc_tpu_torch.utils.png import encode_png
    if img.dtype == bool:
        arr = np.repeat(img.astype(np.uint8)[..., None] * 255, 3, -1)
    else:
        arr = ((img + 1) * 127.5).clip(0, 255).astype(np.uint8)
    Path(path).write_bytes(encode_png(arr))


def _load_png(path: Path) -> np.ndarray:
    from unidisc_tpu_torch.utils.png import decode_png
    return decode_png(Path(path).read_bytes()).astype(np.float32) \
        / 127.5 - 1


def generate_input(output_dir: Path, num_pairs: int = 16, *,
                   image_size: int = 64, seed: int = 0,
                   mask_img: bool = True, mask_txt: bool = True) -> None:
    """Write pair_NNNNNN/{image.png, caption.txt, mask_caption.txt,
    mask.png} (reference generate_input.py layout)."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(num_pairs):
        d = output_dir / f"pair_{i:06d}"
        d.mkdir(exist_ok=True)
        img, caption = _render_scene(rng, image_size)
        _save_png(d / "image.png", img)
        (d / "caption.txt").write_text(caption)
        (d / "mask_caption.txt").write_text(
            mask_caption_spans(caption, rng) if mask_txt else caption)
        if mask_img:
            _save_png(d / "mask.png", random_rect_mask(rng, image_size))


def _encode_image(engine, img: np.ndarray) -> np.ndarray:
    """An image in [-1, 1] resized to the codec's input (JAX's antialiased
    bilinear resize) and encoded: (img_length,) ids."""
    import torch
    import torch.nn.functional as F
    codec = engine.codec
    side = int(engine.m.img_length ** 0.5) * codec.downsample
    if img.shape[0] != side:
        x = torch.from_numpy(np.asarray(img, np.float32)).permute(2, 0, 1)
        img = F.interpolate(x[None], size=(side, side), mode="bilinear",
                            antialias=True, align_corners=False)[0].permute(
            1, 2, 0).numpy()
    return codec.encode(img[None]).cpu().numpy()[0]


def call_model(input_dir: Path, output_dir: Path, engine, *,
               modes: Optional[Sequence[str]] = None,
               num_pairs: Optional[int] = None, steps: Optional[int] = None,
               seed: int = 0, cfg_name: str = "default") -> List[Path]:
    """Sweep the engine over pairs x modes; write
    <output_dir>/<cfg_name>/<mode>__<pair>/{image.png, caption.txt,
    input_*.%, config.json} (reference call_model.py:139-226 layout)."""
    from unidisc_tpu_torch.serving.engine import decode_image_b64, \
        downscale_bool_mask

    input_dir, out_root = Path(input_dir), Path(output_dir) / cfg_name
    out_root.mkdir(parents=True, exist_ok=True)
    pair_dirs = sorted(p for p in input_dir.iterdir() if p.is_dir())
    if num_pairs is not None:
        pair_dirs = pair_dirs[:num_pairs]
    mode_names = list(modes or MODES)
    written = []
    for pair in pair_dirs:
        caption = (pair / "caption.txt").read_text().strip()
        mask_caption = (pair / "mask_caption.txt").read_text().strip() \
            if (pair / "mask_caption.txt").exists() else caption
        img = _load_png(pair / "image.png")
        for name in mode_names:
            mode = MODES[name]
            text = (mask_caption if mode["use_cap_mask"] else caption) \
                if (mode["use_caption"] or mode["use_cap_mask"]) else None
            image_ids = image_mask = None
            if mode["use_image"]:
                image_ids = _encode_image(engine, img)
                if mode["use_img_mask"] and (pair / "mask.png").exists():
                    m = _load_png(pair / "mask.png").mean(-1) > 0
                    side = int(engine.m.img_length ** 0.5)
                    if m.shape[0] // side >= 1 and \
                            m.shape[0] % side == 0:
                        image_mask = downscale_bool_mask(
                            m, m.shape[0] // side).reshape(-1)
                    else:
                        image_mask = np.zeros(engine.m.img_length, bool)
            result = engine.run(text=text, image_ids=image_ids,
                                image_mask=image_mask, steps=steps,
                                seed=seed)
            out = out_root / f"{name}__{pair.name}"
            out.mkdir(exist_ok=True)
            (out / "caption.txt").write_text(result["text"] or caption)
            if result.get("images_b64"):
                _save_png(out / "image.png",
                          decode_image_b64(result["images_b64"][0]))
            else:
                _save_png(out / "image.png", img)
            (out / "input_caption.txt").write_text(text or "")
            (out / "config.json").write_text(json.dumps(
                {"mode": name, "pair": pair.name, "steps": steps,
                 "seed": seed, "task": result.get("task", "auto")}))
            written.append(out)
    return written


def generate_rewards(input_dir: Path, output_file: Path, engine, *,
                     scorer_names: Sequence[str] = ("model_likelihood",
                                                    "token_entropy",
                                                    "image_diversity"),
                     batch_size: int = 8, rng_seed: int = 0) -> Dict:
    """Score every generated dir with the reward registry; write JSON
    {dir_name: {mode, rewards: {name: value}}} (reference
    generate_rewards.py; reward_config weighting happens in analyze). The
    model likelihood runs the engine's DIT on its device, every batch
    under the noise of `rng_seed`."""
    from unidisc_tpu_torch.eval.harness import model_apply_fn
    from unidisc_tpu_torch.eval.rewards import get_scorer

    input_dir = Path(input_dir)
    gen_dirs = sorted(p for p in input_dir.rglob("*__pair_*")
                      if p.is_dir())
    cfg = engine.config
    scorers = {}
    for name in scorer_names:
        kw = {}
        if name == "model_likelihood":
            kw = dict(config=cfg, apply_fn=model_apply_fn(cfg, engine.model),
                      seed=rng_seed, device=engine.device)
        elif name == "token_entropy":
            kw = dict(vocab_size=cfg.model.vocab_size)
        scorers[name] = get_scorer(name, **kw)

    results = {}
    for i in range(0, len(gen_dirs), batch_size):
        chunk = gen_dirs[i:i + batch_size]
        texts = [(d / "caption.txt").read_text().strip() for d in chunk]
        imgs = np.stack([_load_png(d / "image.png") for d in chunk])
        image_ids = np.stack([_encode_image(engine, im) for im in imgs])
        txt_ids = engine.tokenizer(
            texts, max_length=cfg.model.txt_length)["input_ids"]
        input_ids = np.concatenate(
            [txt_ids, image_ids + cfg.model.text_vocab_size], -1)
        modality = np.concatenate([
            np.zeros_like(txt_ids),
            np.ones_like(image_ids)], -1)
        batch = {"input_ids": input_ids.astype(np.int32),
                 "modality": modality.astype(np.int32),
                 "image_ids": image_ids, "images": imgs, "texts": texts}
        for j, d in enumerate(chunk):
            mode = json.loads((d / "config.json").read_text())["mode"] \
                if (d / "config.json").exists() else d.name.split("__")[0]
            results[str(d.relative_to(input_dir))] = {
                "mode": mode, "rewards": {}}
        for name, score in scorers.items():
            vals = np.asarray(score(batch), np.float64)
            for j, d in enumerate(chunk):
                results[str(d.relative_to(input_dir))]["rewards"][name] = \
                    float(vals[j])
    Path(output_file).write_text(json.dumps(results, indent=1))
    return results


def analyze_rewards(rewards_file: Path, *,
                    weights: Optional[Dict[str, float]] = None,
                    output_file: Optional[Path] = None) -> Dict:
    """Per-mode mean/std per reward + weighted total, ranked
    (reference analyze_rewards.py aggregation)."""
    data = json.loads(Path(rewards_file).read_text())
    by_mode: Dict[str, Dict[str, List[float]]] = {}
    for rec in data.values():
        mode = rec["mode"]
        for name, v in rec["rewards"].items():
            by_mode.setdefault(mode, {}).setdefault(name, []).append(v)
    summary = {}
    for mode, rewards in sorted(by_mode.items()):
        stats = {name: {"mean": float(np.mean(v)), "std": float(np.std(v)),
                        "n": len(v)}
                 for name, v in rewards.items()}
        total = sum(stats[n]["mean"] * (weights or {}).get(n, 1.0)
                    for n in stats)
        summary[mode] = {"rewards": stats, "total": total}
    ranked = sorted(summary, key=lambda m: -summary[m]["total"])
    out = {"summary": summary, "ranking": ranked}
    if output_file is not None:
        Path(output_file).write_text(json.dumps(out, indent=1))
    for mode in ranked:
        row = " ".join(f"{n}={s['mean']:+.4f}"
                       for n, s in summary[mode]["rewards"].items())
        print(f"{mode:20s} total={summary[mode]['total']:+.4f}  {row}")
    return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="unidisc_tpu_torch.eval.scoring")
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("generate-input")
    g.add_argument("output_dir", type=Path)
    g.add_argument("--num-pairs", type=int, default=16)
    g.add_argument("--image-size", type=int, default=64)
    g.add_argument("--seed", type=int, default=0)
    c = sub.add_parser("call-model")
    c.add_argument("--input-dir", type=Path, required=True)
    c.add_argument("--output-dir", type=Path, required=True)
    c.add_argument("--preset", default="tiny")
    c.add_argument("--checkpoint", default=None)
    c.add_argument("--codec", default="dummy")
    c.add_argument("--steps", type=int, default=None)
    c.add_argument("--num-pairs", type=int, default=None)
    c.add_argument("--device", default="cuda")
    r = sub.add_parser("generate-rewards")
    r.add_argument("--input-dir", type=Path, required=True)
    r.add_argument("--output-file", type=Path, required=True)
    r.add_argument("--preset", default="tiny")
    r.add_argument("--checkpoint", default=None)
    r.add_argument("--codec", default="dummy")
    r.add_argument("--device", default="cuda")
    a = sub.add_parser("analyze-rewards")
    a.add_argument("rewards_file", type=Path)
    a.add_argument("--output-file", type=Path, default=None)
    args = ap.parse_args(argv)

    if args.cmd == "generate-input":
        generate_input(args.output_dir, args.num_pairs,
                       image_size=args.image_size, seed=args.seed)
        return
    if args.cmd == "analyze-rewards":
        analyze_rewards(args.rewards_file, output_file=args.output_file)
        return

    # the two engine-backed commands
    from unidisc_tpu_torch.serving.engine import build_engine
    engine = build_engine(preset=args.preset, checkpoint=args.checkpoint,
                          codec_name=args.codec, device=args.device)
    if args.cmd == "call-model":
        call_model(args.input_dir, args.output_dir, engine,
                   steps=args.steps, num_pairs=args.num_pairs)
    else:
        generate_rewards(args.input_dir, args.output_file, engine)


if __name__ == "__main__":
    main()
