"""Dataset adapters for the precompute pipeline (port of
``unidisc_tpu/data/hf_datasets.py``).

Each adapter yields (caption, image (H, W, 3) float32 in [-1, 1]) pairs
for ``data/precompute.py::precompute_tokens`` (``text_stream`` yields
texts): Hugging Face datasets (``hf_stream`` over a path the caller gives,
``hf_image_caption_stream`` over the named ``DATASETS``), a local folder
of images with sidecar captions, the run dir of the generate CLI, and
unpaired image and text sources. Images are resized with PIL's bicubic
filter, as in the JAX package.

``datasets`` and PIL are imported inside the functions that need them; a
missing package raises an ``ImportError`` that names it. Rows are skipped
only where an image fails to decode (PIL's ``UnidentifiedImageError`` /
``OSError``) or a ``samples.jsonl`` line is not JSON; the JAX adapters
skip a row on any exception.
"""

from __future__ import annotations

import importlib
import json
import pathlib
from typing import Iterator, Optional, Tuple

import numpy as np

# dataset name -> (hf path, image column, caption column)
DATASETS = {
    "imagenet": ("imagenet-1k", "image", "label"),
    "cc12m": ("pixparse/cc12m-wds", "jpg", "txt"),
    "cc12m_3m": ("pixparse/cc12m-wds", "jpg", "txt"),
    "cub200": ("Multimodal-Fatima/CUB_train", "image", "description"),
    "mjhq": ("playgroundai/MJHQ-30K", "image", "prompt"),
    "coco": ("HuggingFaceM4/COCO", "image", "sentences"),
    "laion-aesthetic": ("laion/laion2B-en-aesthetic", "URL", "TEXT"),
    "laion400m": ("laion/laion400m", "URL", "TEXT"),
    "facecaption": ("OpenFace-CQUPT/FaceCaption-15M", "image", "caption"),
    "vggface2": ("ProgramComputer/VGGFace2", "image", "label"),
    "flickr30k": ("nlphuji/flickr30k", "image", "caption"),
    "winoground": ("facebook/winoground", "image_0", "caption_0"),
    "geneval": ("djghosh/geneval", "image", "prompt"),
    "mmc4": ("HuggingFaceM4/mmc4", "image", "text"),
    "cambrian": ("nyu-visionx/Cambrian-10M", "image", "conversations"),
}

# text-only datasets for the unpaired path: name -> (hf path, text column)
TEXT_DATASETS = {
    "text8": ("afmck/text8", "text"),
    "lm1b": ("lm1b", "text"),
    "openwebtext": ("openwebtext", "text"),
    "fineweb": ("HuggingFaceFW/fineweb", "text"),
}


def _require(module: str, package: str):
    """Import `module`, or raise an ImportError naming `package`."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"data/hf_datasets.py needs the {package!r} "
                          f"package, which is not installed") from e


def _image_module():
    return _require("PIL.Image", "Pillow")


def _decode_errors(image) -> tuple:
    """The exceptions of an image that fails to decode."""
    return (image.UnidentifiedImageError, OSError)


def _prep_image(img, image_size: int) -> np.ndarray:
    image = _image_module()
    if not isinstance(img, image.Image):
        img = image.fromarray(np.asarray(img))
    img = img.convert("RGB").resize((image_size, image_size),
                                    image.BICUBIC)
    return np.asarray(img, np.float32) / 127.5 - 1.0


def _load(path: str, split: str, streaming: bool):
    datasets = _require("datasets", "datasets")
    try:
        return datasets.load_dataset(path, split=split, streaming=streaming)
    except Exception as e:  # noqa: BLE001 - raised again with the advice
        raise RuntimeError(
            f"could not load HF dataset {path!r} ({type(e).__name__}: {e}); "
            f"on a machine with no network, pre-download it with "
            f"`datasets.load_dataset` elsewhere, or use the procedural "
            f"images (python -m unidisc_tpu_torch.data.precompute)") from e


def hf_image_caption_stream(name: str, *, split: str = "train",
                            image_size: int = 256,
                            limit: Optional[int] = None,
                            streaming: bool = True
                            ) -> Iterator[Tuple[str, np.ndarray]]:
    """(caption, image) pairs of a dataset named in ``DATASETS``."""
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(DATASETS)} "
                       f"(or pass any HF path via hf_stream)")
    path, img_col, cap_col = DATASETS[name]
    yield from hf_stream(path, img_col, cap_col, split=split,
                         image_size=image_size, limit=limit,
                         streaming=streaming)


def hf_stream(path: str, img_col: str, cap_col: str, *, split="train",
              image_size=256, limit=None, streaming=True
              ) -> Iterator[Tuple[str, np.ndarray]]:
    """(caption, image) pairs of the HF dataset at `path`: rows missing
    either column are skipped; a list caption gives its first entry, a
    dict caption its "raw"."""
    ds = _load(path, split, streaming)
    errors = _decode_errors(_image_module())
    n = 0
    for row in ds:
        if limit is not None and n >= limit:
            return
        img, cap = row.get(img_col), row.get(cap_col)
        if img is None or cap is None:
            continue
        if isinstance(cap, (list, tuple)):
            cap = cap[0] if cap else ""
        if isinstance(cap, dict):
            cap = cap.get("raw", "")
        try:
            image = _prep_image(img, image_size)
        except errors:
            continue
        yield str(cap), image
        n += 1


def text_stream(name: str, *, split: str = "train",
                limit: Optional[int] = None, streaming: bool = True
                ) -> Iterator[str]:
    """The non-empty texts of a ``TEXT_DATASETS`` name, or of any HF path
    with a "text" column."""
    path, col = TEXT_DATASETS.get(name, (name, "text"))
    ds = _load(path, split, streaming)
    n = 0
    for row in ds:
        if limit is not None and n >= limit:
            return
        t = row.get(col)
        if t:
            yield str(t)
            n += 1


def imagefolder_stream(root: str, *, image_size: int = 256,
                       limit: Optional[int] = None
                       ) -> Iterator[Tuple[str, np.ndarray]]:
    """The images (.png, .jpg, .jpeg, .webp) under `root`, sorted, each
    captioned by its sidecar x.txt, else its directory's name with "_"
    as spaces; a file that fails to decode is skipped."""
    image = _image_module()
    errors = _decode_errors(image)
    n = 0
    for p in sorted(pathlib.Path(root).rglob("*")):
        if p.suffix.lower() not in (".png", ".jpg", ".jpeg", ".webp"):
            continue
        if limit is not None and n >= limit:
            return
        cap_file = p.with_suffix(".txt")
        cap = cap_file.read_text().strip() if cap_file.exists() \
            else p.parent.name.replace("_", " ")
        try:
            img = image.open(p)
        except errors:
            continue
        yield cap, _prep_image(img, image_size)
        n += 1


def generated_images_stream(run_dir: str, *, image_size: int = 256,
                            limit: Optional[int] = None
                            ) -> Iterator[Tuple[str, np.ndarray]]:
    """The PNGs of a generate-CLI run dir with their ``samples.jsonl``
    captions ("" for a PNG with none); a line that is not JSON is
    skipped."""
    root = pathlib.Path(run_dir)
    caps = {}
    meta = root / "samples.jsonl"
    if meta.exists():
        for line in meta.read_text().splitlines():
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            caps[rec.get("image", "")] = rec.get("text", "")
    image = _image_module()
    n = 0
    for p in sorted(root.glob("*.png")):
        if limit is not None and n >= limit:
            return
        yield caps.get(p.name, ""), _prep_image(image.open(p), image_size)
        n += 1


def unpaired_stream(image_iter, text_iter, *, seed: int = 0,
                    buffer: int = 256) -> Iterator[Tuple[str, np.ndarray]]:
    """Images of one source paired at random with texts of another: the
    first `buffer` texts fill a pool; each image takes a random pool slot's
    text, which the next text replaces (the pool's texts are reused once
    the text source ends)."""
    rng = np.random.default_rng(seed)
    pool = []
    for t in text_iter:
        pool.append(t)
        if len(pool) >= buffer:
            break
    if not pool:
        raise ValueError("empty text stream")
    for _, img in image_iter:
        try:
            new_t = next(text_iter)
            j = int(rng.integers(0, len(pool)))
            t, pool[j] = pool[j], new_t
        except StopIteration:
            t = pool[int(rng.integers(0, len(pool)))]
        yield t, img
