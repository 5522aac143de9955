"""ctypes binding to the native interleaved-document packer,
``native/packer.cpp`` (the port's own binding of the JAX package's C++
twin of ``data/interleaved.py::pack_documents``; the same arrays, bit for
bit).

At first use the source is compiled with ``g++ -O3`` into the port's
``build/`` directory (``ops/_build.py::BUILD_DIR``) under a name that
carries the hash of the source and of the flags, and loaded with
``ctypes``; the source is only read. A failed build or load raises:
nothing falls back to the Python packer, whose choice is the caller's
(``data/streaming.py``'s ``packer=``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from unidisc_tpu_torch.data.interleaved import Document, PackedBatch
from unidisc_tpu_torch.ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parents[2] / "native" / "packer.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile ``native/packer.cpp`` into ``build/libpacker-<hash>.so``
    unless that file exists already. Returns the library's path."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    out = BUILD_DIR / f"libpacker-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native packer needs a C++ "
                           "compiler (or pass packer='python')")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {SRC.name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded packer library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.pack_documents_i32.restype = ctypes.c_int32
            lib.pack_documents_i32.argtypes = [i32p] * 5 + \
                [ctypes.c_int32] * 5 + [i32p] * 5 + [ctypes.c_int32]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def pack_documents_native(docs: Sequence[Document], length: int, *,
                          pad_id: int, eos_id: Optional[int] = None,
                          batch_size: Optional[int] = None,
                          rope_offsets: Optional[dict] = None
                          ) -> PackedBatch:
    """``interleaved.pack_documents`` through the native packer."""
    lib = load()
    seg_ids, seg_len, seg_kind, seg_doc, seg_base = [], [], [], [], []
    for d, doc in enumerate(docs):
        for seg in doc.segments:
            ids = np.asarray(seg.ids, np.int32).reshape(-1)
            is_img = seg.kind == "image"
            seg_ids.append(ids)
            seg_len.append(len(ids))
            seg_kind.append(int(is_img))
            seg_doc.append(d)
            seg_base.append(rope_offsets[len(ids)]
                            if is_img and rope_offsets is not None else 0)
    flat = np.ascontiguousarray(
        np.concatenate(seg_ids) if seg_ids else np.zeros(0, np.int32),
        np.int32)

    def arr(x):
        return np.ascontiguousarray(np.asarray(x, np.int32))
    seg_len_a, seg_kind_a = arr(seg_len), arr(seg_kind)
    seg_doc_a, seg_base_a = arr(seg_doc), arr(seg_base)
    max_rows = max(len(docs), 1)
    outs = [np.empty((max_rows, length), np.int32) for _ in range(5)]
    b = lib.pack_documents_i32(
        _ptr(flat), _ptr(seg_len_a), _ptr(seg_kind_a), _ptr(seg_doc_a),
        _ptr(seg_base_a), len(seg_len), len(docs), length, pad_id,
        -1 if eos_id is None else eos_id, *map(_ptr, outs), max_rows)
    if b < 0:
        raise ValueError("the native packer refused the segments")

    def fit(a, fill):
        a = a[:b]
        if batch_size is not None:
            if b < batch_size:
                pad = np.full((batch_size - b, length), fill, np.int32)
                a = np.concatenate([a, pad], 0)
            a = a[:batch_size]
        return a

    input_ids, modality, sample_ids, rope_index, img_block_index = (
        fit(a, fill) for a, fill in zip(outs, (pad_id, 0, -1, 0, 0)))
    return PackedBatch(
        input_ids=input_ids, modality=modality, sample_ids=sample_ids,
        rope_index=rope_index, img_block_index=img_block_index,
        attention_mask=(sample_ids >= 0))
