"""Host-to-device prefetching loader wrapper (port of
``unidisc_tpu/data/prefetch.py``).

``DevicePrefetcher(loader, device)`` runs a host thread ahead of the
consumer: it draws each batch from the loader, stages its numpy arrays in
pinned host memory and copies them to the card with ``non_blocking=True``
on a side stream, recording an event after the copies. The consumer's
``next`` makes its current stream wait on that event before it hands the
batch out, so an unfinished copy is never read, and marks each tensor
with ``record_stream`` so the caching allocator keeps its memory until the
consumer's work on it is done. Entries that are not numpy arrays pass
through. On the CPU (``device="cpu"``) the arrays become tensors with no
copy and no stream. An exception of the loader is raised in the consumer.

Resume: the JAX wrapper's ``state_dict`` returns the loader's live state,
which its worker has already moved past up to depth + 1 batches that
training has not consumed, so a resume from it skips them. Here each batch
carries the loader state captured just after it was drawn, and
``state_dict`` returns the state of the last batch handed out: a loader
restored from it continues with the next batch training has not seen.
The worker starts at the first batch asked for, so ``load_state_dict``
before that restores the loader the worker will read.
"""

from __future__ import annotations

import copy
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from unidisc_tpu_torch.device import resolve_device

_END = object()


class DevicePrefetcher:
    def __init__(self, loader: Iterator, device="cuda", depth: int = 2):
        self.loader = loader
        self.device = resolve_device(device)
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = None
        self._state = self._loader_state()
        self._done = False
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None

    def _loader_state(self):
        if not hasattr(self.loader, "state_dict"):
            return {}
        return copy.deepcopy(self.loader.state_dict())

    def _stage(self, batch: dict):
        """The batch with its arrays on the device, and the event that
        marks the end of their copies (None on the CPU)."""
        arrays = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in batch.items() if isinstance(v, np.ndarray)}
        out = {k: v for k, v in batch.items()
               if not isinstance(v, np.ndarray)}
        if self._stream is None:
            out.update(arrays)
            return out, None
        with torch.cuda.stream(self._stream):
            for k, v in arrays.items():
                out[k] = v.pin_memory().to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _put(self, item) -> bool:
        """Queue an item unless closed; False once closed."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for batch in self.loader:
                if self._stop.is_set():
                    return
                state = self._loader_state()
                staged, event = self._stage(batch)
                if not self._put((staged, event, state)):
                    return
        except Exception as e:  # noqa: BLE001 - handed to the consumer
            self._put(e)
            return
        self._put(_END)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._done:
            raise StopIteration
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker,
                                            daemon=True)
            self._thread.start()
        item = self._q.get()
        if item is _END:
            self._done = True
            raise StopIteration
        if isinstance(item, Exception):
            self._done = True
            raise item
        batch, event, self._state = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for v in batch.values():
                if torch.is_tensor(v):
                    v.record_stream(stream)
        return batch

    def close(self) -> None:
        """Stop the worker (it ends after the batch it is drawing)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

    def state_dict(self):
        """The loader's state just after the last batch handed out."""
        return self._state

    def load_state_dict(self, state) -> None:
        if self._thread is not None:
            raise RuntimeError("load_state_dict before the first batch: the "
                               "worker has already read the loader")
        if hasattr(self.loader, "load_state_dict"):
            self.loader.load_state_dict(state)
        self._state = self._loader_state()
