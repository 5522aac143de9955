"""Checkpointing for the port's train state (port of
``unidisc_tpu/training/checkpoint.py``, with ``torch.save`` in place of
Orbax).

Layout: ``<dir>/<step>/state.pt`` (``TrainState.state_dict()``, tensors
on the CPU) and ``<dir>/<step>/meta.json`` (the config snapshot, the step
and extras such as the data loader's state). A step is written into a
temporary directory and renamed into place, so a step directory that
exists is complete. At most ``max_to_keep`` steps are kept.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import List, Optional

import torch

from unidisc_tpu_torch.config import Config


class CheckpointManager:
    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1000):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, state, config: Config,
             extra: Optional[dict] = None, force: bool = False,
             write: bool = True) -> bool:
        """Save unless the step exists already or, without force, is off
        the save interval. Returns True if a checkpoint was written (or,
        with write False, would have been). write False: gather the state
        (a mesh's ranks all call ``state_dict``) but write nothing; rank 0
        writes."""
        step = int(step)
        if step in self.all_steps():
            return False
        if not force and self.save_interval_steps and \
                step % self.save_interval_steps:
            return False
        meta = {"config": json.loads(config.to_json()), "step": step,
                **(extra or {})}
        tensors = _to_cpu(state.state_dict())
        if not write:
            return True
        tmp = tempfile.mkdtemp(prefix=f".{step}-", dir=self.directory)
        try:
            torch.save(tensors, os.path.join(tmp, "state.pt"))
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            os.replace(tmp, self._step_dir(step))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old))
        return True

    def restore(self, state, step: Optional[int] = None) -> tuple:
        """Load a step (the latest by default) into `state` in place.
        Returns (state, meta)."""
        step = self._resolve(step)
        state.load_state_dict(self.read_state(step))
        return state, self.read_meta(step)

    def read_state(self, step: Optional[int] = None) -> dict:
        """A step's saved ``TrainState.state_dict`` (CPU tensors), without
        a state to load it into: serving reads only its EMA."""
        return torch.load(os.path.join(self._step_dir(self._resolve(step)),
                                       "state.pt"),
                          map_location="cpu", weights_only=True)

    def read_meta(self, step: Optional[int] = None) -> dict:
        with open(os.path.join(self._step_dir(self._resolve(step)),
                               "meta.json")) as f:
            return json.load(f)

    def _resolve(self, step: Optional[int]) -> int:
        step = self.latest_step() if step is None else int(step)
        if step is None or step not in self.all_steps():
            raise FileNotFoundError(f"no checkpoint for step {step} in "
                                    f"{self.directory}")
        return step

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit())


def _to_cpu(tree):
    """Compact CPU copies: the state's tensors may be views of one flat
    buffer, which torch.save would otherwise write whole for each view.
    Values that are not tensors (a layout's names and shapes) pass as
    they are."""
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if not torch.is_tensor(tree):
        return tree
    return tree.detach().to("cpu", copy=True)
