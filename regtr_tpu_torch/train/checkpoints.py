"""Checkpoints with the optimizer's state, and parameters in the flat .npz
interchange format (the port's counterpart of regtr_tpu/train/
checkpoints.py).

`CheckpointManager` keeps the JAX one's contract in the port's own format
(orbax is not a dependency of the port): one directory per step, <step>/,
holding state.pt (a `torch.save` of the model's state_dict, the
optimizer's state and the step, read back with weights_only=True) and
checkpoint.json (the step and its save time); best.json records the best
validation score, {"step", "score"}, higher is better.  Like orbax's
manager, it keeps the last `max_to_keep` checkpoints and, every
`keep_every_hours`, one for good.

The .npz archive holds one array per parameter under JAX's 'a/b/c' keys
(the format tools/convert_torch_ckpt.py writes too), so the JAX package and
the port read each other's files.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..convert import jax_params_from_state_dict, state_dict_from_jax

logger = logging.getLogger("regtr_tpu_torch")

_STATE = "state.pt"
_INFO = "checkpoint.json"
# the save time's clock (a test replaces it)
_now = time.time


def resolve_ckpt_dir(path) -> Path:
    """A run directory or its ckpt/ -> the checkpoint directory."""
    path = Path(path).resolve()
    return path / "ckpt" if (path / "ckpt").is_dir() else path


class CheckpointManager:
    def __init__(self, ckpt_dir, max_to_keep: int = 6,
                 keep_every_hours: Optional[float] = 3.0):
        self.directory = Path(ckpt_dir).resolve()
        self.max_to_keep = max_to_keep
        self.keep_every_s = (None if keep_every_hours is None
                             else keep_every_hours * 3600.0)
        self._best_file = self.directory / "best.json"
        # step -> save time, of the checkpoints on disk
        self._times = {}
        if self.directory.is_dir():
            for d in self.directory.iterdir():
                if d.name.isdigit() and (d / _INFO).exists():
                    info = json.loads((d / _INFO).read_text())
                    self._times[int(info["step"])] = float(info["time"])

    # -- save ---------------------------------------------------------------
    def save(self, step: int, model: torch.nn.Module, optimizer=None,
             score: Optional[float] = None) -> bool:
        """Save the model's and the optimizer's state at `step`, unless a
        checkpoint at this step or a later one exists (orbax's rule); then
        update best.json when `score` beats its record.  Returns whether a
        checkpoint was written."""
        step = int(step)
        latest = self.latest_step()
        saved = latest is None or step > latest
        if saved:
            self.directory.mkdir(parents=True, exist_ok=True)
            tmp = self.directory / f"tmp-{step}"
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir()
            torch.save({"step": step, "model": model.state_dict(),
                        "optimizer": (None if optimizer is None
                                      else optimizer.state_dict())},
                       tmp / _STATE)
            now = _now()
            (tmp / _INFO).write_text(json.dumps({"step": step,
                                                 "time": now}))
            os.replace(tmp, self.directory / str(step))
            self._times[step] = now
            self._remove_old()
        if score is not None:
            best = self.best_record()
            if best is None or score > best["score"]:
                self._best_file.write_text(json.dumps(
                    {"step": step, "score": float(score)}))
        return saved

    def _remove_old(self):
        """Delete what orbax's policy would: all but the last max_to_keep,
        except the first checkpoint and each one saved at least
        keep_every_hours after the last one so kept."""
        steps = self.all_steps()
        keep = set(steps[-self.max_to_keep:])
        if self.keep_every_s is not None and steps:
            last = steps[0]
            keep.add(last)
            for s in steps[1:]:
                if self._times[s] - self._times[last] >= self.keep_every_s:
                    keep.add(s)
                    last = s
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.directory / str(s))
                del self._times[s]

    # -- load ---------------------------------------------------------------
    def all_steps(self):
        return sorted(self._times)

    def latest_step(self) -> Optional[int]:
        return max(self._times, default=None)

    def best_record(self):
        if self._best_file.exists():
            return json.loads(self._best_file.read_text())
        return None

    def restore(self, model: torch.nn.Module, optimizer=None,
                step: Optional[int] = None, best: bool = False) -> int:
        """Load a checkpoint into the model (and the optimizer, when given)
        in place, on the model's device; returns its step.  step=None: the
        latest, or the best with best=True when best.json names a
        checkpoint still on disk."""
        if step is None:
            rec = self.best_record() if best else None
            if rec is not None and rec["step"] in self._times:
                step = rec["step"]
            else:
                step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        device = next(model.parameters()).device
        state = torch.load(self.directory / str(step) / _STATE,
                           map_location=device, weights_only=True)
        model.load_state_dict(state["model"])
        if optimizer is not None:
            optimizer.load_state_dict(state["optimizer"])
        return int(state["step"])

    def close(self):
        """Nothing is held open (the JAX manager's interface)."""


def save_params_npz(path, model: torch.nn.Module) -> None:
    """Write the model's parameters in the JAX layout."""
    np.savez(path, **jax_params_from_state_dict(model))


def load_params_npz(path, model: torch.nn.Module) -> torch.nn.Module:
    """Load a flat .npz into the model, in place; returns the model.

    As in the JAX package, a parameter missing from the archive keeps the
    model's value with a warning (a converted reference checkpoint may lack
    the loss's parameters), and an archive missing more than half of them
    raises: it belongs to another configuration.  A key with no counterpart
    in the model raises too.
    """
    flat = jax_params_from_state_dict(model)
    with np.load(path) as data:
        stored = {k: data[k] for k in data.files}
    missing = sorted(set(flat) - set(stored))
    if len(missing) > 0.5 * len(flat):
        raise ValueError(
            f"{path} matches only {len(flat) - len(missing)}/{len(flat)} "
            f"params of this model: wrong config or checkpoint? (first "
            f"missing: {missing[:3]})")
    if missing:
        logger.warning("%d params not in %s (kept init values): %s%s",
                       len(missing), path, ", ".join(missing[:5]),
                       "..." if len(missing) > 5 else "")
    flat.update(stored)
    model.load_state_dict(state_dict_from_jax(flat, model))
    return model
