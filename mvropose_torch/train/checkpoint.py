"""Checkpoints and resume: port of `mvropose_tpu/train/checkpoint.py`.

  * `save_params_npz` / `load_params_npz`: the flat `best_params.npz` file
    in the reference's names and layouts (`utils/weights.py`
    `export_jax_params` / `load_jax_params`), so each package reads the
    other's file.
  * `CheckpointManager`: the whole train state (the model's parameters and
    BatchNorm statistics, both AdamW groups' moments, the update count) and
    `CheckpointMeta(epoch, best_val_loss)`, one `torch.save` file a step
    under one directory, the newest `max_to_keep` kept. The state is copied
    to the host when `save` is called; the file is written on a thread
    (the reference's async orbax saves), which `wait` joins. `restore`
    brings everything back, so a resumed run continues as an uninterrupted
    one would (the learning rates are a function of the update count).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from pathlib import Path

import numpy as np
import torch

from mvropose_torch.train.state import TrainState
from mvropose_torch.utils.weights import export_jax_params, load_jax_params


@dataclasses.dataclass
class CheckpointMeta:
    epoch: int = 0
    best_val_loss: float = float("inf")


def save_params_npz(path: str | Path, model: torch.nn.Module) -> None:
    """The model's weights (parameters and BatchNorm statistics under
    `batch_stats/`) as the reference's flat .npz file."""
    np.savez(path, **export_jax_params(model))


def load_params_npz(path: str | Path, model: torch.nn.Module) -> torch.nn.Module:
    """Fill `model` from a `save_params_npz` file of either package (strict
    both ways, `load_jax_params`)."""
    load_jax_params(model, path)
    return model


def _to_host(obj):
    """A nested state with every tensor cloned to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class CheckpointManager:
    """Rolling train-state checkpoints, `<step>.pt`, under one directory."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def steps(self) -> list[int]:
        return sorted(int(p.stem) for p in self.directory.glob("*.pt") if p.stem.isdigit())

    def save(self, step: int, state: TrainState, meta: CheckpointMeta) -> None:
        payload = _to_host({
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step,
            "meta": dataclasses.asdict(meta),
        })
        self.wait()
        self._thread = threading.Thread(target=self._write, args=(step, payload), daemon=True)
        self._thread.start()

    def _write(self, step: int, payload: dict) -> None:
        try:
            path = self.directory / f"{step}.pt"
            tmp = path.with_suffix(".tmp")
            torch.save(payload, tmp)
            os.replace(tmp, path)  # a reader never sees a partial file
            for old in self.steps()[: -self.max_to_keep]:
                (self.directory / f"{old}.pt").unlink(missing_ok=True)
        except BaseException as e:  # re-raised by wait() on the caller's thread
            self._error = e

    def restore(self, state: TrainState, step: int | None = None) -> CheckpointMeta | None:
        """Load checkpoint `step` (the newest by default) into `state` in
        place -> its meta, or None if there is none."""
        self.wait()
        steps = self.steps()
        if step is None:
            step = steps[-1] if steps else None
        if step is None:
            return None
        payload = torch.load(self.directory / f"{step}.pt", map_location="cpu",
                             weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return CheckpointMeta(**payload["meta"])

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error
