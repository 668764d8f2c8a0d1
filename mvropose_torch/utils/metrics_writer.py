"""JSONL metric writer: port of `mvropose_tpu/utils/metrics_writer.py`.

One JSON object per `write`: {"step", "time", **metrics}, scalars as floats
and small vectors (per-joint MAE) as lists, appended to
`<log_dir>/metrics.jsonl` and flushed; `write_image` saves an RGB uint8
image as `<log_dir>/images/<name>_step<step>.png` (its `.npy` where cv2 is
missing or the write fails). With `use_wandb` (`cli train --wandb`) the
records and images also go to wandb where it imports and initializes, as
the reference's; where it does not, the JSONL file alone. The reference's
writer cannot be shared: importing it runs `mvropose_tpu/utils/__init__.py`,
which imports jax.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Mapping

import numpy as np


def _jsonable(v):
    if isinstance(v, (list, tuple)):
        return [float(x) for x in v]
    if np.ndim(v) > 0:
        return np.asarray(v, dtype=np.float64).reshape(-1).tolist()
    return float(v)


class MetricWriter:
    def __init__(self, log_dir: str | Path, use_wandb: bool = False):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._file = open(self.log_dir / "metrics.jsonl", "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init()
                self._wandb = wandb
            except Exception:
                self._wandb = None

    def write(self, step: int, metrics: Mapping[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: _jsonable(v) for k, v in metrics.items()})
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log(dict(metrics), step=step)

    def write_image(self, step: int, name: str, image) -> None:
        """Save an image artifact (numpy HWC uint8 RGB) under the log dir."""
        out = self.log_dir / "images"
        out.mkdir(exist_ok=True)
        path = out / f"{name}_step{step}.png"
        try:
            import cv2

            # cv2.imwrite reports a failure by returning False.
            if not cv2.imwrite(str(path), np.asarray(image)[:, :, ::-1]):
                raise IOError(f"cv2.imwrite failed for {path}")
        except Exception:
            np.save(str(path.with_suffix(".npy")), np.asarray(image))
        if self._wandb is not None:
            self._wandb.log({name: self._wandb.Image(np.asarray(image))}, step=step)

    def close(self) -> None:
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()

    def __enter__(self) -> "MetricWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
