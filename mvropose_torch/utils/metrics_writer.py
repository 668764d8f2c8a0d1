"""JSONL metric writer: port of `mvropose_tpu/utils/metrics_writer.py`.

One JSON object per `write`: {"step", "time", **metrics}, scalars as floats
and small vectors (per-joint MAE) as lists, appended to
`<log_dir>/metrics.jsonl` and flushed. No wandb and no image artifacts. The
reference's writer cannot be shared: importing it runs
`mvropose_tpu/utils/__init__.py`, which imports jax.
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
    def __init__(self, log_dir: str | Path):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._file = open(self.log_dir / "metrics.jsonl", "a")

    def write(self, step: int, metrics: Mapping[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: _jsonable(v) for k, v in metrics.items()})
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def close(self) -> None:
        self._file.close()

    def __enter__(self) -> "MetricWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
