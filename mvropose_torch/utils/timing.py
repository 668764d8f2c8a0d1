"""Stage timing: port of `mvropose_tpu/utils/timing.py` on CUDA events.

`StageTimer.timed(name, fn, *args)` runs `fn` and records its time under
`name`: on a card, the device time between two CUDA events recorded around
the call on the current stream (the host does not wait per call; `report`
synchronizes once and reads every pair); on the CPU, the wall time of the
call. `stage(name)` times an enclosed block the same way, its device work
included, and names it for `torch.profiler` traces (`record_function`), as
the reference's `jax.named_scope`. The report and summary formats are the
reference's.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Iterator

import torch


class StageTimer:
    """Per-stage totals and counts; `device` "cuda" times by CUDA events,
    anything else by the wall clock."""

    def __init__(self, device="cpu"):
        self.cuda = torch.device(device).type == "cuda"
        self._wall: dict[str, float] = defaultdict(float)
        self._events: dict[str, list] = defaultdict(list)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        """Time the enclosed block (its device work, on a card) as `name`."""
        with torch.profiler.record_function(name):
            if self.cuda:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                yield
                end.record()
                self._events[name].append((start, end))
            else:
                t0 = time.perf_counter()
                yield
                self._wall[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def timed(self, name: str, fn, *args, **kwargs):
        """Run fn and record its time under `name`."""
        with self.stage(name):
            return fn(*args, **kwargs)

    @property
    def totals(self) -> dict[str, float]:
        """Seconds per stage (on a card, after waiting for its events)."""
        if self.cuda and self._events:
            torch.cuda.synchronize()
        out = dict(self._wall)
        for name, pairs in self._events.items():
            out[name] = out.get(name, 0.0) + sum(s.elapsed_time(e) for s, e in pairs) / 1e3
        return out

    def report(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "total_s": total,
                "count": self.counts[name],
                "mean_s": total / max(self.counts[name], 1),
            }
            for name, total in self.totals.items()
        }

    def summary(self) -> str:
        lines = []
        for name, r in sorted(self.report().items(), key=lambda kv: -kv[1]["total_s"]):
            lines.append(
                f"{name:30s} total {r['total_s']:8.3f}s  n={r['count']:5d}  mean {r['mean_s'] * 1e3:8.2f}ms"
            )
        return "\n".join(lines)

