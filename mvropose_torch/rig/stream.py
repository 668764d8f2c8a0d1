"""Batched streaming inference loop.

A copy of `mvropose_tpu/rig/stream.py` (numpy only), so that the port
imports nothing of the JAX package; `tests/test_torch_serve.py` holds the
two to the same statistics.

The reference runs one model forward PER CAMERA THREAD on a shared GPU model
(the original project's DIP_REAL.py:98-127) - the threads serialize on the GIL and
the CUDA stream, so N cameras cost N sequential forwards. Here the main loop
gathers the latest frame from every source and runs ONE jitted step batching
all cameras - the TPU rebuild's core throughput fix (SURVEY.md section 3.3).

Failure semantics match the reference: sources that fail to initialize are
reported and excluded (placeholder output), sources that stall simply keep
their mask bit off for that tick.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np

from mvropose_torch.rig.source import CameraSource, Frame


@dataclasses.dataclass
class StreamStats:
    ticks: int = 0
    # NEW camera frames consumed (deduplicated by Frame.seq): a tick that
    # re-infers a camera's unchanged latest frame does not count it again,
    # so camera_fps reports what the cameras actually produced, not the
    # tick rate times V (the loop legitimately re-infers stale frames -
    # consumers want a pose every tick - but throughput must not claim them).
    frames_processed: int = 0
    total_step_time_s: float = 0.0
    start_time_s: float = 0.0
    end_time_s: float | None = None  # set when run() exits; properties use it
    # Frames dropped because their resolution did not match frame_hw - a
    # persistent nonzero count means the rig is misconfigured (the serve CLI
    # reports it instead of spinning silently).
    skipped_resolution: int = 0
    # Double-buffered mode: host (gather+preprocess+dispatch) and fetch
    # (block-until-device-done) phases, accumulated separately so overlap is
    # measurable: with true overlap, total wall per tick approaches
    # max(host, device) instead of host + device, i.e.
    # total_step_time_s + total_fetch_time_s can exceed wall elapsed.
    total_fetch_time_s: float = 0.0
    overlapped: bool = False

    @property
    def _elapsed(self) -> float:
        end = self.end_time_s if self.end_time_s is not None else time.perf_counter()
        return end - self.start_time_s

    @property
    def fps(self) -> float:
        return self.ticks / self._elapsed if self._elapsed > 0 else 0.0

    @property
    def camera_fps(self) -> float:
        return self.frames_processed / self._elapsed if self._elapsed > 0 else 0.0


class StreamingPipeline:
    """Gather-latest -> batched-infer loop over N camera sources.

    infer_fn(images_u8 (V, H, W, 3), view_mask (V,)) -> anything; it is
    expected to be a jitted device function (preprocess + model + decode).
    on_result(result, frames) runs on host (viz, logging).

    Double-buffered mode (fetch_fn given): infer_fn becomes the DISPATCH
    phase (host preprocess + async device enqueue, returning an unfetched
    handle, e.g. jax device arrays) and fetch_fn(handle) the blocking
    device->host fetch. Each tick dispatches frame-set N then fetches N-1,
    so the host work of N+1 (camera gather, cv2 undistort, H2D) runs
    concurrently with the device computing N - the overlap the reference
    approximated with per-camera threads (DIP_REAL.py:98-127), here with one
    batched device step and one frame-set of latency. on_result fires when a
    set's results are fetched, paired with ITS frames.
    """

    def __init__(
        self,
        sources: Sequence[CameraSource],
        infer_fn: Callable,
        on_result: Optional[Callable] = None,
        frame_hw: tuple[int, int] = (720, 1280),
        init_timeout_s: float = 10.0,
        max_skew_s: float | None = None,
        fetch_fn: Optional[Callable] = None,
    ):
        """max_skew_s: when set, a camera whose latest frame is older than
        the newest frame by more than this is masked out for the tick -
        stale views must not be fused as if synchronized (the reference
        displayed whatever was latest per camera with no skew check,
        DIP_REAL.py:219)."""
        self.sources = list(sources)
        self.infer_fn = infer_fn
        self.on_result = on_result
        self.frame_hw = frame_hw
        self.init_timeout_s = init_timeout_s
        self.max_skew_s = max_skew_s
        self.fetch_fn = fetch_fn
        self._pending = None  # (handle, frames) awaiting fetch
        self._last_seq: dict[int, int] = {}  # per-source last consumed Frame.seq
        self.stats = StreamStats(overlapped=fetch_fn is not None)
        self.active: list[CameraSource] = []
        self.failed: list[CameraSource] = []

    def start(self) -> None:
        for s in self.sources:
            s.start()
        deadline = time.perf_counter() + self.init_timeout_s
        while time.perf_counter() < deadline:
            if all(s.is_ready or s.initialization_failed for s in self.sources):
                break
            time.sleep(0.05)
        self.active = [s for s in self.sources if s.is_ready]
        self.failed = [s for s in self.sources if not s.is_ready]

    def stop(self) -> None:
        for s in self.sources:
            s.stop()

    def tick(self) -> Optional[object]:
        """One gather + infer step. Returns infer_fn's result (double-
        buffered mode: the PREVIOUS set's fetched result), or None if
        nothing could be inferred and nothing was pending."""
        if self.stats.start_time_s == 0.0:  # tick()-driven use without run()
            self.stats.start_time_s = time.perf_counter()
        V = len(self.sources)
        H, W = self.frame_hw
        # np.empty, not np.zeros: at 4x720p the batch is ~11 MB and zeroing
        # it every tick at ~70 ticks/s is pure memset bandwidth; only the
        # slots without a frame need zero-filling (the mask carries
        # correctness, zeroed pixels keep masked slots deterministic).
        images = np.empty((V, H, W, 3), np.uint8)
        mask = np.zeros((V,), bool)
        frames: list[Optional[Frame]] = [None] * V
        for i, s in enumerate(self.sources):
            f = s.latest()
            if f is None:
                images[i] = 0
                continue
            if f.image.shape[:2] != (H, W):
                self.stats.skipped_resolution += 1
                images[i] = 0
                continue
            images[i] = f.image
            mask[i] = True
            frames[i] = f
        if not mask.any():
            # Nothing new to dispatch, but never withhold an already-computed
            # set: the consumer most needs the last result exactly when the
            # cameras stall.
            return self.drain() if self._pending is not None else None
        if self.max_skew_s is not None:
            newest = max(f.timestamp for f in frames if f is not None)
            for i, f in enumerate(frames):
                if f is not None and newest - f.timestamp > self.max_skew_s:
                    mask[i] = False
                    frames[i] = None
                    images[i] = 0
            if not mask.any():
                return self.drain() if self._pending is not None else None
        t0 = time.perf_counter()
        out = self.infer_fn(images, mask)
        self.stats.total_step_time_s += time.perf_counter() - t0
        self.stats.ticks += 1
        for i, f in enumerate(frames):
            if f is not None and self._last_seq.get(i) != f.seq:
                self._last_seq[i] = f.seq
                self.stats.frames_processed += 1
        if self.fetch_fn is None:
            if self.on_result is not None:
                self.on_result(out, frames)
            return out
        # Double-buffered: `out` is an unfetched handle for THIS set; block
        # on (and deliver) the previous set while the device works on this.
        result = None
        if self._pending is not None:
            handle, pframes = self._pending
            t1 = time.perf_counter()
            result = self.fetch_fn(handle)
            self.stats.total_fetch_time_s += time.perf_counter() - t1
            if self.on_result is not None:
                self.on_result(result, pframes)
        self._pending = (out, frames)
        return result

    def drain(self):
        """Fetch + deliver the in-flight frame set (double-buffered mode)."""
        if self._pending is None:
            return None
        handle, pframes = self._pending
        self._pending = None
        t1 = time.perf_counter()
        result = self.fetch_fn(handle)
        self.stats.total_fetch_time_s += time.perf_counter() - t1
        if self.on_result is not None:
            self.on_result(result, pframes)
        return result

    def run(self, duration_s: float | None = None, max_ticks: int | None = None) -> StreamStats:
        self.stats = StreamStats(
            start_time_s=time.perf_counter(), overlapped=self.fetch_fn is not None
        )
        self._last_seq.clear()
        end = time.perf_counter() + duration_s if duration_s is not None else None
        while True:
            if end is not None and time.perf_counter() >= end:
                break
            if max_ticks is not None and self.stats.ticks >= max_ticks:
                break
            before = self.stats.ticks
            self.tick()
            if self.stats.ticks == before:
                # Nothing dispatched (no frames / all stale): yield instead
                # of burning a full core spinning on the mailboxes.
                time.sleep(0.0005)
        if self.fetch_fn is not None:
            self.drain()
        self.stats.end_time_s = time.perf_counter()
        return self.stats
