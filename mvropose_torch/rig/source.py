"""Camera source abstraction.

A copy of `mvropose_tpu/rig/source.py` (numpy only), so that the port
imports nothing of the JAX package; `tests/test_torch_serve.py` holds the
two to the same frames.

The reference binds directly to the ZED SDK inside per-camera threads
(the original project's DIP_REAL.py:55-133). Camera I/O cannot run on a TPU, so the
rebuild defines a `CameraSource` protocol with three backends:
  * ZedCameraSource   - real hardware via pyzed (gated import; identical
                        init-failure semantics to the reference)
  * FileReplaySource  - replays a directory of frames at a fixed rate (the
                        testing fake the reference never had)
  * SyntheticSource   - procedural frames for benchmarks

Threading model fixes the reference's unguarded shared state
(`processed_frame` written/read without a lock, DIP_REAL.py:72,127,219):
each source owns a single-slot mailbox guarded by a lock; readers get the
latest complete frame or None, never a torn write.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from pathlib import Path
from typing import Optional, Protocol, Sequence, runtime_checkable

import numpy as np


@dataclasses.dataclass(frozen=True)
class Frame:
    image: np.ndarray  # (H, W, 3) uint8 RGB
    timestamp: float
    serial: str
    seq: int


@runtime_checkable
class CameraSource(Protocol):
    serial: str

    def start(self) -> None: ...

    def stop(self) -> None: ...

    @property
    def is_ready(self) -> bool: ...

    @property
    def initialization_failed(self) -> bool: ...

    def latest(self) -> Optional[Frame]: ...


class _MailboxSource:
    """Shared base: locked single-slot latest-frame mailbox."""

    def __init__(self, serial: str):
        self.serial = serial
        self._lock = threading.Lock()
        self._frame: Optional[Frame] = None
        self._ready = False
        self._failed = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seq = 0

    @property
    def is_ready(self) -> bool:
        return self._ready

    @property
    def initialization_failed(self) -> bool:
        return self._failed

    def latest(self) -> Optional[Frame]:
        with self._lock:
            return self._frame

    def _publish(self, image: np.ndarray, ts: float) -> None:
        frame = Frame(image=image, timestamp=ts, serial=self.serial, seq=self._seq)
        self._seq += 1
        with self._lock:
            self._frame = frame

    def start(self) -> None:
        self._stop.clear()  # restartable: a stop() must not poison the next start()
        self._thread = threading.Thread(target=self._run_guarded, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _run_guarded(self) -> None:
        """Worker wrapper: ANY uncaught exception marks the source failed.

        Without this, a worker that dies (bad serial string, unreadable
        replay file mid-run, SDK error outside the guarded open) leaves the
        source neither ready nor failed - the pipeline then blocks its full
        init timeout before misclassifying it, or keeps treating a dead
        source as live with a stale mailbox frame."""
        try:
            self._run()
        except Exception:  # noqa: BLE001 - the flag IS the error channel
            import traceback

            self._failed = True
            self._ready = False
            traceback.print_exc()

    def _run(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError


class FileReplaySource(_MailboxSource):
    """Replays image files at a fixed FPS; loops by default."""

    def __init__(self, serial: str, paths: Sequence[str | Path], fps: float = 30.0, loop: bool = True):
        super().__init__(serial)
        self.paths = [str(p) for p in paths]
        self.fps = fps
        self.loop = loop

    def _run(self) -> None:
        import cv2

        if not self.paths:
            self._failed = True
            return
        first = cv2.imread(self.paths[0])
        if first is None:
            self._failed = True
            return
        self._ready = True
        period = 1.0 / self.fps if self.fps > 0 else 0.0  # <=0: replay unthrottled
        i = 0
        while not self._stop.is_set():
            t0 = time.perf_counter()
            img = cv2.imread(self.paths[i % len(self.paths)])
            if img is not None:
                self._publish(cv2.cvtColor(img, cv2.COLOR_BGR2RGB), time.time())
            i += 1
            if not self.loop and i >= len(self.paths):
                break
            dt = time.perf_counter() - t0
            if dt < period:
                time.sleep(period - dt)


class SyntheticSource(_MailboxSource):
    """Procedural frames at a fixed FPS (benchmark source)."""

    def __init__(self, serial: str, hw: tuple[int, int] = (720, 1280), fps: float = 30.0):
        super().__init__(serial)
        self.hw = hw
        self.fps = fps

    def _run(self) -> None:
        rng = np.random.default_rng(abs(hash(self.serial)) % (2**32))
        base = rng.integers(0, 255, size=(*self.hw, 3)).astype(np.uint8)
        self._ready = True
        period = 1.0 / self.fps if self.fps > 0 else 0.0
        while not self._stop.is_set():
            t0 = time.perf_counter()
            img = np.roll(base, self._seq % self.hw[0], axis=0)
            self._publish(img, time.time())
            dt = time.perf_counter() - t0
            if dt < period:
                time.sleep(period - dt)


class ZedCameraSource(_MailboxSource):
    """Real ZED camera via pyzed (only importable on a rig host).

    Mirrors the reference's init semantics: open by serial at HD720@30
    (the original project's DIP_REAL.py:82-93), flag failure instead of raising.
    """

    def __init__(self, serial: str, fps: int = 30, resolution: str = "HD720"):
        super().__init__(serial)
        self.fps = fps
        self.resolution = resolution

    def _run(self) -> None:  # pragma: no cover - needs hardware
        try:
            import pyzed.sl as sl
        except ImportError:
            self._failed = True
            return
        zed = sl.Camera()
        init = sl.InitParameters()
        init.camera_resolution = getattr(sl.RESOLUTION, self.resolution)
        init.camera_fps = self.fps
        init.set_from_serial_number(int(self.serial))
        if zed.open(init) != sl.ERROR_CODE.SUCCESS:
            self._failed = True
            return
        self._ready = True
        runtime = sl.RuntimeParameters()
        mat = sl.Mat()
        try:
            while not self._stop.is_set():
                if zed.grab(runtime) == sl.ERROR_CODE.SUCCESS:
                    zed.retrieve_image(mat, sl.VIEW.LEFT)
                    bgr = mat.get_data()[:, :, :3]
                    self._publish(bgr[:, :, ::-1].copy(), time.time())
        finally:
            zed.close()
