"""Realtime rig layer: camera sources and the batched streaming loop
(copies of `mvropose_tpu/rig/{source,stream}.py`; the viewer is not
ported, as `--display` is not)."""

from mvropose_torch.rig.source import CameraSource, FileReplaySource, Frame, SyntheticSource
from mvropose_torch.rig.stream import StreamingPipeline, StreamStats

__all__ = [
    "CameraSource",
    "FileReplaySource",
    "Frame",
    "StreamingPipeline",
    "StreamStats",
    "SyntheticSource",
]
