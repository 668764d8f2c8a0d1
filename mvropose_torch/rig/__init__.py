"""Realtime rig layer: camera sources, the batched streaming loop and the
viewer (copies of `mvropose_tpu/rig/{source,stream,viewer}.py`)."""

from mvropose_torch.rig.source import CameraSource, FileReplaySource, Frame, SyntheticSource
from mvropose_torch.rig.stream import StreamingPipeline, StreamStats
from mvropose_torch.rig.viewer import draw_keypoints_overlay, tile_frames

__all__ = [
    "CameraSource",
    "FileReplaySource",
    "Frame",
    "StreamingPipeline",
    "StreamStats",
    "SyntheticSource",
    "draw_keypoints_overlay",
    "tile_frames",
]
