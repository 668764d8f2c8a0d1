"""Calibration layer of the port: ZED .conf intrinsics (a copy of the
reference's `calib/zed_conf.py`) and the rig registry (`calib/registry.py`,
on the port's robots). The reference's ArUco averaging (`calib/aruco.py`)
is not ported (ROADMAP.md queue 1, item 11)."""

from mvropose_torch.calib.registry import (
    CameraCalib,
    CameraExtrinsic,
    RigSpec,
    load_dream_rig,
    load_rig,
)
from mvropose_torch.calib.zed_conf import (
    load_dream_camera_settings,
    load_stereo_params,
    load_zed_intrinsics,
)

__all__ = [
    "CameraCalib",
    "CameraExtrinsic",
    "RigSpec",
    "load_dream_camera_settings",
    "load_dream_rig",
    "load_rig",
    "load_stereo_params",
    "load_zed_intrinsics",
]
