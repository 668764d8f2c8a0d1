"""Calibration layer of the port: ZED .conf intrinsics (a copy of the
reference's `calib/zed_conf.py`), the ArUco extrinsic averaging
(`calib/aruco.py`, on the port's rotations) and the rig registry
(`calib/registry.py`, on the port's robots)."""

from mvropose_torch.calib.aruco import (
    average_marker_detections,
    compute_view_pose,
    stereo_right_from_left,
)

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
    "average_marker_detections",
    "compute_view_pose",
    "stereo_right_from_left",
    "CameraCalib",
    "CameraExtrinsic",
    "RigSpec",
    "load_dream_camera_settings",
    "load_dream_rig",
    "load_rig",
    "load_stereo_params",
    "load_zed_intrinsics",
]
