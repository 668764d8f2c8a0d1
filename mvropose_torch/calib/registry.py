"""Rig registry: cameras, views and extrinsics in one config tree.

Port of `mvropose_tpu/calib/registry.py` (`CameraCalib`, `CameraExtrinsic`,
`RigSpec`, the serial tables, `load_dream_rig`, `load_rig`) on the port's
`geometry/robots.py`; the rest is numpy and json, as in the reference. One
declarative RigSpec per rig replaces the original project's serial <-> view
tables. Units (the FR5/Meca rvec-in-degrees trap) are resolved at load time:
every CameraExtrinsic in memory is radians/meters.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np

from mvropose_torch.geometry.robots import RobotSpec, get_robot


@dataclasses.dataclass(frozen=True)
class CameraCalib:
    camera_matrix: np.ndarray  # (3, 3)
    distortion_coeffs: np.ndarray  # (5,)


@dataclasses.dataclass(frozen=True)
class CameraExtrinsic:
    rvec: np.ndarray  # (3,) radians, world->camera
    tvec: np.ndarray  # (3,) meters


# The rig serial tables (SURVEY.md section 2).
FR5_SERIAL_TO_VIEW = {"38007749": "left", "34850673": "right", "30779426": "top"}
FR3_SERIAL_TO_VIEW = {
    "41182735": "view1",
    "49429257": "view2",
    "44377151": "view3",
    "49045152": "view4",
}
MECA_INSERTION_SERIAL_TO_VIEW = {
    "41182735": "front",
    "49429257": "right",
    "44377151": "left",
    "49045152": "top",
}


@dataclasses.dataclass(frozen=True)
class RigSpec:
    name: str
    robot: RobotSpec
    serial_to_view: Mapping[str, str]
    # Keyed by "{view}_{cam}" (cam in {"leftcam", "rightcam"}), optionally
    # prefixed by a pose name for multi-pose rigs ("pose1_view1_leftcam").
    calibs: Mapping[str, CameraCalib]
    extrinsics: Mapping[str, CameraExtrinsic]
    heatmap_size: Tuple[int, int] = (128, 128)
    sigma: float = 5.0
    max_views: int = 8
    # Keypoint count override for rigs whose GT keypoints are NOT the FK
    # chain (DREAM stores 7 named link keypoints while the panda chain has 8
    # FK points; reference DREAM_Train.py:49,52).
    num_keypoints_override: int | None = None

    @property
    def num_keypoints(self) -> int:
        return self.num_keypoints_override or self.robot.n_keypoints

    # Static view index table (replaces the reference's stateful view_to_idx
    # registry, the original project's MvRoPose_FR3.py:594-598): serial+cam -> embedding index.
    def view_index(self, serial: str, cam_side: str) -> int:
        serials = sorted(self.serial_to_view)
        return serials.index(serial) * 2 + (0 if cam_side.startswith("left") else 1)

    def camera_key(self, view: str, cam: str, pose: str | None = None) -> str:
        key = f"{view}_{cam}"
        return f"{pose}_{key}" if pose else key


def _load_extrinsic_record(rec: Mapping, rvec_unit: str) -> CameraExtrinsic:
    """rvec unit resolution: an explicit per-record "rvec_unit" field wins
    (records written by this framework's calibrate subcommands carry it);
    otherwise fall back to the robot's declared summary convention
    (reference-produced files: FR5/Meca summaries store degrees, FR3
    radians). Without the field, a radian-valued record in a deg-robot
    summary would be silently shrunk ~57x.
    """
    unit = rec.get("rvec_unit", rvec_unit)
    rvec = np.array([rec["rvec_x"], rec["rvec_y"], rec["rvec_z"]], dtype=np.float64)
    if unit == "deg":
        rvec = np.deg2rad(rvec)
    tvec = np.array([rec["tvec_x"], rec["tvec_y"], rec["tvec_z"]], dtype=np.float64)
    return CameraExtrinsic(rvec=rvec, tvec=tvec)


def load_dream_rig(
    base_paths,
    heatmap_size: Tuple[int, int] = (128, 128),
    sigma: float = 3.0,
) -> RigSpec:
    """Rig for the DREAM-real subsets: one camera per subset directory,
    intrinsics from each `_camera_settings.json` (the original project's
    DREAM_Train.py:79-96), zero distortion, no extrinsics (keypoints are
    stored in the dataset)."""
    from mvropose_torch.calib.zed_conf import load_dream_camera_settings

    calibs: Dict[str, CameraCalib] = {}
    serial_to_view: Dict[str, str] = {}
    for i, base in enumerate([Path(p) for p in base_paths]):
        settings = base / "_camera_settings.json"
        if not settings.exists():
            continue
        intr = load_dream_camera_settings(settings)
        view = base.name  # e.g. panda-3cam_azure
        calibs[f"{view}_leftcam"] = CameraCalib(intr.camera_matrix, intr.distortion_coeffs)
        serial_to_view[f"{i:08d}"] = view
    return RigSpec(
        name="dream",
        robot=get_robot("dream_panda"),
        serial_to_view=serial_to_view,
        calibs=calibs,
        extrinsics={},
        heatmap_size=heatmap_size,
        sigma=sigma,
        max_views=1,
        # keypoint count (7 named links) comes from the robot spec's
        # keypoint_fk_indices - no override needed.
    )


def load_rig(
    name: str,
    robot_name: str,
    serial_to_view: Mapping[str, str],
    calib_dir: str | Path | None = None,
    aruco_summary_paths: Mapping[str, str | Path] | str | Path | None = None,
    heatmap_size: Tuple[int, int] = (128, 128),
    sigma: float = 5.0,
    max_views: int = 8,
) -> RigSpec:
    """Assemble a RigSpec from reference-format artifacts.

    calib_dir: directory of `{view}_{serial}_{cam}_calib.json` files (the
    schema written by the reference's Calib_cam_save scripts and by our
    `mvropose_tpu.cli calibrate`).
    aruco_summary_paths: one `*_aruco_pose_summary.json` path, or a mapping
    {pose_name: path-or-list-of-paths} for multi-pose rigs (FR3's
    pose1/pose2). A LIST per pose exists for mixed-robot runs that share one
    artifact set: several robots each ship an UNPREFIXED summary (fr5 +
    meca_insertion), and collapsing them to one dict slot would silently
    drop all but the last robot's extrinsics. Records from later paths win
    on a {view}_{cam} key collision - per-run view names must be disjoint
    (they are in the mixed synthetic sets).
    """
    robot = get_robot(robot_name)
    calibs: Dict[str, CameraCalib] = {}
    if calib_dir is not None:
        for path in sorted(Path(calib_dir).glob("*_calib.json")):
            stem = path.name.replace("_calib.json", "")  # view_serial_cam
            parts = stem.split("_")
            view, cam = parts[0], parts[-1]
            data = json.loads(path.read_text())
            calibs[f"{view}_{cam}"] = CameraCalib(
                camera_matrix=np.asarray(data["camera_matrix"], dtype=np.float64),
                distortion_coeffs=np.asarray(data["distortion_coeffs"], dtype=np.float64).reshape(-1),
            )

    extrinsics: Dict[str, CameraExtrinsic] = {}
    if aruco_summary_paths is not None:
        if isinstance(aruco_summary_paths, (str, Path)):
            aruco_summary_paths = {"": aruco_summary_paths}
        for pose_name, paths in aruco_summary_paths.items():
            if isinstance(paths, (str, Path)):
                paths = [paths]
            for path in paths:
                records = json.loads(Path(path).read_text())
                for rec in records:
                    key = f"{rec['view']}_{rec['cam']}"
                    if pose_name:
                        key = f"{pose_name}_{key}"
                    extrinsics[key] = _load_extrinsic_record(rec, robot.extrinsic_rvec_unit)

    return RigSpec(
        name=name,
        robot=robot,
        serial_to_view=dict(serial_to_view),
        calibs=calibs,
        extrinsics=extrinsics,
        heatmap_size=heatmap_size,
        sigma=sigma,
        max_views=max_views,
    )
