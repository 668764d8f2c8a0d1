"""Per-robot dataset builders: synced CSV tables -> dataset objects.

Port of `mvropose_tpu/data/builders.py:78-287` on the port's CSV `Table`
(`data/table.py`) in place of pandas: one builder per robot family, each
returning the same SingleViewDataset / MultiViewDataset types, and the
seeded train/val split. Columns are read whole (one `to_numpy` per frame,
then a plain list loop), as the reference does.
"""

from __future__ import annotations

from pathlib import Path
import numpy as np

from mvropose_torch.calib.registry import RigSpec
from mvropose_torch.data.dataset import (
    MultiViewDataset,
    SingleViewDataset,
    SingleViewSample,
)
from mvropose_torch.data.grouping import group_by_time_tolerance
from mvropose_torch.data.sync import DREAM_KEYPOINT_NAMES
from mvropose_torch.data.table import Table


def _serial_view_from_path(path: str, rig: RigSpec) -> tuple[str, str, str] | None:
    parts = Path(path).name.split("_")
    if len(parts) < 3:
        return None
    serial, cam = parts[1], parts[2] + "cam"
    view = rig.serial_to_view.get(serial)
    if view is None:
        return None
    return serial, cam, view


def _paths_and_angles(
    df: Table, angle_cols: list[str]
) -> tuple[list[str], np.ndarray]:
    paths = df["image_path"].astype(str).tolist()
    angles = df[angle_cols].to_numpy(np.float32)
    return paths, angles


def normalize_reference_index(df: Table) -> Table:
    """Adapt the original project's matched_index*.csv schema to ours.

    Its artifacts (dataset/Fr5/Fr5_*_250526/matched_index.csv and
    matched_index_with_roi.csv) use dotted columns:
    img.path, img.serial, img.view, img.ts, joint.path, joint.ts, abs_dt,
    joint.0..joint.N [, roi.path, roi.x1..roi.y2]. This framework's sync
    schema is image_path + joint_1..joint_{N+1} + robot_timestamp; roi.*
    passes through (build_fr5_roi_single_view already reads dotted roi
    columns). Idempotent on already-normalized frames.
    """
    import re

    if "image_path" in df.columns:
        return df
    out = Table()
    out["image_path"] = df["img.path"].astype(str)
    joint_cols = sorted(
        (c for c in df.columns if re.fullmatch(r"joint\.\d+", c)),
        key=lambda c: int(c.split(".")[1]),
    )
    for i, c in enumerate(joint_cols):
        out[f"joint_{i + 1}"] = df[c].astype(float)
    out["robot_timestamp"] = df["img.ts"].astype(float)
    for c in df.columns:
        if c.startswith("roi."):
            out[c] = df[c]
    return out


def build_fr5_single_view(
    df: Table, rig: RigSpec, image_hw: tuple[int, int] = (1080, 1920)
) -> SingleViewDataset:
    """Fr5 rows (joint_1..joint_6 in degrees) -> single-view dataset with
    on-the-fly FK+projection GT."""
    n = rig.robot.n_joints
    paths, angles = _paths_and_angles(df, [f"joint_{i}" for i in range(1, n + 1)])
    samples = []
    for path, ang in zip(paths, angles):
        svc = _serial_view_from_path(path, rig)
        if svc is None:
            continue
        serial, cam, view = svc
        ckey = f"{view}_{cam}"
        if ckey not in rig.calibs or ckey not in rig.extrinsics:
            continue
        samples.append(
            SingleViewSample(image_path=path, camera_key=ckey, view=view, angles=ang)
        )
    return SingleViewDataset(samples, rig, image_hw)


def build_meca500_single_view(
    df: Table, rig: RigSpec, image_hw: tuple[int, int] = (1080, 1920)
) -> SingleViewDataset:
    """Meca500: one fixed camera ('front_leftcam'), degrees."""
    n = rig.robot.n_joints
    ckey = next(iter(rig.calibs))
    view = ckey.split("_")[0]
    paths, angles = _paths_and_angles(df, [f"joint_{i}" for i in range(1, n + 1)])
    samples = [
        SingleViewSample(image_path=path, camera_key=ckey, view=view, angles=ang)
        for path, ang in zip(paths, angles)
    ]
    return SingleViewDataset(samples, rig, image_hw)


def build_dream_single_view(
    df: Table, rig: RigSpec, image_hw: tuple[int, int] = (480, 640)
) -> SingleViewDataset:
    """DREAM: stored 2D keypoints (no FK needed), one camera per subset dir.

    Each sample binds to the calib of the subset directory containing it
    (camera keys '{subset}_leftcam' from calib.registry.load_dream_rig);
    with a single-calib rig every sample uses that calib (reference
    DREAM_Train.py:103-107 does the same prefix matching)."""
    keys = sorted(rig.calibs)
    default_key = keys[0]
    paths, angles = _paths_and_angles(df, [f"joint_{i}" for i in range(1, 8)])
    kp_cols = [f"kpt_{n}_proj_{ax}" for n in DREAM_KEYPOINT_NAMES for ax in ("x", "y")]
    kps_all = df[kp_cols].to_numpy(np.float32).reshape(len(df), len(DREAM_KEYPOINT_NAMES), 2)
    # Camera-frame 3D keypoint locations (the sync schema always carries
    # them, sync.py::sync_dream) - the GT-pose-by-alignment input for the
    # eval pose metrics (rotations.kabsch).
    loc_cols = [f"kpt_{n}_loc_{ax}" for n in DREAM_KEYPOINT_NAMES for ax in ("x", "y", "z")]
    locs_all = (
        df[loc_cols].to_numpy(np.float32).reshape(len(df), len(DREAM_KEYPOINT_NAMES), 3)
        if all(c in df.columns for c in loc_cols)
        else [None] * len(df)
    )
    samples = []
    for path, ang, kps, loc in zip(paths, angles, kps_all, locs_all):
        ckey = default_key
        for k in keys:
            view_name = k.rsplit("_", 1)[0]
            if f"/{view_name}/" in path or f"/{view_name}_" in path or view_name in Path(path).parts:
                ckey = k
                break
        view = ckey.rsplit("_", 1)[0]
        samples.append(
            SingleViewSample(
                image_path=path, camera_key=ckey, view=view, angles=ang,
                keypoints_2d=kps, keypoints_3d_cam=loc,
            )
        )
    return SingleViewDataset(samples, rig, image_hw)


def build_meca_insertion_single_view(
    df: Table, rig: RigSpec, image_hw: tuple[int, int] = (1200, 1920)
) -> SingleViewDataset:
    """Meca insertion rig: zed-serial filenames over 4 views x 2 cams,
    Meca500 kinematics, joints in degrees from robot_data.txt rows."""
    n = rig.robot.n_joints
    paths, angles = _paths_and_angles(df, [f"joint_{i}" for i in range(1, n + 1)])
    samples = []
    for path, ang in zip(paths, angles):
        svc = _serial_view_from_path(path, rig)
        if svc is None:
            continue
        serial, cam, view = svc
        ckey = f"{view}_{cam}"
        if ckey not in rig.calibs or ckey not in rig.extrinsics:
            continue
        samples.append(
            SingleViewSample(image_path=path, camera_key=ckey, view=view, angles=ang)
        )
    return SingleViewDataset(samples, rig, image_hw)


def build_fr5_roi_single_view(
    df: Table, rig: RigSpec, image_hw: tuple[int, int] = (512, 512)
) -> SingleViewDataset:
    """Fr5 ROI variant: rows carry precomputed robot bounding boxes
    (roi.x1..roi.y2 columns, the reference's matched_index_with_roi.csv);
    samples crop to the ROI and stretch to image_hw."""
    n = rig.robot.n_joints
    paths, angles = _paths_and_angles(df, [f"joint_{i}" for i in range(1, n + 1)])
    rois = df[[f"roi.{k}" for k in ("x1", "y1", "x2", "y2")]].to_numpy(np.int64)
    samples = []
    for path, ang, roi in zip(paths, angles, rois):
        svc = _serial_view_from_path(path, rig)
        if svc is None:
            continue
        serial, cam, view = svc
        ckey = f"{view}_{cam}"
        if ckey not in rig.calibs or ckey not in rig.extrinsics:
            continue
        samples.append(
            SingleViewSample(
                image_path=path,
                camera_key=ckey,
                view=view,
                angles=ang,
                roi=tuple(int(v) for v in roi),
            )
        )
    return SingleViewDataset(samples, rig, image_hw)


def build_fr3_single_view(
    df: Table, rig: RigSpec, image_hw: tuple[int, int] = (1200, 1920)
) -> SingleViewDataset:
    """FR3 single-view (the reference's Franka_research3_model_train path):
    each synced row is one sample; extrinsics resolve per pose from the image
    path (pose1/pose2), angles are radians from the ROS2 YAML columns."""
    angle_cols = sorted(
        (c for c in df.columns if c.startswith("position_fr3_joint")),
        key=lambda c: int(c.rsplit("joint", 1)[1]),
    )
    paths, angles = _paths_and_angles(df, angle_cols)
    samples = []
    for path, ang in zip(paths, angles):
        svc = _serial_view_from_path(path, rig)
        if svc is None:
            continue
        serial, cam, view = svc
        ckey = f"{view}_{cam}"
        pose = next((p for p in ("pose1", "pose2") if p in path), None)
        ekey = f"{pose}_{ckey}" if pose and f"{pose}_{ckey}" in rig.extrinsics else ckey
        if ckey not in rig.calibs or ekey not in rig.extrinsics:
            continue
        samples.append(
            SingleViewSample(image_path=path, camera_key=ckey, view=view, angles=ang)
        )

    def extr_key_fn(s: SingleViewSample) -> str:
        pose = next((p for p in ("pose1", "pose2") if p in s.image_path), None)
        key = f"{pose}_{s.camera_key}" if pose else s.camera_key
        return key if key in rig.extrinsics else s.camera_key

    return SingleViewDataset(samples, rig, image_hw, extr_key_fn=extr_key_fn)


def build_fr3_multi_view(
    df: Table,
    rig: RigSpec,
    image_hw: tuple[int, int] = (1200, 1920),
    tolerance_s: float = 0.07,
    max_views: int = 8,
    min_views: int = 2,
) -> MultiViewDataset:
    """FR3: temporal grouping -> multi-view dataset; pose1/pose2 extrinsic
    selection from the image path (the reference's path sniffing,
    MvRoPose_FR3.py:205)."""
    angle_cols = [c for c in df.columns if c.startswith("position_fr3_joint")]
    angle_cols = sorted(angle_cols, key=lambda c: int(c.rsplit("joint", 1)[1]))
    groups = group_by_time_tolerance(
        df, tolerance_s, max_views, ts_col="robot_timestamp",
        angle_cols=angle_cols, min_views=min_views,
    )

    def pose_from_path(path: str) -> str | None:
        for pose in ("pose1", "pose2"):
            if pose in path:
                return pose
        return None

    return MultiViewDataset(
        groups, rig, image_hw, max_views=max_views, pose_from_path=pose_from_path
    )


def train_val_split(dataset, val_fraction: float = 0.1, seed: int = 42):
    """Deterministic split (the reference seeds 42 everywhere)."""
    import copy

    n = len(dataset.samples) if hasattr(dataset, "samples") else len(dataset.groups)
    order = np.arange(n)
    np.random.default_rng(seed).shuffle(order)
    n_train = int(n * (1 - val_fraction))
    train = copy.copy(dataset)
    val = copy.copy(dataset)
    if hasattr(dataset, "samples"):
        train.samples = [dataset.samples[i] for i in order[:n_train]]
        val.samples = [dataset.samples[i] for i in order[n_train:]]
    else:
        train.groups = [dataset.groups[i] for i in order[:n_train]]
        val.groups = [dataset.groups[i] for i in order[n_train:]]
    return train, val
