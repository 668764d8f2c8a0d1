"""ArUco multi-marker extrinsic calibration: port of `mvropose_tpu/calib/aruco.py`.

The original project's three-stage pipeline (Fr5_preprocessing.py:81-143 and
191-313, Meca_insertion_preprocessing.py:84-93 and 316-377):
  stage 1: per-marker averaging of repeated detections (quaternion
           eigen-mean + angular/positional outlier rejection);
  stage 2: per-view pose = mean over markers of (marker pose + board offset);
  stage 3: the right camera's pose from the left one's through the ZED
           [STEREO] baseline transform.

Host code that runs once at calibration time: numpy, with the rotation math
on the port's `geometry/rotations.py` in f32 on the CPU, where the reference
runs its jnp rotations in f32; the stereo transform in float64 as the
reference's.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from mvropose_torch.geometry.rotations import (
    average_quaternion,
    matrix_to_rodrigues,
    quat_angular_distance,
    quat_to_matrix,
    rodrigues_to_matrix,
)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


def average_marker_detections(
    detections: Sequence[Mapping],
    angular_outlier_deg: float = 1.0,
    position_outlier_m: float | None = None,
) -> dict | None:
    """Average repeated detections of ONE marker with outlier rejection.

    detections: {"position_m": {x, y, z}, "rotation_quat": {x, y, z, w}}
    dicts (the raw capture JSON schema). Returns the same schema averaged,
    or None when fewer than 2 raw detections arrive or none survives the
    outlier gates (a single survivor is returned unaveraged, as the original
    project's Fr5_preprocessing.py:103)."""
    if len(detections) < 2:
        return None
    pos = np.array([[m["position_m"][k] for k in "xyz"] for m in detections])
    quat = np.array([[m["rotation_quat"][k] for k in "xyzw"] for m in detections])
    q0 = average_quaternion(_f32(quat))
    ang = np.array([np.degrees(float(quat_angular_distance(q0, _f32(q)))) for q in quat])
    keep = ang <= angular_outlier_deg
    if position_outlier_m is not None:
        dist = np.linalg.norm(pos - pos.mean(axis=0), axis=1)
        keep &= dist < position_outlier_m
    if not keep.any():
        return None
    avg_pos = pos[keep].mean(axis=0)
    avg_quat = _np(average_quaternion(_f32(quat[keep])))
    return {
        "position_m": dict(zip("xyz", (float(v) for v in avg_pos))),
        "rotation_quat": dict(zip("xyzw", (float(v) for v in avg_quat))),
        "n_used": int(keep.sum()),
        "n_total": len(detections),
    }


def average_detections_with_corners(
    detections: Sequence[Mapping],
    position_outlier_m: float = 0.001,
    angular_outlier_deg: float = 3.0,
) -> dict | None:
    """Meca-insertion stage-1 averaging: joint positional (1 mm) and angular
    (3 deg) outlier rejection against the mean, at least half of the
    detections must survive, and the corner pixels are averaged over the
    same mask (Meca_insertion_preprocessing.py:84-93, 181-205).

    detections carry {"position_m", "rotation_quat", "corners_pixel"};
    returns the same schema averaged, or None when too few survive. A single
    detection passes through unchanged (:184-186)."""
    if not detections:
        return None
    if len(detections) < 2:
        return dict(detections[0])
    pos = np.array([[m["position_m"][k] for k in "xyz"] for m in detections])
    quat = np.array([[m["rotation_quat"][k] for k in "xyzw"] for m in detections])
    corners = np.array([m["corners_pixel"] for m in detections], dtype=np.float32)

    avg_pos = pos.mean(axis=0)
    avg_quat = average_quaternion(_f32(quat))
    pos_mask = np.linalg.norm(pos - avg_pos, axis=1) < position_outlier_m
    ang = np.array([np.degrees(float(quat_angular_distance(avg_quat, _f32(q)))) for q in quat])
    mask = pos_mask & (ang < angular_outlier_deg)
    if mask.sum() == 0 or mask.sum() < len(detections) / 2:
        return None
    out_quat = _np(average_quaternion(_f32(quat[mask])))
    return {
        "position_m": dict(zip("xyz", (float(v) for v in pos[mask].mean(axis=0)))),
        "rotation_quat": dict(zip("xyzw", (float(v) for v in out_quat))),
        "corners_pixel": corners[mask].mean(axis=0).tolist(),
        "n_used": int(mask.sum()),
        "n_total": len(detections),
    }


def compute_view_pose(
    marker_poses: Mapping[str, Mapping],
    marker_offsets: Mapping[str, np.ndarray],
) -> dict | None:
    """Per-view rig pose: the mean over markers of (marker pose + board
    offset), over the markers in both the detections and the offset table
    (Fr5_preprocessing.py:221-235) -> {"rvec": (3,), "tvec": (3,),
    "n_markers"} (radians, metres, world -> camera), or None if no marker
    is usable."""
    tvecs, quats = [], []
    for mid, offset in marker_offsets.items():
        if mid not in marker_poses:
            continue
        p = marker_poses[mid]
        t = np.array([p["position_m"][k] for k in "xyz"])
        q = np.array([p["rotation_quat"][k] for k in "xyzw"])
        Rm = _np(quat_to_matrix(_f32(q)))
        tvecs.append(t + Rm @ np.asarray(offset))
        quats.append(q)
    if not tvecs:
        return None
    mean_q = average_quaternion(_f32(np.stack(quats)))
    mean_r = _np(matrix_to_rodrigues(quat_to_matrix(mean_q)))
    return {"rvec": mean_r, "tvec": np.mean(tvecs, axis=0), "n_markers": len(tvecs)}


def solve_marker_pose_from_corners(
    corners_px: np.ndarray,  # (4, 2) pixel corners, TL TR BR BL order
    marker_size_m: float,
    K: np.ndarray,
    dist: np.ndarray | None = None,
) -> dict:
    """One marker's pose from its corner pixels (stage 2,
    Meca_insertion_preprocessing.py:210-249: solvePnP + solvePnPRefineLM),
    by the port's planar PnP and LM (`geometry/pnp.py::solve_pnp`). The
    object points use the original project's top-left origin
    ([[0,0,0],[s,0,0],[s,s,0],[0,s,0]], :211-213), so tvec is the top-left
    corner, not the marker's centre -> {"rvec", "tvec", "reproj_error_px"}."""
    from mvropose_torch.geometry.camera import project_points
    from mvropose_torch.geometry.pnp import solve_pnp

    s = marker_size_m
    obj = _f32([[0.0, 0.0, 0.0], [s, 0.0, 0.0], [s, s, 0.0], [0.0, s, 0.0]])
    img = _f32(corners_px)
    K_t = _f32(K)
    dist_t = _f32(dist) if dist is not None else None
    rvec, tvec, _ = solve_pnp(obj, img, K_t, dist=dist_t)
    proj = _np(project_points(obj, rvec, tvec, K_t, dist_t))
    err = float(np.linalg.norm(proj - _np(img), axis=-1).mean())
    return {"rvec": _np(rvec), "tvec": _np(tvec), "reproj_error_px": err}


def _euler_zyx_rad_to_matrix_np(rz: float, ry: float, rx: float) -> np.ndarray:
    """float64 scipy `Rotation.from_euler('zyx', [rz, ry, rx])` (extrinsic):
    R = Rx(rx) @ Ry(ry) @ Rz(rz)."""
    cz, sz = np.cos(rz), np.sin(rz)
    cy, sy = np.cos(ry), np.sin(ry)
    cx, sx = np.cos(rx), np.sin(rx)
    Rz = np.array([[cz, -sz, 0.0], [sz, cz, 0.0], [0.0, 0.0, 1.0]])
    Ry = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
    Rx = np.array([[1.0, 0.0, 0.0], [0.0, cx, -sx], [0.0, sx, cx]])
    return Rx @ Ry @ Rz


def stereo_right_from_left(
    rvec_left: np.ndarray,
    tvec_left: np.ndarray,
    stereo: Mapping[str, float],
    correction_offset: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """The right camera's extrinsic from the left one's through the ZED
    factory stereo transform, as stage 3 (Meca_insertion_preprocessing.py:
    333-346):

      1. right-in-left from the conf: t = [Baseline, TY, TZ] / 1000 (mm),
         R = euler-zyx([RZ, CV, RX], radians);
      2. inverted -> T_left_to_right;
      3. world -> right = T_left_to_right o (world -> left);
      4. an optional manual correction added to tvec_right
         (`RIGHT_CAM_CORRECTION_OFFSET`, :316).
    """
    R_wl = _np(rodrigues_to_matrix(_f32(rvec_left))).astype(np.float64)
    t_wl = np.asarray(tvec_left, dtype=np.float64)
    t_rl = np.array([stereo["baseline"], stereo.get("ty", 0.0), stereo.get("tz", 0.0)]) / 1000.0
    R_rl = _euler_zyx_rad_to_matrix_np(stereo.get("rz", 0.0), stereo.get("ry", 0.0),
                                       stereo.get("rx", 0.0))
    R_lr = R_rl.T
    t_lr = -R_rl.T @ t_rl
    R_wr = R_lr @ R_wl
    t_wr = R_lr @ t_wl + t_lr
    if correction_offset is not None:
        t_wr = t_wr + np.asarray(correction_offset)
    return _np(matrix_to_rodrigues(_f32(R_wr))), t_wr
