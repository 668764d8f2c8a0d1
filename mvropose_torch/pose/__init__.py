"""Serve path: model outputs -> camera pose per view.

Port of `mvropose_tpu/pose/__init__.py`: decoded keypoints + confidences,
FK(predicted angles) as the 3D model points, RANSAC PnP per camera, and
optionally the joint (pose, angles) refinement of `pose/refine.py`. Every
function takes leading batch dimensions where the reference vmaps, the
backend follows the tensors (the decode and SVD kernels on the card, their
plain versions on the CPU), and the random draws are a `PoseDraws` given by
the caller (the parity tests pass the reference's `jax.random` draws; serve
draws one set on the device and uses it every tick, as the reference's
serve uses PRNGKey(0) every tick) or drawn from a `torch.Generator`.
Nothing here waits for the device except `recover_pose_single_view`, a host
API that returns numpy.

Deliberate divergence from the reference: with refine on, a view reports
success if its RANSAC succeeded or it has >= 4 confident keypoints, the
reference's own gate ("confidence >= 0.6 and >= 4 points"). The reference's
`pose/__init__.py:200` takes any confident keypoint, so a view with 1-3 of
them reports success and suppresses its fallback.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mvropose_torch.decode import decode_keypoints
from mvropose_torch.geometry.camera import project_points
from mvropose_torch.geometry.pnp import draw_gumbel, solve_pnp_ransac
from mvropose_torch.geometry.robots import RobotSpec, forward_kinematics
from mvropose_torch.geometry.triangulation import projection_matrix, triangulate_keypoints
from mvropose_torch.pose.refine import RESOLVE_HYPOTHESES, refine_rig_pose_angles

# The reference's serve gate: keypoint confidence >= 0.6 and >= 4 points.
DEFAULT_CONFIDENCE_THRESHOLD = 0.6
MIN_POSE_POINTS = 4


@dataclasses.dataclass
class PoseResult:
    rvec: np.ndarray  # (3,)
    tvec: np.ndarray  # (3,)
    success: bool
    n_inliers: int
    keypoints_2d: np.ndarray  # (J, 2) decoded, image px
    scores: np.ndarray  # (J,)
    used_fallback: bool


@dataclasses.dataclass(frozen=True)
class PoseDraws:
    """The random draws of one rig's pose recovery (leading dimensions
    `...` for a batch of rigs): the RANSAC's Gumbel draws and, with refine,
    the starts' N(0, 1) angle perturbations and the re-solve's Gumbel draws."""

    gumbel: torch.Tensor  # (..., V, n_hypotheses, J)
    starts: torch.Tensor | None = None  # (..., n_starts, A)
    regumbel: torch.Tensor | None = None  # (..., V, 16, J)

    @classmethod
    def draw(cls, lead: tuple, views: int, joints: int, angles: int, refine: bool,
             generator: torch.Generator | None = None, device=None, n_hypotheses: int = 16,
             n_starts: int = 32) -> "PoseDraws":
        """One set from `generator` on `device`."""
        gumbel = draw_gumbel((*lead, views, n_hypotheses, joints), generator, device)
        if not refine:
            return cls(gumbel)
        starts = torch.randn((*lead, n_starts, angles), generator=generator, device=device)
        regumbel = draw_gumbel((*lead, views, RESOLVE_HYPOTHESES, joints), generator, device)
        return cls(gumbel, starts, regumbel)


def recover_pose_single_view(
    heatmaps: torch.Tensor,  # (J, Hm, Wm) raw logits
    pred_angles: torch.Tensor,  # (A,) native units
    robot: RobotSpec,
    K,
    image_hw: tuple[int, int],
    view: str | None = None,
    confidence_threshold: float = DEFAULT_CONFIDENCE_THRESHOLD,
    fallback_extrinsic: tuple[np.ndarray, np.ndarray] | None = None,
    gumbel: torch.Tensor | None = None,  # (32, J)
    generator: torch.Generator | None = None,
) -> PoseResult:
    """Decode + FK + RANSAC PnP for one view, the ArUco fallback pose on
    failure. A host API: it reads the result back (and so waits for the
    device), as the reference's `bool()` does."""
    dev = heatmaps.device
    xy, conf = decode_keypoints(heatmaps, image_hw=image_hw)
    base = torch.as_tensor(robot.base_rotation(view), device=dev)
    obj = robot.keypoints_from_fk(forward_kinematics(robot, pred_angles.to(dev), base))
    weights = (conf >= confidence_threshold).float()
    result = solve_pnp_ransac(obj, xy, torch.as_tensor(K, dtype=torch.float32, device=dev),
                              weights=weights, gumbel=gumbel, generator=generator)
    success = bool(result["success"])
    rvec, tvec = result["rvec"].cpu().numpy(), result["tvec"].cpu().numpy()
    use_fallback = not success and fallback_extrinsic is not None
    if use_fallback:
        rvec, tvec = (np.asarray(a) for a in fallback_extrinsic)
    return PoseResult(rvec=rvec, tvec=tvec, success=success,
                      n_inliers=int(result["n_inliers"]), keypoints_2d=xy.cpu().numpy(),
                      scores=conf.cpu().numpy(), used_fallback=use_fallback)


def solve_rig_pnp(
    xy: torch.Tensor,  # (..., V, J, 2) decoded keypoints, image px
    conf: torch.Tensor,  # (..., V, J)
    pred_angles: torch.Tensor,  # (..., A) shared robot state
    base_rotations: torch.Tensor,  # (..., V, 3, 3) per-view base corrections
    Ks: torch.Tensor,  # (..., V, 3, 3)
    robot: RobotSpec,
    confidence_threshold: float = DEFAULT_CONFIDENCE_THRESHOLD,
    gumbel: torch.Tensor | None = None,  # (..., V, n_hypotheses, J)
    generator: torch.Generator | None = None,
    n_hypotheses: int = 16,
) -> dict:
    """Per-camera RANSAC PnP from decoded keypoints, the decode-free core of
    `recover_pose_batch`: the recovered pose maps base-rotated FK points into
    each camera's frame. Returns `solve_pnp_ransac`'s dict over (..., V)
    plus keypoints_xy and confidence."""
    V = xy.shape[-3]
    weights = (conf >= confidence_threshold).to(xy.dtype)
    angles = pred_angles[..., None, :].expand(*pred_angles.shape[:-1], V, pred_angles.shape[-1])
    obj = robot.keypoints_from_fk(forward_kinematics(robot, angles, base_rotations))
    out = solve_pnp_ransac(obj, xy, Ks, weights=weights, gumbel=gumbel, generator=generator,
                           n_hypotheses=n_hypotheses)
    out["keypoints_xy"], out["confidence"] = xy, conf
    return out


def recover_pose_batch(
    heatmaps: torch.Tensor,  # (..., V, J, Hm, Wm) raw logits, one per camera
    pred_angles: torch.Tensor,  # (..., A) shared robot state
    base_rotations: torch.Tensor,  # (..., V, 3, 3)
    Ks: torch.Tensor,  # (..., V, 3, 3)
    robot: RobotSpec,
    image_hw: tuple[int, int],
    confidence_threshold: float = DEFAULT_CONFIDENCE_THRESHOLD,
    draws: PoseDraws | None = None,
    generator: torch.Generator | None = None,
    n_hypotheses: int = 16,
    decode_mode: str = "argmax",
    refine: bool = False,
    refine_sigma_px: float = 1.2,
    refine_sigma_prior: float = 0.2,
) -> dict:
    """A rig tick's pose recovery: decode -> FK(pred angles) -> RANSAC PnP
    per camera -> optionally the joint refinement. Returns dict with rvec
    (..., V, 3), tvec (..., V, 3), inlier_mask, n_inliers and success
    (..., V), keypoints_xy (..., V, J, 2), confidence (..., V, J), and with
    refine refined_angles (..., A). `decode_mode` "refine" is the subpixel
    decode (the reference measured ~3x less pose error with it)."""
    xy, conf = decode_keypoints(heatmaps, image_hw=image_hw, mode=decode_mode)
    *lead, V, J, _ = xy.shape
    if draws is None:
        draws = PoseDraws.draw(tuple(lead), V, J, pred_angles.shape[-1], refine, generator,
                               xy.device, n_hypotheses)
    out = solve_rig_pnp(xy, conf, pred_angles, base_rotations, Ks, robot,
                        confidence_threshold=confidence_threshold, gumbel=draws.gumbel,
                        n_hypotheses=n_hypotheses)
    if refine:
        ref = refine_rig_pose_angles(
            xy, conf, pred_angles, out["rvec"], out["tvec"], base_rotations, Ks, robot,
            starts=draws.starts, regumbel=draws.regumbel, sigma_px=refine_sigma_px,
            sigma_prior=refine_sigma_prior, confidence_threshold=confidence_threshold)
        out["rvec"], out["tvec"], out["refined_angles"] = ref["rvec"], ref["tvec"], ref["angles"]
        confident = (conf >= confidence_threshold).sum(-1) >= MIN_POSE_POINTS
        out["success"] = out["success"] | confident
    return out


def recover_pose_multiview(
    heatmaps: torch.Tensor,  # (V, J, Hm, Wm)
    view_mask: torch.Tensor,  # (V,)
    rvecs: torch.Tensor,  # (V, 3) calibrated world -> camera extrinsics
    tvecs: torch.Tensor,  # (V, 3)
    Ks: torch.Tensor,  # (V, 3, 3)
    image_hw: tuple[int, int],
    confidence_threshold: float = DEFAULT_CONFIDENCE_THRESHOLD,
):
    """Triangulate the robot's keypoints from every confident view -> (points
    (J, 3) in the world frame, observability (J,): 1 where >= 2 views see
    the keypoint)."""
    xy, conf = decode_keypoints(heatmaps, image_hw=image_hw)
    weights = (conf >= confidence_threshold).float() * view_mask.float()[:, None]
    pts3d = triangulate_keypoints(xy, projection_matrix(rvecs, tvecs, Ks), weights)
    return pts3d, ((weights > 0).sum(0) >= 2).float()


def reprojection_errors(points3d: torch.Tensor, keypoints_2d: torch.Tensor, rvec: torch.Tensor,
                        tvec: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel distance (..., J) of projected points (..., J, 3) to keypoints."""
    proj = project_points(points3d, rvec, tvec, K, None)
    return torch.linalg.norm(proj - keypoints_2d, dim=-1)


__all__ = [
    "DEFAULT_CONFIDENCE_THRESHOLD",
    "PoseDraws",
    "PoseResult",
    "recover_pose_batch",
    "recover_pose_multiview",
    "recover_pose_single_view",
    "refine_rig_pose_angles",
    "reprojection_errors",
    "solve_rig_pnp",
]
