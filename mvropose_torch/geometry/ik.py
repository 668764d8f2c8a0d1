"""Differentiable inverse kinematics: port of `mvropose_tpu/geometry/ik.py`.

The FK chain (`geometry/robots.py::forward_kinematics`) is a torch
function, so its Jacobian comes from forward-mode autodiff and a damped
Gauss-Newton solver follows: drive the arm to a pose recovered by the
vision stack, or check predicted angles against keypoints.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from mvropose_torch.geometry.robots import RobotSpec, forward_kinematics


def fk_jacobian(spec: RobotSpec, joint_angles, base_rotation=None) -> torch.Tensor:
    """d keypoints / d angles: (J+1, 3, A)."""
    angles = torch.as_tensor(joint_angles, dtype=torch.float32)
    return jacfwd(lambda a: forward_kinematics(spec, a, base_rotation))(angles)


def solve_ik(spec: RobotSpec, target_positions, initial_angles, weights=None,
             base_rotation=None, iters: int = 30, damping: float = 1e-3):
    """Damped Gauss-Newton IK: the angles minimizing ||FK(angles) - targets||
    over (J+1, 3) target positions, from (A,) initial angles in the robot's
    unit, with optional (J+1,) per-keypoint weights. Marquardt damping
    (relative to diag(JᵀJ)) keeps the step well-conditioned in either angle
    unit. -> (angles (A,), RMSE over the fitted residuals, metres)."""
    targets = torch.as_tensor(target_positions, dtype=torch.float32)
    J1 = targets.shape[0]
    w = (torch.ones(J1, dtype=torch.float32, device=targets.device) if weights is None
         else torch.as_tensor(weights, dtype=torch.float32))
    w = w.repeat_interleave(3)

    def residuals(angles):
        pts = forward_kinematics(spec, angles, base_rotation)
        return (pts - targets).reshape(-1) * w

    jac = jacfwd(residuals)
    angles = torch.as_tensor(initial_angles, dtype=torch.float32).clone()
    for _ in range(iters):
        r = residuals(angles)
        Jm = jac(angles)
        JtJ = Jm.T @ Jm
        A = (JtJ + damping * torch.diag(torch.diagonal(JtJ))
             + 1e-12 * torch.eye(JtJ.shape[0], dtype=JtJ.dtype, device=JtJ.device))
        angles = angles - torch.linalg.solve(A, Jm.T @ r)
    # The RMSE over the fitted residuals only: a zero-weight keypoint's
    # residuals are zero and would understate the error.
    r = residuals(angles)
    rmse = torch.sqrt((r ** 2).sum() / (w > 0).sum().clamp(min=1))
    return angles, rmse
