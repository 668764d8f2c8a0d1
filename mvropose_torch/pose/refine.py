"""Joint (camera pose, joint angle) reprojection refinement.

Port of `mvropose_tpu/pose/refine.py::refine_rig_pose_angles`, whose
docstring gives the objective and why it exists: damped Gauss-Newton over
p = [rvec_1..V, tvec_1..V, theta] minimizing

    sum_v w_vj |project(R_v FK(theta)_j + t_v) - xy_vj|^2 / sigma_px^2
    + |theta - theta_pred|^2 / sigma_prior^2

from `n_starts` angle hypotheses around the prediction, then a RANSAC-PnP
re-solve with the best angles and a short polish, kept only if it lowers the
cost. Fixed iteration counts, forward-mode Jacobians
(`geometry.pnp.batched_jacobian`), the (6V + A)-square systems by Cholesky
(`_spd_solve`): nothing waits for the device, and the step can be captured
in a CUDA graph. The draws (the starts' N(0, 1) angle
perturbations and the re-solve's Gumbel draws) are arguments, or drawn from
a `torch.Generator`.

Deliberate divergence from the reference: a NaN cost (a start that diverged)
counts as +inf before the best start is chosen and before the re-solve's
polish is compared with it. The reference's `argmin` takes the NaN
(`pose/refine.py:131`), and its `take` comparison with a NaN is false, so
its result is the NaN start's.
"""

from __future__ import annotations

import torch
from mvropose_torch.geometry.camera import project_points
from mvropose_torch.geometry.pnp import batched_jacobian, draw_gumbel, solve_pnp_ransac
from mvropose_torch.geometry.robots import RobotSpec, forward_kinematics

DEFAULT_SIGMA_PX = 1.2  # the reference's measured refine-decode error
DEFAULT_CONFIDENCE_THRESHOLD = 0.6  # the reference's serve gate
RESOLVE_HYPOTHESES = 16  # the re-solve's RANSAC hypotheses, as the reference


def _spd_solve(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x of M x = b for symmetric positive definite M (..., n, n), b (..., n):
    Cholesky without its error check, then two triangular solves. The
    reference solves with LU (`jnp.linalg.solve`); `torch.linalg.solve_ex`
    takes MAGMA on the card for a batch of more than 16 systems of n > 16
    (the refinement's: 32 starts, n = 6V + A = 31 at 4 views), which cannot
    be captured in a CUDA graph; cuSOLVER's batched Cholesky and cuBLAS's
    triangular solves can. A matrix that is not positive definite gives a
    non-finite step, whose cost counts as +inf."""
    L = torch.linalg.cholesky_ex(M, check_errors=False)[0]
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]


def _finite_cost(cost: torch.Tensor) -> torch.Tensor:
    """NaN costs as +inf, so that they never win a minimum."""
    return torch.where(torch.isnan(cost), torch.inf, cost)


def refine_rig_pose_angles(
    xy: torch.Tensor,  # (..., V, J, 2) decoded keypoints, image px
    conf: torch.Tensor,  # (..., V, J)
    pred_angles: torch.Tensor,  # (..., A) network prediction, native units
    rvec0: torch.Tensor,  # (..., V, 3) initial pose (solve_rig_pnp's)
    tvec0: torch.Tensor,  # (..., V, 3)
    base_rotations: torch.Tensor,  # (..., V, 3, 3)
    Ks: torch.Tensor,  # (..., V, 3, 3)
    robot: RobotSpec,
    starts: torch.Tensor | None = None,  # (..., n_starts, A) N(0, 1) draws
    regumbel: torch.Tensor | None = None,  # (..., V, 16, J) the re-solve's Gumbel draws
    generator: torch.Generator | None = None,
    view_mask: torch.Tensor | None = None,  # (..., V) bool; None: all valid
    sigma_px: float = DEFAULT_SIGMA_PX,
    sigma_prior: float = 0.2,  # prior std in the robot's native angle unit
    n_starts: int = 32,
    iters: int = 40,
    polish_iters: int = 20,
    damping: float = 1e-3,
    confidence_threshold: float = DEFAULT_CONFIDENCE_THRESHOLD,
) -> dict:
    """Multi-start joint LM + RANSAC-PnP re-solve -> dict(rvec (..., V, 3),
    tvec (..., V, 3), angles (..., A), cost (...)), the lowest-cost fit.
    Start 0 is the unperturbed prediction, the others pred + sigma_prior *
    starts; the poses start at (rvec0, tvec0)."""
    lead, (V, J), A = xy.shape[:-3], xy.shape[-3:-1], pred_angles.shape[-1]
    dev, dt = xy.device, xy.dtype
    if view_mask is None:
        view_mask = torch.ones((*lead, V), dtype=torch.bool, device=dev)
    w = (conf >= confidence_threshold).to(dt) * view_mask[..., None].to(dt)
    if starts is None:
        starts = torch.randn((*lead, n_starts, A), generator=generator, device=dev, dtype=dt)
    if regumbel is None:
        regumbel = draw_gumbel((*lead, V, RESOLVE_HYPOTHESES, J), generator, dev, dt)
    P = 6 * V + A

    def objects(theta, bases):
        fk = robot.keypoints_from_fk(forward_kinematics(robot, theta))  # (..., J, 3)
        return torch.einsum("...vij,...kj->...vki", bases, fk)  # (..., V, J, 3)

    def residuals(p, xy_, w_, pred, bases, K):
        """Residuals (..., 2VJ + A) of parameters (..., P); the rig's tensors
        broadcast against p's leading dimensions."""
        rv, tv = p[..., :3 * V].unflatten(-1, (V, 3)), p[..., 3 * V:6 * V].unflatten(-1, (V, 3))
        theta = p[..., 6 * V:]
        proj = project_points(objects(theta, bases), rv, tv, K, None)  # (..., V, J, 2)
        r_proj = ((proj - xy_) * w_[..., None] / sigma_px).flatten(-3)
        return torch.cat([r_proj, (theta - pred) / sigma_prior], -1)

    # Flattened rigs (B), each with its starts (S): the rig's tensors (B, 1, ...).
    rig = tuple(x.expand(*lead, *x.shape[-n:]).reshape(-1, 1, *x.shape[-n:]) for x, n in (
        (xy, 3), (w, 2), (pred_angles, 1), (base_rotations, 3), (Ks, 3)))
    eye = torch.eye(P, dtype=dt, device=dev)

    def lm(p, n):  # p (B, S, P)
        for _ in range(n):
            Jm, r = batched_jacobian(lambda q: residuals(q, *rig), p)  # (B, S, R, P), (B, S, R)
            Jt = Jm.transpose(-1, -2)
            JtJ = Jt @ Jm
            M = JtJ + damping * torch.diag_embed(torch.diagonal(JtJ, dim1=-2, dim2=-1)) + 1e-9 * eye
            p = p - _spd_solve(M, (Jt @ r[..., None])[..., 0])
        return p, _finite_cost((residuals(p, *rig) ** 2).sum(-1))

    perturb = sigma_prior * starts.reshape(-1, n_starts, A)
    perturb = torch.cat([torch.zeros_like(perturb[:, :1]), perturb[:, 1:]], 1)
    B = perturb.shape[0]
    p_pose0 = torch.cat([rvec0.expand(*lead, V, 3).reshape(B, 3 * V),
                         tvec0.expand(*lead, V, 3).reshape(B, 3 * V)], -1)
    p0 = torch.cat([p_pose0[:, None].expand(B, n_starts, 6 * V), rig[2] + perturb], -1)
    ps, costs = lm(p0, iters)
    b = costs.argmin(-1)  # the first of equal minima, as jnp.argmin
    best_cost = torch.take_along_dim(costs, b[:, None], 1)[:, 0]
    best = torch.take_along_dim(ps, b[:, None, None].expand(B, 1, P), 1)[:, 0]

    # Escape pose-side local minima: RANSAC per view on the best angles'
    # object points, a short joint polish, kept only if it lowers the cost.
    theta_best = best[:, 6 * V:]
    xy_b, w_b, _, bases_b, Ks_b = (x[:, 0] for x in rig)
    pnp = solve_pnp_ransac(objects(theta_best, bases_b), xy_b, Ks_b, weights=w_b,
                           gumbel=regumbel.reshape(B, V, RESOLVE_HYPOTHESES, J),
                           n_hypotheses=RESOLVE_HYPOTHESES)
    p_repnp0 = torch.cat([pnp["rvec"].flatten(-2), pnp["tvec"].flatten(-2), theta_best], -1)
    p_polish, cost_polish = lm(p_repnp0[:, None], polish_iters)
    take = cost_polish[:, 0] < best_cost
    p_final = torch.where(take[:, None], p_polish[:, 0], best)
    return {
        "rvec": p_final[:, :3 * V].reshape(*lead, V, 3),
        "tvec": p_final[:, 3 * V:6 * V].reshape(*lead, V, 3),
        "angles": p_final[:, 6 * V:].reshape(*lead, A),
        "cost": torch.where(take, cost_polish[:, 0], best_cost).reshape(lead),
    }
