"""Multi-view DLT triangulation with per-view weights.

Port of `mvropose_tpu/geometry/triangulation.py` (`projection_matrix`,
`triangulate_dlt`, `triangulate_keypoints`), with leading batch dimensions in
place of the reference's vmaps. A view of weight 0 drops out.
"""

from __future__ import annotations

import torch

from mvropose_torch.geometry.rotations import rodrigues_to_matrix


def projection_matrix(rvec: torch.Tensor, tvec: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """rvec (..., 3), tvec (..., 3), K (..., 3, 3) -> P = K [R | t] (..., 3, 4)."""
    Rt = torch.cat([rodrigues_to_matrix(rvec), tvec[..., :, None]], dim=-1)
    return K @ Rt


def triangulate_dlt(pixels: torch.Tensor, proj_matrices: torch.Tensor,
                    weights: torch.Tensor | None = None) -> torch.Tensor:
    """One 3D point from V views: pixels (..., V, 2), P (..., V, 3, 4),
    weights (..., V) -> (..., 3). The null vector of the row-normalized,
    weighted [u P3 - P1; v P3 - P2] system."""
    if weights is None:
        weights = torch.ones(pixels.shape[:-1], dtype=pixels.dtype, device=pixels.device)
    P1, P2, P3 = proj_matrices[..., 0, :], proj_matrices[..., 1, :], proj_matrices[..., 2, :]
    A = torch.cat([pixels[..., 0:1] * P3 - P1, pixels[..., 1:2] * P3 - P2], dim=-2)  # (..., 2V, 4)
    w2 = torch.cat([weights, weights], dim=-1)
    A = A / (torch.linalg.norm(A, dim=-1, keepdim=True) + 1e-12) * w2[..., None]
    X = torch.linalg.svd(A, full_matrices=True).Vh[..., -1, :]
    return X[..., :3] / (X[..., 3:] + 1e-12)


def triangulate_keypoints(pixels: torch.Tensor, proj_matrices: torch.Tensor,
                          weights: torch.Tensor | None = None) -> torch.Tensor:
    """J keypoints from V views: pixels (..., V, J, 2), P (V, 3, 4), weights
    (..., V, J) or (..., V) -> (..., J, 3)."""
    if weights is None:
        weights = torch.ones(pixels.shape[:-1], dtype=pixels.dtype, device=pixels.device)
    elif weights.dim() == pixels.dim() - 2:
        weights = weights[..., None].expand(pixels.shape[:-1])
    return triangulate_dlt(pixels.transpose(-3, -2), proj_matrices, weights.transpose(-2, -1))
