"""Multi-view DLT triangulation with per-view weights.

Port of `mvropose_tpu/geometry/triangulation.py` (`projection_matrix`,
`triangulate_dlt` and its system `dlt_system`, `heatmap_projection_matrices`,
`triangulate_keypoints`), with leading batch dimensions in place of the
reference's vmaps. A view of weight 0 drops out. The SVD is `ops/small_svd.small_svd`: the kernel on a
CUDA tensor (`torch.linalg.svd` would wait for the device), LAPACK on a CPU
tensor. X[:3] / X[3] does not depend on the sign of the null vector, so the
two agree wherever the null space has dimension 1.
"""

from __future__ import annotations

import torch

from mvropose_torch.geometry.rotations import rodrigues_to_matrix
from mvropose_torch.ops.small_svd import small_svd


def projection_matrix(rvec: torch.Tensor, tvec: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """rvec (..., 3), tvec (..., 3), K (..., 3, 3) -> P = K [R | t] (..., 3, 4)."""
    Rt = torch.cat([rodrigues_to_matrix(rvec), tvec[..., :, None]], dim=-1)
    return K @ Rt


def heatmap_projection_matrices(rvecs: torch.Tensor, tvecs: torch.Tensor, K: torch.Tensor,
                                image_hw, heatmap_hw) -> torch.Tensor:
    """(V, 3, 4) projection matrices in heatmap pixels: P of the image-pixel
    intrinsics K ((3, 3) or (V, 3, 3)) scaled on the left by diag(hm_w / img_w,
    hm_h / img_h, 1), so that keypoints decoded in heatmap pixels triangulate
    directly. 3D stays metric. The factors stay Python floats: no
    host-to-device copy."""
    P = projection_matrix(rvecs, tvecs, K.expand(rvecs.shape[0], 3, 3))
    return torch.stack([P[..., 0, :] * (heatmap_hw[1] / image_hw[1]),
                        P[..., 1, :] * (heatmap_hw[0] / image_hw[0]), P[..., 2, :]], dim=-2)


def dlt_system(pixels: torch.Tensor, proj_matrices: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """The row-normalized, weighted [u P3 - P1; v P3 - P2] system of one
    point: pixels (..., V, 2), P (..., V, 3, 4), weights (..., V) ->
    (..., 2V, 4); a view of weight 0 gives two zero rows."""
    P1, P2, P3 = proj_matrices[..., 0, :], proj_matrices[..., 1, :], proj_matrices[..., 2, :]
    A = torch.cat([pixels[..., 0:1] * P3 - P1, pixels[..., 1:2] * P3 - P2], dim=-2)
    w2 = torch.cat([weights, weights], dim=-1)
    return A / (torch.linalg.norm(A, dim=-1, keepdim=True) + 1e-12) * w2[..., None]


def triangulate_dlt(pixels: torch.Tensor, proj_matrices: torch.Tensor,
                    weights: torch.Tensor | None = None) -> torch.Tensor:
    """One 3D point from V views: pixels (..., V, 2), P (..., V, 3, 4),
    weights (..., V) -> (..., 3). The null vector of `dlt_system`, a
    (..., 2V, 4) SVD."""
    if weights is None:
        weights = torch.ones(pixels.shape[:-1], dtype=pixels.dtype, device=pixels.device)
    X = small_svd(dlt_system(pixels, proj_matrices, weights))[2][..., -1, :]
    return X[..., :3] / (X[..., 3:] + 1e-12)


def triangulate_keypoints(pixels: torch.Tensor, proj_matrices: torch.Tensor,
                          weights: torch.Tensor | None = None) -> torch.Tensor:
    """J keypoints from V views: pixels (..., V, J, 2), P (V, 3, 4) or
    (..., V, 3, 4), weights (..., V, J) or (..., V) -> (..., J, 3)."""
    if weights is None:
        weights = torch.ones(pixels.shape[:-1], dtype=pixels.dtype, device=pixels.device)
    elif weights.dim() == pixels.dim() - 2:
        weights = weights[..., None].expand(pixels.shape[:-1])
    return triangulate_dlt(pixels.transpose(-3, -2), proj_matrices.unsqueeze(-4),
                           weights.transpose(-2, -1))
