"""SO(3) utilities: rotation vectors, quaternions, euler angles.

Port of `mvropose_tpu/geometry/rotations.py`. Quaternions are (x, y, z, w),
as scipy's. Every function takes leading batch dimensions (the JAX versions
are vmapped instead).
"""

from __future__ import annotations

import torch

from mvropose_torch.ops.small_svd import small_svd

_EPS = 1e-12


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def rodrigues_to_matrix(rvec) -> torch.Tensor:
    """Rotation vectors (..., 3) -> rotation matrices (..., 3, 3): the
    Rodrigues formula with small-angle Taylor branches."""
    rvec = torch.as_tensor(rvec)
    theta2 = (rvec * rvec).sum(-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    K = _skew(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def matrix_to_quat(R) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> unit quaternions (..., 4), w >= 0:
    Shepperd's method, the best-conditioned of four candidates."""
    R = torch.as_tensor(R)
    m = [[R[..., i, j] for j in range(3)] for i in range(3)]
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = m
    tr = m00 + m11 + m22
    s = [torch.sqrt(torch.clamp(v, min=_EPS)) * 2.0 for v in
         (1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22)]
    cands = torch.stack([
        torch.stack([(m21 - m12) / s[0], (m02 - m20) / s[0], (m10 - m01) / s[0], s[0] / 4.0], -1),
        torch.stack([s[1] / 4.0, (m01 + m10) / s[1], (m02 + m20) / s[1], (m21 - m12) / s[1]], -1),
        torch.stack([(m01 + m10) / s[2], s[2] / 4.0, (m12 + m21) / s[2], (m02 - m20) / s[2]], -1),
        torch.stack([(m02 + m20) / s[3], (m12 + m21) / s[3], s[3] / 4.0, (m10 - m01) / s[3]], -1),
    ], -2)  # (..., 4, 4)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], -1)
    idx = scores.argmax(-1)[..., None, None].expand(*scores.shape[:-1], 1, 4)
    q = torch.take_along_dim(cands, idx, dim=-2)[..., 0, :]
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
    return torch.where(q[..., 3:] < 0, -q, q)


def quat_to_rodrigues(q) -> torch.Tensor:
    """Unit quaternions (..., 4) -> rotation vectors (..., 3), angle in [0, pi]."""
    q = torch.as_tensor(q)
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
    q = torch.where(q[..., 3:] < 0, -q, q)
    v, w = q[..., :3], q[..., 3]
    norm_v = torch.linalg.norm(v, dim=-1)
    angle = 2.0 * torch.atan2(norm_v, w)
    scale = torch.where(norm_v < 1e-9, 2.0 / torch.clamp(w, min=_EPS), angle / (norm_v + _EPS))
    return v * scale[..., None]


def matrix_to_rodrigues(R) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> rotation vectors (..., 3), through the
    quaternion (stable near pi)."""
    return quat_to_rodrigues(matrix_to_quat(R))


def euler_zyx_deg_to_matrix(angles_deg) -> torch.Tensor:
    """Extrinsic z-y-x euler angles in degrees (..., 3) -> R = Rx(c) Ry(b) Rz(a),
    as scipy's `Rotation.from_euler('zyx', [a, b, c], degrees=True)`."""
    a = torch.deg2rad(torch.as_tensor(angles_deg))
    (cz, cy, cx), (sz, sy, sx) = torch.cos(a).unbind(-1), torch.sin(a).unbind(-1)
    o, i = torch.zeros_like(cz), torch.ones_like(cz)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    Rz = mat([[cz, -sz, o], [sz, cz, o], [o, o, i]])
    Ry = mat([[cy, o, sy], [o, i, o], [-sy, o, cy]])
    Rx = mat([[i, o, o], [o, cx, -sx], [o, sx, cx]])
    return Rx @ Ry @ Rz


def quat_to_matrix(q) -> torch.Tensor:
    """Unit quaternions (..., 4) -> rotation matrices (..., 3, 3)."""
    q = torch.as_tensor(q)
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def average_quaternion(quats, weights=None) -> torch.Tensor:
    """Eigen-mean of quaternions (..., N, 4) -> (..., 4), w >= 0: the dominant
    eigenvector of sum_i w_i q_i q_i^T. A calibration helper, off the serve
    tick, so `torch.linalg.eigh` (which waits for the device) is fine here."""
    quats = torch.as_tensor(quats)
    if weights is None:
        weights = torch.ones(quats.shape[:-1], dtype=quats.dtype, device=quats.device)
    M = torch.einsum("...n,...ni,...nj->...ij", weights, quats, quats)
    q = torch.linalg.eigh(M).eigenvectors[..., -1]
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
    return torch.where(q[..., 3:] < 0, -q, q)


def quat_angular_distance(q1, q2) -> torch.Tensor:
    """Geodesic angle (radians) between unit quaternions (..., 4)."""
    q1, q2 = torch.as_tensor(q1), torch.as_tensor(q2)
    q1 = q1 / (torch.linalg.norm(q1, dim=-1, keepdim=True) + _EPS)
    q2 = q2 / (torch.linalg.norm(q2, dim=-1, keepdim=True) + _EPS)
    dot = (q1 * q2).sum(-1).abs()
    return 2.0 * torch.arccos(torch.clamp(dot, 0.0, 1.0))


def det3(M: torch.Tensor) -> torch.Tensor:
    """Determinants of (..., 3, 3) matrices, written out (no LU, no sync)."""
    return torch.linalg.cross(M[..., 0, :], M[..., 1, :], dim=-1).mul(M[..., 2, :]).sum(-1)


def kabsch(src, dst, weights=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Least-squares rigid alignment of (..., N, 3) point sets: (R, t) with
    dst ~= src @ R^T + t, by the SVD of the weighted cross-covariance with
    the det-sign fix for reflections; weight-0 points drop out."""
    src, dst = torch.as_tensor(src), torch.as_tensor(dst)
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = weights[..., None] / (weights.sum(-1)[..., None, None] + _EPS)
    mu_s, mu_d = (src * w).sum(-2), (dst * w).sum(-2)
    H = torch.einsum("...ni,...nj,...n->...ij", src - mu_s[..., None, :], dst - mu_d[..., None, :],
                     weights)
    U, _, Vh = small_svd(H, compute_u=True)
    V, Ut = Vh.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.sign(det3(V @ Ut))
    ones = torch.ones_like(d)
    R = V @ torch.diag_embed(torch.stack([ones, ones, d], -1)) @ Ut
    return R, mu_d - (R @ mu_s[..., None])[..., 0]
