"""Perspective-n-Point: DLT and planar initializers, LM refinement, RANSAC.

Port of `mvropose_tpu/geometry/pnp.py`. Every function takes leading batch
dimensions where the reference vmaps (views, hypotheses, candidates), and
runs fixed iteration counts with `torch.where` updates where the reference
runs `lax.scan`, so nothing on the way waits for the device:
  * the SVDs go through `ops.small_svd` (the Jacobi kernel on the card);
  * K and the Hartley normalizations are inverted in closed form;
  * the 6 x 6 LM systems are solved by `torch.linalg.solve_ex` without its
    error check (a singular system gives a non-finite step, which the LM
    rejects as the reference's does);
  * the Jacobians are forward mode (`torch.func.jvp`, one-hot tangents
    batched by `torch.func.vmap`: `batched_jacobian`).
RANSAC samples its hypotheses by Gumbel top-k, as the reference does, from a
(..., n_hypotheses, N) Gumbel tensor given by the caller (the parity tests
pass the reference's own `jax.random` draws) or drawn from a
`torch.Generator`.
"""

from __future__ import annotations

import math

import torch
from torch.func import jvp, vmap

from mvropose_torch.geometry.camera import project_points
from mvropose_torch.geometry.rotations import det3, matrix_to_rodrigues, rodrigues_to_matrix
from mvropose_torch.ops.small_svd import small_svd


def _mat(rows) -> torch.Tensor:
    """Nested lists of (...) tensors -> a (..., R, C) matrix."""
    entries = torch.broadcast_tensors(*(e for row in rows for e in row))
    return torch.stack(entries, -1).unflatten(-1, (len(rows), len(rows[0])))


def _inv3(K: torch.Tensor) -> torch.Tensor:
    """Inverses of (..., 3, 3) matrices by the adjugate (no LU, no sync)."""
    c0 = torch.linalg.cross(K[..., 1, :], K[..., 2, :], dim=-1)
    c1 = torch.linalg.cross(K[..., 2, :], K[..., 0, :], dim=-1)
    c2 = torch.linalg.cross(K[..., 0, :], K[..., 1, :], dim=-1)
    adj_t = torch.stack([c0, c1, c2], -1)  # columns: the cofactor rows
    return adj_t / (K[..., 0, :] * c0).sum(-1)[..., None, None]


def _weighted_mean(pts: torch.Tensor, weights: torch.Tensor):
    wsum = weights.sum(-1) + 1e-12
    return (pts * weights[..., None]).sum(-2) / wsum[..., None], wsum


def _normalize_2d(pts: torch.Tensor, weights: torch.Tensor):
    """Hartley normalization of weighted 2D points (..., N, 2) ->
    (T, T^-1, normalized points), T (..., 3, 3)."""
    mean, wsum = _weighted_mean(pts, weights)
    d = torch.sqrt(((pts - mean[..., None, :]) ** 2).sum(-1) + 1e-12)
    scale = math.sqrt(2.0) / ((d * weights).sum(-1) / wsum + 1e-12)
    mx, my = mean.unbind(-1)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    T = _mat([[scale, zero, -scale * mx], [zero, scale, -scale * my], [zero, zero, one]])
    T_inv = _mat([[1.0 / scale, zero, mx], [zero, 1.0 / scale, my], [zero, zero, one]])
    return T, T_inv, (pts - mean[..., None, :]) * scale[..., None, None]


def _normalize_3d(pts: torch.Tensor, weights: torch.Tensor):
    """The same for 3D points (..., N, 3) -> (U (..., 4, 4), normalized points)."""
    mean, wsum = _weighted_mean(pts, weights)
    d = torch.sqrt(((pts - mean[..., None, :]) ** 2).sum(-1) + 1e-12)
    scale = math.sqrt(3.0) / ((d * weights).sum(-1) / wsum + 1e-12)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    m = (-scale[..., None] * mean).unbind(-1)
    U = _mat([[scale, zero, zero, m[0]], [zero, scale, zero, m[1]], [zero, zero, scale, m[2]],
              [zero, zero, zero, one]])
    return U, (pts - mean[..., None, :]) * scale[..., None, None]


def _normalized_image(image_points: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixels (..., N, 2) -> normalized camera coordinates K^-1 [u v 1]."""
    ones = torch.ones_like(image_points[..., :1])
    pix_h = torch.cat([image_points, ones], -1)
    return (pix_h @ _inv3(K).transpose(-1, -2))[..., :2]


def _project_to_rotation(M: torch.Tensor):
    """(U D Vh, S) of (..., 3, 3) matrices: the nearest rotation, D fixing
    det(U Vh) to +1."""
    U, S, Vh = small_svd(M, compute_u=True)
    det = det3(U @ Vh)
    ones = torch.ones_like(det)
    return U @ (torch.stack([ones, ones, det], -1)[..., None] * Vh), S


def _weights_like(object_points: torch.Tensor, weights):
    if weights is None:
        return torch.ones(object_points.shape[:-1], dtype=object_points.dtype,
                          device=object_points.device)
    return weights


def _broadcast(object_points, image_points, weights):
    """Points (..., N, 3), (..., N, 2) and weights (..., N) expanded to their
    common leading dimensions (views, hypotheses), without a copy."""
    weights = _weights_like(object_points, weights)
    lead = torch.broadcast_shapes(object_points.shape[:-2], image_points.shape[:-2],
                                  weights.shape[:-1])
    N = object_points.shape[-2]
    return (object_points.expand(*lead, N, 3), image_points.expand(*lead, N, 2),
            weights.expand(*lead, N))


def solve_pnp_dlt(object_points: torch.Tensor, image_points: torch.Tensor, K: torch.Tensor,
                  weights: torch.Tensor | None = None):
    """Weighted DLT pose init: (..., N >= 6, 3) + (..., N, 2) -> (rvec (..., 3),
    tvec (..., 3)). The 3 x 4 projection in normalized image coordinates is
    the null vector of the (2N, 12) system; its left 3 x 3 is projected onto
    SO(3). Weight 0 drops a point."""
    object_points, image_points, weights = _broadcast(object_points, image_points, weights)
    xy = _normalized_image(image_points, K)
    _, T2_inv, xyn = _normalize_2d(xy, weights)
    U4, Xn = _normalize_3d(object_points, weights)
    ones = torch.ones_like(Xn[..., :1])
    Xh = torch.cat([Xn, ones], -1)  # (..., N, 4)
    zero = torch.zeros_like(Xh)
    u, v = xyn[..., 0:1], xyn[..., 1:2]
    A = torch.cat([torch.cat([Xh, zero, -u * Xh], -1), torch.cat([zero, Xh, -v * Xh], -1)], -2)
    A = A * torch.cat([weights, weights], -1)[..., None]
    _, _, Vh = small_svd(A)
    P = T2_inv @ Vh[..., -1, :].unflatten(-1, (3, 4)) @ U4
    # Points in front of the camera: the weighted sign of their depths.
    depths = (torch.cat([object_points, ones], -1) @ P[..., 2, :, None])[..., 0]
    flip = (torch.sign(depths) * weights).sum(-1) < 0
    P = torch.where(flip[..., None, None], -P, P)
    R, S = _project_to_rotation(P[..., :3])
    t = P[..., 3] / (S.sum(-1) / 3.0 + 1e-12)[..., None]
    return matrix_to_rodrigues(R), t


def solve_pnp_planar(object_points: torch.Tensor, image_points: torch.Tensor, K: torch.Tensor,
                     weights: torch.Tensor | None = None):
    """Homography pose init for (near-)planar points, both roots of the
    two-fold planar ambiguity: ((rvec1, tvec1), (rvec2, tvec2)), each
    (..., 3). The reference's docstring (`pnp.py:119`) derives the second
    root; the signs the SVDs leave free cancel out of both."""
    object_points, image_points, weights = _broadcast(object_points, image_points, weights)
    c, _ = _weighted_mean(object_points, weights)
    centered = (object_points - c[..., None, :]) * weights[..., None]
    _, _, Vt = small_svd(centered)
    B2 = Vt[..., :2, :].transpose(-1, -2)  # (..., 3, 2) in-plane basis
    n = Vt[..., 2, :]  # plane normal
    plane_pts = (object_points - c[..., None, :]) @ B2

    xy = _normalized_image(image_points, K)
    _, T2_inv, xyn = _normalize_2d(xy, weights)
    T3, _, ppn = _normalize_2d(plane_pts, weights)
    X, Y = ppn[..., 0:1], ppn[..., 1:2]
    x, y = xyn[..., 0:1], xyn[..., 1:2]
    one, zero = torch.ones_like(X), torch.zeros_like(X)
    A = torch.cat([torch.cat([X, Y, one, zero, zero, zero, -x * X, -x * Y, -x], -1),
                   torch.cat([zero, zero, zero, X, Y, one, -y * X, -y * Y, -y], -1)], -2)
    A = A * torch.cat([weights, weights], -1)[..., None]
    _, _, Vh = small_svd(A)
    H = T2_inv @ Vh[..., -1, :].unflatten(-1, (3, 3)) @ T3
    H = torch.where((H[..., 2, 2] < 0)[..., None, None], -H, H)  # plane origin at z > 0

    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    s = 2.0 / (torch.linalg.norm(h1, dim=-1) + torch.linalg.norm(h2, dim=-1) + 1e-12)
    r1, r2, t_h = h1 * s[..., None], h2 * s[..., None], h3 * s[..., None]
    r3 = torch.linalg.cross(r1, r2, dim=-1)
    Rp, _ = _project_to_rotation(torch.stack([r1, r2, r3], -1))

    # Plane frame -> world: Q = [B2 n]; R_w Q = [r1 r2 det(Q) r3] keeps R_w proper.
    Q = torch.cat([B2, n[..., :, None]], -1)
    ones = torch.ones_like(s)
    col_scale = torch.stack([ones, ones, det3(Q)], -1)[..., None, :]

    def world(Rp_):
        Rw = (Rp_ * col_scale) @ Q.transpose(-1, -2)
        return matrix_to_rodrigues(Rw), t_h - (Rw @ c[..., :, None])[..., 0]

    # Second root: the plane normal reflected across the ray to the plane
    # origin, as a rotation by 2 theta about n x v (fronto-parallel: root 1).
    v = t_h / (torch.linalg.norm(t_h, dim=-1, keepdim=True) + 1e-12)
    n_cam = Rp[..., :, 2]
    axis = torch.linalg.cross(n_cam, v, dim=-1)
    s_ax = torch.linalg.norm(axis, dim=-1)
    theta = torch.atan2(s_ax, (n_cam * v).sum(-1))
    tilted = (s_ax > 1e-8)[..., None]
    safe_axis = torch.where(tilted, axis / (s_ax[..., None] + 1e-12), torch.zeros_like(axis))
    G = rodrigues_to_matrix(safe_axis * (2.0 * theta)[..., None])
    Rp2 = torch.where(tilted[..., None], G @ Rp, Rp)
    return world(Rp), world(Rp2)


def batched_jacobian(f, params: torch.Tensor):
    """(J (..., R, P), f(params) (..., R)) for a function whose row (..., R)
    depends on the same row of params (..., P) only: forward mode, what
    `torch.func.jacfwd` computes, with the P one-hot tangents batched by
    `vmap` and the batch kept as explicit dimensions. (Under `vmap` over the
    batch, a 0-dim tensor meets Python floats, and torch's forward AD then
    gives float64 tangents; so an unbatched call gets a batch of one.)
    Under `torch.inference_mode` (the serve step's) the duals are made
    outside it, from a normal copy of params: an inference tensor cannot
    be a dual's primal."""
    if params.dim() == 1:
        J, r = batched_jacobian(f, params[None])
        return J[0], r[0]
    P = params.shape[-1]
    with torch.inference_mode(False):
        params = params.clone() if params.is_inference() else params
        eye = torch.eye(P, dtype=params.dtype, device=params.device)
        basis = eye.reshape(P, *(1,) * (params.dim() - 1), P).expand(P, *params.shape)
        r, J = vmap(lambda t: jvp(f, (params,), (t,)), out_dims=(None, -1))(basis)
    return J, r


def _reproj_residuals(params, object_points, image_points, K, dist, weights):
    """Weighted reprojection residuals (..., 2N) of params (..., 6) = [rvec tvec]."""
    proj = project_points(object_points, params[..., :3], params[..., 3:], K, dist)
    return ((proj - image_points) * weights[..., None]).flatten(-2)


def refine_pnp_lm(object_points: torch.Tensor, image_points: torch.Tensor, K: torch.Tensor,
                  rvec0: torch.Tensor, tvec0: torch.Tensor, dist=None,
                  weights: torch.Tensor | None = None, iters: int = 20):
    """Levenberg-Marquardt refinement of (rvec, tvec) on the reprojection
    error, `iters` iterations with multiplicative damping, as the reference
    (cv2.solvePnPRefineLM). The pose's leading dimensions set the batch;
    the points, K and weights broadcast against them.
    Returns (rvec, tvec, final cost), each over the pose's leading dimensions."""
    params = torch.cat([rvec0, tvec0], -1)
    lead = params.shape[:-1]
    weights = _weights_like(object_points, weights)

    def res(p):
        return _reproj_residuals(p, object_points, image_points, K, dist, weights)

    lam = torch.full(lead, 1e-3, dtype=params.dtype, device=params.device)
    for _ in range(iters):
        J, r = batched_jacobian(res, params)  # (..., 2N, 6), (..., 2N)
        Jt = J.transpose(-1, -2)
        JtJ = Jt @ J
        H = JtJ + lam[..., None, None] * torch.diag_embed(
            torch.diagonal(JtJ, dim1=-2, dim2=-1) + 1e-9)
        delta = torch.linalg.solve_ex(H, Jt @ r[..., None], check_errors=False)[0][..., 0]
        new_params = params - delta
        improved = (res(new_params) ** 2).sum(-1) < (r ** 2).sum(-1)
        params = torch.where(improved[..., None], new_params, params)
        lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0), 1e-10, 1e8)
    return params[..., :3], params[..., 3:], (res(params) ** 2).sum(-1)


def _take(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """x indexed along `dim` (< 0) by `idx`, which has x's shape up to `dim`."""
    trailing = x.shape[x.dim() + dim + 1:]
    i = idx.reshape(*idx.shape, 1, *(1,) * len(trailing))
    return torch.take_along_dim(x, i.expand(*idx.shape, 1, *trailing), dim).squeeze(dim)


def _initializers(object_points, image_points, K, weights):
    """The three initial poses (DLT, both planar roots) -> (rvecs, tvecs), each
    (..., 3, 3) with the candidate second to last."""
    r_dlt, t_dlt = solve_pnp_dlt(object_points, image_points, K, weights)
    (r_p1, t_p1), (r_p2, t_p2) = solve_pnp_planar(object_points, image_points, K, weights)
    return torch.stack([r_dlt, r_p1, r_p2], -2), torch.stack([t_dlt, t_p1, t_p2], -2)


def solve_pnp(object_points: torch.Tensor, image_points: torch.Tensor, K: torch.Tensor,
              weights: torch.Tensor | None = None, dist=None, refine_iters: int = 20):
    """Non-robust PnP (cv2.solvePnP + solvePnPRefineLM): all three
    initializers, each LM-polished, the lowest reprojection cost wins ->
    (rvec, tvec, cost)."""
    weights = _weights_like(object_points, weights)
    cand_r, cand_t = _initializers(object_points, image_points, K, weights)
    unsq = lambda x: x.unsqueeze(-3)  # noqa: E731 - the candidate dimension
    rs, ts, costs = refine_pnp_lm(unsq(object_points), unsq(image_points), unsq(K), cand_r,
                                  cand_t, dist=dist, weights=weights[..., None, :],
                                  iters=refine_iters)
    b = costs.argmin(-1)
    return _take(rs, b, -2), _take(ts, b, -2), _take(costs[..., None], b, -2)[..., 0]


def draw_gumbel(shape, generator: torch.Generator | None = None, device=None,
                dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) of u uniform in [tiny, 1), as
    `jax.random.gumbel`, from `generator` on `device`."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(dtype).tiny)))


def solve_pnp_ransac(object_points: torch.Tensor, image_points: torch.Tensor, K: torch.Tensor,
                     weights: torch.Tensor | None = None, dist=None,
                     gumbel: torch.Tensor | None = None,
                     generator: torch.Generator | None = None, n_hypotheses: int = 32,
                     min_points: int = 6, inlier_threshold_px: float = 8.0,
                     refine_iters: int = 10) -> dict:
    """RANSAC PnP with static shapes, over the leading dimensions of the
    points (..., N, 3): each of `n_hypotheses` hypotheses takes the
    `min_points` points of largest Gumbel draw among the nonzero-weight ones,
    runs the three initializers each with an 8-iteration LM polish on them,
    and keeps its best by inlier count (ties: smaller mean inlier error);
    the best hypothesis is LM-refined on its inliers and the inliers
    recounted. `gumbel` (..., n_hypotheses, N) or else drawn from
    `generator`. Returns dict(rvec, tvec, inlier_mask, n_inliers, success),
    success being >= 4 inliers among nonzero-weight points."""
    object_points, image_points, weights = _broadcast(object_points, image_points, weights)
    lead, N = object_points.shape[:-2], object_points.shape[-2]
    lead = torch.broadcast_shapes(lead, K.shape[:-2])
    object_points, image_points = object_points.expand(*lead, N, 3), image_points.expand(*lead, N, 2)
    weights, K = weights.expand(*lead, N), K.expand(*lead, 3, 3)
    if gumbel is None:
        gumbel = draw_gumbel((*lead, n_hypotheses, N), generator, object_points.device,
                             object_points.dtype)
    valid = weights > 0
    logits = torch.where(valid[..., None, :], gumbel, -torch.inf)
    sel = logits.topk(min_points, dim=-1).indices
    sel_w = torch.zeros_like(logits).scatter(-1, sel, 1.0) * valid[..., None, :]

    def hyp(x):  # (..., X, ...) -> (..., 1, X, ...): broadcast over hypotheses
        return x.unsqueeze(len(lead))

    cand_r, cand_t = _initializers(hyp(object_points), hyp(image_points), hyp(K), sel_w)

    def cand(x):  # and over the three candidates
        return hyp(x).unsqueeze(len(lead) + 1)

    rs, ts, _ = refine_pnp_lm(cand(object_points), cand(image_points), cand(K), cand_r, cand_t,
                              dist=dist, weights=sel_w[..., None, :], iters=8)
    err = torch.linalg.norm(project_points(cand(object_points), rs, ts, cand(K), dist)
                            - cand(image_points), dim=-1)  # (..., H, 3, N)
    inl = (err < inlier_threshold_px) & cand(valid)
    n_inl = inl.sum(-1).to(err.dtype)
    scores = n_inl - 1e-3 * torch.where(inl, err, 0.0).sum(-1) / (n_inl + 1e-6)
    b = scores.argmax(-1)  # (..., H): each hypothesis's best candidate
    rs, ts, inl, scores = (_take(x, b, -2) for x in (rs, ts, inl, scores[..., None]))
    best = scores[..., 0].argmax(-1)
    rvec, tvec, inlier_mask = (_take(x, best, -2) for x in (rs, ts, inl))
    rvec, tvec, _ = refine_pnp_lm(object_points, image_points, K, rvec, tvec, dist=dist,
                                  weights=inlier_mask.to(object_points.dtype),
                                  iters=refine_iters)
    err = torch.linalg.norm(project_points(object_points, rvec, tvec, K, dist) - image_points,
                            dim=-1)
    inlier_mask = (err < inlier_threshold_px) & valid
    n_inliers = inlier_mask.sum(-1)
    return {"rvec": rvec, "tvec": tvec, "inlier_mask": inlier_mask, "n_inliers": n_inliers,
            "success": n_inliers >= 4}
