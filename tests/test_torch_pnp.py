"""PnP, its SVD kernel and the rest of rotations/camera: the port vs the JAX
reference, f32 on the CPU, and the SVD kernel on the card.

Inputs come from a numpy seed; RANSAC's Gumbel draws are the reference's own
(`jax.random`, split as `solve_pnp_ransac` splits them), so the two packages
test the same hypotheses. Tolerances:
  * success, inlier mask and inlier count equal;
  * rotations within 1e-3 rad and translations within 1e-3 of |t| of the
    reference (f32 SVDs by two libraries, then LM iterations; the measured
    gaps are ~1e-5). Where fewer than 6 points pass the confidence gate, the
    DLT's null space has more than one dimension and the two SVDs return
    different vectors of it, so only the success mask is compared;
  * the LM cost within 1e-3 relative (plus 1e-6 absolute for a cost ~0);
  * rotations, quaternions and projections 2e-5 (f32 in another order),
    `kabsch` 1e-4, undistortion 1e-3 px (8 fixed-point iterations).
The SVD kernel is held to `torch.linalg.svd` through sign-free quantities:
singular values within 2e-5 of the largest, |<v, v'>| of the last right
singular vector within 1e-4 of 1 where its singular value is simple, the
columns of A Vh^T orthogonal with norms S, and for 3 x 3 input U S Vh = A and
the projected rotation U D Vh within 1e-5 (where it is unique: rank >= 2).
"""

import itertools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvropose_tpu.geometry import camera as jcam
from mvropose_tpu.geometry import pnp as jpnp
from mvropose_tpu.geometry import robots as jrob
from mvropose_tpu.geometry import rotations as jrot

from mvropose_torch.geometry import camera as tcam
from mvropose_torch.geometry import pnp as tpnp
from mvropose_torch.geometry import robots as trob
from mvropose_torch.geometry import rotations as trot
from mvropose_torch.ops import small_svd
from torch_parity import assert_pose_close, jax_ransac_gumbel, np32, rotation_gap

K = np.array([[737.0, 0.0, 640.0], [0.0, 737.0, 360.0], [0.0, 0.0, 1.0]], np.float32)
COST_REL = 1e-3
# FR3 with joints 1, 3, 5 and 7 at zero keeps the chain in one plane.
PLANAR_FR3 = np.array([0.0, 0.5, 0.0, -1.2, 0.0, 1.0, 0.0], np.float32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def scene(robot: str, angles, seed: int, noise_px: float = 0.0, outliers=()):
    """FK points of `robot` at `angles`, one camera ~2 m away, their pixels
    (plus noise, and 60 px added to the `outliers`) -> (obj, xy, rvec, tvec)."""
    spec = jrob.get_robot(robot)
    obj = np.asarray(spec.keypoints_from_fk(jrob.forward_kinematics(spec, jnp.asarray(angles))),
                     np.float32)
    rng = np.random.default_rng(seed)
    rvec = rng.normal(scale=1.0, size=3).astype(np.float32)
    tvec = np.array([*rng.uniform(-0.2, 0.2, 2), rng.uniform(2.0, 2.5)], np.float32)
    xy = np.asarray(jcam.project_points(jnp.asarray(obj), rvec, tvec, jnp.asarray(K)), np.float32)
    xy = xy + rng.normal(scale=noise_px, size=xy.shape).astype(np.float32)
    for i in outliers:
        xy[i] += 60.0
    return obj, xy, rvec, tvec


def robot_angles(robot: str, seed: int) -> np.ndarray:
    spec = jrob.get_robot(robot)
    scale = 60.0 if spec.angle_unit == "deg" else 1.0
    return np.random.default_rng(seed).uniform(-scale, scale, spec.n_joints).astype(np.float32)


# name: (robot, angles, noise px, outliers, weights (None: all 1)); both
# robots' units (fr3 radians, fr5 degrees), the planar chain.
RANSAC_CASES = {
    "exact_fr3": ("fr3", robot_angles("fr3", 1), 0.0, (), None),
    "noisy_fr3": ("fr3", robot_angles("fr3", 2), 0.5, (), None),
    "outliers_fr3": ("fr3", robot_angles("fr3", 3), 0.5, (1, 5), None),
    "gate_fr3": ("fr3", robot_angles("fr3", 4), 0.5, (2, 6), [1, 1, 0, 1, 1, 1, 0, 1]),
    "planar_fr3": ("fr3", PLANAR_FR3, 0.5, (), None),
    "exact_fr5": ("fr5", robot_angles("fr5", 5), 0.0, (), None),
    "noisy_fr5": ("fr5", robot_angles("fr5", 6), 0.5, (3,), None),
    "few_fr3": ("fr3", robot_angles("fr3", 7), 0.5, (), [1, 0, 1, 1, 0, 1, 0, 1]),
    "zero_fr5": ("fr5", robot_angles("fr5", 8), 0.5, (), [0] * 7),
}
SUCCESS_ONLY = {"few_fr3", "zero_fr5"}  # < 6 gated points: a DLT null space of dim > 1


def _ransac_inputs(name):
    robot, angles, noise, outliers, w = RANSAC_CASES[name]
    obj, xy, _, _ = scene(robot, angles, seed=len(name), noise_px=noise, outliers=outliers)
    weights = np.ones(len(obj), np.float32) if w is None else np.asarray(w, np.float32)
    return obj, xy, weights


@pytest.fixture(scope="module")
def ransac_refs():
    """The reference's solve_pnp_ransac on every case (16 hypotheses from
    PRNGKey(name's length)) and the draws it made."""
    refs = {}
    for name in RANSAC_CASES:
        obj, xy, w = _ransac_inputs(name)
        key = jax.random.PRNGKey(len(name))
        out = jpnp.solve_pnp_ransac(jnp.asarray(obj), jnp.asarray(xy), jnp.asarray(K),
                                    jnp.asarray(w), key=key, n_hypotheses=16)
        refs[name] = ({k: np.asarray(v) for k, v in out.items()},
                      jax_ransac_gumbel(key, 16, len(obj)))
    return refs


@pytest.mark.parametrize("name", sorted(RANSAC_CASES))
def test_solve_pnp_ransac_matches_jax(ransac_refs, name):
    ref, gumbel = ransac_refs[name]
    obj, xy, w = _ransac_inputs(name)
    got = tpnp.solve_pnp_ransac(_t(obj), _t(xy), _t(K), _t(w), gumbel=_t(gumbel), n_hypotheses=16)
    assert bool(got["success"]) == bool(ref["success"])
    if name in SUCCESS_ONLY:
        return
    np.testing.assert_array_equal(got["inlier_mask"].numpy(), ref["inlier_mask"])
    assert int(got["n_inliers"]) == int(ref["n_inliers"])
    assert_pose_close(got["rvec"], got["tvec"], ref["rvec"], ref["tvec"])


def test_ransac_hypotheses_match_jax():
    """Hypothesis by hypothesis on an FR3 view (the reference's draws): both
    planar roots agree everywhere, and the DLT candidate agrees wherever the
    6 sampled points are 6 distinct points. FR3's chain origins 1 and 2, and
    5 and 6, coincide at every angle (its modified-DH rows 2 and 6 have
    a = d = 0), so a sample holding both of a pair has a DLT null space of
    dimension > 1, and each package's SVD returns its own vector of it: the
    reference's DLT candidate there is arbitrary, and a RANSAC whose winner
    is such a candidate is compared on its success only."""
    obj, xy, w = _ransac_inputs("noisy_fr3")
    for pair in ((1, 2), (5, 6)):
        np.testing.assert_allclose(obj[pair[0]], obj[pair[1]], atol=1e-6)
    gumbel = jax_ransac_gumbel(jax.random.PRNGKey(3), 16, len(obj))
    degenerate = 0
    for g in gumbel:
        sel = np.zeros(len(obj), np.float32)
        sel[np.argsort(-g)[:6]] = 1.0
        args = (jnp.asarray(obj), jnp.asarray(xy), jnp.asarray(K), jnp.asarray(sel))
        targs = (_t(obj), _t(xy), _t(K), _t(sel))
        for got, want in zip(tpnp.solve_pnp_planar(*targs), jpnp.solve_pnp_planar(*args)):
            assert rotation_gap(np32(got[0]), np32(want[0])) <= 1e-4
        if len(np.unique(obj[sel > 0].round(6), axis=0)) == 6:
            assert_pose_close(*tpnp.solve_pnp_dlt(*targs), *jpnp.solve_pnp_dlt(*args))
        else:
            degenerate += 1
    assert 0 < degenerate < len(gumbel)


def test_ransac_rejects_outliers_and_gated_points(ransac_refs):
    """The planted outliers and the gated points are not inliers, and the
    poses are near the truth, in both packages."""
    for name, bad in (("outliers_fr3", (1, 5)), ("gate_fr3", (2, 6))):
        ref, _ = ransac_refs[name]
        assert not ref["inlier_mask"][list(bad)].any() and ref["n_inliers"] == 6
    assert not ransac_refs["zero_fr5"][0]["success"]


def test_solve_pnp_ransac_batches_views(ransac_refs):
    """Three cases of one robot as one (3, N) batch give each case's result."""
    names = ["exact_fr3", "noisy_fr3", "outliers_fr3"]
    obj, xy, w = (np.stack(a) for a in zip(*(_ransac_inputs(n) for n in names)))
    gumbel = np.stack([ransac_refs[n][1] for n in names])
    got = tpnp.solve_pnp_ransac(_t(obj), _t(xy), _t(K), _t(w), gumbel=_t(gumbel), n_hypotheses=16)
    for i, n in enumerate(names):
        ref = ransac_refs[n][0]
        np.testing.assert_array_equal(got["inlier_mask"][i].numpy(), ref["inlier_mask"])
        assert_pose_close(got["rvec"][i], got["tvec"][i], ref["rvec"], ref["tvec"])


def test_ransac_draws_from_a_generator():
    """Without given draws the hypotheses come from the generator: the same
    seed gives the same result."""
    obj, xy, w = _ransac_inputs("noisy_fr3")
    runs = [tpnp.solve_pnp_ransac(_t(obj), _t(xy), _t(K), _t(w), n_hypotheses=8,
                                  generator=torch.Generator().manual_seed(5)) for _ in range(2)]
    assert torch.equal(runs[0]["rvec"], runs[1]["rvec"]) and bool(runs[0]["success"])


@pytest.mark.parametrize("name", ["noisy_fr3", "planar_fr3", "noisy_fr5"])
def test_initializers_match_jax(name):
    """solve_pnp_dlt and both roots of solve_pnp_planar on all points."""
    obj, xy, w = _ransac_inputs(name)
    args = (jnp.asarray(obj), jnp.asarray(xy), jnp.asarray(K), jnp.asarray(w))
    targs = (_t(obj), _t(xy), _t(K), _t(w))
    r, t = tpnp.solve_pnp_dlt(*targs)
    if name != "planar_fr3":  # coplanar points: the DLT is degenerate
        assert_pose_close(r, t, *jpnp.solve_pnp_dlt(*args))
    for got, want in zip(tpnp.solve_pnp_planar(*targs), jpnp.solve_pnp_planar(*args)):
        assert_pose_close(*got, *want)


def test_planar_roots_differ_on_the_planar_chain():
    """On a planar chain the two planar roots are two poses (the two-fold
    ambiguity), in both packages."""
    obj, xy, w = _ransac_inputs("planar_fr3")
    (r1, _), (r2, _) = tpnp.solve_pnp_planar(_t(obj), _t(xy), _t(K), _t(w))
    assert rotation_gap(r1.numpy(), r2.numpy()) > 1e-2


@pytest.mark.parametrize("distorted", [False, True])
def test_refine_pnp_lm_matches_jax(distorted):
    obj, xy, rvec, tvec = scene("fr3", robot_angles("fr3", 9), seed=9, noise_px=0.5)
    dist = np.array([0.05, -0.01, 0.001, -0.001, 0.002], np.float32) if distorted else None
    if distorted:
        xy = np.asarray(jcam.project_points(jnp.asarray(obj), rvec, tvec, jnp.asarray(K),
                                            jnp.asarray(dist)), np.float32)
    r0, t0 = rvec + 0.05, tvec * 1.05
    w = np.ones(len(obj), np.float32)
    w[3] = 0.0
    want = jpnp.refine_pnp_lm(jnp.asarray(obj), jnp.asarray(xy), jnp.asarray(K), jnp.asarray(r0),
                              jnp.asarray(t0), dist=None if dist is None else jnp.asarray(dist),
                              weights=jnp.asarray(w), iters=12)
    got = tpnp.refine_pnp_lm(_t(obj), _t(xy), _t(K), _t(r0), _t(t0),
                             dist=None if dist is None else _t(dist), weights=_t(w), iters=12)
    assert_pose_close(got[0], got[1], want[0], want[1])
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=COST_REL, atol=1e-6)


@pytest.mark.parametrize("name", ["noisy_fr3", "planar_fr3", "exact_fr5"])
def test_solve_pnp_matches_jax(name):
    obj, xy, w = _ransac_inputs(name)
    want = jpnp.solve_pnp(jnp.asarray(obj), jnp.asarray(xy), jnp.asarray(K), jnp.asarray(w))
    got = tpnp.solve_pnp(_t(obj), _t(xy), _t(K), _t(w))
    assert_pose_close(got[0], got[1], want[0], want[1])
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=COST_REL, atol=1e-6)


def test_lm_jacobian_is_the_analytic_one():
    """`batched_jacobian` (forward mode, the batch explicit) against central
    differences in f64, on a batch of two and unbatched."""
    obj, xy, rvec, tvec = scene("fr5", robot_angles("fr5", 10), seed=10)
    o, i, k = (torch.tensor(a, dtype=torch.float64) for a in (obj, xy, K))
    w = torch.ones(len(obj), dtype=torch.float64)
    p = torch.from_numpy(np.stack([np.r_[rvec, tvec], np.r_[rvec + 0.1, tvec]])).double()

    def res(q):
        return tpnp._reproj_residuals(q, o, i, k, None, w)

    J, r = tpnp.batched_jacobian(res, p)
    assert J.shape == (2, 2 * len(obj), 6) and torch.equal(r, res(p))
    eps = 1e-6
    fd = torch.stack([(res(p + eps * e) - res(p - eps * e)) / (2 * eps)
                      for e in torch.eye(6, dtype=torch.float64)], -1)
    np.testing.assert_allclose(J.numpy(), fd.numpy(), rtol=1e-5, atol=1e-4)
    J1, _ = tpnp.batched_jacobian(res, p[0])
    torch.testing.assert_close(J1, J[0])
    # f32 stays f32, though the residuals combine 0-dim tensors with Python floats.
    o, i, k, w = (x.float() for x in (o, i, k, w))
    assert tpnp.batched_jacobian(res, p.float())[0].dtype == torch.float32


def test_rotation_functions_match_jax():
    rng = np.random.default_rng(21)
    q = rng.normal(size=(6, 4)).astype(np.float32)
    q2 = rng.normal(size=(6, 4)).astype(np.float32)
    np.testing.assert_allclose(np32(trot.quat_to_matrix(_t(q))),
                               np32(jax.vmap(jrot.quat_to_matrix)(jnp.asarray(q))), atol=2e-5)
    np.testing.assert_allclose(
        np32(trot.quat_angular_distance(_t(q), _t(q2))),
        np32(jax.vmap(jrot.quat_angular_distance)(jnp.asarray(q), jnp.asarray(q2))), atol=2e-5)
    w = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    near = q[0] + 0.05 * rng.normal(size=(6, 4)).astype(np.float32)  # a cluster: a clear mean
    np.testing.assert_allclose(np32(trot.average_quaternion(_t(near), _t(w))),
                               np32(jrot.average_quaternion(jnp.asarray(near), jnp.asarray(w))),
                               atol=2e-5)
    M = rng.normal(size=(5, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(trot.det3(_t(M)).numpy(), np.linalg.det(M), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_kabsch_matches_jax(weighted):
    rng = np.random.default_rng(22)
    src = rng.normal(size=(9, 3)).astype(np.float32)
    R = np.asarray(jrot.rodrigues_to_matrix(jnp.asarray([0.4, -1.1, 2.0])), np.float32)
    dst = src @ R.T + np.array([0.1, -0.3, 1.5], np.float32) + 0.01 * rng.normal(size=(9, 3))
    dst = dst.astype(np.float32)
    w = rng.uniform(0, 1, 9).astype(np.float32) if weighted else None
    want = jrot.kabsch(jnp.asarray(src), jnp.asarray(dst), None if w is None else jnp.asarray(w))
    got = trot.kabsch(_t(src), _t(dst), None if w is None else _t(w))
    for g, e in zip(got, want):
        np.testing.assert_allclose(np32(g), np32(e), atol=1e-4)
    assert abs(float(torch.linalg.det(got[0])) - 1.0) < 1e-5  # proper, not a reflection


def test_camera_functions_match_jax():
    rng = np.random.default_rng(23)
    pts = np.c_[rng.uniform(-0.5, 0.5, (10, 2)), rng.uniform(1.0, 3.0, 10)].astype(np.float32)
    dist = np.array([-0.1, 0.02, 0.001, -0.002, 0.003], np.float32)
    for d in (None, dist):
        np.testing.assert_allclose(
            np32(tcam.project_camera_frame(_t(pts), _t(K), None if d is None else _t(d))),
            np32(jcam.project_camera_frame(jnp.asarray(pts), jnp.asarray(K),
                                           None if d is None else jnp.asarray(d))), atol=2e-3)
    pix = np32(jcam.project_camera_frame(jnp.asarray(pts), jnp.asarray(K), jnp.asarray(dist)))
    got = tcam.undistort_points(_t(pix), _t(K), _t(dist))
    np.testing.assert_allclose(
        np32(got), np32(jcam.undistort_points(jnp.asarray(pix), jnp.asarray(K), jnp.asarray(dist))),
        atol=1e-3)
    # 8 fixed-point steps invert the mild distortion to the ideal pixels.
    ideal = np32(jcam.project_camera_frame(jnp.asarray(pts), jnp.asarray(K)))
    np.testing.assert_allclose(np32(got), ideal, atol=0.05)


# ------------------------------------------------------------ the SVD kernel

# The tick's shapes: the DLT (2N, 12), the plane fit (N, 3), the homography
# (2N, 9), the rotation projection (3, 3), N = 8 (fr3) and 7; the
# geometric3d head's triangulation on cli eval's 8 views, (2V, 4) with V = 8
# (W = 16 lanes a matrix for 4 columns); and the kernel's largest.
SVD_SHAPES = [(16, 12), (14, 12), (8, 3), (7, 3), (16, 9), (14, 9), (3, 3), (16, 4), (32, 16)]


def _svd_inputs(m: int, n: int, seed: int) -> np.ndarray:
    """64 matrices: random, with one and two columns spanned by the others
    (rank-deficient), one near-rotation (3 x 3), zero rows (a gated point),
    and all zeros."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(64, m, n)).astype(np.float32)
    a[1, :, -1] = a[1, :, :-1] @ rng.normal(size=n - 1) if n > 1 else 0.0
    if n > 2:
        a[2, :, -2:] = a[2, :, :-2] @ rng.normal(size=(n - 2, 2))
    a[3, : m // 2] = 0.0
    a[4] = 0.0
    if (m, n) == (3, 3):
        a[5] = trot.rodrigues_to_matrix(torch.tensor([0.3, 1.0, -0.2])).numpy() * 2.5
        a[6] = np.outer(rng.normal(size=3), rng.normal(size=3))  # rank 1
    return a


def fr3_dlt_systems(monkeypatch) -> np.ndarray:
    """The (16, 12) DLT systems RANSAC builds for fr3 (the port's FK and
    projection, no jax): one for each choice of 6 of the 8 keypoints, the
    others weighted 0. FR3's coincident keypoints (1 = 2 and 5 = 6) give most
    of them a null space of dimension > 1."""
    robot = trob.get_robot("fr3")
    angles = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, 7).astype(np.float32))
    obj = robot.keypoints_from_fk(trob.forward_kinematics(robot, angles))
    xy = tcam.project_points(obj, _t([0.3, -1.2, 0.5]), _t([0.1, -0.05, 2.2]), _t(K))
    picks = _t([[i in c for i in range(8)] for c in itertools.combinations(range(8), 6)])
    systems = []

    def record(a, compute_u=False):
        systems.append(a.clone())
        return small_svd.small_svd(a, compute_u)

    monkeypatch.setattr(tpnp, "small_svd", record)
    tpnp.solve_pnp_dlt(obj, xy, _t(K), picks)
    return systems[0].numpy()  # the DLT's; the rotation projection's follows


# The kernel's constants, read from its source: the most sweeps and the
# noise stop's factor.
_KERNEL_SOURCE = (Path(small_svd.__file__).parents[1] / "csrc" / "small_svd.cu").read_text()
KERNEL_SWEEPS = int(re.search(r"constexpr int kSweeps = (\d+);", _KERNEL_SOURCE).group(1))
KERNEL_NOISE = float(re.search(r"constexpr float kNoise = ([\d.]+)f;", _KERNEL_SOURCE).group(1))


def jacobi_schedule(n: int) -> list:
    """The kernel's round-robin order for n columns: n2 - 1 rounds (n2 = n
    rounded up to even), each the list of its (first, second) column pairs.
    The columns sit in n2 slots; slot i pairs with slot n2 - 1 - i, then the
    columns in slots 1 .. n2 - 1 turn one slot. An odd n's phantom column
    sits in slot 0, and its pair is dropped."""
    n2 = n + n % 2
    slots = [n, *range(n)] if n % 2 else list(range(n))
    rounds = []
    for _ in range(n2 - 1):
        rounds.append([(slots[i], slots[n2 - 1 - i]) for i in range(n % 2, n2 // 2)])
        slots = [slots[0], *slots[2:], slots[1]]
    return rounds


def jacobi_svd_model(a: np.ndarray, sweeps: int = KERNEL_SWEEPS):
    """The kernel's algorithm in numpy f32, batched over matrices: the same
    power-of-two scaling, rounds in the same order, the columns' squared
    norms exact at each sweep's start and carried through its rotations, the
    same rotations (in exact f32 where the kernel takes the special-function
    unit's rsqrt and a Newton step), the same noise stop, ranking and U for
    3 x 3 input -> (U or None, S, Vh, the sweeps each matrix ran, the last
    without a rotation included)."""
    a = a.astype(np.float32)
    B, m, n = a.shape
    one, two = np.float32(1), np.float32(2)
    amax = np.fmax.reduce(np.abs(a).reshape(B, -1), axis=1)  # NaN ignored, as fmaxf
    e = np.where((amax > 0) & (amax <= np.finfo(np.float32).max), np.frexp(amax)[1], 0)
    a = np.ldexp(a, -e[:, None, None]).astype(np.float32)  # the largest entry in [0.5, 1)
    v = np.broadcast_to(np.eye(n, dtype=np.float32), (B, n, n)).copy()
    eps = np.float32(np.finfo(np.float32).eps)
    noise2 = np.float32(KERNEL_NOISE) ** 2 * eps * eps * (a * a).sum((1, 2))
    live, ran = np.ones(B, bool), np.zeros(B, int)
    schedule = jacobi_schedule(n)
    for _ in range(sweeps):
        rotated = np.zeros(B, bool)
        norm2 = (a * a).sum(1)
        for pairs in schedule:
            if not pairs:
                continue
            P, Q = [p for p, _ in pairs], [q for _, q in pairs]
            al, be = norm2[:, P], norm2[:, Q]
            ga = (a[:, :, P] * a[:, :, Q]).sum(1)
            # Rotate only where the smaller column would move by more than
            # KERNEL_NOISE eps |A|_F.
            rot = live[:, None] & (ga * ga > noise2[:, None] * np.maximum(al, be))
            d, g = be - al, two * ga
            with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
                inv_h = one / np.sqrt(d * d + g * g)
                cos2, sin2 = np.abs(d) * inv_h, np.copysign(one, d) * g * inv_h
                k = one / np.sqrt((one + cos2) ** 2 + sin2 * sin2)
            c = np.where(rot, (one + cos2) * k, one)
            s = np.where(rot, sin2 * k, np.float32(0))
            cs2 = two * c * s * ga
            norm2[:, P] = np.maximum(c * c * al + s * s * be - cs2, 0)
            norm2[:, Q] = np.maximum(s * s * al + c * c * be + cs2, 0)
            c, s = c[:, None], s[:, None]
            for x in (a, v):
                xp, xq = x[:, :, P], x[:, :, Q]
                x[:, :, P], x[:, :, Q] = c * xp - s * xq, s * xp + c * xq
            rotated |= rot.any(1)
        ran += live
        live &= rotated
    sigma = np.sqrt((a * a).sum(1))  # of the scaled A
    order = np.argsort(-np.where(np.isnan(sigma), np.inf, sigma), axis=1, kind="stable")
    S = np.take_along_axis(sigma, order, 1)[:, : min(m, n)]
    Vh = np.take_along_axis(v, order[:, None, :], 2).transpose(0, 2, 1)
    if (m, n) != (3, 3):
        return None, np.ldexp(S, e[:, None]), Vh, ran
    cols = np.take_along_axis(a, order[:, None, :], 2)  # (B, 3, 3), columns in rank order
    U = np.zeros((B, 3, 3), np.float32)
    for b in range(B):
        s, c = S[b], cols[b].T
        u0 = c[0] / s[0] if s[0] > 0 else np.eye(3, dtype=np.float32)[0]
        if s[1] > 1e-6 * s[0]:
            u1 = c[1] / s[1]
        else:
            i = int(np.argmin(np.abs(u0)))
            u1 = np.eye(3, dtype=np.float32)[i] - u0[i] * u0
            u1 /= np.linalg.norm(u1)
        u2 = np.cross(u0, u1)
        if s[2] > 1e-6 * s[0] and u2 @ c[2] < 0:
            u2 = -u2
        U[b] = np.stack([u0, u1, u2], 1)
    return U, np.ldexp(S, e[:, None]), Vh, ran


def assert_svd_close(a, U, S, Vh, want_U, want_S, want_Vh):
    """The sign-free comparisons of the module docstring (want_U, want_S,
    want_Vh: one reference SVD, whose signs go together)."""
    a, S, Vh, want_S, want_Vh = (np.asarray(x, np.float64) for x in (a, S, Vh, want_S, want_Vh))
    scale = np.maximum(want_S[:, :1], 1e-30)
    np.testing.assert_allclose(S / scale, want_S / scale, atol=2e-5)
    n = Vh.shape[-1]
    np.testing.assert_allclose(Vh @ Vh.transpose(0, 2, 1), np.broadcast_to(np.eye(n), Vh.shape),
                               atol=1e-5)
    av = a @ Vh.transpose(0, 2, 1)  # columns: u_k s_k
    gram = av.transpose(0, 2, 1) @ av
    full = np.zeros_like(gram)
    k = S.shape[-1]
    full[:, np.arange(k), np.arange(k)] = S ** 2
    np.testing.assert_allclose(gram / scale[..., None] ** 2, full / scale[..., None] ** 2, atol=4e-5)
    if n <= a.shape[-2]:  # the last singular value simple: the null vector agrees
        simple = want_S[:, -1] < want_S[:, -2] - 1e-3 * scale[:, 0]
        dots = np.abs((Vh[:, -1] * want_Vh[:, -1]).sum(-1))
        assert (dots[simple] >= 1 - 1e-4).all(), dots[simple].min()
    if U is not None:
        U = np.asarray(U, np.float64)
        np.testing.assert_allclose(U @ (S[..., None] * Vh), a, atol=1e-5 * scale.max())
        np.testing.assert_allclose(U @ U.transpose(0, 2, 1), np.broadcast_to(np.eye(3), U.shape),
                                   atol=1e-5)
        rot = lambda u, vh: u @ (np.stack([np.ones(len(u)), np.ones(len(u)),  # noqa: E731
                                           np.linalg.det(u @ vh)], -1)[..., None] * vh)
        want_U = np.asarray(want_U, np.float64)
        unique = want_S[:, 1] > 1e-6 * scale[:, 0]  # rank <= 1: no unique nearest rotation
        np.testing.assert_allclose(rot(U, Vh)[unique], rot(want_U, want_Vh)[unique], atol=1e-5)


def test_small_svd_cpu_is_torch_svd():
    a = torch.from_numpy(_svd_inputs(16, 12, 0))
    U, S, Vh = small_svd.small_svd(a)
    want = torch.linalg.svd(a, full_matrices=True)
    assert U is None and torch.equal(S, want.S) and torch.equal(Vh, want.Vh)
    U3, _, _ = small_svd.small_svd(a[:, :3, :3], compute_u=True)
    assert torch.equal(U3, torch.linalg.svd(a[:, :3, :3]).U)


@pytest.mark.parametrize("shape", SVD_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_jacobi_model_matches_lapack(shape):
    """The kernel's algorithm (its numpy model, KERNEL_SWEEPS sweeps) against
    LAPACK in f64 at every tick shape, rank-deficient input included."""
    a = _svd_inputs(*shape, seed=sum(shape))
    U, S, Vh, _ = jacobi_svd_model(a)
    assert_svd_close(a, U, S, Vh, *np.linalg.svd(a.astype(np.float64), full_matrices=True))


@pytest.mark.parametrize("n", range(1, 17))
def test_jacobi_schedule_meets_every_pair_once(n):
    """A sweep: n2 - 1 rounds of n // 2 disjoint pairs, every pair of
    columns once."""
    rounds = jacobi_schedule(n)
    assert len(rounds) == n + n % 2 - 1
    for pairs in rounds:
        assert len(pairs) == n // 2
        cols = [c for pair in pairs for c in pair]
        assert len(set(cols)) == len(cols) and max(cols, default=0) < n
    met = sorted(tuple(sorted(pair)) for pairs in rounds for pair in pairs)
    assert met == list(itertools.combinations(range(n), 2))


@pytest.mark.parametrize("case", [*SVD_SHAPES, "fr3_dlt"],
                         ids=lambda s: s if isinstance(s, str) else f"{s[0]}x{s[1]}")
def test_jacobi_model_stops_on_null_space_noise(case, monkeypatch):
    """Null spaces of dimension 1 and > 1 (`_svd_inputs`' matrices 1 and 2;
    fr3's DLT systems, coincident keypoints among the 6 picked) stop within
    8 sweeps, as simple ones do, and still match LAPACK."""
    if case == "fr3_dlt":
        a = fr3_dlt_systems(monkeypatch)
        sv = np.linalg.svd(a.astype(np.float64), compute_uv=False)
        assert (sv[:, -2] < 1e-6 * sv[:, 0]).sum() >= len(a) // 2  # dimension > 1
    else:
        a = _svd_inputs(*case, seed=sum(case))[1:3]
    U, S, Vh, ran = jacobi_svd_model(a)
    assert ran.max() <= 8, ran
    assert_svd_close(a, U, S, Vh, *np.linalg.svd(a.astype(np.float64), full_matrices=True))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SVD kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [*SVD_SHAPES, "fr3_dlt"],
                         ids=lambda s: s if isinstance(s, str) else f"{s[0]}x{s[1]}")
def test_small_svd_kernel_matches_torch_on_card(cuda_device, shape, monkeypatch):
    """The kernel against torch.linalg.svd on the card (f32), one launch a
    call; two calls bit-identical; fr3's DLT systems included."""
    a = fr3_dlt_systems(monkeypatch) if shape == "fr3_dlt" else _svd_inputs(*shape, seed=sum(shape))
    a = torch.from_numpy(a).to(cuda_device)
    before = small_svd.launches
    U, S, Vh = small_svd.small_svd_cuda(a, compute_u=shape == (3, 3))
    U2, S2, Vh2 = small_svd.small_svd_cuda(a, compute_u=shape == (3, 3))
    torch.cuda.synchronize()
    assert small_svd.launches == before + 2
    assert torch.equal(S, S2) and torch.equal(Vh, Vh2) and (U is None or torch.equal(U, U2))
    want = torch.linalg.svd(a, full_matrices=True)
    cpu = lambda x: None if x is None else x.cpu().numpy()  # noqa: E731
    assert_svd_close(a.cpu().numpy(), cpu(U), cpu(S), cpu(Vh), cpu(want.U), cpu(want.S),
                     cpu(want.Vh))


@pytest.mark.cuda
def test_small_svd_kernel_refuses_other_shapes(cuda_device):
    for shape, kwargs in (((4, 33, 4), {}), ((4, 5, 17), {}), ((4, 4, 3), {"compute_u": True})):
        with pytest.raises(ValueError):
            small_svd.small_svd_cuda(torch.zeros(shape, device=cuda_device), **kwargs)
    with pytest.raises(ValueError):
        small_svd.small_svd_cuda(torch.zeros(2, 3, 3, dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError):
        small_svd.small_svd(torch.zeros(2, 40, 3, device=cuda_device))  # no fallback
