"""The joint (pose, angles) refinement: the port vs the JAX reference, f32 on
the CPU, and the port's two deliberate divergences from it, each shown on the
reference with the same planted input.

The draws are the reference's own (`jax.random`: the starts' normals and the
re-solve's Gumbel draws, split as `refine_rig_pose_angles` splits them).
Tolerances: success equal; rotations within 1e-3 rad, translations within
1e-3 of |t|; the refined angles within 1e-3 of the angle unit's radian
(5.7e-2 deg) and the cost within 1e-3 relative (40 LM iterations of f32
solves of a (6V + A)-square system in another order; measured ~7e-4 rad
on the weakest-determined angle).

The whole `recover_pose_batch` runs on fr5 (degrees): FR3's chain has
coincident keypoints (origins 1 and 2, 5 and 6), so a RANSAC hypothesis
that samples both of a pair has fewer than 6 distinct points and a DLT
null space of dimension > 1, from which the two packages' SVDs return
different vectors (`test_torch_pnp.py::test_ransac_hypotheses_match_jax`).
On FR3 (radians) the refinement itself is compared from the reference's own
RANSAC poses.
"""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvropose_tpu import pose as jpose
from mvropose_tpu.geometry import robots as jrob
from mvropose_tpu.pose import refine as jrefine

from mvropose_torch import pose as tpose
from mvropose_torch.geometry import robots as trob
from mvropose_torch.pose.refine import refine_rig_pose_angles
from torch_parity import (
    assert_pose_close,
    jax_refine_draws,
    jax_rig_gumbel,
    pose_scene,
)

COST_REL = 1e-3


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _angle_tol(robot: str) -> float:
    return float(np.rad2deg(1e-3)) if jrob.get_robot(robot).angle_unit == "deg" else 1e-3


def _planted(scene: dict) -> dict:
    """View 1 keeps 2 confident keypoints: too few for a pose."""
    heat = scene["heatmaps"].copy()
    heat[1, 2:] -= 10.0  # peaks at sigmoid(-5): below the 0.6 gate
    return {**scene, "heatmaps": heat}


@pytest.fixture(scope="module")
def batch_refs():
    """The reference's recover_pose_batch with refine on (fr5, 2 views,
    PRNGKey(5)), on a rig and on the same rig with view 1 planted."""
    spec, key = jrob.get_robot("fr5"), jax.random.PRNGKey(5)
    scene = pose_scene("fr5", 2, seed=50)
    refs = {}
    for name, s in (("rig", scene), ("planted", _planted(scene))):
        out = jpose.recover_pose_batch(
            jnp.asarray(s["heatmaps"]), jnp.asarray(s["pred_angles"]), jnp.asarray(s["bases"]),
            jnp.asarray(s["Ks"]), spec, s["image_hw"], key=key, refine=True)
        refs[name] = (s, {k: np.asarray(v) for k, v in out.items()})
    starts, regumbel = jax_refine_draws(key, 2, 7, 6)
    return refs, tpose.PoseDraws(_t(jax_rig_gumbel(key, 2, 16, 7)), _t(starts), _t(regumbel))


def _port_batch(s: dict, draws) -> dict:
    return tpose.recover_pose_batch(_t(s["heatmaps"]), _t(s["pred_angles"]), _t(s["bases"]),
                                    _t(s["Ks"]), trob.get_robot("fr5"), s["image_hw"],
                                    draws=draws, refine=True)


def test_recover_pose_batch_refine_matches_jax(batch_refs):
    refs, draws = batch_refs
    s, ref = refs["rig"]
    got = _port_batch(s, draws)
    np.testing.assert_array_equal(got["success"].numpy(), ref["success"])
    assert ref["success"].all()
    assert_pose_close(got["rvec"], got["tvec"], ref["rvec"], ref["tvec"])
    np.testing.assert_allclose(got["refined_angles"].numpy(), ref["refined_angles"],
                               atol=_angle_tol("fr5"))


def test_refined_success_needs_four_confident_keypoints(batch_refs):
    """Divergence (the reference's pose/__init__.py:200): with refine on, the
    reference reports success for a view with any confident keypoint, so
    view 1, with 2, succeeds there and its fallback would be suppressed;
    the port holds it to the reference's own gate, >= 4 confident keypoints
    (or a RANSAC success). View 0 agrees."""
    refs, draws = batch_refs
    s, ref = refs["planted"]
    got = _port_batch(s, draws)
    conf = got["confidence"].numpy()
    assert ((conf >= 0.6).sum(-1) == [7, 2]).all()
    assert ref["success"].tolist() == [True, True]  # the reference's fault
    assert got["success"].tolist() == [True, False]
    assert_pose_close(got["rvec"][0], got["tvec"][0], ref["rvec"][0], ref["tvec"][0])


def _direct_inputs():
    """fr3 (radians), two views: the reference's RANSAC poses as the start."""
    s = pose_scene("fr3", 2, seed=50)
    key = jax.random.PRNGKey(6)
    rig = jpose.solve_rig_pnp(jnp.asarray(s["xy"]), jnp.asarray(s["conf"]),
                              jnp.asarray(s["pred_angles"]), jnp.asarray(s["bases"]),
                              jnp.asarray(s["Ks"]), jrob.get_robot("fr3"), key=key)
    args = [s["xy"], s["conf"], s["pred_angles"], np.asarray(rig["rvec"]),
            np.asarray(rig["tvec"]), s["bases"], s["Ks"]]
    return args, key


@pytest.fixture(scope="module")
def direct_ref():
    args, key = _direct_inputs()
    out = jrefine.refine_rig_pose_angles(*(jnp.asarray(a) for a in args), jrob.get_robot("fr3"),
                                         key)
    return args, key, {k: np.asarray(v) for k, v in out.items()}


def _port_direct(args, starts, regumbel) -> dict:
    return refine_rig_pose_angles(*(_t(a) for a in args), trob.get_robot("fr3"),
                                  starts=_t(starts), regumbel=_t(regumbel))


def test_refine_rig_pose_angles_matches_jax(direct_ref):
    args, key, ref = direct_ref
    got = _port_direct(args, *jax_refine_draws(key, 2, 8, 7))
    assert_pose_close(got["rvec"], got["tvec"], ref["rvec"], ref["tvec"])
    np.testing.assert_allclose(got["angles"].numpy(), ref["angles"], atol=_angle_tol("fr3"))
    np.testing.assert_allclose(float(got["cost"]), float(ref["cost"]), rtol=COST_REL)


def test_refine_batches_rigs(direct_ref):
    """Two copies of the rig as a (2, ...) batch give the single rig's result."""
    args, key, _ = direct_ref
    starts, regumbel = jax_refine_draws(key, 2, 8, 7)
    one = _port_direct(args, starts, regumbel)
    two = refine_rig_pose_angles(*(_t(np.stack([a, a])) for a in args), trob.get_robot("fr3"),
                                 starts=_t(np.stack([starts, starts])),
                                 regumbel=_t(np.stack([regumbel, regumbel])))
    for k in ("rvec", "tvec", "angles", "cost"):
        torch.testing.assert_close(two[k][1], one[k], rtol=1e-5, atol=1e-5)


def test_nan_restart_cost_never_wins(direct_ref, monkeypatch):
    """Divergence (the reference's pose/refine.py:131): a start that goes NaN
    (planted: start 31's perturbation) wins the reference's argmin and its
    NaN pose is returned, since `take` compares with NaN; the port counts a
    NaN cost as +inf, so it returns the fit of the other starts, the
    reference's own fit without the planted start."""
    args, key, ref = direct_ref
    starts, regumbel = jax_refine_draws(key, 2, 8, 7)
    planted = starts.copy()
    planted[31] = np.nan

    def normal(k, shape, dtype=jnp.float32):
        assert shape == planted.shape
        return jnp.asarray(planted, dtype)

    monkeypatch.setattr(jax.random, "normal", normal)
    # A new function object with the reference's code: jit traces it afresh
    # (the decorated one's trace, with the real draws, is cached).
    f = jrefine.refine_rig_pose_angles.__wrapped__
    g = types.FunctionType(f.__code__, f.__globals__, f.__name__, f.__defaults__, f.__closure__)
    g.__kwdefaults__ = f.__kwdefaults__
    fresh = jax.jit(g, static_argnames=("robot", "n_starts", "iters", "polish_iters"))
    nan_ref = fresh(*(jnp.asarray(a) for a in args), jrob.get_robot("fr3"), key)
    assert np.isnan(np.asarray(nan_ref["rvec"])).all()  # the reference's fault
    got = _port_direct(args, planted, regumbel)
    assert all(bool(torch.isfinite(v).all()) for v in got.values())
    assert_pose_close(got["rvec"], got["tvec"], ref["rvec"], ref["tvec"])
    np.testing.assert_allclose(float(got["cost"]), float(ref["cost"]), rtol=COST_REL)


def test_refine_draws_from_a_generator():
    """Without given draws the starts and the re-solve come from the
    generator: the same seed, the same fit. No operation of the residuals
    or the Jacobians falls back to a per-sample loop under vmap (torch
    warns where a batching rule is missing)."""
    args, _ = _direct_inputs()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*[Bb]atching rule.*")
        runs = [refine_rig_pose_angles(*(_t(a) for a in args), trob.get_robot("fr3"), n_starts=4,
                                       iters=5, polish_iters=3,
                                       generator=torch.Generator().manual_seed(2))
                for _ in range(2)]
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k])
