"""Geometry and the synthetic rig: the torch port vs the JAX reference, f32 on the CPU.

Robot tables must be equal. FK, rotations, projection and triangulation run
the same f32 operations in another order (torch's cos/sin and matmuls
against XLA's): FK points within 2e-6 m, rotation matrices 2e-6, pixels
2e-4 px at focal lengths of ~100 px, triangulated points 1e-4 m. The
synthetic batch is rendered from the reference's own `jax.random` draws:
keypoints as above, images and heatmaps within 2e-5 (blob values are
exp(-d2/(2 sigma^2)) with |d value/d px| <= 0.61/sigma, times the keypoint
gap, plus the kernel's reciprocal-multiply against the jnp division).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvropose_tpu.data import synthetic as jsyn
from mvropose_tpu.geometry import camera as jcam
from mvropose_tpu.geometry import robots as jrob
from mvropose_tpu.geometry import rotations as jrot
from mvropose_tpu.geometry import triangulation as jtri

from mvropose_torch.data import synthetic as tsyn
from mvropose_torch.geometry import camera as tcam
from mvropose_torch.geometry import robots as trob
from mvropose_torch.geometry import rotations as trot
from mvropose_torch.geometry import triangulation as ttri
from torch_parity import np32

ROBOTS = ["fr3", "fr5", "meca500", "dream_panda"]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("name", ROBOTS)
def test_robot_tables_equal_the_reference(name):
    j, t = jrob.get_robot(name), trob.get_robot(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.n_joints, t.n_keypoints) == (j.n_joints, j.n_keypoints)
    for view in [None, "unknown", *j.view_base_rotations_zyx_deg]:
        np.testing.assert_allclose(t.base_rotation(view), j.base_rotation(view), atol=2e-6)


@pytest.mark.parametrize("name", ROBOTS)
def test_fk_with_base_rotation_matches_jax(name):
    j, t = jrob.get_robot(name), trob.get_robot(name)
    rng = np.random.default_rng(11)
    scale = 90.0 if j.angle_unit == "deg" else np.pi / 2
    angles = rng.uniform(-scale, scale, size=(5, j.n_joints)).astype(np.float32)
    base = np.asarray(jrot.euler_zyx_deg_to_matrix(jnp.asarray([30.0, -20.0, 75.0])))
    for b in (None, base):
        want = j.keypoints_from_fk(jrob.forward_kinematics_batch(j, jnp.asarray(angles), b))
        got = t.keypoints_from_fk(trob.forward_kinematics_batch(
            t, _t(angles), None if b is None else _t(b)))
        assert got.shape == (5, j.n_keypoints, 3)
        np.testing.assert_allclose(np32(got), np32(want), atol=2e-6)


def test_rotations_match_jax():
    rng = np.random.default_rng(12)
    rvecs = rng.normal(size=(16, 3)).astype(np.float32)
    rvecs[0] = 0.0  # the small-angle branch
    rvecs[1] = [np.pi - 1e-3, 0.0, 0.0]  # near pi: the quaternion route
    R_j = jax.vmap(jrot.rodrigues_to_matrix)(jnp.asarray(rvecs))
    R_t = trot.rodrigues_to_matrix(_t(rvecs))
    np.testing.assert_allclose(np32(R_t), np32(R_j), atol=2e-6)
    back_j = jax.vmap(jrot.matrix_to_rodrigues)(R_j)
    back_t = trot.matrix_to_rodrigues(R_t)
    np.testing.assert_allclose(np32(back_t), np32(back_j), atol=2e-5)
    eul = rng.uniform(-180, 180, size=(8, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np32(trot.euler_zyx_deg_to_matrix(_t(eul))),
        np32(jax.vmap(jrot.euler_zyx_deg_to_matrix)(jnp.asarray(eul))), atol=2e-6)


@pytest.mark.parametrize("dist", [None, [0.1, -0.05, 0.001, -0.002, 0.01]])
def test_project_points_matches_jax(dist):
    rng = np.random.default_rng(13)
    pts = rng.uniform(-0.5, 0.5, size=(9, 3)).astype(np.float32)
    rvec, tvec = np.float32([0.3, -0.2, 0.1]), np.float32([0.05, -0.1, 2.0])
    K = np.float32([[110.0, 0, 64], [0, 105.0, 60], [0, 0, 1]])
    want = jcam.project_points(jnp.asarray(pts), rvec, tvec, jnp.asarray(K),
                               None if dist is None else jnp.asarray(dist, jnp.float32))
    got = tcam.project_points(_t(pts), _t(rvec), _t(tvec), _t(K),
                              None if dist is None else _t(dist))
    np.testing.assert_allclose(np32(got), np32(want), atol=2e-4)


def test_triangulation_matches_jax_and_recovers_points():
    rig = jsyn.make_rig(n_views=4, image_hw=(128, 128))
    K, rv, tv = (np.asarray(a) for a in (rig.K, rig.rvecs, rig.tvecs))
    P_j = jax.vmap(lambda r, t: jtri.projection_matrix(r, t, jnp.asarray(K)))(rv, tv)
    P_t = ttri.projection_matrix(_t(rv), _t(tv), _t(K))
    np.testing.assert_allclose(np32(P_t), np32(P_j), rtol=1e-5, atol=1e-4)
    pts = np.random.default_rng(14).uniform(-0.4, 0.4, size=(2, 6, 3)).astype(np.float32)
    px = np.stack([np.asarray(jax.vmap(lambda p: jcam.project_points(p, r, t, jnp.asarray(K)))(
        jnp.asarray(pts))) for r, t in zip(rv, tv)], axis=1)  # (B, V, J, 2)
    w = np.ones(px.shape[:-1], np.float32)
    w[0, 2] = 0.0  # a dropped view
    px[0, 2] += 40.0  # ... whose pixels are garbage
    want = jax.vmap(lambda p, ww: jtri.triangulate_keypoints(p, P_j, ww))(jnp.asarray(px),
                                                                          jnp.asarray(w))
    got = ttri.triangulate_keypoints(_t(px), P_t, _t(w))
    np.testing.assert_allclose(np32(got), np32(want), atol=1e-4)
    np.testing.assert_allclose(np32(got), pts, atol=1e-4)


def test_rig_and_palette_match_jax():
    for n in (1, 3, 4):
        j, t = jsyn.make_rig(n_views=n, image_hw=(96, 128)), tsyn.make_rig(n_views=n,
                                                                           image_hw=(96, 128))
        np.testing.assert_array_equal(t.K, j.K)
        np.testing.assert_allclose(t.rvecs, j.rvecs, atol=2e-6)
        np.testing.assert_allclose(t.tvecs, j.tvecs, atol=1e-6)
    np.testing.assert_array_equal(tsyn.joint_palette(7), jsyn.joint_palette(7))


@pytest.mark.parametrize("name", ["fr5", "fr3"])
def test_synthetic_batch_from_injected_jax_draws(name):
    """The reference's batch and the port's render of the reference's own
    draws (angles and noise, split as synthesize_multiview_batch splits its
    key) agree; the port's draws come from a torch.Generator instead."""
    j_robot, t_robot = jrob.get_robot(name), trob.get_robot(name)
    B, V, img, hm = 2, 3, (64, 64), (32, 32)
    j_rig = jsyn.make_rig(n_views=V, image_hw=img)
    key = jax.random.PRNGKey(7)
    want = jsyn.synthesize_multiview_batch(j_robot, jsyn.rig_tuple(j_rig), key, B,
                                           image_hw=img, heatmap_hw=hm)
    k_ang, k_noise = jax.random.split(key)
    half = 90.0 if j_robot.angle_unit == "deg" else jnp.pi / 2.0
    angles = jax.random.uniform(k_ang, (B, j_robot.n_joints), minval=-0.6 * half,
                                maxval=0.6 * half).astype(jnp.float32)
    noise = 0.05 * jax.random.normal(k_noise, (B, V, *img, 3))
    got = tsyn.render_multiview_batch(t_robot, tsyn.rig_tuple(tsyn.make_rig(n_views=V,
                                                                            image_hw=img)),
                                      _t(angles), _t(noise), image_hw=img, heatmap_hw=hm)
    np.testing.assert_array_equal(np32(got["angles"]), np32(want["angles"]))
    np.testing.assert_allclose(np32(got["keypoints_3d"]), np32(want["keypoints_3d"]), atol=2e-6)
    np.testing.assert_allclose(np32(got["keypoints_2d"]), np32(want["keypoints_2d"]), atol=2e-4)
    for k in ("images", "heatmaps"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(np32(got[k]), np32(want[k]), atol=2e-5)
    np.testing.assert_array_equal(got["view_ids"].numpy(), np.asarray(want["view_ids"]))
    np.testing.assert_array_equal(got["view_mask"].numpy(), np.asarray(want["view_mask"]))
    drawn = tsyn.synthesize_multiview_batch(t_robot, tsyn.rig_tuple(tsyn.make_rig(V, img)),
                                            torch.Generator().manual_seed(0), B, img, hm)
    assert {k: tuple(v.shape) for k, v in drawn.items()} == {
        k: tuple(got[k].shape) for k in drawn}
    lim = 0.6 * (90.0 if t_robot.angle_unit == "deg" else np.pi / 2)
    assert float(drawn["angles"].abs().max()) <= lim
