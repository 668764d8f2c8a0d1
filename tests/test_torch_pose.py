"""Pose recovery on the serve path: the port vs the JAX reference, f32 on the
CPU, and the pose step on the card against the port's CPU route.

Inputs are `torch_parity.pose_scene` rigs (a numpy seed, the port's FK and
projection); the RANSAC draws are the reference's own `jax.random` draws,
split as `solve_rig_pnp` splits them. Tolerances as `test_torch_pnp.py`:
success and inlier counts equal, rotations within 1e-3 rad, translations
within 1e-3 of |t|; decoded keypoints as `test_torch_decode.py` (argmax
exact, the refine decode 4e-2 px of heatmap); triangulated points 1e-4 m,
reprojection errors 1e-3 px, the pose metrics 1e-3 deg and 1e-6 m. On the
card, on clean keypoints, the same success masks and the same pose
tolerances against the CPU route with the same draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvropose_tpu.geometry import robots as jrob
from mvropose_tpu.models import EstimatorConfig as JaxEstimatorConfig
from mvropose_tpu.models import MultiViewPoseEstimator as JaxEstimator
from mvropose_tpu.models.vit import ViTConfig as JaxViTConfig
from mvropose_tpu import pose as jpose
from mvropose_tpu.train import metrics as jmetrics

from mvropose_torch import pose as tpose
from mvropose_torch.cli.main import PoseStep, serve_step
from mvropose_torch.geometry import robots as trob
from mvropose_torch.models import EstimatorConfig, MultiViewPoseEstimator, ViTConfig
from mvropose_torch.ops import small_svd
from mvropose_torch.train import metrics as tmetrics
from mvropose_torch.utils.weights import load_jax_params
from torch_parity import (
    NOMINAL_K,
    assert_pose_close,
    export_npz,
    jax_ransac_gumbel,
    jax_rig_gumbel,
    np32,
    pose_scene,
    random_variables,
)

# name: (robot, views, decode mode)
RIG_CASES = {"fr3_v1": ("fr3", 1, "argmax"), "fr3_v4": ("fr3", 4, "argmax"),
             "fr3_v4_refine_decode": ("fr3", 4, "refine"), "fr5_v4": ("fr5", 4, "argmax")}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _scene(name):
    robot, views, _ = RIG_CASES[name]
    return pose_scene(robot, views, seed=views + len(robot))


@pytest.fixture(scope="module")
def rig_refs():
    """The reference's recover_pose_batch (refine off, PRNGKey(7)) on every
    rig case, its draws, and its solve_rig_pnp on the scenes' own keypoints
    (one confidence below the gate)."""
    refs = {}
    for name, (robot, views, mode) in RIG_CASES.items():
        s, spec = _scene(name), jrob.get_robot(robot)
        key = jax.random.PRNGKey(7)
        batch = jpose.recover_pose_batch(
            jnp.asarray(s["heatmaps"]), jnp.asarray(s["pred_angles"]), jnp.asarray(s["bases"]),
            jnp.asarray(s["Ks"]), spec, s["image_hw"], key=key, decode_mode=mode)
        conf = s["conf"].copy()
        conf[0, 1] = 0.3
        rig = jpose.solve_rig_pnp(jnp.asarray(s["xy"]), jnp.asarray(conf),
                                  jnp.asarray(s["pred_angles"]), jnp.asarray(s["bases"]),
                                  jnp.asarray(s["Ks"]), spec, key=key)
        gumbel = jax_rig_gumbel(key, views, 16, spec.n_keypoints)
        refs[name] = ({k: np.asarray(v) for k, v in batch.items()},
                      {k: np.asarray(v) for k, v in rig.items()}, conf, gumbel)
    return refs


def _assert_rig_close(got: dict, ref: dict):
    np.testing.assert_array_equal(got["success"].numpy(), ref["success"])
    np.testing.assert_array_equal(got["n_inliers"].numpy(), ref["n_inliers"])
    assert_pose_close(got["rvec"], got["tvec"], ref["rvec"], ref["tvec"])


@pytest.mark.parametrize("name", sorted(RIG_CASES))
def test_recover_pose_batch_matches_jax(rig_refs, name):
    robot, _, mode = RIG_CASES[name]
    s, (ref, _, _, gumbel) = _scene(name), rig_refs[name]
    got = tpose.recover_pose_batch(
        _t(s["heatmaps"]), _t(s["pred_angles"]), _t(s["bases"]), _t(s["Ks"]),
        trob.get_robot(robot), s["image_hw"], draws=tpose.PoseDraws(_t(gumbel)), decode_mode=mode)
    atol = 0.0 if mode == "argmax" else 4e-2 * 10  # heatmap px -> image px (x10 at 1280/128)
    np.testing.assert_allclose(got["keypoints_xy"].numpy(), ref["keypoints_xy"], atol=atol)
    np.testing.assert_allclose(got["confidence"].numpy(), ref["confidence"], atol=1e-6)
    assert ref["success"].all()
    _assert_rig_close(got, ref)
    assert "refined_angles" not in got


@pytest.mark.parametrize("name", ["fr3_v1", "fr3_v4", "fr5_v4"])
def test_solve_rig_pnp_matches_jax(rig_refs, name):
    """From the scene's keypoints, one of view 0's below the gate."""
    robot = RIG_CASES[name][0]
    s, (_, ref, conf, gumbel) = _scene(name), rig_refs[name]
    got = tpose.solve_rig_pnp(_t(s["xy"]), _t(conf), _t(s["pred_angles"]), _t(s["bases"]),
                              _t(s["Ks"]), trob.get_robot(robot), gumbel=_t(gumbel))
    _assert_rig_close(got, ref)
    np.testing.assert_array_equal(got["inlier_mask"].numpy(), ref["inlier_mask"])
    assert not ref["inlier_mask"][0, 1]


def test_recover_pose_batch_batches_rigs(rig_refs):
    """Two rigs as one (2, V, ...) batch give each rig's result."""
    names = ["fr3_v4", "fr3_v4_refine_decode"]
    scenes = [_scene(n) for n in names]
    stack = lambda k: _t(np.stack([s[k] for s in scenes]))  # noqa: E731
    gumbel = _t(np.stack([rig_refs[n][3] for n in names]))
    got = tpose.recover_pose_batch(stack("heatmaps"), stack("pred_angles"), _t(scenes[0]["bases"]),
                                   _t(scenes[0]["Ks"]), trob.get_robot("fr3"), (720, 1280),
                                   draws=tpose.PoseDraws(gumbel))
    for i, n in enumerate(names):  # both decoded by argmax here: fr3_v4's reference
        if RIG_CASES[n][2] == "argmax":
            _assert_rig_close({k: v[i] for k, v in got.items()}, rig_refs[n][0])
    assert got["rvec"].shape == (2, 4, 3) and got["success"].all()


def test_recover_pose_single_view_matches_jax():
    s = pose_scene("fr5", 1, seed=3)
    spec = jrob.get_robot("fr5")
    key = jax.random.PRNGKey(4)
    gumbel = jax_ransac_gumbel(key, 32, spec.n_keypoints)
    for heat in (s["heatmaps"][0], np.full_like(s["heatmaps"][0], -5.0)):  # confident; none
        fallback = (np.array([0.1, 0.2, 0.3], np.float32), np.array([0.0, 0.0, 1.0], np.float32))
        want = jpose.recover_pose_single_view(jnp.asarray(heat), jnp.asarray(s["pred_angles"]),
                                              spec, NOMINAL_K, (720, 1280), view="left",
                                              fallback_extrinsic=fallback, key=key)
        got = tpose.recover_pose_single_view(_t(heat), _t(s["pred_angles"]), trob.get_robot("fr5"),
                                             NOMINAL_K, (720, 1280), view="left",
                                             fallback_extrinsic=fallback, gumbel=_t(gumbel))
        assert (got.success, got.used_fallback, got.n_inliers) == (
            want.success, want.used_fallback, want.n_inliers)
        np.testing.assert_array_equal(got.keypoints_2d, want.keypoints_2d)
        if want.success or want.used_fallback:
            assert_pose_close(got.rvec, got.tvec, want.rvec, want.tvec)


def test_recover_pose_multiview_and_reprojection_match_jax():
    s = pose_scene("fr3", 4, seed=11, noise_px=0.0)
    mask = np.array([True, True, False, True])
    want = jpose.recover_pose_multiview(jnp.asarray(s["heatmaps"]), jnp.asarray(mask),
                                        jnp.asarray(s["rvecs"]), jnp.asarray(s["tvecs"]),
                                        jnp.asarray(s["Ks"]), (720, 1280))
    got = tpose.recover_pose_multiview(_t(s["heatmaps"]), torch.from_numpy(mask), _t(s["rvecs"]),
                                       _t(s["tvecs"]), _t(s["Ks"]), (720, 1280))
    np.testing.assert_allclose(got[0].numpy(), np32(want[0]), atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), np32(want[1]))
    pts = np32(want[0])
    err_j = jpose.reprojection_errors(jnp.asarray(pts), jnp.asarray(s["xy"][0]),
                                      jnp.asarray(s["rvecs"][0]), jnp.asarray(s["tvecs"][0]),
                                      jnp.asarray(NOMINAL_K))
    err_t = tpose.reprojection_errors(_t(pts), _t(s["xy"][0]), _t(s["rvecs"][0]),
                                      _t(s["tvecs"][0]), _t(NOMINAL_K))
    np.testing.assert_allclose(err_t.numpy(), np32(err_j), atol=1e-3)


def test_pose_metrics_match_jax():
    rng = np.random.default_rng(31)
    rp, rg = rng.normal(size=(2, 5, 3)).astype(np.float32)
    tp, tg = rng.normal(size=(2, 5, 3)).astype(np.float32)
    rg[0] = rp[0]  # zero error: the clamp
    np.testing.assert_allclose(tmetrics.pose_rotation_err_deg(_t(rp), _t(rg)).numpy(),
                               np32(jmetrics.pose_rotation_err_deg(jnp.asarray(rp),
                                                                   jnp.asarray(rg))), atol=1e-3)
    np.testing.assert_allclose(  # broadcasting one ground truth over the views
        tmetrics.pose_rotation_err_deg(_t(rp), _t(rg[0])).numpy(),
        np32(jmetrics.pose_rotation_err_deg(jnp.asarray(rp), jnp.asarray(rg[0]))), atol=1e-3)
    np.testing.assert_allclose(tmetrics.pose_translation_err_m(_t(tp), _t(tg)).numpy(),
                               np32(jmetrics.pose_translation_err_m(jnp.asarray(tp),
                                                                    jnp.asarray(tg))), atol=1e-6)


# ------------------------------------------------------------ the whole slice

MODEL_SIZE, FRAME_HW = 32, (72, 128)
SLICE_CFG = JaxEstimatorConfig(
    vit=JaxViTConfig(image_size=MODEL_SIZE, patch_size=8, hidden_size=64, num_layers=2,
                     num_heads=4, dtype="float32"),
    num_joints=8, num_angles=7, heatmap_size=(32, 32), max_views=4, num_fusion_queries=4,
    dtype="float32",
)


def planted_heatmaps(angles: np.ndarray, views: int, seed: int) -> np.ndarray:
    """(1, views, 8, 32, 32) logits, +5 at the pixels where fr3's keypoints
    at `angles` project into a FRAME_HW frame seen by the nominal K from
    cameras 12 m and more away (so that the robot fits the small frame),
    -5 far from them. Added to a random model's heatmaps (|logit| < 1), they
    make its views' RANSAC succeed."""
    from mvropose_torch.geometry.camera import project_points
    from mvropose_torch.geometry.rotations import rodrigues_to_matrix

    robot = trob.get_robot("fr3")
    obj = robot.keypoints_from_fk(trob.forward_kinematics(robot, _t(angles)))
    H, W = FRAME_HW
    K = _t([[737.0, 0, W / 2], [0, 737.0, H / 2], [0, 0, 1]])
    rng = np.random.default_rng(seed)
    xys, z = [], 12.0
    while len(xys) < views:
        rvec = _t(rng.normal(size=3))
        tvec = _t([0.0, 0.0, z]) - rodrigues_to_matrix(rvec) @ obj.mean(0)
        xy = project_points(obj, rvec, tvec, K).numpy()
        if xy.min() > 6 and xy[:, 0].max() < W - 6 and xy[:, 1].max() < H - 6:
            xys.append(xy)
        else:
            z += 1.0
    hm_h, hm_w = SLICE_CFG.heatmap_size
    xy = np.stack(xys)
    hx, hy = xy[..., 0] * hm_w / W, xy[..., 1] * hm_h / H
    d2 = (np.arange(hm_w)[None, None, None, :] - hx[..., None, None]) ** 2 + (
        np.arange(hm_h)[None, None, :, None] - hy[..., None, None]) ** 2
    return (10.0 * np.exp(-d2 / (2 * 1.5 ** 2)) - 5.0).astype(np.float32)[None]


class PlantedModel(torch.nn.Module):
    """The port's model with `plant` added to its heatmaps."""

    def __init__(self, model, plant: np.ndarray):
        super().__init__()
        self.model, self.plant = model, _t(plant)

    def forward(self, *args, **kwargs):
        hm, ang = self.model(*args, **kwargs)
        return hm + self.plant, ang


@pytest.fixture(scope="module")
def slice_ref(tmp_path_factory):
    """A random small JAX model (fr3's arity) exported as a run, and the
    reference serve's `infer` with --recover-pose on 2 views: model, then
    recover_pose_batch with the nominal K and identity bases, PRNGKey(0).
    Heatmaps planted on the projections of FK of the model's own angles are
    added to the model's (`planted_heatmaps`), so that views succeed."""
    from mvropose_tpu.data.dataset import IMAGENET_MEAN, IMAGENET_STD

    model = JaxEstimator(SLICE_CFG)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, 2, MODEL_SIZE, MODEL_SIZE, 3)),
                             jnp.zeros((1, 2), jnp.int32), jnp.ones((1, 2), bool)),
        jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed=16)
    npz = export_npz(variables, tmp_path_factory.mktemp("slice") / "best_params.npz")
    frames = np.random.default_rng(17).integers(0, 256, size=(2, *FRAME_HW, 3), dtype=np.uint8)
    imgs = jax.image.resize(jnp.asarray(frames, jnp.float32) / 255.0,
                            (2, MODEL_SIZE, MODEL_SIZE, 3), "bilinear")
    imgs = (imgs - jnp.asarray(IMAGENET_MEAN)) / jnp.asarray(IMAGENET_STD)
    hm, ang = model.apply(variables, imgs[None], jnp.arange(2, dtype=jnp.int32)[None],
                          jnp.ones((1, 2), bool))
    plant = planted_heatmaps(np32(ang[0]), 2, seed=18)
    hm = hm + jnp.asarray(plant)
    H, W = FRAME_HW
    Ks = jnp.asarray(np.tile(np.array([[737.0, 0, W / 2], [0, 737.0, H / 2], [0, 0, 1]],
                                      np.float32), (2, 1, 1)))
    pose = jpose.recover_pose_batch(hm[0], ang[0], jnp.tile(jnp.eye(3), (2, 1, 1)), Ks,
                                    jrob.get_robot("fr3"), FRAME_HW)
    gumbel = jax_rig_gumbel(jax.random.PRNGKey(0), 2, 16, 8)
    return npz, frames, {k: np.asarray(v) for k, v in pose.items()}, np32(ang), gumbel, plant


def test_serve_step_with_pose_matches_jax(slice_ref):
    """The port's serve step with --recover-pose (model, peak decode, FK,
    RANSAC PnP, the fallback substitution) against the reference's on the
    same weights, planted heatmaps and draws: keypoints exact, confidences
    and angles 1e-3, success (both views succeed), and the poses."""
    npz, frames, ref, ang_ref, gumbel, plant = slice_ref
    assert ref["success"].all(), ref["success"]
    cfg = dataclasses.asdict(SLICE_CFG)
    model = MultiViewPoseEstimator(EstimatorConfig(vit=ViTConfig(**cfg.pop("vit")), **cfg)).eval()
    load_jax_params(model, npz)
    model = PlantedModel(model, plant)
    step = PoseStep(2, FRAME_HW, "cpu", angles=7)
    step.draws = tpose.PoseDraws(_t(gumbel))
    with torch.no_grad():
        xy, conf, ang, rvec, tvec, success = serve_step(
            model, torch.from_numpy(frames), torch.ones(2, dtype=torch.bool), MODEL_SIZE,
            FRAME_HW, pose=step)
    np.testing.assert_array_equal(xy.numpy(), ref["keypoints_xy"])
    np.testing.assert_allclose(conf.numpy(), ref["confidence"], atol=1e-3)
    np.testing.assert_allclose(ang.numpy(), ang_ref, atol=1e-3)
    np.testing.assert_array_equal(success.numpy(), ref["success"])
    assert_pose_close(rvec, tvec, ref["rvec"], ref["tvec"])
    assert success.dtype == torch.bool and torch.isfinite(rvec).all() and torch.isfinite(tvec).all()


def test_pose_step_draws_once():
    """The serve step's draws are made once, from the seed, on the device:
    two steps built alike hold equal draws, with refine the starts and the
    re-solve's too."""
    a, b = (PoseStep(3, (720, 1280), "cpu", angles=7, refine=True)
            for _ in range(2))
    for x, y in zip(dataclasses.astuple(a.draws), dataclasses.astuple(b.draws)):
        assert torch.equal(x, y)
    assert a.draws.gumbel.shape == (3, 16, 8) and a.draws.starts.shape == (32, 7)
    assert a.draws.regumbel.shape == (3, 16, 8)
    assert PoseStep(3, (720, 1280), "cpu", angles=7).draws.starts is None


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode and SVD kernels have no CPU mode")
    return torch.device("cuda")


def _pose_inputs(device, refine: bool, views: int = 4):
    s = pose_scene("fr3", views, seed=40 + views, noise_px=0.0)
    draws = tpose.PoseDraws.draw((), views, 8, 7, refine, torch.Generator().manual_seed(9))
    move = lambda x: None if x is None else x.to(device)  # noqa: E731
    args = [torch.from_numpy(s[k]).to(device)
            for k in ("heatmaps", "pred_angles", "bases", "Ks")]
    return args, tpose.PoseDraws(*(move(x) for x in dataclasses.astuple(draws))), s


@pytest.mark.cuda
@pytest.mark.parametrize("refine", [False, True])
def test_pose_step_on_card_matches_cpu(cuda_device, refine):
    """recover_pose_batch on the card (the peak decode and the SVD kernel)
    against the CPU route on the same rig and draws: keypoints and success
    equal; and from the exact keypoints (solve_rig_pnp, then the
    refinement) the poses within the CPU tolerances. From the heatmaps the
    argmax quantizes the keypoints by up to 5 px, and FR3's RANSAC then
    picks among near-equal hypotheses, some from a DLT null space of
    dimension > 1 (`test_torch_pnp.py::test_ransac_hypotheses_match_jax`)."""
    robot = trob.get_robot("fr3")
    outs = {}
    for dev in ("cpu", cuda_device):
        args, draws, s = _pose_inputs(dev, refine)
        before = small_svd.launches
        full = tpose.recover_pose_batch(*args, robot, (720, 1280), draws=draws, refine=refine)
        xy, conf = (torch.from_numpy(s[k]).to(dev) for k in ("xy", "conf"))
        clean = tpose.solve_rig_pnp(xy, conf, *args[1:], robot, gumbel=draws.gumbel)
        if refine:
            clean.update(tpose.refine_rig_pose_angles(
                xy, conf, args[1], clean["rvec"], clean["tvec"], *args[2:], robot,
                starts=draws.starts, regumbel=draws.regumbel))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert small_svd.launches - before == 2 * (10 if refine else 5)
        outs[str(dev)] = [{k: v.cpu() for k, v in o.items()} for o in (full, clean)]
    (cpu, cpu_clean), (card, card_clean) = outs["cpu"], outs[str(cuda_device)]
    torch.testing.assert_close(card["keypoints_xy"], cpu["keypoints_xy"], rtol=0, atol=0)
    assert torch.equal(card["success"], cpu["success"]) and bool(cpu["success"].all())
    assert torch.equal(card_clean["success"], cpu_clean["success"])
    assert_pose_close(card_clean["rvec"], card_clean["tvec"], cpu_clean["rvec"], cpu_clean["tvec"])


@pytest.mark.cuda
@pytest.mark.parametrize("refine", [False, True])
def test_pose_step_never_syncs(cuda_device, refine):
    """The pose step enqueues everything and never waits for the device (no
    host copy, no .item(), no error check that reads the device)."""
    args, draws, _ = _pose_inputs(cuda_device, refine)
    robot = trob.get_robot("fr3")
    tpose.recover_pose_batch(*args, robot, (720, 1280), draws=draws, refine=refine)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tpose.recover_pose_batch(*args, robot, (720, 1280), draws=draws, refine=refine)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out["rvec"]).all()
