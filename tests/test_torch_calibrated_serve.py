"""The calibrated rig and every checkpoint kind on the serve path: the torch
port vs the JAX reference, f32 on the CPU.

The reference's serve undistorts each frame on the host (`cv2.remap` with
`undistort_map`'s grid, `mvropose_tpu/cli/main.py:1608-1627,1746-1761`); its
`infer` is a closure, so `_jax_calibrated_infer` below composes the same
functions in the same order. Tolerances:
  * `undistort_map` 1e-3 px at 720 x 1280 (f32 in both packages);
  * the remap: bit-equal to its numpy arithmetic; against cv2.remap at most
    one level apart on at most 1e-4 of the values (cv2 interpolates on
    fixed-point weights);
  * the calibrated serve step as `test_torch_pose.py::
    test_serve_step_with_pose_matches_jax`: keypoints exact (planted peaks),
    confidences and angles 1e-3, success equal, poses within 1e-3 rad and
    1e-3 of |t|; the fallback pose of a failed camera exact.
"""

import dataclasses
import json

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvropose_tpu import pose as jpose
from mvropose_tpu.cli.main import _write_model_config
from mvropose_tpu.data.dataset import IMAGENET_MEAN, IMAGENET_STD
from mvropose_tpu.geometry import camera as jcam
from mvropose_tpu.geometry import robots as jrob
from mvropose_tpu.geometry.triangulation import heatmap_projection_matrices as jax_hm_proj
from mvropose_tpu.models import EstimatorConfig as JaxEstimatorConfig
from mvropose_tpu.models import MultiViewPoseEstimator as JaxMultiView
from mvropose_tpu.models import SingleViewPoseEstimator as JaxSingleView
from mvropose_tpu.models.heads import UNetViTKeypointHead as JaxUNet
from mvropose_tpu.models.vit import ViTConfig as JaxViTConfig

import mvropose_torch.cli.main as cli
from mvropose_torch import pose as tpose
from mvropose_torch.geometry import robots as trob
from mvropose_torch.geometry.camera import RemapTaps, project_points, undistort_map
from mvropose_torch.geometry.rotations import rodrigues_to_matrix
from mvropose_torch.geometry.triangulation import heatmap_projection_matrices
from mvropose_torch.models import MultiViewPoseEstimator, SingleViewPoseEstimator
from mvropose_torch.utils.weights import load_jax_params
from test_torch_serve import SERVE_TINY, port_config
from torch_parity import assert_pose_close, export_npz, jax_rig_gumbel, np32, random_variables

cv2 = pytest.importorskip("cv2")

FRAME_HW, MODEL_SIZE, VIEWS = (72, 128), 32, 3
DIST = [-0.05, 0.02, 1e-3, -1e-3, 0.0]  # ZED-like (k1, k2, p1, p2, k3)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


# --- the undistortion ----------------------------------------------------------


def test_undistort_map_matches_jax():
    K = np.array([[1060.0, 0, 645.3], [0, 1058.5, 362.1], [0, 0, 1]], np.float32)
    want = np32(jcam.undistort_map(jnp.asarray(K), jnp.asarray(DIST, jnp.float32), 720, 1280))
    got = undistort_map(_t(K), _t(DIST), 720, 1280)
    assert got.shape == (2, 720, 1280) and got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=1e-3)


def remap_model(frame: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """`RemapTaps`'s arithmetic in numpy f32, one (H, W, C) frame, grid (2, H, W)."""
    H, W = frame.shape[:2]
    sy, sx = grid[0].astype(np.float32), grid[1].astype(np.float32)
    y0, x0 = np.floor(sy), np.floor(sx)
    fy, fx = sy - y0, sx - x0
    y0, x0 = y0.astype(np.int64), x0.astype(np.int64)
    one = np.float32(1)
    out = np.zeros(frame.shape, np.float32)
    for dy, dx, w in ((0, 0, (one - fy) * (one - fx)), (0, 1, (one - fy) * fx),
                      (1, 0, fy * (one - fx)), (1, 1, fy * fx)):
        y, x = y0 + dy, x0 + dx
        inside = (y >= 0) & (y < H) & (x >= 0) & (x < W)
        v = frame[np.clip(y, 0, H - 1), np.clip(x, 0, W - 1)].astype(np.float32)
        out = out + v * np.where(inside, w, np.float32(0))[..., None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _remap_case(seed: int):
    """Three 180 x 320 frames: a ZED-like grid, the same grid scaled 1.1x about
    the corner (a third of it outside the frame), and one shifted by 3.5 px."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(3, 180, 320, 3), dtype=np.uint8)
    K = np.array([[200.0, 0, 160], [0, 200, 90], [0, 0, 1]], np.float32)
    grid = np32(jcam.undistort_map(jnp.asarray(K), jnp.asarray(DIST, jnp.float32), 180, 320))
    grids = np.stack([grid, grid * np.float32(1.1) - np.float32(10), grid + np.float32(3.5)])
    return frames, grids.astype(np.float32)


def test_remap_matches_its_numpy_arithmetic_and_cv2():
    frames, grids = _remap_case(41)
    got = RemapTaps.from_maps(_t(grids))(torch.from_numpy(frames)).numpy()
    assert got.dtype == np.uint8 and got.shape == frames.shape
    outside = (grids[1, 0] >= 180) | (grids[1, 1] >= 320)  # every tap outside
    assert outside.mean() > 0.05  # the second grid crosses the border
    for v in range(3):
        np.testing.assert_array_equal(got[v], remap_model(frames[v], grids[v]))
        want = cv2.remap(frames[v], grids[v, 1], grids[v, 0], cv2.INTER_LINEAR)
        off = np.abs(got[v].astype(int) - want.astype(int))
        assert off.max() <= 1 and (off > 0).mean() <= 1e-4, (v, off.max(), (off > 0).mean())
    assert (got[1][outside] == 0).all()


# --- the calibrated serve step ---------------------------------------------------

ROBOT = "fr3"
KEYS = [f"view{i + 1}_leftcam" for i in range(VIEWS)]
K_CAL = np.array([[150.0, 0, 64.0], [0, 150.0, 36.0], [0, 0, 1]], np.float32)


def _vit():
    return JaxViTConfig(image_size=MODEL_SIZE, patch_size=8, hidden_size=64, num_layers=1,
                        num_heads=4, dtype="float32")


KIND_CFGS = {
    "mv_geometric3d": JaxEstimatorConfig(vit=_vit(), num_joints=8, num_angles=7,
                                         heatmap_size=(32, 32), max_views=4, num_fusion_queries=4,
                                         dtype="float32", angle_head="geometric3d"),
    "sv_query": JaxEstimatorConfig(vit=_vit(), num_joints=8, num_angles=7, heatmap_size=(32, 32),
                                   max_views=4, num_angle_queries=2, dtype="float32"),
}


def rig_poses(angles: np.ndarray, seed: int, dark: int | None = None):
    """Per view (rvec, tvec) that put fr3 at `angles`, seen through its
    view's base rotation, inside a FRAME_HW frame of K_CAL with a 6 px margin,
    and the (V, 8, 32, 32) logit heatmaps peaked on those pixels (+5 there,
    -5 far off): what a trained model's heatmaps would add to a random one's.
    View `dark`'s peaks stay below confidence 0.001: its recovery fails."""
    robot = trob.get_robot(ROBOT)
    H, W = FRAME_HW
    rng = np.random.default_rng(seed)
    rvecs, tvecs, xys = [], [], []
    for i in range(VIEWS):
        base = torch.from_numpy(robot.base_rotation(KEYS[i].split("_")[0]))
        obj = robot.keypoints_from_fk(trob.forward_kinematics(robot, _t(angles), base))
        z = 2.0
        while True:
            rvec = _t(rng.normal(size=3))
            tvec = _t([0.0, 0.0, z]) - rodrigues_to_matrix(rvec) @ obj.mean(0)
            xy = project_points(obj, rvec, tvec, _t(K_CAL)).numpy()
            if xy.min() > 6 and xy[:, 0].max() < W - 6 and xy[:, 1].max() < H - 6:
                break
            z += 0.5
        rvecs.append(rvec.numpy()), tvecs.append(tvec.numpy()), xys.append(xy)
    xy = np.stack(xys)
    # Peaks on the nearest heatmap pixel: every map's argmax by a wide margin.
    hx, hy = np.rint(xy[..., 0] * 32 / W), np.rint(xy[..., 1] * 32 / H)
    d2 = (np.arange(32)[None, None, None, :] - hx[..., None, None]) ** 2 + (
        np.arange(32)[None, None, :, None] - hy[..., None, None]) ** 2
    blob = np.exp(-d2 / (2 * 1.5 ** 2))
    plant = (10.0 * blob - 5.0).astype(np.float32)
    plant[dark] = 2.0 * blob[dark] - 9.0  # peaks, but no confident keypoint
    return np.stack(rvecs), np.stack(tvecs), plant


def write_calibration(root, rvecs, tvecs, missing=()):
    """`cli calibrate intrinsics` files for KEYS and an ArUco summary: view 2's
    record in degrees with its unit tag, the others in radians (fr3's unit,
    untagged); the views in `missing` without a record."""
    root.mkdir(parents=True, exist_ok=True)
    records = []
    for i, key in enumerate(KEYS):
        view, cam = key.split("_")
        (root / f"{view}_1000{i}_{cam}_calib.json").write_text(json.dumps(
            {"camera_matrix": (K_CAL * (1 + 0.01 * i)).round(3).tolist(),
             "distortion_coeffs": DIST}))
        if i in missing:
            continue
        rec = {"view": view, "cam": cam, **dict(zip(("tvec_x", "tvec_y", "tvec_z"),
                                                    map(float, tvecs[i])))}
        rv = np.degrees(rvecs[i].astype(np.float64)) if i == 1 else rvecs[i]
        rec.update(zip(("rvec_x", "rvec_y", "rvec_z"), map(float, rv)))
        if i == 1:
            rec["rvec_unit"] = "deg"
        records.append(rec)
    (root / "summary.json").write_text(json.dumps(records))
    return root


def _jax_calibrated_infer(kind, model, variables, frames, mask, calib_dir, plant):
    """The reference serve's host undistortion and `infer`
    (`mvropose_tpu/cli/main.py:1599-1733`), its lines composed: the calib
    files' K and grids, the summary's fallback poses, cv2.remap, the resize
    and normalization, the model (geometric3d: the summary's heatmap-pixel
    projection matrices) with `plant` added to its keypoint head's output
    (flax's method interception, so that a geometric head decodes it too),
    recover_pose_batch with the calibrated K and base rotations, the
    fallback substitution."""
    robot = jrob.get_robot(ROBOT)
    H, W = FRAME_HW
    Ks, grids, views = [], [], []
    for key in KEYS:
        view, cam = key.split("_")
        data = json.loads(next(calib_dir.glob(f"{view}_*_{cam}_calib.json")).read_text())
        K = jnp.asarray(data["camera_matrix"], jnp.float32)
        grids.append(np.asarray(jcam.undistort_map(K, jnp.asarray(data["distortion_coeffs"],
                                                                 jnp.float32), H, W)))
        Ks.append(np.asarray(data["camera_matrix"], np.float32)), views.append(view)
    by_key = {f"{r['view']}_{r['cam']}": r
              for r in json.loads((calib_dir / "summary.json").read_text())}
    fb_r, fb_t, fb_v = [], [], []
    for key in KEYS:
        rec = by_key.get(key)
        if rec is None:
            fb_r.append(np.zeros(3)), fb_t.append(np.zeros(3)), fb_v.append(False)
            continue
        rv = np.array([rec["rvec_x"], rec["rvec_y"], rec["rvec_z"]])
        if rec.get("rvec_unit", robot.extrinsic_rvec_unit) == "deg":
            rv = np.deg2rad(rv)
        fb_r.append(rv), fb_t.append(np.array([rec["tvec_x"], rec["tvec_y"], rec["tvec_z"]]))
        fb_v.append(True)
    fb_rvec, fb_tvec = (jnp.asarray(np.stack(a), jnp.float32) for a in (fb_r, fb_t))
    fb_valid = jnp.asarray(np.asarray(fb_v))
    Ks = jnp.asarray(np.stack(Ks))
    bases = jnp.asarray(np.stack([robot.base_rotation(v) for v in views]).astype(np.float32))
    und = np.stack([cv2.remap(frames[i], grids[i][1], grids[i][0], cv2.INTER_LINEAR)
                    for i in range(VIEWS)])
    imgs = jax.image.resize(jnp.asarray(und, jnp.float32) / 255.0,
                            (VIEWS, MODEL_SIZE, MODEL_SIZE, 3), "bilinear")
    imgs = (imgs - jnp.asarray(IMAGENET_MEAN)) / jnp.asarray(IMAGENET_STD)
    m = jnp.asarray(mask)
    @jax.jit
    def apply(variables, *args, plant, **kwargs):
        def add_plant(call, args, kwargs, context):
            out = call(*args, **kwargs)
            if isinstance(context.module, JaxUNet) and context.method_name == "__call__":
                return out + plant.reshape(out.shape)
            return out

        with flax.linen.intercept_methods(add_plant):
            return model.apply(variables, *args, **kwargs)

    plant = jnp.asarray(plant)
    if kind.startswith("sv"):
        hm_v, ang_pc = apply(variables, imgs, plant=plant)
        mf = m.astype(ang_pc.dtype)[:, None]
        ang = (jnp.sum(ang_pc * mf, axis=0) / jnp.maximum(jnp.sum(mf), 1.0))[None]
        hm = hm_v[None]
    else:
        serve_pm = jax_hm_proj(fb_rvec, fb_tvec, Ks, FRAME_HW, (32, 32))[None]
        hm, ang = apply(variables, imgs[None], jnp.arange(VIEWS, dtype=jnp.int32)[None],
                        m[None], proj_mats=serve_pm, plant=plant)
    recover = jax.jit(jpose.recover_pose_batch, static_argnames=("robot", "image_hw"))
    pose = recover(hm[0], ang[0], bases, Ks, robot=robot,
                   image_hw=FRAME_HW)
    use_fb = (~pose["success"]) & fb_valid
    pose["rvec"] = jnp.where(use_fb[:, None], fb_rvec, pose["rvec"])
    pose["tvec"] = jnp.where(use_fb[:, None], fb_tvec, pose["tvec"])
    return (np32(hm), np32(ang), {k: np.asarray(v) for k, v in pose.items()},
            np.asarray(use_fb), und)


def plant_keypoint_head(model, plant: np.ndarray) -> None:
    """Add `plant` to the port's keypoint head's output, as the reference's
    side does: every later module, a geometric head too, reads it."""
    plant = torch.from_numpy(plant)
    model.keypoint_head.register_forward_hook(lambda m, args, out: out + plant.reshape(out.shape))


# kind: (frame mask, views without a summary record, the view left unplanted)
SERVE_CASES = {"mv_geometric3d": ([True, True, True], (), 2),
               "sv_query": ([True, False, True], (2,), 2)}


@pytest.fixture(scope="module")
def calibrated_refs(tmp_path_factory):
    refs = {}
    for kind, (mask, missing, dark) in SERVE_CASES.items():
        cfg = KIND_CFGS[kind]
        rng = np.random.default_rng(43)
        frames = rng.integers(0, 256, size=(VIEWS, *FRAME_HW, 3), dtype=np.uint8)
        if kind.startswith("sv"):
            model = JaxSingleView(cfg)
            init = (jnp.zeros((1, MODEL_SIZE, MODEL_SIZE, 3)),)
            kwargs = {}
        else:
            model = JaxMultiView(cfg)
            init = (jnp.zeros((1, VIEWS, MODEL_SIZE, MODEL_SIZE, 3)),
                    jnp.zeros((1, VIEWS), jnp.int32), jnp.ones((1, VIEWS), bool))
            kwargs = {"proj_mats": jnp.zeros((1, VIEWS, 3, 4))}
        shapes = jax.eval_shape(lambda k: model.init(k, *init, **kwargs), jax.random.PRNGKey(0))
        variables = random_variables(shapes, seed=44)
        root = tmp_path_factory.mktemp(kind)
        npz = export_npz(variables, root / "best_params.npz")
        _write_model_config(root, cfg, multi_view=kind.startswith("mv"), model_size=MODEL_SIZE)
        # The model's own angles fix the rig's poses: a first pass with no
        # plant. (A geometric head's angles move with the plant; here they
        # stay close enough for its planted cameras' recoveries.)
        zero = np.zeros((VIEWS, 8, 32, 32), np.float32)
        rvecs, tvecs, _ = rig_poses(np.zeros(7, np.float32), seed=45)
        calib_dir = write_calibration(root / "calib", rvecs, tvecs, missing)
        _, ang, *_ = _jax_calibrated_infer(kind, model, variables, frames, mask, calib_dir, zero)
        rvecs, tvecs, plant = rig_poses(ang[0], seed=45, dark=dark)
        calib_dir = write_calibration(root / "calib", rvecs, tvecs, missing)
        hm, ang, pose, use_fb, und = _jax_calibrated_infer(kind, model, variables, frames, mask,
                                                           calib_dir, plant)
        refs[kind] = dict(npz=npz, frames=frames, mask=np.asarray(mask), calib_dir=calib_dir,
                          plant=plant, hm=hm, ang=ang, pose=pose, use_fb=use_fb, und=und,
                          gumbel=jax_rig_gumbel(jax.random.PRNGKey(0), VIEWS, 16, 8))
    return refs


@pytest.mark.parametrize("kind", list(SERVE_CASES))
def test_calibrated_serve_step_matches_jax(calibrated_refs, kind):
    """One calibrated tick through the port's serve_step (the device remap,
    preprocess, the model, recover_pose_batch with the calibrated K and base
    rotations, the ArUco fallback), read from the same calib files and
    summary, against the reference's functions composed as its serve: the
    undistorted frames, the heatmaps, keypoints, confidences, angles (the
    single-view checkpoint's the mean over its unmasked cameras), success
    (the unplanted camera fails), and the poses, the failed camera's the
    summary's where it has a record."""
    r = calibrated_refs[kind]
    cfg = port_config(KIND_CFGS[kind])
    single = kind.startswith("sv")
    model = (SingleViewPoseEstimator if single else MultiViewPoseEstimator)(cfg).eval()
    load_jax_params(model, r["npz"])
    plant_keypoint_head(model, r["plant"])
    keys = ",".join(KEYS)
    calib = cli.read_calibration(r["calib_dir"], keys, VIEWS)
    cli.read_fallback_poses(calib, r["calib_dir"] / "summary.json", keys, trob.get_robot(ROBOT))
    np.testing.assert_array_equal(calib.fb_valid, ~np.isin(np.arange(VIEWS),
                                                           SERVE_CASES[kind][1]))
    remap = calib.remap(FRAME_HW, "cpu")
    proj = None if single else heatmap_projection_matrices(
        _t(calib.fb_rvec), _t(calib.fb_tvec), _t(calib.Ks), FRAME_HW, (32, 32))[None]
    step = cli.PoseStep(VIEWS, FRAME_HW, "cpu", angles=7, robot=ROBOT, calib=calib)
    step.draws = tpose.PoseDraws(_t(r["gumbel"]))
    frames, mask = torch.from_numpy(r["frames"]), torch.from_numpy(r["mask"])
    und = remap(frames)
    off = np.abs(und.numpy().astype(int) - r["und"].astype(int))
    assert off.max() <= 1 and (off > 0).sum() <= 16  # of 82944 values, cv2's fixed point
    with torch.no_grad():
        imgs = cli.preprocess(und, MODEL_SIZE)
        hm = (model(imgs) if single else model(imgs[None], torch.arange(VIEWS)[None], mask[None],
                                              proj_mats=proj))[0]
        xy, conf, ang, rvec, tvec, success = cli.serve_step(
            model, frames, mask, MODEL_SIZE, FRAME_HW, pose=step, remap=remap, proj_mats=proj,
            single_view=single)
    hm_ref, ref = r["hm"], r["pose"]
    hm = np32(hm).reshape(hm_ref.shape)
    np.testing.assert_allclose(hm, hm_ref, rtol=1e-3, atol=1e-3)
    top2 = np.sort(hm_ref.reshape(*hm_ref.shape[:-2], -1), axis=-1)[..., -2:]
    assert np.min(top2[..., 1] - top2[..., 0]) > 10 * np.abs(hm - hm_ref).max()  # same peaks
    np.testing.assert_allclose(np32(ang), r["ang"], rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(xy.numpy(), ref["keypoints_xy"])
    np.testing.assert_allclose(conf.numpy(), ref["confidence"], atol=1e-3)
    np.testing.assert_array_equal(success.numpy(), ref["success"])
    assert list(ref["success"]) == [True, True, False]
    used = r["use_fb"]
    assert used[2] == (not single)
    solved = ref["success"]
    assert_pose_close(rvec[solved], tvec[solved], ref["rvec"][solved], ref["tvec"][solved])
    np.testing.assert_array_equal(rvec.numpy()[used], ref["rvec"][used])
    np.testing.assert_array_equal(tvec.numpy()[used], ref["tvec"][used])


def test_single_view_angles_are_the_mean_over_unmasked_cameras():
    """serve_step on a single-view model: the per-camera angles' mean over
    the unmasked cameras, zeros where every camera is masked."""

    class PerCamera(torch.nn.Module):
        def forward(self, imgs):
            V = imgs.shape[0]
            return torch.zeros(V, 2, 8, 8), torch.arange(V * 2.0).reshape(V, 2)

    frames = torch.zeros((3, 8, 8, 3), dtype=torch.uint8)
    for mask, want in (([True, False, True], [2.0, 3.0]), ([False] * 3, [0.0, 0.0])):
        _, _, ang = cli.serve_step(PerCamera(), frames, torch.tensor(mask), 8, (8, 8),
                                   single_view=True)
        np.testing.assert_array_equal(ang.numpy(), [want])


# --- the CLI ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def calib_dir(tmp_path_factory):
    rvecs, tvecs, _ = rig_poses(np.zeros(7, np.float32), seed=46)
    return write_calibration(tmp_path_factory.mktemp("cli_calib"), rvecs, tvecs)


def _rig_flags(calib_dir) -> list:
    return ["--frame-hw", *map(str, FRAME_HW), "--views", str(VIEWS), "--calib-dir",
            str(calib_dir), "--camera-keys", ",".join(KEYS)]


def _run_dir(root, kind: str, head: str):
    """A run directory of the port's own (`write_run_dir`) for fr3's arity."""
    cfg = port_config(dataclasses.replace(KIND_CFGS["sv_query"], angle_head=head))
    model = (SingleViewPoseEstimator if kind == "single_view" else MultiViewPoseEstimator)(cfg)
    from mvropose_torch.utils.weights import random_flat

    cli.write_run_dir(root, cfg, MODEL_SIZE, random_flat(model, seed=5), kind=kind)
    return root / "best_params.npz"


def _tiny(*extra) -> list:
    """SERVE_TINY without its rig (views, frame size), which `_rig_flags` gives."""
    return ["serve", "--fps", "60", "--model-size", "32", "--hidden-size", "64",
            "--num-layers", "1", "--duration", "1.0", "--device", "cpu", *extra]


@pytest.mark.parametrize("kind, head, int8", [
    ("single_view", "query", False), ("single_view", "geometric", True),
    ("multi_view", "geometric", False), ("multi_view", "geometric3d", False)])
def test_cli_serves_every_kind_on_a_calibrated_rig(calib_dir, tmp_path, kind, head, int8):
    """`serve --params RUN` on the calibrated rig with --summary and
    --recover-pose for each checkpoint kind (geometric3d needs them all):
    per-camera poses, boolean success, finite outputs."""
    npz = _run_dir(tmp_path, kind, head)
    args = cli.build_parser().parse_args(
        [*_tiny("--params", str(npz), "--recover-pose", "--summary",
                str(calib_dir / "summary.json"), *(["--int8-backbone"] if int8 else [])),
         *_rig_flags(calib_dir)])
    stats, last = cli.serve(args)
    assert stats.ticks >= 1 and len(last) == 6
    xy, conf, ang, rvec, tvec, success = last
    assert xy.shape == (VIEWS, 8, 2) and ang.shape == (1, 7) and rvec.shape == (VIEWS, 3)
    assert success.dtype == np.bool_ and all(np.isfinite(a).all() for a in last[:5])


def test_cli_serve_geometric_heads_without_params(capsys, calib_dir):
    """--angle-head geometric without --params (random weights), and
    geometric3d on the calibrated rig with its summary; --max-skew reaches
    the pipeline."""
    assert cli.main(SERVE_TINY + ["--angle-head", "geometric", "--max-skew", "0.5"]) == 0
    assert "random weights from seed 0" in capsys.readouterr().out
    assert cli.main(_tiny("--angle-head", "geometric3d", "--recover-pose", "--summary",
                          str(calib_dir / "summary.json"), *_rig_flags(calib_dir))) == 0


def test_cli_serve_passes_max_skew(monkeypatch):
    seen = {}

    class Pipe(cli.StreamingPipeline):
        def __init__(self, *args, **kwargs):
            seen.update(kwargs)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(cli, "StreamingPipeline", Pipe)
    assert cli.main(SERVE_TINY + ["--max-skew", "0.25"]) == 0
    assert seen["max_skew_s"] == 0.25


@pytest.mark.parametrize("extra, message", [
    (["--calib-dir", "calib"], "--calib-dir and --camera-keys run only together"),
    (["--camera-keys", "view1_leftcam,view2_leftcam"],
     "--calib-dir and --camera-keys run only together"),
    (["--summary", "summary.json"], "--summary runs only with --calib-dir"),
    (["--summary", "summary.json", "--calib-dir", "c", "--camera-keys", "a_b,c_d"],
     "--summary runs only with .*--recover-pose"),
], ids=["calib_dir_alone", "camera_keys_alone", "summary_alone", "summary_without_pose"])
def test_cli_serve_refuses_incomplete_rig_flags(extra, message):
    with pytest.raises(SystemExit, match=message):
        cli.main(SERVE_TINY + extra)


def test_cli_serve_refuses_a_key_count_other_than_views(calib_dir):
    flags = _rig_flags(calib_dir)
    flags[flags.index("--camera-keys") + 1] = ",".join(KEYS[:2])
    with pytest.raises(SystemExit, match="--camera-keys lists 2 cameras, --views is 3"):
        cli.main(_tiny(*flags))


def test_cli_serve_refuses_a_key_without_calibration(calib_dir):
    flags = _rig_flags(calib_dir)
    flags[flags.index("--camera-keys") + 1] = "view1_leftcam,view2_leftcam,view9_rightcam"
    with pytest.raises(SystemExit, match="no calibration file view9_\\*_rightcam_calib.json"):
        cli.main(_tiny(*flags))


def test_cli_serve_geometric3d_keeps_the_reference_exits(calib_dir, tmp_path):
    """A geometric3d model needs --recover-pose --summary and the calibrated
    rig, and a summary record for every camera (the reference's two exits)."""
    with pytest.raises(SystemExit, match="geometric3d checkpoint needs --recover-pose --summary"):
        cli.main(SERVE_TINY + ["--angle-head", "geometric3d"])
    records = json.loads((calib_dir / "summary.json").read_text())
    (tmp_path / "partial.json").write_text(json.dumps(records[:2]))
    with pytest.raises(SystemExit, match="--summary is missing extrinsics"):
        cli.main(_tiny("--angle-head", "geometric3d", "--recover-pose", "--summary",
                       str(tmp_path / "partial.json"), *_rig_flags(calib_dir)))
