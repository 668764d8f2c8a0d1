"""Shared pieces of the torch-port parity tests (`tests/test_torch_*.py`).

Both packages get the same inputs and the same weights: inputs come from a
numpy seed, JAX variables are drawn with numpy over a `jax.eval_shape` tree
and cross into the port through the reference's own `save_params_npz` file.
"""

from __future__ import annotations

from pathlib import Path

import jax
import numpy as np
import torch

from mvropose_tpu.train.checkpoint import save_params_npz

# pytest-xdist runs the suite's files in several processes at once, and on
# tiny tensors torch's CPU ops keep their OpenMP threads spinning: at eight
# threads a process on eight cores, six processes made a `cli train` test
# ~20x slower than alone (698 s against 34 s). One thread a test process.
torch.set_num_threads(1)


def random_variables(shapes, seed: int = 0):
    """numpy-seeded variables for an eval_shape tree, scaled to keep
    activations O(1) so that the comparisons are not of near-zero values:
    kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1), BatchNorm running
    variance in [0.5, 1.5], everything else N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        names = [str(getattr(k, "key", k)) for k in path]
        name = names[-1]
        if name == "kernel":
            if len(s.shape) == 3:  # DenseGeneral: (D, H, dh) in, (H, dh, D) out
                fan_in = s.shape[0] if names[-2] in ("query", "key", "value") else s.shape[0] * s.shape[1]
            else:
                fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(s.dtype)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(s.dtype)
        if name == "var":
            return rng.uniform(0.5, 1.5, size=s.shape).astype(s.dtype)
        return (0.1 * rng.normal(size=s.shape)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def export_npz(variables, path) -> str:
    """Write JAX variables as the reference's flat checkpoint file."""
    save_params_npz(path, variables["params"], variables.get("batch_stats"))
    return str(path)


def np32(x) -> np.ndarray:
    """A JAX array or torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def jax_ransac_gumbel(key, n_hypotheses: int, n_points: int) -> np.ndarray:
    """The Gumbel draws `solve_pnp_ransac` makes from `key`: (n_hypotheses, N)."""
    keys = jax.random.split(key, n_hypotheses)
    return np.stack([np.asarray(jax.random.gumbel(k, (n_points,)), np.float32) for k in keys])


def jax_rig_gumbel(key, views: int, n_hypotheses: int, n_points: int) -> np.ndarray:
    """`solve_rig_pnp`'s draws from `key` (split per view, then per
    hypothesis): (V, n_hypotheses, N)."""
    return np.stack([jax_ransac_gumbel(k, n_hypotheses, n_points)
                     for k in jax.random.split(key, views)])


def jax_refine_draws(key, views: int, n_points: int, n_angles: int, n_starts: int = 32):
    """`refine_rig_pose_angles`'s draws from `key`: the starts' N(0, 1)
    perturbations (n_starts, A) and the re-solve's Gumbel draws (V, 16, N)."""
    starts = np.asarray(jax.random.normal(key, (n_starts, n_angles)), np.float32)
    return starts, jax_rig_gumbel(jax.random.fold_in(key, 1), views, 16, n_points)


def load_script(name: str):
    """`scripts/<name>.py` as a module (its `main(argv)` runs it in-process)."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


NOMINAL_K = np.array([[737.0, 0.0, 640.0], [0.0, 737.0, 360.0], [0.0, 0.0, 1.0]], np.float32)


def pose_scene(robot_name: str, views: int, seed: int, noise_px: float = 0.5,
               image_hw=(720, 1280), heatmap_hw=(128, 128)) -> dict:
    """A rig of `views` cameras ~3.5 m from a robot, made with the port's FK
    and projection from a numpy seed (no JAX, so the card's tests use it
    too): true angles and a prediction off by ~0.05 rad (or 3 deg), per-view
    poses with every keypoint inside the image, the keypoints' pixels plus
    `noise_px` noise, confidences 0.9, and logit heatmaps whose peaks sit on
    the noisy keypoints (sigmoid 0.99). All numpy f32."""
    from mvropose_torch.geometry import robots as trob
    from mvropose_torch.geometry.camera import project_points
    from mvropose_torch.geometry.rotations import rodrigues_to_matrix

    robot = trob.get_robot(robot_name)
    rng = np.random.default_rng(seed)
    deg = robot.angle_unit == "deg"
    angles = rng.uniform(-1, 1, robot.n_joints).astype(np.float32) * (60.0 if deg else 1.0)
    pred = angles + rng.normal(scale=3.0 if deg else 0.05, size=angles.shape).astype(np.float32)
    obj = robot.keypoints_from_fk(trob.forward_kinematics(robot, torch.from_numpy(angles)))
    H, W = image_hw
    rvecs, tvecs, xys = [], [], []
    while len(rvecs) < views:
        rvec = torch.from_numpy(rng.normal(size=3).astype(np.float32))
        shift = np.array([*rng.uniform(-0.15, 0.15, 2), 3.5], np.float32)
        tvec = torch.from_numpy(shift) - rodrigues_to_matrix(rvec) @ obj.mean(0)
        xy = project_points(obj, rvec, tvec, torch.from_numpy(NOMINAL_K)).numpy()
        if (xy[:, 0].min() > 20 and xy[:, 0].max() < W - 20 and xy[:, 1].min() > 20
                and xy[:, 1].max() < H - 20):
            rvecs.append(rvec.numpy()), tvecs.append(tvec.numpy()), xys.append(xy)
    xy = np.stack(xys) + rng.normal(scale=noise_px, size=(views, len(obj), 2))
    hm_h, hm_w = heatmap_hw
    hx, hy = xy[..., 0] * hm_w / W, xy[..., 1] * hm_h / H
    cols, rows = np.arange(hm_w), np.arange(hm_h)
    d2 = (cols[None, None, None, :] - hx[..., None, None]) ** 2 + (
        rows[None, None, :, None] - hy[..., None, None]) ** 2
    heatmaps = 10.0 * np.exp(-d2 / (2 * 1.5 ** 2)) - 5.0
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {"angles": angles, "pred_angles": f32(pred), "rvecs": f32(rvecs),
            "tvecs": f32(tvecs), "xy": f32(xy), "conf": np.full(xy.shape[:2], 0.9, np.float32),
            "heatmaps": f32(heatmaps), "Ks": np.tile(NOMINAL_K, (views, 1, 1)),
            "bases": np.tile(np.eye(3, dtype=np.float32), (views, 1, 1)),
            "image_hw": tuple(image_hw)}


ROT_TOL, TRANS_REL = 1e-3, 1e-3  # rad; share of |t|


def rotation_gap(rvec_a, rvec_b) -> np.ndarray:
    """Geodesic angle (rad) between rotation vectors (..., 3), in f64."""
    from mvropose_torch.geometry.rotations import rodrigues_to_matrix

    Ra, Rb = (rodrigues_to_matrix(torch.from_numpy(np.array(r, np.float64))).numpy()
              for r in (rvec_a, rvec_b))
    cos = np.clip((np.einsum("...ij,...ij->...", Ra, Rb) - 1.0) / 2.0, -1.0, 1.0)
    return np.arccos(cos)


def assert_pose_close(rvec, tvec, rvec_ref, tvec_ref):
    """Rotations within ROT_TOL, translations within TRANS_REL of |t_ref|."""
    gap = rotation_gap(np32(rvec), np32(rvec_ref))
    assert gap.max(initial=0.0) <= ROT_TOL, gap
    gap = np.linalg.norm(np32(tvec) - np32(tvec_ref), axis=-1)
    assert (gap <= TRANS_REL * np.linalg.norm(np32(tvec_ref), axis=-1)).all(), gap


def heatmap_rig_scene(seed: int, batch: int = 2, views: int = 4, joints: int = 4,
                      hw=(32, 32)) -> dict:
    """Planted heatmaps of a stereo-like rig, for the geometric angle heads:
    `views` cameras 3 m behind the origin along -x, spread 1 m in y and
    turned toward it, f = 1.25 w heatmap px (P in heatmap pixels). Each
    sample's joints 1.. are random points within 0.3 m of the origin; joint
    `far` (2) lies 300 m out along +x, beyond the +-100 clip. Each (view,
    joint) map is a logit blob peaked on its projection (10 exp(-d^2 / 2) -
    5, confidence sigmoid(5)); joint 1 is faint (exp(-d^2 / 2) - 4, below
    confidence 0.05) in all but view 0, so fewer than 2 views observe it;
    the last view is masked in sample 0. numpy f32, no JAX."""
    rng = np.random.default_rng(seed)
    h, w = hw
    f = 1.25 * w
    K = np.array([[f, 0.0, (w - 1) / 2], [0.0, f, (h - 1) / 2], [0.0, 0.0, 1.0]])
    P = []
    for y in np.linspace(-0.5, 0.5, views):
        c = np.array([-3.0, y, 0.05 * y])
        fwd = -c / np.linalg.norm(c)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        P.append(K @ np.concatenate([R, (-R @ c)[:, None]], 1))
    P = np.stack(P)
    pts = rng.uniform(-0.3, 0.3, size=(batch, joints, 3))
    pts[:, 2] = [300.0, 0.2, 0.1]
    hom = np.concatenate([pts, np.ones((batch, joints, 1))], -1)
    uvw = np.einsum("vij,bkj->bvki", P, hom)
    xy = uvw[..., :2] / uvw[..., 2:]  # (B, V, J, 2)
    d2 = ((np.arange(w)[None, None, None, None, :] - xy[..., 0, None, None]) ** 2
          + (np.arange(h)[None, None, None, :, None] - xy[..., 1, None, None]) ** 2)
    heatmaps = 10.0 * np.exp(-d2 / 2.0) - 5.0
    heatmaps[:, 1:, 1] = np.exp(-d2[:, 1:, 1] / 2.0) - 4.0
    mask = np.ones((batch, views), bool)
    mask[0, -1] = False
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {"heatmaps": f32(heatmaps), "mask": mask, "xy": f32(xy), "points": f32(pts),
            "proj_mats": f32(np.broadcast_to(P, (batch, *P.shape)))}


# Captured-image fixtures for the `cli train` slice (60 x 80 frames), made
# through the reference's own `cli sync` and `cli calibrate`.
CAPTURE_HW = (60, 80)
FR3_SERIALS = ("41182735", "49429257")  # fr3's view1 and view2
FR3_CONF = """\
[LEFT_CAM_FHD]
cx = 40.5
cy = 29.5
fx = 70.0
fy = 71.0
k1 = -0.08
k2 = 0.02
k3 = 0.0
p1 = 0.001
p2 = -0.002

[RIGHT_CAM_FHD]
cx = 39.0
cy = 30.5
fx = 69.0
fy = 70.0
k1 = -0.05
k2 = 0.01
k3 = 0.0
p1 = -0.001
p2 = 0.001
"""


def _capture_image(rng, hw=CAPTURE_HW) -> np.ndarray:
    """A smooth random BGR image (noise blurred), so that undistortion and
    JPEG keep most pixels away from rounding ties."""
    import cv2

    img = rng.integers(0, 256, size=(*hw, 3)).astype(np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 1.5)


def fr3_capture(root, ticks: int = 6, seed: int = 0) -> dict:
    """An FR3 capture of 2 serials x left/right cameras (4 views) over
    `ticks` joint records: ROS2 joint YAML (3-decimal epochs) and JPEGs
    named zed_<serial>_<side>_<epoch with 9 decimals>.jpg under pose1/, each
    within 5 ms of its record, so the views of a tick tie on
    robot_timestamp; the reference's `cli sync fr3` CSV, its `cli calibrate
    intrinsics` files (with distortion) and a `pose1_aruco_pose_summary.json`.
    Tick 1 also holds an unreadable image (right camera of view 2), tick 2 a
    file named off the convention and tick 3 an image of the wrong size
    (left camera of view 2). -> {"csv", "calib_dir", "summary", "root"}."""
    import cv2

    from mvropose_tpu.cli.main import main as jax_main

    root = Path(root)
    rng = np.random.default_rng(seed)
    jdir, img_dir = root / "joints", root / "pose1"
    jdir.mkdir(parents=True)
    img_dir.mkdir(parents=True)
    docs = []
    names = ", ".join(f"fr3_joint{j}" for j in range(1, 8))
    for i in range(ticks):
        sec, nsec = 1700000000 + i, 123456789 + 7654321 * i
        pos = ", ".join(f"{v:.6f}" for v in rng.uniform(-0.6, 0.6, 7))
        docs.append(f"header:\n  stamp:\n    sec: {sec}\n    nanosec: {nsec}\n"
                    f"name: [{names}]\nposition: [{pos}]\n")
        t = float(f"{sec}.{nsec:09d}"[:14]) - 0.0333  # sync adds the camera delay
        for serial in FR3_SERIALS:
            for side in ("left", "right"):
                ts = t + rng.uniform(-0.005, 0.005)
                path = img_dir / f"zed_{serial}_{side}_{ts:.9f}.jpg"
                if (i, serial, side) == (1, FR3_SERIALS[1], "right"):
                    path.write_bytes(b"not a jpeg")
                elif (i, serial, side) == (3, FR3_SERIALS[1], "left"):
                    cv2.imwrite(str(path), _capture_image(rng, (50, 80)))
                else:
                    cv2.imwrite(str(path), _capture_image(rng))
        if i == 2:
            cv2.imwrite(str(img_dir / f"cam_{t:.9f}.jpg"), _capture_image(rng))
    (jdir / "joint_states_0.yaml").write_text("---\n".join(docs))
    csv = root / "fr3.csv"
    assert jax_main(["sync", "fr3", "--base-dirs", str(img_dir), "--joint-dir", str(jdir),
                     "--out", str(csv), "--tolerance", "0.05"]) == 0
    conf = root / "SN.conf"
    conf.write_text(FR3_CONF)
    calib_dir = root / "calib"
    summary = root / "pose1_aruco_pose_summary.json"
    for k, (serial, view) in enumerate(zip(FR3_SERIALS, ("view1", "view2"))):
        jax_main(["calibrate", "intrinsics", "--conf", str(conf), "--serial", serial,
                  "--view", view, "--resolution", "FHD", "--out-dir", str(calib_dir)])
        for c, cam in enumerate(("leftcam", "rightcam")):
            jax_main(["calibrate", "manual", "--view", view, "--cam", cam,
                      "--tvec", str(0.1 * k - 0.05 * c), "-0.3", "2.2",
                      "--rvec-deg", str(5.0 * k), str(3.0 * c - 2.0), "1.5",
                      "--out", str(summary)])
    return {"csv": csv, "calib_dir": calib_dir, "summary": summary, "root": root}
