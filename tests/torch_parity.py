"""Shared pieces of the torch-port parity tests (`tests/test_torch_*.py`).

Both packages get the same inputs and the same weights: inputs come from a
numpy seed, JAX variables are drawn with numpy over a `jax.eval_shape` tree
and cross into the port through the reference's own `save_params_npz` file.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from mvropose_tpu.train.checkpoint import save_params_npz


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
