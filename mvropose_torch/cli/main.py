"""Command line for the torch port: `python -m mvropose_torch sync|group|calibrate|train|eval|visualize|profile|serve ...`.

`sync` and `group` are the reference's (`mvropose_tpu/cli/main.py::_cmd_sync`,
`_cmd_group`) on `data/sync.py` and `data/grouping.py`: the same flags, the
same printed lines, the CSV bytes pandas writes, and `--strict`'s exit 1.

`train` is the port of the reference's `cli train`
(`mvropose_tpu/cli/main.py::_cmd_train`): the synced CSVs (read without
pandas, `data/table.py`) -> the rig (`calib/registry.py`) -> the robot's
dataset and its seeded split (`data/builders.py`) -> per batch the host's
decode and undistortion and the device preprocessing (`data/dataset.py`:
resize, augmentation, normalization, the GT render on the card's kernel) ->
`train/loop.py::fit` (two-group AdamW steps, logs/metrics.jsonl,
best_params.npz beside model_config.json, so `serve --params` reads the
run; checkpoints to resume from). `--robot a,b` trains one single-view model
on several robots (`data/mixed.py`: batches padded to the widest robot, every
robot's angles in radians). `--backbone-ckpt` grafts a DINO checkpoint
(timm, HF DINOv2 or DINOv3 naming; `.pth`, `.pt`, `.bin` or `.npz`) into
the backbone before training (`models/dino_convert.py`). It runs on the
card in bf16 unless `--device cpu` (f32). The train batches are decoded and
undistorted in `--num-workers` worker processes (default 4, or
MVROPOSE_NUM_WORKERS; `data/worker_loader.py`, the reference's grain
stream: an epoch is the floor of the batches, a resumed run reseeds), or
in-process at 0 and for a mixed dataset. `--wandb` also logs to wandb where
it imports. `--mesh` exits naming its ROADMAP.md item.

`calibrate` (intrinsics, manual, extrinsics, corners, stereo-transfer;
`calib/aruco.py`), `visualize` (GT skeleton panels) and `profile` (the
serve model's stages between CUDA events, `utils/timing.py`) are the
reference's commands.

`eval` (`cli/eval.py`) is the port of the reference's `cli eval`, for one
robot and for a mixed-robot checkpoint.

`serve` is the port of the reference's `cli serve` (`mvropose_tpu/cli/main.py::_cmd_serve`)
for every checkpoint kind it serves: the multi-view estimator with the
query, geometric or geometric3d angle head, and the single-view estimator
(query or geometric), which serves the V cameras as one batch and averages
their angles over the unmasked cameras. N camera sources -> one batched
step (preprocess + model + peak decode) per rig tick through the port's
`rig.StreamingPipeline` (a copy of the reference's). `--recover-pose` adds
per-camera RANSAC PnP on FK of the predicted angles to the step
(`pose.recover_pose_batch`), and `--refine-pose` the joint (pose, angles)
refinement. On a calibrated rig (`--calib-dir --camera-keys`) each frame is
undistorted on the device inside the step (`geometry.camera.RemapTaps`, what
the reference's host `cv2.remap` computes), and the pose step takes the
cameras' own K and each view's base rotation; `--summary` adds the ArUco
fallback poses, and gives a geometric3d checkpoint its projection matrices.
No step waits for the device.
`--int8-backbone` (and `--int8-attention` with it) quantize the loaded model
as the reference's flags do; a checkpoint whose model_config.json says
`fused_ln` runs the fused LayerNorm. At `--model-size` 736 and above the
backbone has T >= 2048 tokens and its attention runs the flash kernel on the
card (`ops/attention.py`), as the reference's does on a TPU. `--display
window|dir` draws each tick's keypoints on its frames (`rig/viewer.py`) and
shows the canvas or writes every `--display-every`-th under
`--display-dir`; `--replay-dir` decodes its frames with cv2 and exits
naming it where cv2 cannot be imported.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib.util
import json
import os
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mvropose_torch.calib.registry import (
    FR3_SERIAL_TO_VIEW,
    FR5_SERIAL_TO_VIEW,
    MECA_INSERTION_SERIAL_TO_VIEW,
    RigSpec,
    load_dream_rig,
    load_rig,
)
from mvropose_torch.data import IMAGENET_MEAN, IMAGENET_STD, builders
from mvropose_torch.data.augment import AugmentConfig
from mvropose_torch.data.dataset import make_device_preprocessor
from mvropose_torch.data.grouping import group_by_time_tolerance, tolerance_grid_search
from mvropose_torch.data.mixed import MixedRobotDataset
from mvropose_torch.data.table import concat, read_csv
from mvropose_torch.data.worker_loader import make_worker_loader
from mvropose_torch.decode import decode_keypoints
from mvropose_torch.geometry.camera import RemapTaps, undistort_map
from mvropose_torch.geometry.robots import get_robot
from mvropose_torch.geometry.triangulation import heatmap_projection_matrices
from mvropose_torch.models import (
    EstimatorConfig,
    MultiViewPoseEstimator,
    SingleViewPoseEstimator,
    ViTConfig,
)
from mvropose_torch.models.dino_convert import graft_backbone_ckpt
from mvropose_torch.models.heads import resize_bilinear
from mvropose_torch.models.vit import device_constant
from mvropose_torch.pose import PoseDraws, recover_pose_batch
from mvropose_torch.rig import (
    FileReplaySource,
    StreamingPipeline,
    SyntheticSource,
    draw_keypoints_overlay,
    tile_frames,
)
from mvropose_torch.train import (
    TrainConfig,
    create_train_state,
    make_eval_step,
    make_multi_view_train_step,
    make_single_view_train_step,
)
from mvropose_torch.train.loop import epoch_generator, fit
from mvropose_torch.utils.metrics_writer import MetricWriter
from mvropose_torch.utils.viz import multi_view_panel, prediction_panel
from mvropose_torch.utils.weights import flax_init_state, int8ify, load_jax_params, random_state

KINDS = {"multi_view": MultiViewPoseEstimator, "single_view": SingleViewPoseEstimator}


def read_model_config(params_path):
    """(EstimatorConfig, model_size, kind) from the model_config.json beside a
    params file, or None if there is none."""
    p = Path(params_path).parent / "model_config.json"
    if not p.exists():
        return None
    d = json.loads(p.read_text())
    cfg = EstimatorConfig(
        vit=ViTConfig(**d["vit"]),
        num_joints=d["num_joints"],
        num_angles=d["num_angles"],
        heatmap_size=tuple(d["heatmap_size"]),
        max_views=d["max_views"],
        num_fusion_queries=d["num_fusion_queries"],
        num_angle_queries=d["num_angle_queries"],
        angle_head=d["angle_head"],
    )
    return cfg, int(d["model_size"]), d["kind"]


def write_model_config(run, cfg, model_size: int, kind: str = "multi_view") -> None:
    """model_config.json in `run` (`cfg`, `model_size` and `kind`,
    "multi_view" or "single_view"), the reference's layout: the inverse of
    `read_model_config`."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} is not one of {sorted(KINDS)}")
    run = Path(run)
    run.mkdir(parents=True, exist_ok=True)
    (run / "model_config.json").write_text(json.dumps({
        "kind": kind, "model_size": model_size, "vit": dataclasses.asdict(cfg.vit),
        "num_joints": cfg.num_joints, "num_angles": cfg.num_angles,
        "heatmap_size": list(cfg.heatmap_size), "max_views": cfg.max_views,
        "num_fusion_queries": cfg.num_fusion_queries, "num_angle_queries": cfg.num_angle_queries,
        "angle_head": cfg.angle_head,
    }, indent=2))


def write_run_dir(run, cfg, model_size: int, flat, kind: str = "multi_view") -> None:
    """A run directory as training leaves it, what `serve --params
    RUN/best_params.npz` reads: model_config.json (`write_model_config`)
    beside best_params.npz (`flat`, the reference's flat names)."""
    write_model_config(run, cfg, model_size, kind)
    np.savez(Path(run) / "best_params.npz", **flat)


def preprocess(images_u8: torch.Tensor, model_size: int) -> torch.Tensor:
    """(V, H, W, 3) uint8 frames -> (V, S, S, 3) f32 model input: /255,
    bilinear resize (antialiased on a downscale, as jax.image.resize is),
    ImageNet normalization."""
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    x = resize_bilinear(x, (model_size, model_size))
    mean, std = device_constant(_imagenet_stats, (), x.device)
    return ((x - mean) / std).permute(0, 2, 3, 1)


def _imagenet_stats():
    return IMAGENET_MEAN.reshape(1, 3, 1, 1), IMAGENET_STD.reshape(1, 3, 1, 1)


def nominal_K(image_hw) -> np.ndarray:
    """The reference serve's K for an uncalibrated rig: a 720p-class camera,
    fx = fy = 737 px, the principal point at the frame's centre."""
    H, W = image_hw
    return np.array([[737.0, 0.0, W / 2], [0.0, 737.0, H / 2], [0.0, 0.0, 1.0]], np.float32)


@dataclasses.dataclass
class RigCalibration:
    """What `--calib-dir --camera-keys [--summary]` give the serve, one entry
    a camera in the keys' order: K (V, 3, 3) and the distortion (V, 5) from
    the calibration files, the view names, and the ArUco fallback pose
    (rvec, tvec (V, 3) in radians; valid (V,) False where the summary has no
    record)."""

    Ks: np.ndarray
    dists: np.ndarray
    views: list
    fb_rvec: np.ndarray
    fb_tvec: np.ndarray
    fb_valid: np.ndarray

    @classmethod
    def nominal(cls, views: int, image_hw) -> "RigCalibration":
        """The uncalibrated rig: every camera the nominal K, no distortion,
        no view name (an identity base rotation), no fallback pose."""
        zeros = np.zeros((views, 3), np.float32)
        return cls(np.stack([nominal_K(image_hw)] * views), np.zeros((views, 5), np.float32),
                   [None] * views, zeros, zeros.copy(), np.zeros(views, bool))

    def remap(self, image_hw, device) -> RemapTaps:
        """The cameras' undistortion of (V, H, W, 3) frames, built on `device`."""
        maps = [undistort_map(torch.from_numpy(K).to(device), torch.from_numpy(d).to(device),
                              *image_hw) for K, d in zip(self.Ks, self.dists)]
        return RemapTaps.from_maps(torch.stack(maps))


def _split_key(key: str) -> tuple[str, str]:
    parts = key.split("_")
    if len(parts) < 2 or not all(parts[:2]):
        raise SystemExit(f"--camera-keys: {key!r} is not a '{{view}}_{{cam}}' key")
    return parts[0], parts[1]


def read_calibration(calib_dir, camera_keys: str, views: int) -> RigCalibration:
    """Each key's `{view}_*_{cam}_calib.json` in `calib_dir` (what `cli
    calibrate intrinsics` writes: camera_matrix, distortion_coeffs), the
    first in name order, as the reference's serve reads it. Exits where the
    key count is not `views` or a key has no file."""
    keys = camera_keys.split(",")
    if len(keys) != views:
        raise SystemExit(f"--camera-keys lists {len(keys)} cameras, --views is {views}: "
                         "one key per view")
    Ks, dists, names = [], [], []
    for key in keys:
        view, cam = _split_key(key)
        matches = sorted(Path(calib_dir).glob(f"{view}_*_{cam}_calib.json"))
        if not matches:
            raise SystemExit(f"no calibration file {view}_*_{cam}_calib.json for camera key "
                             f"{key} in {calib_dir}")
        data = json.loads(matches[0].read_text())
        Ks.append(np.asarray(data["camera_matrix"], np.float32).reshape(3, 3))
        dists.append(np.asarray(data["distortion_coeffs"], np.float32).reshape(-1))
        names.append(view)
    zeros = np.zeros((views, 3), np.float32)
    return RigCalibration(np.stack(Ks), np.stack(dists), names, zeros, zeros.copy(),
                          np.zeros(views, bool))


def read_fallback_poses(calib: RigCalibration, summary, camera_keys: str, robot) -> None:
    """Fill `calib`'s fallback poses from an ArUco summary (`cli calibrate
    extrinsics` / `manual`: records of view, cam, rvec_x..z, tvec_x..z and
    an optional rvec_unit, which wins over the robot's
    `extrinsic_rvec_unit`; degrees are converted). A key without a record
    stays invalid."""
    by_key = {f"{r['view']}_{r['cam']}": r for r in json.loads(Path(summary).read_text())}
    for i, key in enumerate(camera_keys.split(",")):
        rec = by_key.get(key)
        if rec is None:
            continue
        rv = np.array([rec["rvec_x"], rec["rvec_y"], rec["rvec_z"]], np.float64)
        if rec.get("rvec_unit", robot.extrinsic_rvec_unit) == "deg":
            rv = np.deg2rad(rv)
        calib.fb_rvec[i] = rv
        calib.fb_tvec[i] = [rec["tvec_x"], rec["tvec_y"], rec["tvec_z"]]
        calib.fb_valid[i] = True


class PoseStep:
    """Pose recovery on the serve tick, as the reference's serve `recover`
    (`mvropose_tpu/cli/main.py:1630-1691`): on a calibrated rig (`calib`)
    the cameras' own K, each view's base rotation (`robot.base_rotation`)
    and the ArUco fallback poses; else the nominal K (`nominal_K`), identity
    bases and no fallback. A camera whose recovery fails takes its fallback
    pose where it has one (`~success & fb_valid`). Its draws are made once,
    from a generator seeded 0 on the device, and used every tick: the
    reference passes PRNGKey(0) every tick, and resident draws keep the step
    free of host work. The arguments are the serve flags `--pose-robot`,
    `--refine-pose`, `--refine-sigma-px` and `--refine-sigma-prior`."""

    def __init__(self, views: int, image_hw, device, angles: int, robot: str = "fr3",
                 refine: bool = False, sigma_px: float = 1.2, sigma_prior: float = 0.2,
                 calib: RigCalibration | None = None):
        self.image_hw = tuple(image_hw)
        self.robot = get_robot(robot)
        self.refine, self.sigma_px, self.sigma_prior = refine, sigma_px, sigma_prior
        device = torch.device(device)
        if calib is None:
            calib = RigCalibration.nominal(views, image_hw)
        as_tensor = lambda a, dtype=torch.float32: torch.tensor(  # noqa: E731
            np.asarray(a), dtype=dtype, device=device)
        self.Ks = as_tensor(calib.Ks)
        self.bases = as_tensor(np.stack([self.robot.base_rotation(v) for v in calib.views]))
        self.fb_rvec, self.fb_tvec = as_tensor(calib.fb_rvec), as_tensor(calib.fb_tvec)
        self.fb_valid = as_tensor(calib.fb_valid, torch.bool)
        gen = torch.Generator(device).manual_seed(0)
        self.draws = PoseDraws.draw((), views, self.robot.n_keypoints, angles, refine, gen,
                                    device)

    def __call__(self, hm: torch.Tensor, ang: torch.Tensor):
        """(V, J, h, w) heatmaps, (1, A) angles -> (keypoints, confidence,
        angles, rvec (V, 3), tvec (V, 3), success (V,))."""
        pose = recover_pose_batch(hm, ang[0], self.bases, self.Ks, self.robot, self.image_hw,
                                  draws=self.draws, refine=self.refine,
                                  refine_sigma_px=self.sigma_px,
                                  refine_sigma_prior=self.sigma_prior)
        use_fb = (~pose["success"] & self.fb_valid)[:, None]
        rvec = torch.where(use_fb, self.fb_rvec, pose["rvec"])
        tvec = torch.where(use_fb, self.fb_tvec, pose["tvec"])
        return pose["keypoints_xy"], pose["confidence"], ang, rvec, tvec, pose["success"]


def serve_step(model, images_u8, mask, model_size: int, image_hw, pose: PoseStep | None = None,
               remap: RemapTaps | None = None, proj_mats: torch.Tensor | None = None,
               single_view: bool = False):
    """One rig tick on the model's device: (V, H, W, 3) uint8 frames + (V,)
    mask -> (keypoints (V, J, 2) image px, confidence (V, J), angles (1, A)),
    and with `pose` also (rvec (V, 3), tvec (V, 3), success (V,)).

    `remap` undistorts the frames first; `proj_mats` (1, V, 3, 4) go to a
    multi-view model (the geometric3d head's); a `single_view` model runs
    the V frames as one batch, and the angles are the mean of its per-camera
    angles over the unmasked cameras (zeros where none is)."""
    if remap is not None:
        images_u8 = remap(images_u8)
    imgs = preprocess(images_u8, model_size)
    if single_view:
        hm, ang_per_camera = model(imgs)  # (V, J, h, w), (V, A)
        m = mask.to(ang_per_camera.dtype)[:, None]
        ang = ((ang_per_camera * m).sum(0) / m.sum().clamp(min=1.0))[None]
        hm = hm[None]
    else:
        view_ids = torch.arange(imgs.shape[0], device=imgs.device)[None]
        hm, ang = model(imgs[None], view_ids, mask[None], proj_mats=proj_mats)
    if pose is not None:
        return pose(hm[0], ang)
    xy, conf = decode_keypoints(hm[0], image_hw=image_hw)
    return xy, conf, ang


class ServeRunner:
    """Host <-> device staging for `StreamingPipeline`.

    `dispatch` copies a frame set into one of two pinned host buffers (used
    in turn), enqueues the non-blocking upload and the serve step, enqueues
    non-blocking copies of the results into pinned host tensors and records
    an event; it does not wait for the device. `fetch` waits on that event
    only. So in the double-buffered loop the host gathers and uploads set
    N+1 while the device computes set N. On a CPU device both are plain
    synchronous calls. `step(frames, mask)` is the tick's device work
    (`serve_step` with its model and options bound).
    """

    def __init__(self, step, views: int, image_hw, device):
        self.step, self.image_hw = step, tuple(image_hw)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        H, W = self.image_hw
        pin = dict(pin_memory=self.cuda)
        self._frames = [torch.empty((views, H, W, 3), dtype=torch.uint8, **pin) for _ in range(2)]
        self._masks = [torch.empty((views,), dtype=torch.bool, **pin) for _ in range(2)]
        self._uploaded = [None, None]  # event after each buffer's upload
        self._turn = 0

    def dispatch(self, images: np.ndarray, mask: np.ndarray):
        i = self._turn
        self._turn ^= 1
        if self._uploaded[i] is not None:
            self._uploaded[i].synchronize()  # the buffer's previous upload is done
        self._frames[i].numpy()[...] = images
        self._masks[i].numpy()[...] = mask
        with torch.inference_mode():
            frames = self._frames[i].to(self.device, non_blocking=True)
            m = self._masks[i].to(self.device, non_blocking=True)
            if self.cuda:
                self._uploaded[i] = torch.cuda.Event()
                self._uploaded[i].record()
            outs = self.step(frames, m)
            if not self.cuda:
                return None, outs
            host = tuple(
                torch.empty(o.shape, dtype=o.dtype, pin_memory=True).copy_(o, non_blocking=True)
                for o in outs
            )
            done = torch.cuda.Event()
            done.record()
        return done, host

    @staticmethod
    def fetch(handle):
        done, host = handle
        if done is not None:
            done.synchronize()
        return tuple(t.numpy().copy() for t in host)

    def infer(self, images: np.ndarray, mask: np.ndarray):
        return self.fetch(self.dispatch(images, mask))


def _serve_model(args):
    """(model, model_size, kind) for the serve flags or the checkpoint's
    config. With --recover-pose the heads' arity is the robot's (heatmaps =
    keypoints, angles = joints), and a checkpoint of another arity exits."""
    saved = read_model_config(args.params) if args.params else None
    n_joints, n_angles = 8, 7
    if args.recover_pose:
        robot = get_robot(args.pose_robot)
        n_joints, n_angles = robot.n_keypoints, robot.n_joints
    if saved is not None:
        cfg, model_size, kind = saved
        if kind not in KINDS:
            raise SystemExit(f"model_config.json: unknown kind {kind!r}")
        if kind == "multi_view" and args.views > cfg.max_views:
            raise SystemExit(f"--views {args.views} exceeds the trained max_views {cfg.max_views}")
        if args.recover_pose and (cfg.num_joints, cfg.num_angles) != (n_joints, n_angles):
            raise SystemExit(
                f"--pose-robot {args.pose_robot} expects {n_joints} keypoints/{n_angles} angles "
                f"but the checkpoint has {cfg.num_joints}/{cfg.num_angles}"
            )
        print(f"model architecture restored from {Path(args.params).parent / 'model_config.json'}")
    else:
        kind, model_size = "multi_view", args.model_size
        vit = ViTConfig(
            image_size=args.backbone_native_size or args.model_size,
            patch_size=args.patch_size, hidden_size=args.hidden_size,
            num_layers=args.num_layers, num_heads=args.hidden_size // 64,
            num_register_tokens=args.register_tokens, dtype="bfloat16",
            use_rope=args.rope, layer_norm_eps=1e-5 if args.rope else 1e-6,
        )
        cfg = EstimatorConfig(vit=vit, num_joints=n_joints, num_angles=n_angles,
                              max_views=args.views, angle_head=args.angle_head)
    try:
        model = KINDS[kind](cfg, device=args.device).eval()
    except ValueError as e:  # a single-view geometric3d checkpoint, as the reference
        raise SystemExit(f"{kind} checkpoint: {e}") from e
    flat = None
    if args.params:
        with np.load(args.params) as data:
            flat = {k: data[k] for k in data.files}
        load_jax_params(model, flat)
    else:
        model.load_state_dict(random_state(model, seed=0))
        print("no --params: random weights from seed 0")
    if args.int8_backbone:
        int8ify(model, flat, attn=args.int8_attention)
        print(
            "backbone quantized to int8 (per-channel weights, dynamic per-token "
            "activations)" + (" + int8-prob attention" if args.int8_attention else "")
        )
    return model, model_size, kind


def _check_flags(args) -> None:
    """Exit on flags that cannot run together, before anything is made."""
    if args.int8_attention and not args.int8_backbone:
        raise SystemExit("--int8-attention runs only with --int8-backbone")
    if args.refine_pose and not args.recover_pose:
        raise SystemExit("--refine-pose runs only with --recover-pose")
    if bool(args.calib_dir) != bool(args.camera_keys):
        raise SystemExit("--calib-dir and --camera-keys run only together: the keys name each "
                         "view's calibration file in the directory")
    if args.summary and not (args.calib_dir and args.recover_pose):
        raise SystemExit("--summary runs only with --calib-dir, --camera-keys and "
                         "--recover-pose: its fallback poses stand in for failed recoveries "
                         "of the calibrated cameras")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")


def make_display(mode: str, names: list, links, frame_hw, display_dir, every: int):
    """The serve loop's live view, as the reference's (`mvropose_tpu/cli/
    main.py:1778-1830`, the original project's cv2.imshow canvas loop): each
    camera's frame with its keypoints and links drawn where their confidence
    is at least 0.6, a placeholder panel for a camera without a frame, the
    cameras tiled in one row (two rows from 3 cameras). `mode` "window"
    shows the canvas (cv2.imshow; 'q' quits), "dir" writes every `every`-th
    canvas from the first as `display_dir/canvas_<n>.png`. -> (on_result(
    result, frames), a dict whose "q" turns True on 'q'). Two faults of the
    reference are mended: its row of 2 cameras holds only the first, and
    at `every` 1 it writes no canvas (`ROADMAP.md`, deliberate differences)."""
    import cv2

    half = (len(names) + 1) // 2
    layout = ((tuple(names),) if len(names) <= 2
              else (tuple(names[:half]), tuple(names[half:])))
    display_dir = Path(display_dir)
    if mode == "dir":
        display_dir.mkdir(parents=True, exist_ok=True)
    quit_flag = {"q": False}
    ticks = {"n": 0}

    def on_result(result, frames):
        xy, conf = np.asarray(result[0]), np.asarray(result[1])
        panels = {}
        for i, f in enumerate(frames):
            panels[names[i]] = (None if f is None else draw_keypoints_overlay(
                f.image, xy[i], links, scores=conf[i], min_score=0.6))
        canvas = tile_frames(panels, layout=layout, frame_hw=frame_hw)
        ticks["n"] += 1
        if mode == "window":
            cv2.imshow("mvropose_torch serve", canvas[:, :, ::-1])
            if (cv2.waitKey(1) & 0xFF) == ord("q"):
                quit_flag["q"] = True
        elif (ticks["n"] - 1) % every == 0:
            cv2.imwrite(str(display_dir / f"canvas_{ticks['n']:06d}.png"), canvas[:, :, ::-1])

    return on_result, quit_flag


def serve(args):
    """Run the serve loop for `args.duration` seconds.

    Returns (StreamStats, last fetched result (keypoints, confidence, angles,
    and with --recover-pose rvec, tvec, success) as numpy arrays)."""
    _check_flags(args)
    hw = tuple(args.frame_hw)
    calib = None
    if args.calib_dir:
        calib = read_calibration(args.calib_dir, args.camera_keys, args.views)
        if args.summary:
            read_fallback_poses(calib, args.summary, args.camera_keys, get_robot(args.pose_robot))
    if args.replay_dir:
        if importlib.util.find_spec("cv2") is None:
            # Otherwise every replay source fails in its thread, and serve
            # exits saying only that no camera source initialized.
            raise SystemExit(
                "serve --replay-dir decodes frames with cv2, which cannot be imported here; "
                "a frame reader that runs without it is ROADMAP.md queue 1, item 7"
            )
        paths = sorted(Path(args.replay_dir).glob("*.jpg")) + sorted(
            Path(args.replay_dir).glob("*.png")
        )
        chunks = np.array_split(np.asarray(paths, dtype=object), args.views)
        sources = [
            FileReplaySource(f"replay{i}", list(chunks[i]), fps=args.fps)
            for i in range(args.views)
        ]
    else:
        sources = [
            SyntheticSource(f"synthetic{i}", hw=hw, fps=args.fps) for i in range(args.views)
        ]
    model, model_size, kind = _serve_model(args)
    proj_mats = None
    if model.cfg.angle_head == "geometric3d":
        # The reference's two exits: the DLT branch needs the rig's projection
        # matrices, made from the summary's extrinsics and the calibrated K.
        if not (args.recover_pose and args.summary and calib is not None):
            raise SystemExit("a geometric3d checkpoint needs --recover-pose --summary "
                             "--calib-dir/--camera-keys so the rig's projection matrices can "
                             "feed the triangulation branch")
        if not calib.fb_valid.all():
            raise SystemExit("--summary is missing extrinsics for some --camera-keys")
        proj_mats = heatmap_projection_matrices(
            *(torch.from_numpy(a).to(args.device) for a in (calib.fb_rvec, calib.fb_tvec,
                                                            calib.Ks)),
            hw, model.cfg.heatmap_size)[None]
    pose = None
    if args.recover_pose:
        pose = PoseStep(args.views, hw, args.device, model.cfg.num_angles, args.pose_robot,
                        args.refine_pose, args.refine_sigma_px, args.refine_sigma_prior, calib)
    step = functools.partial(
        serve_step, model, model_size=model_size, image_hw=hw, pose=pose,
        remap=None if calib is None else calib.remap(hw, args.device), proj_mats=proj_mats,
        single_view=kind == "single_view")
    runner = ServeRunner(step, args.views, hw, args.device)
    on_result, quit_flag = None, {"q": False}
    if args.display != "off":
        # The pose robot's links with --recover-pose, else a chain over the
        # checkpoint's keypoints (not the default robot's).
        links = (get_robot(args.pose_robot).links if args.recover_pose
                 else tuple((i, i + 1) for i in range(model.cfg.num_joints - 1)))
        on_result, quit_flag = make_display(args.display, [src.serial for src in sources], links,
                                            hw, args.display_dir, args.display_every)
    if args.no_overlap:
        pipe = StreamingPipeline(sources, runner.infer, on_result=on_result, frame_hw=hw,
                                 max_skew_s=args.max_skew)
    else:
        pipe = StreamingPipeline(sources, runner.dispatch, on_result=on_result, frame_hw=hw,
                                 max_skew_s=args.max_skew, fetch_fn=runner.fetch)
    last = None
    pipe.start()
    try:
        print(f"active cameras: {len(pipe.active)}, failed: {len(pipe.failed)}")
        if not pipe.active:
            raise SystemExit("serve: every camera source failed to initialize")
        # Warm-up until a first result comes back, bounded: a frame-size
        # mismatch or a rig whose cameras all died must not spin forever.
        warmup_deadline = time.perf_counter() + max(60.0, args.duration)
        while (last := pipe.tick()) is None:
            if time.perf_counter() >= warmup_deadline:
                raise SystemExit(
                    f"serve: no frame inferred within {max(60.0, args.duration):.0f}s - "
                    f"{pipe.stats.skipped_resolution} frames were dropped for not "
                    f"matching --frame-hw {hw}"
                )
            time.sleep(0.0005)
        if quit_flag["q"]:  # 'q' in the window during the warm-up
            return pipe.stats, last
        pipe.stats = type(pipe.stats)(
            start_time_s=time.perf_counter(), overlapped=pipe.fetch_fn is not None
        )
        end = time.perf_counter() + args.duration
        while time.perf_counter() < end and not quit_flag["q"]:
            before = pipe.stats.ticks
            out = pipe.tick()
            if out is not None:
                last = out
            if pipe.stats.ticks == before:
                time.sleep(0.0005)  # no new frames: do not burn the core
        if pipe.fetch_fn is not None and (out := pipe.drain()) is not None:
            last = out
        pipe.stats.end_time_s = time.perf_counter()
        return pipe.stats, last
    finally:
        pipe.stop()
        if args.display == "window":
            import cv2

            cv2.destroyAllWindows()


def _cmd_serve(args) -> int:
    stats, _ = serve(args)
    print(
        f"served {stats.ticks} ticks ({stats.frames_processed} camera frames) "
        f"at {stats.fps:.2f} tick/s = {stats.camera_fps:.2f} camera-frames/s"
    )
    if stats.overlapped and stats.ticks:
        print(
            f"overlap: host {1e3 * stats.total_step_time_s / stats.ticks:.1f} ms/tick "
            f"+ fetch {1e3 * stats.total_fetch_time_s / stats.ticks:.1f} ms/tick "
            f"(wall {1e3 / max(stats.fps, 1e-9):.1f} ms/tick)"
        )
    return 0


def _cmd_sync(args) -> int:
    """Sync a robot's images with its joint log into one CSV."""
    from mvropose_torch.data import sync as S

    cfg = S.SyncConfig(tolerance_s=args.tolerance, image_delay_s=args.image_delay)
    if args.robot == "fr3" and importlib.util.find_spec("yaml") is None:
        raise SystemExit("cli sync fr3 reads the ROS2 joint streams with PyYAML, which cannot "
                         "be imported here")
    table = {
        "fr5": lambda: S.sync_fr5(args.base_dirs, cfg),
        "fr3": lambda: S.sync_fr3(args.base_dirs, args.joint_dir, cfg),
        "dream": lambda: concat(S.sync_dream(d) for d in args.base_dirs),
        "meca500": lambda: S.sync_meca500(args.base_dirs[0], args.joint_dir),
        "meca_insertion": lambda: S.sync_meca_insertion(args.base_dirs, args.joint_dir, cfg),
    }[args.robot]()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    table.to_csv(args.out)
    print(f"synced {len(table)} rows -> {args.out}")
    if args.strict and len(table) == 0:
        print("error: --strict and no rows matched (check paths/tolerance)", file=sys.stderr)
        return 1
    return 0


def _cmd_group(args) -> int:
    """The grouping's tolerance grid (0.05 to 0.10 s), then the groups at
    --tolerance."""
    df = read_csv(args.csv)
    cands = np.round(np.arange(0.05, 0.101, 0.01), 2)
    best, dist = tolerance_grid_search(df, cands, args.max_views, ts_col=args.ts_col)
    for tol, counts in dist.items():
        print(f"tolerance {tol:.2f}: {dict(sorted(counts.items(), reverse=True))}")
    print(f"recommended tolerance: {best}")
    groups = group_by_time_tolerance(df, args.tolerance, args.max_views, ts_col=args.ts_col,
                                     min_views=args.min_views)
    print(f"final: {len(groups)} groups at tolerance {args.tolerance}")
    if args.out:
        Path(args.out).write_text(json.dumps(groups, default=str))
        print(f"wrote {args.out}")
    return 0


# cli train: the flags that exit, each naming the ROADMAP.md item that ports it.
UNPORTED_TRAIN_FLAGS = (
    (lambda a: a.mesh is not None, "--mesh (multi-device training)", "queue 1, item 10"),
)
SERIAL_MAPS = {
    "fr5": FR5_SERIAL_TO_VIEW,
    "fr3": FR3_SERIAL_TO_VIEW,
    "meca500": {"41182735": "front"},
    "dream_panda": {"00000000": "cam"},
    "meca_insertion": MECA_INSERTION_SERIAL_TO_VIEW,
}


def robot_arg(value: str) -> str:
    """A robot name or a comma list of them (mixed-robot training)."""
    valid = {"fr5", "fr3", "dream", "meca500", "meca_insertion"}
    names = [v.strip() for v in value.split(",")]
    bad = [n for n in names if n not in valid]
    if bad or not names:
        raise argparse.ArgumentTypeError(
            f"unknown robot(s) {bad}; choose from {sorted(valid)} "
            "(comma-separate for mixed training)")
    return ",".join(names)


def load_rig_from_args(args) -> RigSpec:
    """The rig of `--robot`, `--calib-dir`, `--aruco-summary` (a summary
    named pose<N>_... keys its extrinsics with that pose prefix, FR3's
    pose1/pose2; several unprefixed summaries merge) and `--sigma`, or
    `--dream-dirs` for DREAM, as the reference's `_load_rig_from_args`."""
    if args.robot == "dream" and args.dream_dirs:
        return load_dream_rig(args.dream_dirs, sigma=args.sigma)
    robot = {"meca_insertion": "meca500", "dream": "dream_panda"}.get(args.robot, args.robot)
    aruco = None
    if args.aruco_summary:
        aruco = {}
        for path in map(Path, args.aruco_summary):
            tok = path.stem.split("_")[0]
            aruco.setdefault(tok if re.fullmatch(r"pose\d+", tok) else "", []).append(path)
    return load_rig(args.robot, robot, SERIAL_MAPS.get(args.robot, {}),
                    calib_dir=args.calib_dir, aruco_summary_paths=aruco, sigma=args.sigma)


def check_runtime(args, command: str) -> torch.device:
    """Exit, before anything is read, where the captured images cannot be
    decoded (no cv2) or the card asked for is missing -> the device."""
    if importlib.util.find_spec("cv2") is None:
        raise SystemExit(f"cli {command} decodes the captured images with cv2, which cannot "
                         "be imported here")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available (pass "
                         "--device cpu for an f32 run on the CPU)")
    return torch.device(args.device)


def _check_train_flags(args) -> None:
    """Exit, before anything is read, on a flag the port does not run yet, on
    a missing image decoder or a missing card."""
    for hit, flag, item in UNPORTED_TRAIN_FLAGS:
        if hit(args):
            raise SystemExit(f"{flag} is not ported yet (ROADMAP.md {item})")
    check_runtime(args, "train")


SINGLE_VIEW_BUILDERS = {
    "fr5": builders.build_fr5_single_view,
    "fr3": builders.build_fr3_single_view,
    "dream": builders.build_dream_single_view,
    "meca500": builders.build_meca500_single_view,
    "meca_insertion": builders.build_meca_insertion_single_view,
}


def build_single_robot_dataset(args, rig: RigSpec, image_hw):
    """(dataset, multi_view) of the synced CSVs for one robot: FR3's
    multi-view groups unless --single-view, else the robot's single-view
    samples."""
    df = concat(read_csv(c) for c in args.csv)
    if args.robot == "fr3" and not args.single_view:
        return builders.build_fr3_multi_view(df, rig, image_hw, tolerance_s=args.tolerance), True
    return SINGLE_VIEW_BUILDERS[args.robot](df, rig, image_hw), False


def build_mixed_dataset(args, image_hw) -> MixedRobotDataset:
    """The mixed-robot dataset of `--robot a,b,..`: each robot's single-view
    samples from its own --csv (in --robot order) on its own rig, the
    calibration and ArUco files shared."""
    robots = args.robot.split(",")
    children = []
    for name, csv_path in zip(robots, args.csv):
        sub = argparse.Namespace(**{**vars(args), "robot": name})
        children.append(SINGLE_VIEW_BUILDERS[name](read_csv(csv_path), load_rig_from_args(sub),
                                                   image_hw))
    return MixedRobotDataset(children, robots)


def _mixed_refusals(args) -> None:
    """The reference's exits of a mixed-robot run."""
    robots = args.robot.split(",")
    if len(args.csv) != len(robots):
        raise SystemExit(f"--robot {args.robot} needs exactly {len(robots)} --csv files (one per "
                         "robot, in order)")
    if args.fk_loss_weight > 0:
        # The term would need a per-robot FK chain and per-robot extrinsics
        # in the padded batches.
        raise SystemExit("--fk-loss-weight is not supported with mixed robots")
    if args.angle_head == "geometric3d":
        raise SystemExit("mixed-robot training supports --angle-head query or geometric "
                         "(geometric3d is multi-view only)")


def _train_refusals(args, rig: RigSpec, ds, multi_view: bool) -> None:
    """The reference's refusals of the FK-consistency term, and one of its
    silent drops: the multi-view step has no FK term."""
    if args.fk_loss_weight <= 0:
        return
    if multi_view:
        raise SystemExit("--fk-loss-weight is a term of the single-view step: add "
                         "--single-view")
    if not rig.extrinsics:
        raise SystemExit("--fk-loss-weight needs calibrated extrinsics (an ArUco summary); "
                         f"the {args.robot} rig has none")
    if any(s.roi is not None for s in ds.samples):
        raise SystemExit("--fk-loss-weight is not supported with ROI-cropped datasets "
                         "(keypoints are in the crop frame, the FK projection in the full "
                         "camera frame)")


def host_to_device(x, device: torch.device) -> torch.Tensor:
    """A host array or CPU tensor on `device`; to a card through pinned
    memory (pinned here unless the loader pinned it), without waiting."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return (t if t.is_pinned() else t.pin_memory()).to(device, non_blocking=True)
    return t


def train(args):
    """Train one robot's estimator on captured images -> `fit`'s result.

    The synced CSVs (read without pandas) -> the rig -> the dataset and its
    seeded train/val split -> per batch the host decode and undistortion,
    then the device preprocessing (resize, augmentation, normalization, the
    GT render) -> the two-group AdamW steps of `fit`, which writes
    logs/metrics.jsonl, best_params.npz and a checkpoint an epoch under
    `--workdir`, and resumes from the newest one. On the card the model
    computes in bf16 with f32 parameters, on the CPU in f32."""
    _check_train_flags(args)
    device = torch.device(args.device)
    dtype = "float32" if device.type == "cpu" else "bfloat16"
    image_hw = tuple(args.image_hw)
    mixed = "," in args.robot
    if mixed:
        _mixed_refusals(args)
        ds, multi_view = build_mixed_dataset(args, image_hw), False
        for name, child in zip(ds.robot_names, ds.children):
            print(f"  {name}: {len(child)} samples")
        rig = ds.children[0].geometry.rig  # the image, heatmap and sigma of the batches
    else:
        rig = load_rig_from_args(args)
        ds, multi_view = build_single_robot_dataset(args, rig, image_hw)
        _train_refusals(args, rig, ds, multi_view)
    if args.fk_loss_weight > 0 or (multi_view and args.angle_head == "geometric3d"):
        ds.with_extrinsics = True  # per-sample cameras: the FK term's or the DLT's
    train_ds, val_ds = builders.train_val_split(ds, args.val_split)
    print(f"dataset: {len(train_ds)} train / {len(val_ds)} val")
    if len(train_ds) == 0:
        raise SystemExit("no training samples: check --csv, --calib-dir and --aruco-summary")
    # Worker processes decode and undistort (`data/worker_loader.py`) where
    # the dataset is one robot's and holds a full batch, as the reference's
    # grain loader: its stream drops the last partial batch. A mixed
    # dataset's batches pad each robot's samples: in-process.
    use_workers = args.num_workers > 0 and not mixed and len(train_ds) >= args.batch_size
    if args.num_workers > 0 and not use_workers:
        print("note: --num-workers parallel loading needs a non-mixed dataset with >= 1 "
              "full batch; using in-process loading")

    vit = ViTConfig(
        image_size=args.backbone_native_size or args.model_size, patch_size=args.patch_size,
        hidden_size=args.hidden_size, num_layers=args.num_layers,
        num_heads=args.hidden_size // 64, num_register_tokens=args.register_tokens,
        dtype=dtype, use_rope=args.rope, layer_norm_eps=1e-5 if args.rope else 1e-6,
    )
    freeze = not args.no_freeze_backbone
    # A mixed run's heads are as wide as its widest robot.
    cfg = EstimatorConfig(
        vit=vit, num_joints=ds.num_keypoints if mixed else rig.num_keypoints,
        num_angles=ds.num_angles if mixed else rig.robot.n_joints,
        heatmap_size=rig.heatmap_size, max_views=2 * len(rig.serial_to_view),
        freeze_backbone=freeze, dtype=dtype, angle_head=args.angle_head,
    )
    kind = "multi_view" if multi_view else "single_view"
    try:
        model = KINDS[kind](cfg, device=device)
    except ValueError as e:  # a single-view geometric3d model, as the reference
        raise SystemExit(f"{kind}: {e}") from e
    model.load_state_dict(flax_init_state(model, seed=0))
    if args.backbone_ckpt:
        try:
            graft_backbone_ckpt(model.backbone, args.backbone_ckpt)
        except (KeyError, ValueError) as e:  # a config the checkpoint does not fit
            raise SystemExit(str(e)) from e
        print(f"loaded backbone weights from {args.backbone_ckpt}")
    write_model_config(args.workdir, cfg, args.model_size, kind)

    tcfg = TrainConfig(
        num_epochs=args.epochs,
        # The datasets pad the last batch, so in-process an epoch is
        # ceil(len / batch) steps (a floor would end the cosine schedule
        # early); the workers' stream drops it: floor.
        steps_per_epoch=(len(train_ds) // args.batch_size if use_workers
                         else max(1, -(-len(train_ds) // args.batch_size))),
        lr_kpt=args.lr_kpt, lr_ang=args.lr_ang, loss_weight_kpt=args.loss_weight_kpt,
        loss_weight_fk=args.fk_loss_weight, freeze_backbone=freeze,
    )
    aug_cfg = None if args.no_augment else AugmentConfig()
    pre = make_device_preprocessor(ds.geometry, args.model_size, rig.heatmap_size, rig.sigma,
                                   augment_cfg=aug_cfg, device=device)

    def to_device(batch: dict, generator=None) -> dict:
        put = functools.partial(host_to_device, device=device)
        imgs, hms = pre(put(batch["images_u8"]), put(batch["cam_idx"]),
                        put(batch["keypoints_2d"]), generator)
        out = {"images": imgs, "heatmaps": hms, "angles": put(batch["angles"])}
        if multi_view:
            out.update(view_ids=put(batch["view_ids"]), view_mask=put(batch["view_mask"]))
            if args.angle_head == "geometric3d":
                rv, tv, K = (put(batch[k]) for k in ("rvec", "tvec", "K"))
                B, V = rv.shape[:2]
                out["proj_mats"] = heatmap_projection_matrices(
                    rv.reshape(B * V, 3), tv.reshape(B * V, 3), K.reshape(B * V, 3, 3),
                    image_hw, rig.heatmap_size).reshape(B, V, 3, 4)
        else:
            out["sample_weight"] = put(batch["sample_weight"])
            out.update((k, put(batch[k]))
                       for k in ("rvec", "tvec", "K", "base_rotation", "angle_mask") if k in batch)
            if args.fk_loss_weight > 0:
                out["keypoints_2d"] = put(batch["keypoints_2d"])
        return out

    stream = None

    def train_batches(epoch: int):
        nonlocal stream
        # Augmentation draws of an epoch come from (seed, epoch), as dropout's.
        gen = epoch_generator(args.seed, epoch, device, stream=1) if aug_cfg else None
        if not use_workers:
            for b in train_ds.batches(args.batch_size, shuffle=True, seed=epoch):
                yield to_device(b, gen)
            return
        # One endless stream, its workers warm across epochs; an epoch is
        # steps_per_epoch of its batches. It starts at the first epoch this
        # call trains, seeded from that epoch, so a resumed run draws a new
        # order rather than replaying epoch 0's.
        if stream is None:
            if epoch > 0:
                print(f"grain: resuming at epoch {epoch}; stream reseeded with seed "
                      f"{args.seed} + epoch (sample order differs from an uninterrupted run, "
                      "matching the serial path's per-epoch reshuffle semantics)")
            stream = make_worker_loader(train_ds, args.batch_size,
                                        seed=args.seed + 1000003 * epoch,
                                        num_workers=args.num_workers, num_epochs=None,
                                        pin_memory=device.type == "cuda")
        for _ in range(tcfg.steps_per_epoch):
            yield to_device(next(stream), gen)

    def val_batches():
        for b in val_ds.batches(args.batch_size):
            yield to_device(b)

    step = (make_multi_view_train_step(tcfg) if multi_view
            else make_single_view_train_step(tcfg, robot=rig.robot))
    state = create_train_state(model, tcfg)
    eval_step = make_eval_step(tcfg, multi_view)
    writer = MetricWriter(Path(args.workdir) / "logs", use_wandb=args.wandb)

    def on_epoch_end(epoch, state_, record):
        """Every `--viz-every` epochs a panel of the first val batch's
        predictions against its GT (the original project's pred-vs-GT overlays)."""
        if (epoch + 1) % args.viz_every != 0:
            return
        batch = next(iter(val_batches()), None)
        if batch is None:
            return
        out = eval_step(state_, batch)
        imgs, gt = batch["images"][0].cpu().numpy(), batch["heatmaps"][0].cpu().numpy()
        pred = out["pred_heatmaps"][0].float().cpu().numpy()
        if multi_view:
            panel = multi_view_panel(imgs, gt, pred, batch["view_mask"][0].cpu().numpy())
        else:
            panel = prediction_panel(imgs, gt, pred)
        writer.write_image(state_.step, "val_predictions", panel)

    try:
        result = fit(state, step, eval_step, train_batches, val_batches, tcfg, args.workdir,
                     writer, seed=args.seed, on_epoch_end=on_epoch_end)
    finally:
        writer.close()
        if stream is not None:
            stream.close()
    print(f"done: best val loss {result.best_val_loss:.6f} over {result.epochs_run} epochs")
    return result


def _cmd_train(args) -> int:
    train(args)
    return 0


def _cmd_eval(args) -> int:
    from mvropose_torch.cli.eval import cmd_eval

    return cmd_eval(args)


def _detections_by_camera(aruco_dir) -> dict:
    """{(view, cam): {marker id: [detections]}} from the capture files
    `view_*_cam_*.json` of `aruco_dir`, in name order."""
    from collections import defaultdict

    per_cam: dict = defaultdict(lambda: defaultdict(list))
    for f in sorted(Path(aruco_dir).glob("*.json")):
        parts = f.name.split("_")
        for mid, det in json.loads(f.read_text()).items():
            per_cam[(parts[0], parts[2])][mid].append(det)
    return per_cam


def _pose_record(view: str, cam: str, pose: dict) -> dict:
    """A summary record of `compute_view_pose`'s radians."""
    return {
        "view": view, "cam": cam,
        "tvec_x": float(pose["tvec"][0]), "tvec_y": float(pose["tvec"][1]),
        "tvec_z": float(pose["tvec"][2]),
        "rvec_x": float(pose["rvec"][0]), "rvec_y": float(pose["rvec"][1]),
        "rvec_z": float(pose["rvec"][2]),
        "rvec_unit": "rad",
        "n_markers": pose["n_markers"],
    }


def _view_offsets(offsets: dict, view: str) -> dict:
    return {mid: np.asarray(v) for mid, v in offsets.get(view, {}).items()}


def _cmd_calibrate(args) -> int:
    """The reference's `cli calibrate` (`mvropose_tpu/cli/main.py:80-289`):
    intrinsics (ZED .conf -> `{view}_{serial}_{cam}_calib.json`), manual (a
    summary record in degrees, tagged), extrinsics (per-marker averaging and
    board offsets -> radians), corners (the Meca-insertion corner pipeline)
    and stereo-transfer (the right cameras from the left through the ZED
    stereo transform), with its files, schema, units and printed lines."""
    from mvropose_torch.calib import aruco
    from mvropose_torch.calib.zed_conf import load_stereo_params, load_zed_intrinsics
    from mvropose_torch.geometry.rotations import matrix_to_quat, rodrigues_to_matrix

    if args.calib_cmd == "intrinsics":
        out_dir = Path(args.out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for side, name in (("LEFT", "leftcam"), ("RIGHT", "rightcam")):
            intr = load_zed_intrinsics(args.conf, side, args.resolution)
            path = out_dir / f"{args.view}_{args.serial}_{name}_calib.json"
            path.write_text(json.dumps(intr.to_json_dict(), indent=4))
            print(f"wrote {path}")
        return 0

    if args.calib_cmd == "manual":
        # A precomputed extrinsic (Meca500's), rvec in degrees with an
        # explicit unit tag, which the rig loader honours over the robot's.
        rec = {
            "view": args.view, "cam": args.cam,
            "tvec_x": args.tvec[0], "tvec_y": args.tvec[1], "tvec_z": args.tvec[2],
            "rvec_x": args.rvec_deg[0], "rvec_y": args.rvec_deg[1], "rvec_z": args.rvec_deg[2],
            "rvec_unit": "deg",
        }
        out = Path(args.out)
        records = json.loads(out.read_text()) if out.exists() else []
        records = [r for r in records if not (r["view"] == args.view and r["cam"] == args.cam)]
        records.append(rec)
        out.write_text(json.dumps(records, indent=2))
        print(f"wrote {out} ({len(records)} records)")
        return 0

    if args.calib_cmd == "extrinsics":
        offsets = json.loads(Path(args.offsets).read_text())  # {view: {mid: [x, y, z]}}
        records = []
        for (view, cam), markers in _detections_by_camera(args.aruco_dir).items():
            averaged = {}
            for mid, dets in markers.items():
                avg = aruco.average_marker_detections(
                    dets, angular_outlier_deg=args.outlier_deg,
                    position_outlier_m=args.outlier_pos)
                if avg is not None:
                    averaged[mid] = avg
            pose = aruco.compute_view_pose(averaged, _view_offsets(offsets, view))
            if pose is None:
                print(f"[{view}/{cam}] no usable markers, skipped")
                continue
            records.append(_pose_record(view, cam, pose))
            print(f"[{view}/{cam}] pose from {pose['n_markers']} markers")
        Path(args.out).write_text(json.dumps(records, indent=2))
        print(f"wrote {args.out}")
        return 0

    if args.calib_cmd == "corners":
        # Stage 1 averaging with the corners, stage 2 a PnP of each marker
        # from its averaged corners, stage 3 the offsets and the summary.
        offsets = json.loads(Path(args.offsets).read_text())
        serial_map = json.loads(Path(args.serial_map).read_text())  # {view: serial}
        records = []
        for (view, cam), markers in sorted(_detections_by_camera(args.aruco_dir).items()):
            serial = serial_map.get(view)
            calib_path = Path(args.calib_dir) / f"{view}_{serial}_{cam}_calib.json"
            if serial is None or not calib_path.exists():
                print(f"[{view}/{cam}] no calib file, skipped")
                continue
            calib = json.loads(calib_path.read_text())
            K = np.asarray(calib["camera_matrix"], np.float64)
            dist = np.asarray(calib["distortion_coeffs"], np.float64).reshape(-1)
            resolved = {}
            for mid, dets in markers.items():
                avg = aruco.average_detections_with_corners(dets)
                if avg is None or "corners_pixel" not in avg:
                    continue
                solved = aruco.solve_marker_pose_from_corners(
                    np.asarray(avg["corners_pixel"], np.float32), args.marker_size, K, dist)
                q = matrix_to_quat(rodrigues_to_matrix(
                    torch.as_tensor(solved["rvec"], dtype=torch.float32))).numpy()
                resolved[mid] = {
                    "position_m": dict(zip("xyz", (float(v) for v in solved["tvec"]))),
                    "rotation_quat": dict(zip("xyzw", (float(v) for v in q))),
                }
            pose = aruco.compute_view_pose(resolved, _view_offsets(offsets, view))
            if pose is None:
                print(f"[{view}/{cam}] no usable markers, skipped")
                continue
            records.append(_pose_record(view, cam, pose))
            print(f"[{view}/{cam}] pose from {pose['n_markers']} corner-resolved markers")
        Path(args.out).write_text(json.dumps(records, indent=2))
        print(f"wrote {args.out}")
        return 0

    if args.calib_cmd == "stereo-transfer":
        serial_map = json.loads(Path(args.serial_map).read_text())  # {view: serial}
        records = json.loads(Path(args.summary).read_text())
        by_key = {(r["view"], r["cam"]): r for r in records}
        added = 0
        for (view, cam), rec in list(by_key.items()):
            if cam != "leftcam" or (view, "rightcam") in by_key:
                continue
            serial = serial_map.get(view)
            if serial is None:
                continue
            conf = Path(args.conf_dir) / f"SN{serial}.conf"
            if not conf.exists():
                print(f"[{view}] no conf for serial {serial}, skipped")
                continue
            stereo = load_stereo_params(conf, args.resolution)
            rvec_l = np.array([rec["rvec_x"], rec["rvec_y"], rec["rvec_z"]])
            # The transform takes radians: the record's tag, else --rvec-unit.
            if rec.get("rvec_unit", args.rvec_unit) == "deg":
                rvec_l = np.deg2rad(rvec_l)
            tvec_l = np.array([rec["tvec_x"], rec["tvec_y"], rec["tvec_z"]])
            offset = (np.asarray(args.correction_offset, np.float64)
                      if args.correction_offset is not None else None)
            rvec_r, tvec_r = aruco.stereo_right_from_left(rvec_l, tvec_l, stereo,
                                                          correction_offset=offset)
            records.append({
                "view": view, "cam": "rightcam",
                "tvec_x": float(tvec_r[0]), "tvec_y": float(tvec_r[1]),
                "tvec_z": float(tvec_r[2]),
                "rvec_x": float(rvec_r[0]), "rvec_y": float(rvec_r[1]),
                "rvec_z": float(rvec_r[2]),
                "rvec_unit": "rad",
                "derived_from": "stereo_baseline",
            })
            added += 1
        Path(args.summary).write_text(json.dumps(records, indent=2))
        print(f"derived {added} rightcam extrinsics -> {args.summary}")
        return 0
    raise SystemExit("unknown calibrate subcommand")


def _overlay_png(path: Path, panel: np.ndarray) -> None:
    import cv2

    cv2.imwrite(str(path), panel[:, :, ::-1])


def _cmd_visualize(args) -> int:
    """GT sanity panels, the reference's `cli visualize` (`mvropose_tpu/cli/
    main.py:1894-1990`) on `data/table.py`: FK + projection skeletons drawn
    on the undistorted images of random single-view samples, or with FR3's
    `--multi-view` one panel a sampled group per group size, its views side
    by side."""
    import cv2

    from mvropose_torch.data.dataset import SingleViewSample, _load_image_rgb

    rig = load_rig_from_args(args)
    df = concat(read_csv(c) for c in args.csv)
    image_hw = tuple(args.image_hw)
    out_dir = Path(args.out_dir)
    rng = np.random.default_rng(args.seed)
    written = 0
    if args.robot == "fr3" and args.multi_view:
        ds = builders.build_fr3_multi_view(df, rig, image_hw, tolerance_s=args.tolerance)
        out_dir.mkdir(parents=True, exist_ok=True)
        by_size: dict[int, list[int]] = {}
        for gi, g in enumerate(ds.groups):
            by_size.setdefault(len(g["views"]), []).append(gi)
        for size, idxs in sorted(by_size.items()):
            chosen = rng.choice(len(idxs), size=min(args.num_samples, len(idxs)), replace=False)
            for c in chosen:
                g = ds.groups[idxs[int(c)]]
                angles = np.asarray(g["joint_angles"], np.float32)[: rig.robot.n_joints]
                tiles = []
                for rv in ds.resolve_group_views(g):
                    img = _load_image_rgb(rv["image_path"])
                    if img is None:
                        continue
                    img = ds.geometry.undistort_host(img, ds.geometry.key_to_idx[rv["camera_key"]])
                    s = SingleViewSample(image_path=rv["image_path"], camera_key=rv["camera_key"],
                                         view=rv["view"], angles=angles)
                    kps = ds.geometry.gt_keypoints(s, rv["extr_key"])
                    tiles.append(draw_keypoints_overlay(img, kps, rig.robot.links))
                if not tiles:
                    continue
                min_h = min(t.shape[0] for t in tiles)
                tiles = [cv2.resize(t, (int(t.shape[1] * min_h / t.shape[0]), min_h))
                         for t in tiles]
                _overlay_png(out_dir / f"group{size}view_{idxs[int(c)]:05d}.png", np.hstack(tiles))
                written += 1
        print(f"wrote {written} multi-view GT group panels to {out_dir}")
        return 0
    ds = SINGLE_VIEW_BUILDERS[args.robot](df, rig, image_hw)
    out_dir.mkdir(parents=True, exist_ok=True)
    idxs = rng.choice(len(ds.samples), size=min(args.num_samples, len(ds.samples)), replace=False)
    for i in idxs:
        s = ds.samples[int(i)]
        img = _load_image_rgb(s.image_path)
        if img is None:
            continue
        # The GT keypoints live on the undistorted image.
        if img.shape[:2] == tuple(ds.geometry.image_hw):
            img = ds.geometry.undistort_host(img, ds.geometry.key_to_idx[s.camera_key])
        panel = draw_keypoints_overlay(img, ds.geometry.gt_keypoints(s), rig.robot.links)
        _overlay_png(out_dir / f"gt_overlay_{Path(s.image_path).stem}.png", panel)
        written += 1
    print(f"wrote {written} GT overlay panels to {out_dir}")
    return 0


def profile(args) -> "StageTimer":
    """The reference's `cli profile` (`mvropose_tpu/cli/main.py:1993-2040`):
    the multi-view estimator with all-zero weights at --views x
    --model-size, one frame set of N(0, 1) images, then --iters times its
    backbone, its full forward and the peak decode of its heatmaps (to
    720x1280 pixels), each timed as a stage: CUDA events on the card (bf16),
    the wall clock on the CPU (f32). -> the StageTimer."""
    from mvropose_torch.utils.timing import StageTimer

    device = torch.device(args.device)
    vit = ViTConfig(
        image_size=args.model_size, patch_size=16, hidden_size=args.hidden_size,
        num_layers=args.num_layers, num_heads=args.hidden_size // 64,
        dtype="float32" if device.type == "cpu" else "bfloat16",
    )
    cfg = EstimatorConfig(vit=vit, num_joints=8, num_angles=7, max_views=args.views,
                          dtype=vit.dtype)
    model = MultiViewPoseEstimator(cfg, device=device).eval()
    model.load_state_dict({k: torch.zeros_like(v) for k, v in model.state_dict().items()})
    B, V, S = 1, args.views, args.model_size
    gen = torch.Generator(device).manual_seed(0)
    images = torch.randn((B, V, S, S, 3), generator=gen, device=device)
    vids = torch.arange(V, device=device).repeat(B, 1)
    mask = torch.ones((B, V), dtype=torch.bool, device=device)
    flat = images.reshape(B * V, S, S, 3).permute(0, 3, 1, 2)

    def backbone(x):
        return model.backbone(x)["patch_tokens"]

    def decode(h):
        return decode_keypoints(h, image_hw=(720, 1280))

    timer = StageTimer(device)
    with torch.inference_mode():
        hm, _ = model(images, vids, mask)  # warm-up
        backbone(flat)
        decode(hm)
        for _ in range(args.iters):
            timer.timed("backbone", backbone, flat)
            hm, _ = timer.timed("full_forward", model, images, vids, mask)
            timer.timed("decode", decode, hm)
    return timer


def _cmd_profile(args) -> int:
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available (pass "
                         "--device cpu for the wall clock on the CPU)")
    timer = profile(args)
    print(timer.summary())
    report = timer.report()
    full = report["full_forward"]["mean_s"]
    print(f"\nestimated frame-sets/s (forward+decode): "
          f"{1.0 / (full + report['decode']['mean_s']):.2f}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mvropose_torch", description="MvRoPose on PyTorch/CUDA"
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    robots = ["fr5", "fr3", "dream", "meca500", "meca_insertion"]
    ps = sub.add_parser("sync", help="synchronize images with joint logs")
    ps.add_argument("robot", choices=robots)
    ps.add_argument("--base-dirs", nargs="+", required=True)
    ps.add_argument("--joint-dir", default=None)
    ps.add_argument("--out", required=True)
    ps.add_argument("--tolerance", type=float, default=0.05)
    ps.add_argument("--image-delay", type=float, default=0.0333)
    ps.add_argument("--strict", action="store_true", help="exit nonzero when 0 rows matched")
    ps.set_defaults(fn=_cmd_sync)

    pg = sub.add_parser("group", help="multi-view temporal grouping + grid search")
    pg.add_argument("--csv", required=True)
    pg.add_argument("--ts-col", default="robot_timestamp")
    pg.add_argument("--tolerance", type=float, default=0.07)
    pg.add_argument("--max-views", type=int, default=8)
    pg.add_argument("--min-views", type=int, default=2)
    pg.add_argument("--out", default=None)
    pg.set_defaults(fn=_cmd_group)

    pc = sub.add_parser("calibrate", help="camera calibration tools")
    csub = pc.add_subparsers(dest="calib_cmd", required=True)
    ci = csub.add_parser("intrinsics")
    ci.add_argument("--conf", required=True)
    ci.add_argument("--serial", required=True)
    ci.add_argument("--view", required=True)
    ci.add_argument("--resolution", default="FHD")
    ci.add_argument("--out-dir", required=True)
    cm = csub.add_parser("manual")
    cm.add_argument("--view", required=True)
    cm.add_argument("--cam", required=True)
    cm.add_argument("--tvec", type=float, nargs=3, required=True)
    cm.add_argument("--rvec-deg", type=float, nargs=3, required=True)
    cm.add_argument("--out", required=True)
    ce = csub.add_parser("extrinsics")
    ce.add_argument("--aruco-dir", required=True)
    ce.add_argument("--offsets", required=True, help="JSON {view: {marker_id: [x,y,z]}}")
    ce.add_argument("--outlier-deg", type=float, default=1.0)
    ce.add_argument("--outlier-pos", type=float, default=None,
                    help="position outlier threshold in meters (Meca-insertion used 0.001)")
    ce.add_argument("--out", required=True)
    cs = csub.add_parser("stereo-transfer")
    cs.add_argument("--summary", required=True, help="aruco summary JSON to extend in place")
    cs.add_argument("--serial-map", required=True, help="JSON {view: serial}")
    cs.add_argument("--conf-dir", required=True)
    cs.add_argument("--resolution", default="FHD1200")
    cs.add_argument("--rvec-unit", choices=["rad", "deg"], default="rad",
                    help="unit of untagged source records (records written by this CLI carry "
                         "an explicit rvec_unit tag)")
    cs.add_argument("--correction-offset", type=float, nargs=3, default=None,
                    help="manual tvec correction added to the derived rightcam pose "
                         "(the original project's RIGHT_CAM_CORRECTION_OFFSET = -0.025 0 0)")
    cc = csub.add_parser("corners", help="Meca-insertion 3-stage corner pipeline")
    cc.add_argument("--aruco-dir", required=True,
                    help="dir of view_*_cam_*.json capture files with corners_pixel")
    cc.add_argument("--calib-dir", required=True)
    cc.add_argument("--serial-map", required=True, help="JSON {view: serial}")
    cc.add_argument("--offsets", required=True, help="JSON {view: {marker_id: [x,y,z]}}")
    cc.add_argument("--marker-size", type=float, default=0.05,
                    help="marker side length in meters (MARKER_REAL_SIZE_M)")
    cc.add_argument("--out", required=True)
    pc.set_defaults(fn=_cmd_calibrate)

    pz = sub.add_parser("visualize", help="GT skeleton overlay panels (pipeline sanity check)")
    pz.add_argument("--robot", choices=robots, required=True)
    pz.add_argument("--multi-view", action="store_true",
                    help="fr3: grouped multi-view panels by group size")
    pz.add_argument("--tolerance", type=float, default=0.07,
                    help="fr3 multi-view grouping tolerance (s)")
    pz.add_argument("--csv", nargs="+", required=True)
    pz.add_argument("--calib-dir", default=None)
    pz.add_argument("--aruco-summary", nargs="*", default=None)
    pz.add_argument("--dream-dirs", nargs="*", default=None,
                    help="DREAM subset dirs with _camera_settings.json (robot=dream)")
    pz.add_argument("--image-hw", type=int, nargs=2, default=[1080, 1920])
    pz.add_argument("--out-dir", required=True)
    pz.add_argument("--num-samples", type=int, default=6)
    pz.add_argument("--sigma", type=float, default=5.0)
    pz.add_argument("--seed", type=int, default=0)
    pz.set_defaults(fn=_cmd_visualize)

    pp = sub.add_parser("profile", help="per-stage pipeline timing")
    pp.add_argument("--views", type=int, default=4)
    pp.add_argument("--model-size", type=int, default=512)
    pp.add_argument("--hidden-size", type=int, default=768)
    pp.add_argument("--num-layers", type=int, default=12)
    pp.add_argument("--iters", type=int, default=20)
    pp.add_argument("--device", default="cuda", help="torch device (default cuda)")
    pp.set_defaults(fn=_cmd_profile)

    pv = sub.add_parser("serve", help="realtime streaming rig inference")
    pv.add_argument("--replay-dir", default=None)
    pv.add_argument("--views", type=int, default=4)
    pv.add_argument("--fps", type=float, default=30.0)
    pv.add_argument("--frame-hw", type=int, nargs=2, default=[720, 1280])
    pv.add_argument("--model-size", type=int, default=512)
    pv.add_argument("--hidden-size", type=int, default=768)
    pv.add_argument("--num-layers", type=int, default=12)
    pv.add_argument("--patch-size", type=int, default=16)
    pv.add_argument("--register-tokens", type=int, default=0)
    pv.add_argument("--rope", action="store_true")
    pv.add_argument("--backbone-native-size", type=int, default=None,
                    help="(arch flags are only consulted when the params dir "
                         "has no model_config.json)")
    pv.add_argument("--duration", type=float, default=10.0)
    pv.add_argument("--no-overlap", action="store_true",
                    help="disable the double-buffered tick (dispatch N / "
                         "fetch N-1); serial gather->infer->fetch instead")
    pv.add_argument("--params", default=None,
                    help="best_params.npz from the reference's training; "
                         "without it the model gets random weights from seed 0")
    pv.add_argument("--device", default="cuda", help="torch device (default cuda)")
    pv.add_argument("--angle-head", choices=["query", "geometric", "geometric3d"],
                    default="query")
    pv.add_argument("--calib-dir", default=None,
                    help="directory of {view}_{serial}_{cam}_calib.json files (cli calibrate "
                         "intrinsics): undistort each camera on the device, real K for poses")
    pv.add_argument("--camera-keys", default=None,
                    help="comma-separated '{view}_{cam}' per source for undistortion")
    pv.add_argument("--int8-backbone", action="store_true",
                    help="serve with the backbone quantized to int8 "
                         "(models/quantize.py)")
    pv.add_argument("--int8-attention", action="store_true",
                    help="with --int8-backbone: also run int8-probability "
                         "attention (ops/int8_attention.py)")
    pv.add_argument("--recover-pose", action="store_true",
                    help="per-camera 6D RANSAC-PnP pose recovery inside the tick")
    pv.add_argument("--refine-pose", action="store_true",
                    help="with --recover-pose: the joint (pose, angles) refinement inside "
                         "the tick (pose/refine.py)")
    pv.add_argument("--refine-sigma-px", type=float, default=1.2)
    pv.add_argument("--refine-sigma-prior", type=float, default=0.2)
    pv.add_argument("--pose-robot", default="fr3")
    pv.add_argument("--max-skew", type=float, default=None,
                    help="mask cameras whose latest frame lags the newest by more than this (s)")
    pv.add_argument("--summary", default=None,
                    help="aruco_pose_summary.json: ArUco fallback extrinsics on PnP failure")
    pv.add_argument("--display", choices=["off", "window", "dir"], default="off",
                    help="tiled live view: 'window' = cv2.imshow ('q' quits), 'dir' = write "
                         "canvas PNGs")
    pv.add_argument("--display-dir", default="serve_display",
                    help="output directory for --display dir")
    pv.add_argument("--display-every", type=int, default=10,
                    help="write every Nth canvas in --display dir mode")
    pv.set_defaults(fn=_cmd_serve)

    pt = sub.add_parser("train", help="train an estimator on captured images")
    pt.add_argument("--robot", type=robot_arg, required=True,
                    help="fr5|fr3|dream|meca500|meca_insertion, or a comma list for "
                         "mixed-robot training, e.g. --robot fr5,fr3 with one --csv per robot")
    pt.add_argument("--csv", nargs="+", required=True)
    pt.add_argument("--calib-dir", default=None)
    pt.add_argument("--aruco-summary", nargs="*", default=None)
    pt.add_argument("--dream-dirs", nargs="*", default=None,
                    help="DREAM subset dirs with _camera_settings.json (robot=dream)")
    pt.add_argument("--workdir", default="runs/default")
    pt.add_argument("--image-hw", type=int, nargs=2, default=[1080, 1920])
    pt.add_argument("--model-size", type=int, default=224)
    pt.add_argument("--hidden-size", type=int, default=768)
    pt.add_argument("--num-layers", type=int, default=12)
    pt.add_argument("--batch-size", type=int, default=16)
    pt.add_argument("--epochs", type=int, default=100)
    pt.add_argument("--val-split", type=float, default=0.1)
    pt.add_argument("--lr-kpt", type=float, default=1e-4)
    pt.add_argument("--lr-ang", type=float, default=1e-4)
    pt.add_argument("--loss-weight-kpt", type=float, default=100.0)
    pt.add_argument("--sigma", type=float, default=5.0)
    pt.add_argument("--tolerance", type=float, default=0.07)
    pt.add_argument("--single-view", action="store_true")
    pt.add_argument("--no-augment", action="store_true")
    pt.add_argument("--fk-loss-weight", type=float, default=0.0)
    pt.add_argument("--backbone-ckpt", default=None,
                    help="graft a DINO checkpoint (.pth/.pt/.bin or .npz, timm or HF naming) "
                         "into the backbone before training")
    pt.add_argument("--no-freeze-backbone", action="store_true",
                    help="train the backbone too (default: frozen)")
    pt.add_argument("--angle-head", choices=["query", "geometric", "geometric3d"],
                    default="query")
    pt.add_argument("--patch-size", type=int, default=16)
    pt.add_argument("--register-tokens", type=int, default=0)
    pt.add_argument("--rope", action="store_true")
    pt.add_argument("--backbone-native-size", type=int, default=None)
    pt.add_argument("--mesh", type=int, nargs=2, default=None, metavar=("DATA", "MODEL"),
                    help="not ported yet (ROADMAP.md queue 1, item 10)")
    pt.add_argument("--viz-every", type=int, default=10,
                    help="save prediction panels every N epochs")
    pt.add_argument("--wandb", action="store_true",
                    help="also log to wandb where it imports (logs/metrics.jsonl always)")
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--num-workers", type=int,
                    default=int(os.environ.get("MVROPOSE_NUM_WORKERS", "4")),
                    help="worker processes that decode and undistort the train batches (0: "
                         "in-process; a mixed run loads in-process). Env MVROPOSE_NUM_WORKERS "
                         "overrides the default")
    pt.add_argument("--device", default="cuda", help="torch device (default cuda)")
    pt.set_defaults(fn=_cmd_train)

    pe = sub.add_parser("eval", help="evaluate a trained model (PCK/ADD/MAE)")
    pe.add_argument("--robot", type=robot_arg, required=True,
                    help="robot name, or a comma list to evaluate a mixed-robot checkpoint "
                         "per robot")
    pe.add_argument("--csv", nargs="+", required=True)
    pe.add_argument("--params", required=True, help="best_params.npz")
    pe.add_argument("--angle-head", choices=["query", "geometric", "geometric3d"],
                    default="query")
    pe.add_argument("--calib-dir", default=None)
    pe.add_argument("--aruco-summary", nargs="*", default=None)
    pe.add_argument("--dream-dirs", nargs="*", default=None,
                    help="DREAM subset dirs with _camera_settings.json (robot=dream)")
    pe.add_argument("--image-hw", type=int, nargs=2, default=[1080, 1920])
    pe.add_argument("--model-size", type=int, default=224)
    pe.add_argument("--hidden-size", type=int, default=768)
    pe.add_argument("--num-layers", type=int, default=12)
    pe.add_argument("--patch-size", type=int, default=16)
    pe.add_argument("--register-tokens", type=int, default=0)
    pe.add_argument("--rope", action="store_true")
    pe.add_argument("--backbone-native-size", type=int, default=None,
                    help="(arch flags are only consulted when the params dir has no "
                         "model_config.json)")
    pe.add_argument("--batch-size", type=int, default=16)
    pe.add_argument("--sigma", type=float, default=5.0)
    pe.add_argument("--tolerance", type=float, default=0.07)
    pe.add_argument("--pck-px", type=float, default=5.0)
    pe.add_argument("--occlusion-masks", type=int, default=0,
                    help="occlusion-robustness probe: N random solid rectangles per image")
    pe.add_argument("--int8-backbone", action="store_true",
                    help="quantize the loaded checkpoint's backbone to int8 before evaluating")
    pe.add_argument("--int8-attention", action="store_true",
                    help="with --int8-backbone: also run the int8-probability attention")
    pe.add_argument("--refine-pose", action="store_true",
                    help="the joint (pose, angles) refinement on top of the predicted-angle "
                         "PnP; adds the *_refined pose and ADD metrics")
    pe.add_argument("--refine-sigma-px", type=float, default=1.2)
    pe.add_argument("--refine-sigma-prior", type=float, default=0.2,
                    help="angle-prior std in the robot's native unit")
    pe.add_argument("--single-view", action="store_true")
    pe.add_argument("--device", default="cuda", help="torch device (default cuda)")
    pe.set_defaults(fn=_cmd_eval)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
