"""Command line for the torch port: `python -m mvropose_torch.cli serve ...`.

Port of the reference's `cli serve` (`mvropose_tpu/cli/main.py::_cmd_serve`)
for the multi-view checkpoint with the query angle head: N camera sources ->
one batched step (preprocess + model + peak decode) per rig tick through the
port's `rig.StreamingPipeline` (a copy of the reference's). `--recover-pose`
adds per-camera RANSAC PnP on FK of the predicted angles to the step
(`pose.recover_pose_batch`), and `--refine-pose` the joint (pose, angles)
refinement; neither waits for the device.
`--int8-backbone` (and `--int8-attention` with it) quantize the loaded model
as the reference's flags do; a checkpoint whose model_config.json says
`fused_ln` runs the fused LayerNorm. At `--model-size` 736 and above the
backbone has T >= 2048 tokens and its attention runs the flash kernel on the
card (`ops/attention.py`), as the reference's does on a TPU. The serve flags that belong to modules not ported yet exit
with an error naming the ROADMAP.md item that ports them; they never fall
back to something else. `--replay-dir` decodes its frames with cv2 and
exits naming it where cv2 cannot be imported.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mvropose_torch.data import IMAGENET_MEAN, IMAGENET_STD
from mvropose_torch.decode import decode_keypoints
from mvropose_torch.geometry.robots import get_robot
from mvropose_torch.models import EstimatorConfig, MultiViewPoseEstimator, ViTConfig
from mvropose_torch.models.heads import resize_bilinear
from mvropose_torch.models.vit import device_constant
from mvropose_torch.pose import PoseDraws, recover_pose_batch
from mvropose_torch.rig import FileReplaySource, StreamingPipeline, SyntheticSource
from mvropose_torch.utils.weights import int8ify, load_jax_params, random_state

# Serve options of the reference whose modules are not ported yet.
_UNPORTED = {
    "calib_dir": ("--calib-dir", "queue 1, item 7 (serve undistortion)"),
    "summary": ("--summary", "queue 1, item 7 (the ArUco fallback poses; they need "
                "--calib-dir)"),
}


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


def write_run_dir(run, cfg, model_size: int, flat) -> None:
    """A multi-view run directory as training leaves it, what `serve --params
    RUN/best_params.npz` reads: model_config.json (`cfg`, `model_size`; the
    inverse of `read_model_config`) beside best_params.npz (`flat`, the
    reference's flat names)."""
    run = Path(run)
    run.mkdir(parents=True, exist_ok=True)
    (run / "model_config.json").write_text(json.dumps({
        "kind": "multi_view", "model_size": model_size, "vit": dataclasses.asdict(cfg.vit),
        "num_joints": cfg.num_joints, "num_angles": cfg.num_angles,
        "heatmap_size": list(cfg.heatmap_size), "max_views": cfg.max_views,
        "num_fusion_queries": cfg.num_fusion_queries, "num_angle_queries": cfg.num_angle_queries,
        "angle_head": cfg.angle_head,
    }, indent=2))
    np.savez(run / "best_params.npz", **flat)


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


class PoseStep:
    """Pose recovery on the serve tick, as the reference's serve `recover`
    (`mvropose_tpu/cli/main.py:1630-1691`): the nominal K of a 720p-class
    camera (fx = fy = 737 px, the principal point at the frame's centre),
    identity base rotations, and the fallback substitution `~success &
    fb_valid`, fb_valid all False until `--summary` is ported. Its draws are
    made once, from a generator seeded 0 on the device, and used every tick:
    the reference passes PRNGKey(0) every tick, and resident draws keep the
    step free of host work. The arguments are the serve flags `--pose-robot`,
    `--refine-pose`, `--refine-sigma-px` and `--refine-sigma-prior`."""

    def __init__(self, views: int, image_hw, device, angles: int, robot: str = "fr3",
                 refine: bool = False, sigma_px: float = 1.2, sigma_prior: float = 0.2):
        self.image_hw = tuple(image_hw)
        self.robot = get_robot(robot)
        self.refine, self.sigma_px, self.sigma_prior = refine, sigma_px, sigma_prior
        device = torch.device(device)
        H, W = self.image_hw
        K = torch.zeros(3, 3, device=device)
        K[0, 0] = K[1, 1] = 737.0
        K[0, 2], K[1, 2], K[2, 2] = W / 2, H / 2, 1.0
        self.Ks = K.expand(views, 3, 3).contiguous()
        self.bases = torch.eye(3, device=device).expand(views, 3, 3).contiguous()
        self.fb_rvec = torch.zeros(views, 3, device=device)
        self.fb_tvec = torch.zeros(views, 3, device=device)
        self.fb_valid = torch.zeros(views, dtype=torch.bool, device=device)
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


def serve_step(model, images_u8, mask, model_size: int, image_hw, pose: PoseStep | None = None):
    """One rig tick on the model's device: (V, H, W, 3) uint8 frames + (V,)
    mask -> (keypoints (V, J, 2) image px, confidence (V, J), angles (1, A)),
    and with `pose` also (rvec (V, 3), tvec (V, 3), success (V,))."""
    imgs = preprocess(images_u8, model_size)
    view_ids = torch.arange(imgs.shape[0], device=imgs.device)[None]
    hm, ang = model(imgs[None], view_ids, mask[None])
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
    synchronous calls. With a `PoseStep` the step also recovers the cameras'
    poses.
    """

    def __init__(self, model, views: int, model_size: int, image_hw, device,
                 pose: PoseStep | None = None):
        self.model, self.model_size, self.image_hw = model, model_size, tuple(image_hw)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.pose = pose
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
            outs = serve_step(self.model, frames, m, self.model_size, self.image_hw, self.pose)
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
    """(model, model_size) for the serve flags or the checkpoint's config.
    With --recover-pose the heads' arity is the robot's (heatmaps =
    keypoints, angles = joints), and a checkpoint of another arity exits."""
    saved = read_model_config(args.params) if args.params else None
    n_joints, n_angles = 8, 7
    if args.recover_pose:
        robot = get_robot(args.pose_robot)
        n_joints, n_angles = robot.n_keypoints, robot.n_joints
    if saved is not None:
        cfg, model_size, kind = saved
        if kind != "multi_view":
            raise SystemExit(
                f"a {kind} checkpoint is not servable by the port yet "
                "(ROADMAP.md queue 1, item 4: single-view estimator)"
            )
        if args.views > cfg.max_views:
            raise SystemExit(f"--views {args.views} exceeds the trained max_views {cfg.max_views}")
        if args.recover_pose and (cfg.num_joints, cfg.num_angles) != (n_joints, n_angles):
            raise SystemExit(
                f"--pose-robot {args.pose_robot} expects {n_joints} keypoints/{n_angles} angles "
                f"but the checkpoint has {cfg.num_joints}/{cfg.num_angles}"
            )
        print(f"model architecture restored from {Path(args.params).parent / 'model_config.json'}")
    else:
        model_size = args.model_size
        vit = ViTConfig(
            image_size=args.backbone_native_size or args.model_size,
            patch_size=args.patch_size, hidden_size=args.hidden_size,
            num_layers=args.num_layers, num_heads=args.hidden_size // 64,
            num_register_tokens=args.register_tokens, dtype="bfloat16",
            use_rope=args.rope, layer_norm_eps=1e-5 if args.rope else 1e-6,
        )
        cfg = EstimatorConfig(vit=vit, num_joints=n_joints, num_angles=n_angles,
                              max_views=args.views, angle_head=args.angle_head)
    if cfg.angle_head != "query":
        raise SystemExit(
            f"angle_head {cfg.angle_head!r} is not ported yet (ROADMAP.md queue 1, "
            "item 4: geometric angle heads)"
        )
    model = MultiViewPoseEstimator(cfg, device=args.device).eval()
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
    return model, model_size


def serve(args):
    """Run the serve loop for `args.duration` seconds.

    Returns (StreamStats, last fetched result (keypoints, confidence, angles,
    and with --recover-pose rvec, tvec, success) as numpy arrays)."""
    for attr, (flag, item) in _UNPORTED.items():
        if getattr(args, attr):
            raise SystemExit(f"{flag} is not ported yet (ROADMAP.md {item})")
    if args.int8_attention and not args.int8_backbone:
        raise SystemExit("--int8-attention runs only with --int8-backbone")
    if args.refine_pose and not args.recover_pose:
        raise SystemExit("--refine-pose runs only with --recover-pose")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
    hw = tuple(args.frame_hw)
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
    model, model_size = _serve_model(args)
    pose = None
    if args.recover_pose:
        pose = PoseStep(args.views, hw, args.device, model.cfg.num_angles, args.pose_robot,
                        args.refine_pose, args.refine_sigma_px, args.refine_sigma_prior)
    runner = ServeRunner(model, args.views, model_size, hw, args.device, pose)
    if args.no_overlap:
        pipe = StreamingPipeline(sources, runner.infer, frame_hw=hw)
    else:
        pipe = StreamingPipeline(sources, runner.dispatch, frame_hw=hw, fetch_fn=runner.fetch)
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
        pipe.stats = type(pipe.stats)(
            start_time_s=time.perf_counter(), overlapped=pipe.fetch_fn is not None
        )
        end = time.perf_counter() + args.duration
        while time.perf_counter() < end:
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mvropose_torch", description="MvRoPose on PyTorch/CUDA"
    )
    sub = p.add_subparsers(dest="cmd", required=True)
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
                    default="query", help="only 'query' is ported")
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
    for flag, item in _UNPORTED.values():
        pv.add_argument(flag, default=None, help=f"not ported yet (ROADMAP.md {item})")
    pv.set_defaults(fn=_cmd_serve)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
