"""Convergence runs of the PyTorch port on framework-rendered synthetic data.

The port's counterpart of `scripts/train_synthetic.py`, with its flags and
defaults: it trains `mvropose_torch`'s multi-view estimator on batches that
`mvropose_torch.data.synthetic` renders on the device (FK -> projection ->
colored joint blobs; the render is the CUDA heatmap kernel on a GPU), with
the port's two-group AdamW train step, and writes `logs/metrics.jsonl` and
`final_metrics.json` with the reference's keys, minus the pose-recovery ones
(ROADMAP.md queue 1, item 6). The backbone is a small ViT trained from
flax-style random init unless --freeze-backbone.

On a CUDA GPU compute runs in bf16, as the reference on an accelerator; with
--cpu it runs in f32 on the CPU. Without --cpu and without a GPU it exits.
Flag values that are not ported exit with their ROADMAP item and run nothing.

Usage:
  python scripts/torch_train_synthetic.py --mode multi --steps 4000 --batch 16 \\
      --workdir runs/torch_synth_mv
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from mvropose_torch.data.synthetic import make_rig, rig_tuple, synthesize_multiview_batch
from mvropose_torch.decode import decode_keypoints
from mvropose_torch.geometry.heatmap import argmax_decode
from mvropose_torch.geometry.robots import forward_kinematics, get_robot
from mvropose_torch.geometry.triangulation import projection_matrix, triangulate_keypoints
from mvropose_torch.models import EstimatorConfig, MultiViewPoseEstimator, ViTConfig
from mvropose_torch.train import (
    TrainConfig,
    add_auc,
    add_metric,
    angle_mae,
    create_train_state,
    make_multi_view_train_step,
    pck_at_k,
)
from mvropose_torch.utils.metrics_writer import MetricWriter
from mvropose_torch.utils.weights import flax_init_state


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=("single", "multi"), default="single")
    p.add_argument("--robot", default="fr5")
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--dataset-size", type=int, default=0,
                   help="finite train pool size (0 = a fresh batch every step)")
    p.add_argument("--lr-ang", type=float, default=None, help="angle-group lr (defaults to --lr)")
    p.add_argument("--angle-head", choices=("query", "geometric", "geometric3d"), default="query")
    p.add_argument("--fk-loss-weight", type=float, default=0.0)
    p.add_argument("--freeze-backbone", action="store_true",
                   help="frozen backbone, heads-only optimization")
    p.add_argument("--backbone-ckpt", default=None)
    p.add_argument("--render", choices=("blob", "link"), default="blob")
    p.add_argument("--views", type=int, default=3)
    p.add_argument("--image-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--eval-every", type=int, default=100)
    p.add_argument("--eval-batches", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workdir", default="runs/synth_sv")
    p.add_argument("--cpu", action="store_true", help="run on the CPU in f32")
    return p


def check_ported(args) -> None:
    """Exit, naming the ROADMAP item, for every flag value not ported yet."""
    unported = [
        (args.mode == "single", "--mode single", "queue 1, item 4: SingleViewPoseEstimator"),
        (args.render == "link", "--render link", "queue 1, item 11: link rendering"),
        (args.angle_head != "query", f"--angle-head {args.angle_head}",
         "queue 1, item 4: geometric angle heads"),
        (args.fk_loss_weight > 0, "--fk-loss-weight > 0",
         "queue 1, item 4: the single-view step's FK-consistency term"),
        (args.backbone_ckpt is not None, "--backbone-ckpt",
         "queue 1, item 11: models/dino_convert.py"),
    ]
    for hit, flag, item in unported:
        if hit:
            raise SystemExit(f"{flag} is not ported yet (ROADMAP.md {item})")


def build_model(robot, image_size: int, dtype: str, n_views: int, freeze_backbone: bool,
                device) -> MultiViewPoseEstimator:
    """The reference script's multi-view model: a 4-layer 192-wide ViT/16."""
    vit = ViTConfig(image_size=image_size, patch_size=16, hidden_size=192, num_layers=4,
                    num_heads=4, layerscale_init=None, dtype=dtype)
    cfg = EstimatorConfig(
        vit=vit, num_joints=robot.n_keypoints, num_angles=robot.n_joints,
        heatmap_size=(image_size // 2, image_size // 2), max_views=max(4, n_views),
        num_fusion_queries=8, num_angle_queries=4, freeze_backbone=freeze_backbone,
        dtype=dtype, angle_head="query",
    )
    return MultiViewPoseEstimator(cfg, device=device)


def _take(batch: dict, idx: torch.Tensor) -> dict:
    return {k: v[idx] for k, v in batch.items()}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    check_ported(args)
    if args.cpu:
        device, dtype = torch.device("cpu"), "float32"
    elif torch.cuda.is_available():
        device, dtype = torch.device("cuda"), "bfloat16"
    else:
        raise SystemExit("no CUDA GPU: run on the card, or pass --cpu for an f32 CPU run")
    robot = get_robot(args.robot)
    V, size, hm = args.views, args.image_size, args.image_size // 2
    rig = make_rig(n_views=V, image_hw=(size, size))
    rig_arrs = rig_tuple(rig, device)

    def make_batch(seed: int, n: int) -> dict:
        gen = torch.Generator(device).manual_seed(seed)
        return synthesize_multiview_batch(robot, rig_arrs, gen, n, image_hw=(size, size),
                                          heatmap_hw=(hm, hm), render=args.render)

    # Finite train pool (the reference's regime): made once on the device,
    # then each step gathers a random batch of it.
    pool = None
    if args.dataset_size > 0:
        sizes = [256] * (args.dataset_size // 256) + [args.dataset_size % 256]
        chunks = [make_batch(50_000 + i, n) for i, n in enumerate(s for s in sizes if s)]
        pool = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}

    model = build_model(robot, size, dtype, V, args.freeze_backbone, device)
    model.load_state_dict(flax_init_state(model, seed=1))
    tcfg = TrainConfig(num_epochs=1, steps_per_epoch=args.steps, lr_kpt=args.lr,
                       lr_ang=args.lr_ang if args.lr_ang is not None else args.lr,
                       loss_weight_kpt=100.0, freeze_backbone=args.freeze_backbone)
    state = create_train_state(model, tcfg)
    frozen_init = ({k: v.clone() for k, v in model.backbone.state_dict().items()}
                   if args.freeze_backbone else None)
    train_step = make_multi_view_train_step(tcfg)
    n_params = sum(p.numel() for p in model.parameters())
    eval_batches = [make_batch(20_000 + i, args.batch) for i in range(args.eval_batches)]
    K_rig, rv_rig, tv_rig = rig_arrs
    projs = projection_matrix(rv_rig, tv_rig, K_rig)  # (V, 3, 4), image px
    scale = size / hm  # heatmap px -> image px

    @torch.no_grad()
    def eval_metrics(batch: dict) -> dict:
        model.eval()
        pred_hm, pred_ang = model(batch["images"], batch["view_ids"], batch["view_mask"])
        pred_xy = argmax_decode(pred_hm)[0] * scale
        gt_xy = batch["keypoints_2d"]
        fk_pred = robot.keypoints_from_fk(forward_kinematics(robot, pred_ang))
        gt3 = batch["keypoints_3d"][..., : fk_pred.shape[-2], :]
        tri = triangulate_keypoints(pred_xy, projs)  # (B, J, 3)
        return {
            "pck5": pck_at_k(pred_xy, gt_xy, k_px=5.0),
            "pck_tight": pck_at_k(pred_xy, gt_xy, k_px=2.0 + scale),  # quantization-aware
            "add_m": add_metric(fk_pred, gt3),
            "add_auc_10cm": add_auc(fk_pred, gt3, max_threshold_m=0.10),
            "angle_mae": angle_mae(pred_ang, batch["angles"]),
            "angle_mae_per_joint": (pred_ang - batch["angles"]).abs().mean(dim=0),
            "triangulated_add_m": add_metric(tri, batch["keypoints_3d"]),
        }

    def run_eval(batches) -> dict:
        if not batches:
            raise ValueError("run_eval called with an empty batch list")
        ms = [{k: v.float().cpu().numpy() for k, v in eval_metrics(b).items()} for b in batches]
        out = {}
        for k in ms[0]:
            avg = np.mean(np.stack([m[k] for m in ms]), axis=0)
            out[k] = avg.round(4).tolist() if avg.ndim else float(avg)
        return out

    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    writer = MetricWriter(workdir / "logs")
    print(f"mode={args.mode} robot={robot.name} device={device} dtype={dtype} "
          f"params={n_params / 1e6:.2f}M batch={args.batch} views={V} img={size} "
          f"steps={args.steps}", flush=True)

    data_gen = torch.Generator(device).manual_seed(args.seed)
    dropout_gen = torch.Generator(device).manual_seed(args.seed + 1)
    t0 = time.time()
    samples = 0
    for step_i in range(args.steps):
        if pool is not None:
            idx = torch.randint(0, args.dataset_size, (args.batch,), generator=data_gen,
                                device=device)
            batch = _take(pool, idx)
        else:
            batch = synthesize_multiview_batch(
                robot, rig_arrs, data_gen, args.batch, image_hw=(size, size),
                heatmap_hw=(hm, hm), render=args.render)
        m = train_step(state, batch, dropout_gen)
        samples += args.batch
        if (step_i + 1) % args.eval_every == 0 or step_i == 0:
            rec = {"step": step_i + 1, **{k: float(v) for k, v in m.items()},
                   "samples_per_sec": samples / (time.time() - t0), **run_eval(eval_batches)}
            writer.write(step_i + 1, rec)
            print(json.dumps(rec), flush=True)
    final = run_eval(eval_batches)
    if frozen_init is not None:
        # The frozen regime's invariant, on the run itself: the backbone is
        # bit-identical after every update.
        drift = max(float((v.float() - frozen_init[k].float()).abs().max())
                    for k, v in model.backbone.state_dict().items())
        if drift != 0.0:
            raise RuntimeError(f"frozen backbone drifted: {drift}")
        final.update(frozen_backbone=True, frozen_backbone_max_drift=drift,
                     backbone_ckpt=args.backbone_ckpt)

    # Refined-decode residuals (pred - GT, image px) on the held-out batches,
    # as the reference saves them for its task bounds.
    with torch.no_grad():
        res = []
        for b in eval_batches:
            pred_hm, _ = model(b["images"], b["view_ids"], b["view_mask"])
            xy, _ = decode_keypoints(pred_hm, image_hw=(size, size), mode="refine")
            res.append((xy - b["keypoints_2d"]).reshape(-1, xy.shape[-2], 2).cpu().numpy())
    np.save(workdir / "decode_residuals.npy", np.concatenate(res))

    if pool is not None:
        n_pool = min(args.eval_batches, args.dataset_size // args.batch)
        pool_batches = [_take(pool, slice(i * args.batch, (i + 1) * args.batch))
                        for i in range(n_pool)]
        if pool_batches:
            final.update({f"trainset_{k}": v for k, v in run_eval(pool_batches).items()})
        final["dataset_size"] = args.dataset_size
    wall = time.time() - t0
    final.update(
        mode=args.mode, robot=robot.name, steps=args.steps, batch=args.batch, views=V,
        image_size=size, params_m=round(n_params / 1e6, 3), backend=device.type,
        device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        wall_s=round(wall, 1), train_samples_per_sec=round(samples / wall, 1), held_out=True,
    )
    writer.close()
    (workdir / "final_metrics.json").write_text(json.dumps(final, indent=2))
    print("FINAL " + json.dumps(final), flush=True)
    return final


if __name__ == "__main__":
    main()
