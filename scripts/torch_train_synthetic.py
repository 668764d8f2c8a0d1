"""Convergence runs of the PyTorch port on framework-rendered synthetic data.

The port's counterpart of `scripts/train_synthetic.py`, with its flags and
defaults: it trains `mvropose_torch`'s single-view (`--mode single`, the
default: one camera of the rig) or multi-view estimator, with the query,
geometric or (multi-view) geometric3d angle head, on batches that
`mvropose_torch.data.synthetic` renders on the device (FK -> projection ->
colored joint blobs; the render is the CUDA heatmap kernel on a GPU), with
the port's two-group AdamW train steps (single-view: `--fk-loss-weight`
adds the FK-consistency term), and writes `logs/metrics.jsonl` and
`final_metrics.json` with the reference's keys, the recovered camera poses'
errors included (RANSAC PnP per view on the refined decode, against the
rig's true extrinsics, with the predicted and with the true angles). The
backbone is a small ViT trained from flax-style random init unless
--freeze-backbone; --backbone-ckpt grafts a DINO checkpoint into it first
(`models/dino_convert.py`; the model then has LayerScale, as DINO does), and
a frozen graft's drift (0 by construction) goes into final_metrics.json.
The final weights go to `best_params.npz` beside `model_config.json` (the
reference's layouts), so `cli serve --params` and `cli eval --params` read
the run; --int8-eval also scores them under the reference's
`--int8-backbone --int8-attention` on the same held-out batches.

On a CUDA GPU compute runs in bf16, as the reference on an accelerator; with
--cpu it runs in f32 on the CPU. Without --cpu and without a GPU it exits.
Flag values that are not ported exit with their ROADMAP item and run nothing.

Usage:
  python scripts/torch_train_synthetic.py --mode single --steps 1500 --workdir runs/torch_synth_sv
  python scripts/torch_train_synthetic.py --mode multi --steps 4000 --batch 16 \\
      --workdir runs/torch_synth_mv
  python scripts/torch_train_synthetic.py --steps 8000 --batch 64 --freeze-backbone \\
      --backbone-ckpt runs/synth_sv_frozen/dino_192x4.npz --int8-eval --workdir RUN
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

from mvropose_torch.data.synthetic import (
    make_rig,
    rig_tuple,
    single_view_batch,
    synthesize_multiview_batch,
)
from mvropose_torch.decode import decode_keypoints
from mvropose_torch.geometry.heatmap import argmax_decode
from mvropose_torch.geometry.robots import forward_kinematics, get_robot
from mvropose_torch.geometry.triangulation import projection_matrix, triangulate_keypoints
from mvropose_torch.cli.main import write_run_dir
from mvropose_torch.models import (
    EstimatorConfig,
    MultiViewPoseEstimator,
    SingleViewPoseEstimator,
    ViTConfig,
)
from mvropose_torch.models.dino_convert import graft_backbone_ckpt
from mvropose_torch.pose import PoseDraws, recover_pose_batch
from mvropose_torch.train import (
    TrainConfig,
    add_auc,
    add_metric,
    angle_mae,
    create_train_state,
    make_multi_view_train_step,
    make_single_view_train_step,
    pck_at_k,
    pose_rotation_err_deg,
    pose_translation_err_m,
)
from mvropose_torch.utils.metrics_writer import MetricWriter
from mvropose_torch.utils.weights import export_jax_params, flax_init_state, int8ify


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
    p.add_argument("--backbone-ckpt", default=None,
                   help="graft a DINO checkpoint (.npz/.pth, timm or HF naming) into the "
                        "backbone before training")
    p.add_argument("--render", choices=("blob", "link"), default="blob")
    p.add_argument("--views", type=int, default=3)
    p.add_argument("--image-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--eval-every", type=int, default=100)
    p.add_argument("--eval-batches", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workdir", default="runs/synth_sv")
    p.add_argument("--cpu", action="store_true", help="run on the CPU in f32")
    p.add_argument("--int8-eval", action="store_true",
                   help="also score the final weights with an int8 backbone and the int8 "
                        "attention (the reference's --int8-backbone --int8-attention)")
    return p


def check_ported(args) -> None:
    """Exit, naming the ROADMAP item, for every flag value not ported yet."""
    unported = [
        (args.render == "link", "--render link", "queue 1, item 11: link rendering"),
    ]
    for hit, flag, item in unported:
        if hit:
            raise SystemExit(f"{flag} is not ported yet (ROADMAP.md {item})")


def check_flags(args, robot) -> None:
    """Exit on flag values that cannot train: the reference's two asserts on
    the FK-consistency term, its refusal of a single-view geometric3d model,
    and (where the reference silently drops the term) the term in multi
    mode."""
    if args.mode == "single" and args.angle_head == "geometric3d":
        raise SystemExit("--angle-head geometric3d is multi-view only (its DLT branch "
                         "triangulates across views); use --mode multi or 'geometric'")
    if args.fk_loss_weight > 0:
        if args.mode != "single":
            raise SystemExit("--fk-loss-weight is a term of the single-view step: use "
                             "--mode single")
        if args.render == "link":
            raise SystemExit("FK-consistency loss projects the J-joint chain; link mode adds a "
                             "keypoint")
        if robot.keypoint_fk_indices is not None:
            raise SystemExit(
                "FK-consistency loss projects the full FK chain, but this robot's keypoint set "
                "is a subset of chain origins (keypoint_fk_indices); the projected points "
                "would not align with keypoints_2d")


def build_model(mode: str, robot, image_size: int, dtype: str, n_views: int,
                freeze_backbone: bool, angle_head: str, device, with_layerscale: bool = False):
    """The reference script's model: a 4-layer 192-wide ViT/16 (4 heads of
    48) under the single- or multi-view estimator; LayerScale where a DINO
    checkpoint is grafted, whose blocks carry it."""
    vit = ViTConfig(image_size=image_size, patch_size=16, hidden_size=192, num_layers=4,
                    num_heads=4, layerscale_init=1e-5 if with_layerscale else None,
                    dtype=dtype)
    cfg = EstimatorConfig(
        vit=vit, num_joints=robot.n_keypoints, num_angles=robot.n_joints,
        heatmap_size=(image_size // 2, image_size // 2), max_views=max(4, n_views),
        num_fusion_queries=8, num_angle_queries=4, freeze_backbone=freeze_backbone,
        dtype=dtype, angle_head=angle_head,
    )
    return (SingleViewPoseEstimator if mode == "single" else MultiViewPoseEstimator)(
        cfg, device=device)


def predict(model, batch: dict):
    """(heatmaps (B, V, J, Hm, Wm), angles (B, A)) of a batch; a single-view
    model's heatmaps get a view axis of 1."""
    if isinstance(model, SingleViewPoseEstimator):
        hm, ang = model(batch["images"])
        return hm[:, None], ang
    return model(batch["images"], batch["view_ids"], batch["view_mask"],
                 proj_mats=batch.get("proj_mats"))


@torch.no_grad()
def pose_eval(model, robot, batches, rig_arrs, size: int, use_gt_angles: bool) -> dict:
    """Recovered camera poses against the rig's true extrinsics, as the
    reference script's `pose_eval`: the refined decode of the predicted
    heatmaps, FK of the predicted (or the true) angles, RANSAC PnP per view
    with identity base rotations. The errors are means over the successful
    recoveries (None if none succeeded); the reference draws every batch's
    hypotheses from the same keys, so one set of draws serves all batches."""
    model.eval()
    K_rig, rv_rig, tv_rig = rig_arrs
    rots, trans, succ = [], [], []
    draws = None
    for b in batches:
        hm, ang = predict(model, b)
        hm = hm[:, :, : robot.n_keypoints].float()
        B, V = hm.shape[:2]
        if draws is None:
            gen = torch.Generator(hm.device).manual_seed(3)
            draws = PoseDraws.draw((B,), V, robot.n_keypoints, robot.n_joints, False, gen,
                                   hm.device)
        eye = torch.eye(3, device=hm.device).expand(V, 3, 3)
        out = recover_pose_batch(hm, b["angles"] if use_gt_angles else ang.float(), eye,
                                 K_rig.expand(V, 3, 3), robot, (size, size), draws=draws,
                                 decode_mode="refine")
        rots.append(pose_rotation_err_deg(out["rvec"], rv_rig[:V]).flatten())
        trans.append(pose_translation_err_m(out["tvec"], tv_rig[:V]).flatten())
        succ.append(out["success"].flatten())
    ok = torch.cat(succ)
    r, t = torch.cat(rots)[ok], torch.cat(trans)[ok]
    return {"rot_err_deg": float(r.mean()) if len(r) else None,
            "trans_err_m": float(t.mean()) if len(t) else None,
            "success_rate": float(ok.float().mean())}


def _take(batch: dict, idx: torch.Tensor) -> dict:
    return {k: v[idx] for k, v in batch.items()}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    check_ported(args)
    robot = get_robot(args.robot)
    check_flags(args, robot)
    if args.cpu:
        device, dtype = torch.device("cpu"), "float32"
    elif torch.cuda.is_available():
        device, dtype = torch.device("cuda"), "bfloat16"
    else:
        raise SystemExit("no CUDA GPU: run on the card, or pass --cpu for an f32 CPU run")
    single = args.mode == "single"
    V, size, hm = 1 if single else args.views, args.image_size, args.image_size // 2
    rig = make_rig(n_views=V, image_hw=(size, size))
    rig_arrs = rig_tuple(rig, device)
    K_rig, rv_rig, tv_rig = rig_arrs

    def synthesize(gen: torch.Generator, n: int) -> dict:
        mv = synthesize_multiview_batch(robot, rig_arrs, gen, n, image_hw=(size, size),
                                        heatmap_hw=(hm, hm), render=args.render)
        if not single:
            return mv
        b = single_view_batch(mv)
        if args.fk_loss_weight > 0:
            # The camera the renderer projected through, per sample; no base
            # rotation in the synthetic world frame.
            b.update(rvec=rv_rig[0].expand(n, 3), tvec=tv_rig[0].expand(n, 3),
                     K=K_rig.expand(n, 3, 3),
                     base_rotation=torch.eye(3, device=device).expand(n, 3, 3))
        return b

    def make_batch(seed: int, n: int) -> dict:
        return synthesize(torch.Generator(device).manual_seed(seed), n)

    # Finite train pool (the reference's regime): made once on the device,
    # then each step gathers a random batch of it.
    pool = None
    if args.dataset_size > 0:
        sizes = [256] * (args.dataset_size // 256) + [args.dataset_size % 256]
        chunks = [make_batch(50_000 + i, n) for i, n in enumerate(s for s in sizes if s)]
        pool = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}

    model = build_model(args.mode, robot, size, dtype, V, args.freeze_backbone, args.angle_head,
                        device, with_layerscale=args.backbone_ckpt is not None)
    model.load_state_dict(flax_init_state(model, seed=1))
    if args.backbone_ckpt:
        graft_backbone_ckpt(model.backbone, args.backbone_ckpt)
        print(f"grafted backbone weights from {args.backbone_ckpt}", flush=True)
    tcfg = TrainConfig(num_epochs=1, steps_per_epoch=args.steps, lr_kpt=args.lr,
                       lr_ang=args.lr_ang if args.lr_ang is not None else args.lr,
                       loss_weight_kpt=100.0, loss_weight_fk=args.fk_loss_weight,
                       freeze_backbone=args.freeze_backbone)
    state = create_train_state(model, tcfg)
    frozen_init = ({k: v.clone() for k, v in model.backbone.state_dict().items()}
                   if args.freeze_backbone else None)
    train_step = (make_single_view_train_step(tcfg, robot=robot) if single
                  else make_multi_view_train_step(tcfg))
    n_params = sum(p.numel() for p in model.parameters())
    eval_batches = [make_batch(20_000 + i, args.batch) for i in range(args.eval_batches)]
    projs = projection_matrix(rv_rig, tv_rig, K_rig)  # (V, 3, 4), image px
    scale = size / hm  # heatmap px -> image px

    @torch.no_grad()
    def eval_metrics(batch: dict) -> dict:
        model.eval()
        pred_hm, pred_ang = predict(model, batch)
        pred_xy = argmax_decode(pred_hm)[0] * scale  # (B, V, J, 2)
        gt_xy = batch["keypoints_2d"].reshape(pred_xy.shape)
        fk_pred = robot.keypoints_from_fk(forward_kinematics(robot, pred_ang))
        gt3 = batch["keypoints_3d"][..., : fk_pred.shape[-2], :]
        out = {
            "pck5": pck_at_k(pred_xy, gt_xy, k_px=5.0),
            "pck_tight": pck_at_k(pred_xy, gt_xy, k_px=2.0 + scale),  # quantization-aware
            "add_m": add_metric(fk_pred, gt3),
            "add_auc_10cm": add_auc(fk_pred, gt3, max_threshold_m=0.10),
            "angle_mae": angle_mae(pred_ang, batch["angles"]),
            "angle_mae_per_joint": (pred_ang - batch["angles"]).abs().mean(dim=0),
        }
        if not single:
            tri = triangulate_keypoints(pred_xy, projs)  # (B, J, 3)
            out["triangulated_add_m"] = add_metric(tri, batch["keypoints_3d"])
        return out

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
            batch = synthesize(data_gen, args.batch)
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
            pred_hm, _ = predict(model, b)
            xy, _ = decode_keypoints(pred_hm, image_hw=(size, size), mode="refine")
            gt = b["keypoints_2d"].reshape(xy.shape)
            res.append((xy - gt).reshape(-1, xy.shape[-2], 2).cpu().numpy())
    np.save(workdir / "decode_residuals.npy", np.concatenate(res))

    def pose_metrics() -> dict:
        pe = pose_eval(model, robot, eval_batches, rig_arrs, size, use_gt_angles=False)
        pe_gt = pose_eval(model, robot, eval_batches, rig_arrs, size, use_gt_angles=True)
        return dict(pose_rot_err_deg=pe["rot_err_deg"], pose_trans_err_m=pe["trans_err_m"],
                    pose_success_rate=pe["success_rate"],
                    pose_rot_err_deg_gt_angles=pe_gt["rot_err_deg"],
                    pose_trans_err_m_gt_angles=pe_gt["trans_err_m"])

    final.update(pose_metrics())

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
    write_run_dir(workdir, model.cfg, size, export_jax_params(model),
                  "single_view" if single else "multi_view")
    if args.int8_eval:
        # The reference's --int8-backbone --int8-attention on the final
        # weights (in place: the float model is not used after this), and
        # each scalar's gap from the float score.
        int8ify(model, attn=True)
        q = {**run_eval(eval_batches), **pose_metrics()}
        final["int8_backbone_attention"] = q
        final["int8_gap"] = {k: v - final[k] for k, v in q.items()
                             if isinstance(v, float) and isinstance(final.get(k), float)}
    (workdir / "final_metrics.json").write_text(json.dumps(final, indent=2))
    print("FINAL " + json.dumps(final), flush=True)
    return final


if __name__ == "__main__":
    main()
