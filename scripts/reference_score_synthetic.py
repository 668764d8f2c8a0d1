#!/usr/bin/env python3
"""Score a single-view synthetic run's checkpoint with the reference's own held-out evaluation.

    python scripts/reference_score_synthetic.py RUN_DIR [--dtype bfloat16]

RUN_DIR holds `best_params.npz` (the reference's flat layout, as
`scripts/torch_train_synthetic.py` or the reference's trainer writes it)
and `final_metrics.json` (its `image_size` and `batch` are read) of the
single-view fr5 model that `scripts/train_synthetic.py --backbone-ckpt`
builds (a 192-wide, 4-layer ViT/16 with LayerScale, the query head). This
script runs the JAX package only, on the CPU: it builds that model with
`scripts/train_synthetic.py::build_model`, loads the checkpoint's params and
BatchNorm statistics, and repeats `train_synthetic.py`'s final evaluation on
its own held-out pool (`make_batch(PRNGKey(20_000 + i))`, i < 4, the
trainer's default `--eval-batches`):
PCK@5 and the tight PCK on the argmax decode, angle MAE, ADD, AUC@10cm, then
the 6D camera pose by `recover_pose_batch` on the refined decode (keys
split from PRNGKey(3)) with the predicted and with the true angles, errors
over the successful recoveries. It prints one JSON object with
`final_metrics.json`'s keys. So a checkpoint trained by the port
is scored with the same data draws, decode and PnP as the reference's run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

EVAL_BATCHES = 4  # scripts/train_synthetic.py's default --eval-batches

def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("run_dir", type=Path)
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                   help="the model's compute type (bfloat16: as the reference's run on a TPU)")
    args = p.parse_args()

    from mvropose_tpu.cli.main import _load_variables_checked
    from mvropose_tpu.data.synthetic import make_rig, rig_tuple, single_view_batch, \
        synthesize_multiview_batch
    from mvropose_tpu.geometry.heatmap import argmax_decode
    from mvropose_tpu.geometry.robots import forward_kinematics, get_robot
    from mvropose_tpu.pose import recover_pose_batch
    from mvropose_tpu.train import add_auc, add_metric, angle_mae, pck_at_k, \
        pose_rotation_err_deg, pose_translation_err_m
    from scripts.train_synthetic import build_model

    run = json.loads((args.run_dir / "final_metrics.json").read_text())
    robot = get_robot("fr5")
    size, n_batch = run["image_size"], run["batch"]
    hm = size // 2
    rig = rig_tuple(make_rig(n_views=1, image_hw=(size, size)))
    model, _ = build_model("single", robot, size, on_tpu=args.dtype == "bfloat16", n_views=1,
                           freeze_backbone=True, with_layerscale=True)
    variables = model.init(jax.random.PRNGKey(1), jnp.zeros((1, size, size, 3), jnp.float32))
    variables = _load_variables_checked(args.run_dir / "best_params.npz", variables, "query")

    def make_batch(key):
        return single_view_batch(synthesize_multiview_batch(
            robot, rig, key, n_batch, image_hw=(size, size), heatmap_hw=(hm, hm)))

    batches = [make_batch(jax.random.PRNGKey(20_000 + i)) for i in range(EVAL_BATCHES)]
    apply = jax.jit(model.apply)

    def metrics(batch):
        pred_hm, pred_ang = apply(variables, batch["images"])
        pred_xy, _ = argmax_decode(pred_hm)
        scale = size / hm
        gt_xy = batch["keypoints_2d"]
        fk = robot.keypoints_from_fk(jax.vmap(lambda a: forward_kinematics(robot, a))(pred_ang))
        gt3 = batch["keypoints_3d"][..., : fk.shape[-2], :]
        return {"pck5": pck_at_k(pred_xy * scale, gt_xy, k_px=5.0),
                "pck_tight": pck_at_k(pred_xy * scale, gt_xy, k_px=2.0 + scale),
                "add_m": add_metric(fk, gt3), "add_auc_10cm": add_auc(fk, gt3, max_threshold_m=0.10),
                "angle_mae": angle_mae(pred_ang, batch["angles"]),
                "angle_mae_per_joint": jnp.mean(jnp.abs(pred_ang - batch["angles"]), axis=0)}

    ms = [metrics(b) for b in batches]
    final = {}
    for k in ms[0]:
        avg = np.mean(np.stack([np.asarray(m[k]) for m in ms]), axis=0)
        final[k] = avg.round(4).tolist() if avg.ndim else float(avg)

    K_rig, rv_rig, tv_rig = rig
    eye, Ks = jnp.eye(3, dtype=jnp.float32)[None], K_rig[None]

    def pose_eval(use_gt_angles: bool) -> dict:
        rots, trans, succ = [], [], []
        for b in batches:
            hm_b, ang_b = apply(variables, b["images"])
            hm_b = hm_b[:, None, : robot.n_keypoints]
            angles = b["angles"] if use_gt_angles else ang_b
            out = jax.vmap(lambda h, a, k: recover_pose_batch(
                h, a, eye, Ks, robot, (size, size), key=k, decode_mode="refine"))(
                hm_b, angles, jax.random.split(jax.random.PRNGKey(3), hm_b.shape[0]))
            rots.append(np.asarray(pose_rotation_err_deg(out["rvec"], rv_rig[None, :1])).ravel())
            trans.append(np.asarray(pose_translation_err_m(out["tvec"], tv_rig[None, :1])).ravel())
            succ.append(np.asarray(out["success"]).ravel())
        ok = np.concatenate(succ) > 0
        r, t = np.concatenate(rots), np.concatenate(trans)
        return {"rot": float(r[ok].mean()) if ok.any() else None,
                "trans": float(t[ok].mean()) if ok.any() else None, "success": float(ok.mean())}

    pe, pe_gt = pose_eval(False), pose_eval(True)
    final.update(pose_rot_err_deg=pe["rot"], pose_trans_err_m=pe["trans"],
                 pose_success_rate=pe["success"], pose_rot_err_deg_gt_angles=pe_gt["rot"],
                 pose_trans_err_m_gt_angles=pe_gt["trans"], scored_by="reference",
                 checkpoint=str(args.run_dir / "best_params.npz"), dtype=args.dtype,
                 held_out_samples=n_batch * EVAL_BATCHES)
    print(json.dumps(final, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
