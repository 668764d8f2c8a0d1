"""`python -m mvropose_torch.cli eval`: port of the reference's `cli eval`
(`mvropose_tpu/cli/main.py::_cmd_eval` and `_eval_mixed`).

One robot: the synced CSVs -> the robot's dataset (`cli train`'s builders)
-> the checkpoint's model (its model_config.json, else the flags), optionally
quantized to int8 (`--int8-backbone [--int8-attention]`) -> per batch the
device preprocessing (the GT render kernel on the card), the optional
occlusion probe, the forward, and the metrics: PCK in image pixels from the
hard argmax scaled by (image / heatmap), the refined decode's pixel error,
angle MAE (and per joint), FK-space ADD and its AUC, for the multi-view
model the triangulated ADD, and where the rig has extrinsics (or DREAM's
camera-frame keypoints give the GT pose by Kabsch alignment) the recovered
camera pose by RANSAC PnP per view (`--refine-pose`: also the joint
refinement). The report is one JSON line with the reference's keys in its
order.

Several robots (`--robot a,b`): the mixed-robot checkpoint's PCK, angle MAE
in each robot's own unit and FK-space ADD, per robot.

The random draws (the occlusion rectangles, the RANSAC's and the
refinement's) come from an `EvalDraws`, torch generators seeded as the
reference seeds its keys; a caller may pass another source with the same
methods (the parity tests pass the reference's `jax.random` draws).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from mvropose_torch.cli.main import (
    KINDS,
    build_mixed_dataset,
    build_single_robot_dataset,
    check_runtime,
    host_to_device,
    load_rig_from_args,
    read_model_config,
)
from mvropose_torch.data import IMAGENET_MEAN, IMAGENET_STD
from mvropose_torch.data.augment import draw_masking, random_masking
from mvropose_torch.data.dataset import make_device_preprocessor
from mvropose_torch.data.mixed import PAD_KEYPOINT
from mvropose_torch.decode import decode_keypoints
from mvropose_torch.geometry.heatmap import argmax_decode
from mvropose_torch.geometry.pnp import draw_gumbel
from mvropose_torch.geometry.robots import forward_kinematics_batch
from mvropose_torch.geometry.rotations import kabsch, matrix_to_rodrigues, rodrigues_to_matrix
from mvropose_torch.geometry.triangulation import heatmap_projection_matrices
from mvropose_torch.models import EstimatorConfig, ViTConfig
from mvropose_torch.pose import PoseDraws, recover_pose_multiview, solve_rig_pnp
from mvropose_torch.pose.refine import RESOLVE_HYPOTHESES, refine_rig_pose_angles
from mvropose_torch.train.metrics import (
    add_auc,
    add_metric,
    angle_mae,
    pass_rate_auc,
    pck_at_k,
    pose_rotation_err_deg,
    pose_translation_err_m,
)
from mvropose_torch.utils.weights import int8ify, load_jax_params

RANSAC_HYPOTHESES, REFINE_STARTS = 16, 32


class EvalDraws:
    """The eval's draws from torch generators on `device`: the occlusion
    probe's from one generator seeded 7, a batch's set after the previous
    (the reference splits PRNGKey(7) once a batch); the RANSAC's Gumbel
    draws from a generator seeded 13 and the refinement's from one seeded
    29, both made anew at every batch (the reference splits the constant
    PRNGKey(13) and PRNGKey(29) into B keys in every batch, so every batch
    gets the same draws)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._occlusion = torch.Generator(self.device).manual_seed(7)

    def occlusion(self, n_images: int, num_masks: int) -> tuple[list, list]:
        """(rectangles, colours) of `random_masking` for n images."""
        return draw_masking(self._occlusion, n_images, num_masks)

    def pose(self, B: int, V: int, J: int, A: int, refine: bool) -> PoseDraws:
        """A batch's PoseDraws with leading dimension B."""
        gen = torch.Generator(self.device).manual_seed(13)
        gumbel = draw_gumbel((B, V, RANSAC_HYPOTHESES, J), gen, self.device)
        if not refine:
            return PoseDraws(gumbel)
        gen = torch.Generator(self.device).manual_seed(29)
        starts = torch.randn((B, REFINE_STARTS, A), generator=gen, device=self.device)
        return PoseDraws(gumbel, starts,
                         draw_gumbel((B, V, RESOLVE_HYPOTHESES, J), gen, self.device))


def load_model(params, cfg: EstimatorConfig, kind: str, device: torch.device):
    """The checkpoint's model in eval mode -> (model, the checkpoint's flat
    dict). On the CPU it computes in f32, on the card as its config says."""
    if device.type == "cpu":
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  vit=dataclasses.replace(cfg.vit, dtype="float32"))
    try:
        model = KINDS[kind](cfg, device=device).eval()
    except ValueError as e:  # a single-view geometric3d checkpoint
        raise SystemExit(f"{kind} checkpoint: {e}") from e
    with np.load(params) as data:
        flat = {k: data[k] for k in data.files}
    try:
        load_jax_params(model, flat)
    except (KeyError, ValueError) as e:
        raise SystemExit(
            f"checkpoint/architecture mismatch loading {params}: {e}\nThe constructed model "
            f"(angle_head={cfg.angle_head!r}) does not match the trained one. If the run "
            "predates model_config.json, pass the training-time --angle-head/--model-size/"
            "--hidden-size/--num-layers/--patch-size/--register-tokens/--backbone-native-size; "
            "otherwise copy model_config.json from the training workdir next to the params "
            "file.") from e
    return model, flat


def _occluder(num_masks: int, draws, device):
    """The occlusion probe on the model's normalized inputs (..., S, S, 3):
    back to [0, 1], clipped, `num_masks` solid rectangles an image, then
    normalized again; the identity at 0 masks."""
    mean = torch.from_numpy(IMAGENET_MEAN).to(device)
    std = torch.from_numpy(IMAGENET_STD).to(device)

    def occlude(x: torch.Tensor) -> torch.Tensor:
        if num_masks <= 0:
            return x
        flat = x.reshape(-1, *x.shape[-3:])
        raw = (flat * std + mean).clamp(0, 1)
        raw = random_masking(raw, *draws.occlusion(flat.shape[0], num_masks))
        return ((raw - mean) / std).reshape(x.shape).to(x.dtype)

    return occlude


class _Accumulators:
    """Weighted (sum, weight) pairs, so a short last batch counts by its
    samples and not as a whole batch."""

    def __init__(self, *keys):
        self.acc = {k: [0.0, 0.0] for k in keys}

    def bump(self, key: str, value, weight: float) -> None:
        if weight > 0:
            self.acc[key][0] += float(value) * weight
            self.acc[key][1] += weight

    def mean(self, key: str) -> float:
        return self.acc[key][0] / max(self.acc[key][1], 1e-9)


def evaluate(args, draws=None, frames: dict | None = None) -> dict:
    """`cli eval` for one robot -> the report (the dict printed as JSON).
    `draws` (default `EvalDraws` on the model's device) gives the random
    draws; `frames`, where given, receives the per-frame values behind the
    report's pose means (each `pose_rot_err_deg*` / `pose_trans_err_m*` key
    with its list, one value a solved view)."""
    if "," in args.robot:
        return evaluate_mixed(args)
    if args.int8_attention and not args.int8_backbone:
        raise SystemExit("--int8-attention runs only with --int8-backbone")
    device = check_runtime(args, "eval")
    draws = draws or EvalDraws(device)
    put = lambda a: host_to_device(a, device)  # noqa: E731
    image_hw = tuple(args.image_hw)
    img_h, img_w = image_hw
    rig = load_rig_from_args(args)
    ds, multi_view = build_single_robot_dataset(args, rig, image_hw)

    saved = read_model_config(args.params)
    if saved is not None:
        # The architecture of the training run: the flags are not read.
        cfg, model_size, kind = saved
        want = "multi_view" if multi_view else "single_view"
        if kind != want:
            raise SystemExit(f"checkpoint is a {kind} model but the dataset flags select "
                             f"{want} (--robot/--single-view)")
        print(f"model architecture restored from {Path(args.params).parent / 'model_config.json'}")
    else:
        model_size, kind = args.model_size, "multi_view" if multi_view else "single_view"
        vit = ViTConfig(
            image_size=args.backbone_native_size or args.model_size, patch_size=args.patch_size,
            hidden_size=args.hidden_size, num_layers=args.num_layers,
            num_heads=args.hidden_size // 64, num_register_tokens=args.register_tokens,
            dtype="bfloat16", use_rope=args.rope, layer_norm_eps=1e-5 if args.rope else 1e-6)
        cfg = EstimatorConfig(vit=vit, num_joints=rig.num_keypoints,
                              num_angles=rig.robot.n_joints, heatmap_size=rig.heatmap_size,
                              max_views=2 * len(rig.serial_to_view), angle_head=args.angle_head)
    model, flat = load_model(args.params, cfg, kind, device)
    if args.int8_backbone:
        int8ify(model, flat, attn=args.int8_attention)
        print("backbone quantized to int8 (per-channel weights, dynamic per-token activations)"
              + (" + int8-prob attention" if args.int8_attention else ""))
    geo3d = multi_view and model.cfg.angle_head == "geometric3d"
    pre = make_device_preprocessor(ds.geometry, model_size, rig.heatmap_size, rig.sigma,
                                   device=device)
    occlude = _occluder(args.occlusion_masks, draws, device)
    robot = rig.robot

    rig_has_extrinsics = bool(rig.extrinsics)
    # DREAM's camera-frame keypoints give each sample's GT camera pose by
    # rigid alignment of the GT-angle FK skeleton to them.
    pose_gt_by_alignment = not multi_view and ds.has_kp3d
    if multi_view or rig_has_extrinsics or pose_gt_by_alignment:
        ds.with_extrinsics = True  # the triangulated ADD's and the pose errors' cameras
    refined_ang_abs: list = []

    def tri_add(pred_hm, batch, fk_gt):
        """Per valid sample: the mean distance of the triangulated decoded
        keypoints (>= 2 confident views) to the GT FK skeleton rotated into
        the world frame by the first valid view's base rotation, and the
        share of keypoints triangulated."""
        vals, obs_fracs = [], []
        for b in range(pred_hm.shape[0]):
            if batch["sample_weight"][b] == 0:
                continue
            pts3d, obs = recover_pose_multiview(
                pred_hm[b], put(batch["view_mask"][b]), put(batch["rvec"][b]),
                put(batch["tvec"][b]), put(batch["K"][b]), image_hw)
            obs = obs.cpu().numpy()
            obs_fracs.append(float(obs.mean()))
            if obs.sum() < 1:
                continue
            v0 = int(np.argmax(batch["view_mask"][b]))
            gt_world = fk_gt[b] @ batch["base_rotation"][b, v0].T
            d = np.linalg.norm(pts3d.cpu().numpy() - gt_world, axis=-1)
            vals.append(float(np.mean(d[obs > 0])))
        return vals, obs_fracs

    def pose_errors(pred_hm, angle_variants, batch):
        """Per angle variant (and with --refine-pose the refined fit last):
        (rotation errors, translation errors) where PnP succeeded on a valid
        view, successes over valid views, and the all-frames ADD (a failed
        solve inf) where the batch has camera-frame keypoints."""
        if "rvec" not in batch or not (rig_has_extrinsics or pose_gt_by_alignment):
            return [([], [], [], []) for _ in angle_variants]
        hm = pred_hm if multi_view else pred_hm[:, None]
        rv, tv, Kb, base = (put(np.asarray(batch[k], np.float32))
                            for k in ("rvec", "tvec", "K", "base_rotation"))
        if not multi_view:  # (B, ...) -> (B, 1, ...): a one-camera rig
            rv, tv, Kb, base = rv[:, None], tv[:, None], Kb[:, None], base[:, None]
        B, V, J = hm.shape[:3]
        xy, conf = decode_keypoints(hm, image_hw=image_hw, mode="refine")
        vm = (np.asarray(batch["view_mask"], bool) if multi_view
              else np.asarray(batch["sample_weight"]) > 0).reshape(B, V)
        pd = draws.pose(B, V, J, angle_variants[0].shape[-1], args.refine_pose)

        def variant_metrics(out, ang):
            rot = pose_rotation_err_deg(out["rvec"], rv).cpu().numpy()
            trans = pose_translation_err_m(out["tvec"], tv).cpu().numpy()
            succ = out["success"].cpu().numpy()
            ok = vm & succ
            adds = []
            if "keypoints_3d_cam" in batch:
                # FK(angles) through the per-view base rotation and the
                # recovered pose, against the stored camera-frame points.
                fk_kp = robot.keypoints_from_fk(forward_kinematics_batch(robot, ang))
                fk_obj = torch.einsum("bvij,bkj->bvki", base, fk_kp)
                pts_cam = (torch.einsum("bvij,bvkj->bvki", rodrigues_to_matrix(out["rvec"]),
                                        fk_obj) + out["tvec"][:, :, None, :])
                d = torch.linalg.norm(pts_cam - put(batch["keypoints_3d_cam"])[:, None], dim=-1)
                d_mean = d.mean(-1).cpu().numpy()
                adds = list(np.where(succ, d_mean, np.inf)[vm])
            return list(rot[ok]), list(trans[ok]), list(succ[vm].astype(np.float32)), adds

        results, out_pred = [], None
        for ang in angle_variants:
            out = solve_rig_pnp(xy, conf, ang, base, Kb, robot, gumbel=pd.gumbel)
            if out_pred is None:  # the predicted angles' PnP: the refinement's start
                out_pred = out
            results.append(variant_metrics(out, ang))
        if args.refine_pose:
            # The joint (pose, angles) fit from the predicted-angle PnP pose,
            # the predicted angles a prior; it always returns a pose.
            ref = refine_rig_pose_angles(
                xy, conf, angle_variants[0], out_pred["rvec"], out_pred["tvec"], base, Kb,
                robot, starts=pd.starts, regumbel=pd.regumbel, view_mask=put(vm),
                sigma_px=args.refine_sigma_px, sigma_prior=args.refine_sigma_prior)
            results.append(variant_metrics(
                {"rvec": ref["rvec"], "tvec": ref["tvec"],
                 "success": torch.ones((B, V), dtype=torch.bool, device=device)},
                ref["angles"]))
            refined_ang_abs.extend(np.abs(ref["angles"].cpu().numpy() - batch["angles"])[
                vm.any(axis=1)].mean(axis=1))
        return results

    acc = _Accumulators("pck", "mae", "add", "auc", "kp_px", "kp_px2")
    tri_adds, tri_obs, pose_rots, pose_trans, pose_succ, pnp_adds = [], [], [], [], [], []
    pose_rots_gt, pose_trans_gt, pnp_adds_gt = [], [], []
    pose_rots_ref, pose_trans_ref, pnp_adds_ref = [], [], []
    per_joint_sum, n = None, 0
    scale = None
    with torch.inference_mode():
        for batch in ds.batches(args.batch_size):
            imgs, _ = pre(put(batch["images_u8"]), put(batch["cam_idx"]),
                          put(batch["keypoints_2d"]))
            imgs = occlude(imgs)
            if multi_view:
                pm = None
                if geo3d:
                    rv, tv, K = (put(batch[k]) for k in ("rvec", "tvec", "K"))
                    Bv, V = rv.shape[:2]
                    pm = heatmap_projection_matrices(
                        rv.reshape(Bv * V, 3), tv.reshape(Bv * V, 3), K.reshape(Bv * V, 3, 3),
                        image_hw, rig.heatmap_size).reshape(Bv, V, 3, 4)
                view_mask = put(batch["view_mask"])
                pred_hm, pred_ang = model(imgs, put(batch["view_ids"]), view_mask, proj_mats=pm)
                valid = view_mask[..., None]
                n_valid = float(batch["view_mask"].sum())
            else:
                pred_hm, pred_ang = model(imgs)
                valid = put(batch["sample_weight"])[..., None]
                n_valid = float(batch["sample_weight"].sum())
            pred_hm, pred_ang = pred_hm.float(), pred_ang.float()
            # PCK in image pixels against the exact GT keypoints.
            pred_xy, _ = argmax_decode(pred_hm)
            hm_h, hm_w = pred_hm.shape[-2:]
            if scale is None:
                scale = torch.tensor([img_w / hm_w, img_h / hm_h], dtype=torch.float32,
                                     device=device)
            gt_xy = put(batch["keypoints_2d"])
            in_frame = ((gt_xy[..., 0] >= 0) & (gt_xy[..., 0] < img_w)
                        & (gt_xy[..., 1] >= 0) & (gt_xy[..., 1] < img_h))
            kp_valid = (valid > 0) & in_frame
            acc.bump("pck", pck_at_k(pred_xy * scale, gt_xy, k_px=args.pck_px, valid=kp_valid),
                     float(kp_valid.sum()))
            # The pixel error of the refined decode, the one the PnP reads.
            ref_xy = decode_keypoints(pred_hm, image_hw=image_hw, mode="refine")[0]
            kp_err = torch.linalg.norm(ref_xy - gt_xy, dim=-1)
            kw = kp_valid.float()
            n_kp = float(kw.sum())
            if n_kp > 0:
                acc.bump("kp_px", (kp_err * kw).sum() / n_kp, n_kp)
                acc.bump("kp_px2", (kp_err.square() * kw).sum() / n_kp, n_kp)
            gt_ang = put(batch["angles"])
            # A sample that failed to load weighs 0 in the angle metrics.
            samp_w = (view_mask.any(dim=1) if multi_view
                      else put(batch["sample_weight"]) > 0).float()
            n_samp = float(samp_w.sum())
            acc.bump("mae", angle_mae(pred_ang, gt_ang, valid=samp_w), n_samp)
            pj = ((pred_ang - gt_ang).abs() * samp_w[:, None]).sum(0).cpu().numpy()
            per_joint_sum = pj if per_joint_sum is None else per_joint_sum + pj
            fk_pred = forward_kinematics_batch(robot, pred_ang)
            fk_gt = forward_kinematics_batch(robot, gt_ang)
            acc.bump("add", add_metric(fk_pred, fk_gt, valid=samp_w[:, None]), n_samp)
            acc.bump("auc", add_auc(fk_pred, fk_gt, valid=samp_w), n_samp)
            if multi_view:
                ta, to = tri_add(pred_hm, batch, fk_gt.cpu().numpy())
                tri_adds.extend(ta)
                tri_obs.extend(to)
            if pose_gt_by_alignment and "keypoints_3d_cam" in batch:
                # The GT camera pose: the GT-angle FK keypoints, through the
                # base rotation PnP's object points take, aligned to the
                # stored camera-frame points.
                fk_kp_gt = torch.einsum("bij,bkj->bki", put(batch["base_rotation"]),
                                        robot.keypoints_from_fk(fk_gt))
                R_gt, t_gt = kabsch(fk_kp_gt, put(batch["keypoints_3d_cam"]))
                batch = dict(batch, rvec=matrix_to_rodrigues(R_gt).cpu().numpy(),
                             tvec=t_gt.cpu().numpy())
            # With measured joint states (DREAM's deployment) the GT-angle
            # PnP is the protocol number; both share one decode.
            variants = [pred_ang] + ([gt_ang] if pose_gt_by_alignment else [])
            res = pose_errors(pred_hm, variants, batch)
            r, t, s, a = res[0]
            pose_rots += r
            pose_trans += t
            pose_succ += s
            pnp_adds += a
            if pose_gt_by_alignment:
                rg, tg, _, ag = res[1]
                pose_rots_gt += rg
                pose_trans_gt += tg
                pnp_adds_gt += ag
            if args.refine_pose and len(res) > len(variants):
                rr, tr, _, ar = res[-1]
                pose_rots_ref += rr
                pose_trans_ref += tr
                pnp_adds_ref += ar
            n += int(n_valid)
    if frames is not None:
        for suffix, rots, trans in (("", pose_rots, pose_trans),
                                    ("_gt_angles", pose_rots_gt, pose_trans_gt),
                                    ("_refined", pose_rots_ref, pose_trans_ref)):
            if rots:
                frames[f"pose_rot_err_deg{suffix}"] = [float(v) for v in rots]
                frames[f"pose_trans_err_m{suffix}"] = [float(v) for v in trans]
    if n == 0:
        raise SystemExit(
            "eval: every sample had weight 0 - no image loaded at the expected resolution "
            f"{image_hw} (the loader requires exact size; pass --image-hw matching the "
            "dataset's images) or all paths failed to read.")
    report = {
        f"pck@{args.pck_px}px": acc.mean("pck"),
        "kp_px_err_mean": acc.mean("kp_px"),
        "kp_px_err_rms": float(np.sqrt(acc.mean("kp_px2"))),
        "angle_mae": acc.mean("mae"),
        "angle_mae_per_joint": [round(float(v), 4)
                                for v in per_joint_sum / max(acc.acc["mae"][1], 1e-9)],
        "add_m": acc.mean("add"),
        "add_auc@10cm": acc.mean("auc"),
        "samples": n,
        "occlusion_masks": args.occlusion_masks,
    }
    if tri_adds:
        report["triangulated_add_m"] = float(np.mean(tri_adds))
        report["triangulated_obs_rate"] = float(np.mean(tri_obs))
    if pose_succ:
        report["pose_success_rate"] = float(np.mean(pose_succ))
        if pose_rots:
            report["pose_rot_err_deg"] = float(np.mean(pose_rots))
            report["pose_trans_err_m"] = float(np.mean(pose_trans))

        def pnp_add_report(adds, suffix=""):
            # Over all frames: a failed solve is inf and never passes; the
            # mean is over the converged ones.
            v = np.asarray(adds)
            finite = v[np.isfinite(v)]
            if finite.size:
                report[f"pnp_add_m_converged{suffix}"] = float(np.mean(finite))
            report[f"pnp_add_pass@10cm{suffix}"] = float(np.mean(v <= 0.10))
            report[f"pnp_add_auc@10cm{suffix}"] = float(pass_rate_auc(torch.from_numpy(
                v.astype(np.float32))))

        if pnp_adds:
            pnp_add_report(pnp_adds)
        if pose_rots_gt:
            report["pose_rot_err_deg_gt_angles"] = float(np.mean(pose_rots_gt))
            report["pose_trans_err_m_gt_angles"] = float(np.mean(pose_trans_gt))
        if pnp_adds_gt:
            pnp_add_report(pnp_adds_gt, "_gt_angles")
        if pose_rots_ref:
            report["pose_rot_err_deg_refined"] = float(np.mean(pose_rots_ref))
            report["pose_trans_err_m_refined"] = float(np.mean(pose_trans_ref))
            report["refined_angle_mae"] = float(np.mean(refined_ang_abs))
        if pnp_adds_ref:
            pnp_add_report(pnp_adds_ref, "_refined")
    return report


def evaluate_mixed(args) -> dict:
    """`cli eval --robot a,b`: a mixed-robot checkpoint's PCK, angle MAE in
    each robot's own unit (FK of its own angles for the ADD) and FK-space
    ADD, per robot; padded keypoint channels are not counted."""
    robots = args.robot.split(",")
    if len(args.csv) != len(robots):
        raise SystemExit(f"--robot {args.robot} needs {len(robots)} --csv files (one per robot)")
    device = check_runtime(args, "eval")
    put = lambda a: host_to_device(a, device)  # noqa: E731
    image_hw = tuple(args.image_hw)
    ds = build_mixed_dataset(args, image_hw)
    saved = read_model_config(args.params)
    if saved is None:
        raise SystemExit("mixed eval needs model_config.json beside --params")
    cfg, model_size, kind = saved
    if kind != "single_view":
        raise SystemExit(f"mixed eval expects a single_view checkpoint, got {kind}")
    if cfg.num_joints < ds.num_keypoints or cfg.num_angles < ds.num_angles:
        raise SystemExit(
            f"checkpoint arity ({cfg.num_joints} kp / {cfg.num_angles} ang) is narrower than "
            f"the widest robot ({ds.num_keypoints}/{ds.num_angles})")
    model, _ = load_model(args.params, cfg, kind, device)
    rig0 = ds.children[0].geometry.rig
    pre = make_device_preprocessor(ds.geometry, model_size, cfg.heatmap_size, rig0.sigma,
                                   device=device)
    img_h, img_w = image_hw
    stats = {r: {"pck_n": 0.0, "pck_d": 0.0, "mae": 0.0, "add": 0.0, "n": 0.0} for r in robots}
    with torch.inference_mode():
        for batch in ds.batches(args.batch_size):
            imgs, _ = pre(put(batch["images_u8"]), put(batch["cam_idx"]),
                          put(batch["keypoints_2d"]))
            hm, ang = model(imgs)
            xy, _ = argmax_decode(hm.float())
            scale = np.asarray([img_w / hm.shape[-1], img_h / hm.shape[-2]], np.float32)
            pred_xy = xy.cpu().numpy() * scale
            pred_ang = ang.float().cpu().numpy()
            gt_xy = batch["keypoints_2d"]
            w = batch["sample_weight"] > 0
            kp_real = gt_xy[..., 0] > PAD_KEYPOINT + 1.0  # padded channels excluded
            in_frame = ((gt_xy[..., 0] >= 0) & (gt_xy[..., 0] < img_w)
                        & (gt_xy[..., 1] >= 0) & (gt_xy[..., 1] < img_h))
            kp_valid = kp_real & in_frame & w[:, None]
            err = np.linalg.norm(pred_xy - gt_xy, axis=-1)
            for ci, rname in enumerate(robots):
                sel = (batch["robot_id"] == ci) & w
                if not sel.any():
                    continue
                robot = ds.children[ci].geometry.rig.robot
                A = robot.n_joints
                kv = kp_valid & sel[:, None]
                st = stats[rname]
                st["pck_n"] += float(((err <= args.pck_px) & kv).sum())
                st["pck_d"] += float(kv.sum())
                # The angles train in radians: back to the robot's unit.
                to_native = 1.0 / float(ds.angle_scale[ci])
                pa = pred_ang[sel][:, :A] * to_native
                ga = batch["angles"][sel][:, :A] * to_native
                st["mae"] += float(np.abs(pa - ga).sum() / A)
                fk_p = forward_kinematics_batch(robot, torch.from_numpy(pa))
                fk_g = forward_kinematics_batch(robot, torch.from_numpy(ga))
                st["add"] += float(torch.linalg.norm(fk_p - fk_g, dim=-1).mean(-1).sum())
                st["n"] += float(sel.sum())
    report = {"robots": robots, "samples": int(sum(s["n"] for s in stats.values()))}
    for ci, rname in enumerate(robots):
        s = stats[rname]
        n = max(s["n"], 1e-9)
        report[rname] = {
            f"pck@{args.pck_px}px": s["pck_n"] / max(s["pck_d"], 1e-9),
            "angle_mae_native": s["mae"] / n,
            "angle_unit": ds.children[ci].geometry.rig.robot.angle_unit,
            "add_m": s["add"] / n,
            "samples": int(s["n"]),
        }
    return report


def cmd_eval(args) -> int:
    print(json.dumps(evaluate(args)))
    return 0
