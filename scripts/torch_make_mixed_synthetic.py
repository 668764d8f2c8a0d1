"""Generate per-robot synthetic single-view datasets in each robot's own
capture schema, for mixed-robot training, with the torch port.

The port's copy of `scripts/make_mixed_synthetic.py` (the same flags, the
same numpy draws from --seed, so the same seed writes the same angles,
cameras and keypoints). For every robot of --robots, under --out-dir:
  * images `<robot>/<images|pose1>/zed_<serial>_left_<ts>.jpg`, blob renders
    at the rig's GT keypoints (FR3's under pose1/, its capture layout);
  * the robot's synced CSV (fr5/meca: joint_1..N in degrees; fr3:
    position_fr3_joint1..7 in radians; meca_insertion: its robot_data.txt
    log synced by the port's `sync_meca_insertion`);
  * shared `calib/{view}_{serial}_leftcam_calib.json` files and per-robot
    ArUco summaries (`<robot>_aruco_pose_summary.json`, FR3's
    `pose1_aruco_pose_summary.json`).
The rig is the one `cli train` loads (`calib/registry.py::load_rig` over the
files just written) and the blobs sit at its `gt_keypoints`, so the labels
are exact. The render runs on --device (the card's render kernel by default).

Usage:
    python scripts/torch_make_mixed_synthetic.py --out-dir data_synth/mixed \
        --robots fr5 fr3 --n-samples 2000 --seed 0 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# One camera a robot. The view names differ, so the robots share one calib
# directory (its files and the extrinsic records are keyed by {view}_{cam});
# meca_insertion runs the Meca500 chain on its own rig's "front" view, so it
# does not combine with meca500 in one set.
ROBOT_CAMERA = {
    "fr5": {"serial": "38007749", "view": "left", "robot_name": "fr5"},
    "fr3": {"serial": "41182735", "view": "view1", "robot_name": "fr3"},
    "meca500": {"serial": "41182735", "view": "front", "robot_name": "meca500"},
    "meca_insertion": {"serial": "41182735", "view": "front", "robot_name": "meca500"},
}
# Angle half-ranges in each robot's unit, which keep every keypoint in frame.
ANGLE_HALF = {"fr5": 45.0, "fr3": 0.55, "meca500": 40.0, "meca_insertion": 40.0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--robots", nargs="+", default=["fr5", "fr3"], choices=sorted(ROBOT_CAMERA))
    p.add_argument("--n-samples", type=int, default=2000)
    p.add_argument("--image-hw", type=int, nargs=2, default=(128, 128))
    p.add_argument("--focal-scale", type=float, default=0.96)
    p.add_argument("--noise-std", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--calib-from", default=None,
                   help="reuse an existing set's calib/ and ArUco summaries (a held-out eval "
                        "set must share the train set's cameras): pass the train --out-dir "
                        "here and a new --seed for fresh angles")
    p.add_argument("--device", default="cuda", help="torch device of the render (default cuda)")
    args = p.parse_args(argv)

    import cv2
    import torch

    from mvropose_torch.calib.registry import load_rig
    from mvropose_torch.data.dataset import SingleViewSample, _RigGeometry
    from mvropose_torch.data.sync import SyncConfig, sync_meca_insertion
    from mvropose_torch.data.synthetic import _look_at, joint_palette, render_blob_images
    from mvropose_torch.data.table import Table
    from mvropose_torch.geometry.robots import forward_kinematics, get_robot
    from mvropose_torch.geometry.rotations import matrix_to_rodrigues

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available (pass --device "
                         "cpu to render on the CPU)")
    device = torch.device(args.device)
    out = Path(args.out_dir)
    calib_dir = out / "calib"
    calib_dir.mkdir(parents=True, exist_ok=True)
    h, w = args.image_hw
    K = np.array([[args.focal_scale * w, 0, w / 2.0], [0, args.focal_scale * w, h / 2.0],
                  [0, 0, 1]], dtype=np.float32)

    rng = np.random.default_rng(args.seed)
    for rname in args.robots:
        spec = ROBOT_CAMERA[rname]
        serial, view = spec["serial"], spec["view"]
        robot = get_robot(spec["robot_name"])
        prefix = "pose1" if rname == "fr3" else rname
        if args.calib_from:
            src = Path(args.calib_from)
            calib_dir = src / "calib"
            summary = src / f"{prefix}_aruco_pose_summary.json"
        else:
            # Aim the camera at the robot's workspace through the view's base
            # rotation: the FK keypoint cloud of 256 random poses, looked at
            # from a distance at which it spans ~70% of the frame.
            half = ANGLE_HALF[rname]
            probe = rng.uniform(-half, half, size=(256, robot.n_joints)).astype(np.float32)
            base = torch.from_numpy(robot.base_rotation(view))
            cloud = robot.keypoints_from_fk(
                forward_kinematics(robot, torch.from_numpy(probe), base)).numpy().reshape(-1, 3)
            centroid = cloud.mean(axis=0)
            radius = float(np.linalg.norm(cloud - centroid, axis=1).max())
            dist = 2.0 * radius * args.focal_scale / 0.35
            direction = np.array([0.83, 0.35, 0.43])
            center = centroid + dist * direction / np.linalg.norm(direction)
            R = _look_at(center, centroid)
            cam_rvec = matrix_to_rodrigues(torch.tensor(R, dtype=torch.float32)).numpy()
            cam_tvec = (-R @ center).astype(np.float32)
            (calib_dir / f"{view}_{serial}_leftcam_calib.json").write_text(json.dumps({
                "camera_matrix": K.tolist(), "distortion_coeffs": [0.0] * 5}))
            rec = {"view": view, "cam": "leftcam", "rvec_unit": "rad",
                   "rvec_x": float(cam_rvec[0]), "rvec_y": float(cam_rvec[1]),
                   "rvec_z": float(cam_rvec[2]), "tvec_x": float(cam_tvec[0]),
                   "tvec_y": float(cam_tvec[1]), "tvec_z": float(cam_tvec[2])}
            summary = out / f"{prefix}_aruco_pose_summary.json"
            summary.write_text(json.dumps([rec]))

        rig = load_rig(rname, spec["robot_name"], {serial: view}, calib_dir=calib_dir,
                       aruco_summary_paths={"pose1": summary} if rname == "fr3" else summary)
        geom = _RigGeometry(rig, (h, w))
        ckey = f"{view}_leftcam"
        ekey = f"pose1_{ckey}" if rname == "fr3" else ckey

        half = ANGLE_HALF[rname]
        angles = rng.uniform(-half, half, size=(args.n_samples, robot.n_joints)).astype(np.float32)
        img_dir = out / rname / ("pose1" if rname == "fr3" else "images")
        img_dir.mkdir(parents=True, exist_ok=True)
        txt_lines = ["timestamp,j1,j2,j3,j4,j5,j6,j7,x,y,z,a,b"]  # meca_insertion's log
        palette = torch.from_numpy(joint_palette(rig.num_keypoints)).to(device)
        kps = np.stack([geom.gt_keypoints(SingleViewSample(image_path="", camera_key=ckey,
                                                           view=view, angles=a), ekey)
                        for a in angles])  # (N, J, 2)
        oob = (kps[..., 0] < 0) | (kps[..., 0] >= w) | (kps[..., 1] < 0) | (kps[..., 1] >= h)
        print(f"{rname}: {args.n_samples} samples, OOB keypoint frac {oob.mean():.4f}")
        rows = []
        batch = 256
        for s in range(0, args.n_samples, batch):
            e = min(s + batch, args.n_samples)
            noise = args.noise_std * rng.standard_normal((e - s, h, w, 3)).astype(np.float32)
            imgs = render_blob_images(torch.from_numpy(kps[s:e]).to(device), (h, w), palette,
                                      noise=torch.from_numpy(noise).to(device)).cpu().numpy()
            imgs = ((imgs * 0.5 + 0.5) * 255.0).clip(0, 255).astype(np.uint8)
            for i in range(s, e):
                ts = 1000.0 + i
                path = img_dir / f"zed_{serial}_left_{ts}.jpg"
                cv2.imwrite(str(path), imgs[i - s][..., ::-1])
                if rname == "meca_insertion":
                    # The log's row: ts, the 6 actuated joints and the tool
                    # channel, 5 cartesian values.
                    txt_lines.append(",".join([f"{ts}"] + [f"{float(angles[i, j])}"
                                                           for j in range(robot.n_joints)]
                                              + ["0.0"] + ["0.0"] * 5))
                    continue
                names = ([f"position_fr3_joint{j + 1}" for j in range(robot.n_joints)]
                         if rname == "fr3" else [f"joint_{j + 1}" for j in range(robot.n_joints)])
                rows.append({"image_path": str(path),
                             **{n: float(angles[i, j]) for j, n in enumerate(names)}})
        if rname == "meca_insertion":
            txt = out / rname / "robot_data.txt"
            txt.write_text("\n".join(txt_lines))
            table = sync_meca_insertion([img_dir], txt, SyncConfig(tolerance_s=0.05))
            table.to_csv(out / f"{rname}.csv")
            print(f"wrote {out / f'{rname}.csv'} ({len(table)} rows via sync_meca_insertion)")
            continue
        Table.from_records(rows).to_csv(out / f"{rname}.csv")
        print(f"wrote {out / f'{rname}.csv'} ({len(rows)} rows)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
