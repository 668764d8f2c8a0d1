"""Generate a synthetic dataset in the DREAM file schema, with the torch port.

The port's copy of `scripts/make_dream_synthetic.py` (the same flags, the
same numpy draws from --seed, so the same seed writes the same angles and
keypoints): per frame `xxxx.json` (`sim_state.joints` and the 7 named
keypoints' camera-frame 3D `location` and 2D `projected_location`) beside
`xxxx.rgb.jpg`, and the subset's `_camera_settings.json`. The images are the
synthetic rig's blob renders at the stored 2D keypoints, so the
stored-keypoint task (`cli sync dream` -> `cli train --robot dream
--dream-dirs ...`) is exactly learnable. FK, projection and the render are
the port's (`mvropose_torch.geometry`, `data/synthetic.py`); the render runs
on --device (the card's render kernel by default).

Usage:
    python scripts/torch_make_dream_synthetic.py --out-dir /tmp/dream_synth \
        --n-samples 2000 --image-hw 128 128 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--n-samples", type=int, default=2000)
    p.add_argument("--image-hw", type=int, nargs=2, default=(128, 128))
    p.add_argument("--angle-scale", type=float, default=0.6)
    p.add_argument("--noise-std", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--focal-scale", type=float, default=0.55,
                   help="focal length as a multiple of image width; 0.96 matches DREAM-real's "
                        "angular resolution (fx/width = 615.5/640 for its RealSense captures)")
    p.add_argument("--distance", type=float, default=1.6,
                   help="camera ring radius in meters (make_rig distance_m)")
    p.add_argument("--device", default="cuda", help="torch device of the render (default cuda)")
    args = p.parse_args(argv)

    import cv2
    import torch

    from mvropose_torch.data.sync import DREAM_KEYPOINT_NAMES
    from mvropose_torch.data.synthetic import joint_palette, make_rig, render_blob_images
    from mvropose_torch.geometry.camera import project_points
    from mvropose_torch.geometry.robots import forward_kinematics, get_robot
    from mvropose_torch.geometry.rotations import rodrigues_to_matrix

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available (pass --device "
                         "cpu to render on the CPU)")
    device = torch.device(args.device)
    robot = get_robot("dream_panda")  # the FR3 chain, radians
    fk_idx = np.asarray(robot.keypoint_fk_indices, dtype=np.int64)
    assert len(fk_idx) == len(DREAM_KEYPOINT_NAMES)

    h, w = args.image_hw
    rig = make_rig(n_views=1, image_hw=(h, w), distance_m=args.distance,
                   focal_scale=args.focal_scale)
    K, rvec, tvec = rig.K, rig.rvecs[0], rig.tvecs[0]

    rng = np.random.default_rng(args.seed)
    half = args.angle_scale * np.pi / 2.0
    angles = rng.uniform(-half, half, size=(args.n_samples, robot.n_joints)).astype(np.float32)

    # FK -> 3D (world) -> the 7 keypoints -> projection; DREAM stores the 3D
    # locations in the CAMERA frame.
    kp3d_w = forward_kinematics(robot, torch.from_numpy(angles))[:, fk_idx]  # (N, 7, 3)
    kp2d = project_points(kp3d_w, torch.from_numpy(rvec), torch.from_numpy(tvec),
                          torch.from_numpy(K)).numpy()
    R = rodrigues_to_matrix(torch.from_numpy(rvec)).numpy()
    kp3d_c = kp3d_w.numpy() @ R.T + tvec[None, None]

    out = Path(args.out_dir) / "panda_synth"
    out.mkdir(parents=True, exist_ok=True)
    (out / "_camera_settings.json").write_text(json.dumps({"camera_settings": [{
        "name": "camera",
        "intrinsic_settings": {"fx": float(K[0, 0]), "fy": float(K[1, 1]),
                               "cx": float(K[0, 2]), "cy": float(K[1, 2])},
        "captured_image_size": {"width": w, "height": h},
    }]}, indent=2))

    palette = torch.from_numpy(joint_palette(len(fk_idx))).to(device)
    batch = 256
    for s in range(0, args.n_samples, batch):
        e = min(s + batch, args.n_samples)
        noise = args.noise_std * rng.standard_normal((e - s, h, w, 3)).astype(np.float32)
        imgs = render_blob_images(torch.from_numpy(kp2d[s:e]).to(device), (h, w), palette,
                                  noise=torch.from_numpy(noise).to(device)).cpu().numpy()
        imgs = ((imgs * 0.5 + 0.5) * 255.0).clip(0, 255).astype(np.uint8)
        for i in range(s, e):
            cv2.imwrite(str(out / f"{i:04d}.rgb.jpg"), imgs[i - s][..., ::-1])
            rec = {
                "sim_state": {"joints": [{"name": f"panda_joint{j + 1}",
                                          "position": float(angles[i, j])}
                                         for j in range(robot.n_joints)]},
                "objects": [{
                    "class": "panda_synth",
                    "keypoints": [{"name": n, "location": [float(x) for x in kp3d_c[i, k]],
                                   "projected_location": [float(x) for x in kp2d[i, k]]}
                                  for k, n in enumerate(DREAM_KEYPOINT_NAMES)],
                }],
            }
            (out / f"{i:04d}.json").write_text(json.dumps(rec))
    print(f"wrote {args.n_samples} DREAM-schema samples to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
