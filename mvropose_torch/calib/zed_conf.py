"""ZED factory calibration (.conf INI) parsing: a copy of
`mvropose_tpu/calib/zed_conf.py` (numpy and configparser only), held to the
original by `tests/test_torch_capture_data.py`.

Replaces the original project's per-robot extractor scripts
(the original project's dataset/3_Calib_cam_save.py:17-76 for FHD,
4_Calib_cam_save.py:35-112 for FHD1200) with one parametric loader. The
.conf files carry per-resolution [LEFT/RIGHT_CAM_<RES>] pinhole+distortion
sections and a [STEREO] section with the baseline transform.
"""

from __future__ import annotations

import configparser
import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    camera_matrix: np.ndarray  # (3, 3) float64
    distortion_coeffs: np.ndarray  # (5,) [k1, k2, p1, p2, k3]

    def to_json_dict(self) -> dict:
        """Serialization matching the reference's calib JSON schema
        ({camera_matrix, distortion_coeffs})."""
        return {
            "camera_matrix": self.camera_matrix.tolist(),
            "distortion_coeffs": self.distortion_coeffs.tolist(),
        }


def load_zed_intrinsics(conf_path: str | Path, side: str, resolution: str = "FHD") -> Intrinsics:
    """Parse [<SIDE>_CAM_<RESOLUTION>] from a ZED SN*.conf file.

    side: "LEFT" | "RIGHT"; resolution: e.g. "FHD", "FHD1200", "HD720".
    """
    cfg = configparser.ConfigParser()
    read = cfg.read(str(conf_path), encoding="utf-8-sig")
    if not read:
        raise FileNotFoundError(conf_path)
    section = f"{side.upper()}_CAM_{resolution.upper()}"
    cam = cfg[section]
    fx, fy = float(cam["fx"]), float(cam["fy"])
    cx, cy = float(cam["cx"]), float(cam["cy"])
    dist = np.array(
        [float(cam["k1"]), float(cam["k2"]), float(cam["p1"]), float(cam["p2"]), float(cam["k3"])]
    )
    K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
    return Intrinsics(K, dist)


def load_dream_camera_settings(path: str | Path) -> Intrinsics:
    """Parse a DREAM dataset `_camera_settings.json` into Intrinsics.

    The reference reads fx/fy/cx/cy from
    camera_settings[0].intrinsic_settings and uses zero distortion
    (the original project's model/DREAM_Train.py:86-94).
    """
    import json

    data = json.loads(Path(path).read_text())
    intr = data["camera_settings"][0]["intrinsic_settings"]
    K = np.array(
        [[intr["fx"], 0.0, intr["cx"]], [0.0, intr["fy"], intr["cy"]], [0.0, 0.0, 1.0]]
    )
    return Intrinsics(K, np.zeros(5))


def load_stereo_params(conf_path: str | Path, resolution: str = "FHD1200") -> dict:
    """Parse the [STEREO] left->right transform (baseline in mm, rotations in
    radians), per the reference's Meca-insertion stage 3
    (the original project's dataset/Meca_insertion_preprocessing.py:43-68)."""
    cfg = configparser.ConfigParser()
    read = cfg.read(str(conf_path), encoding="utf-8-sig")
    if not read:
        raise FileNotFoundError(conf_path)
    s = cfg["STEREO"]
    # No silent fallbacks for the per-resolution rotation keys: a typo'd
    # --resolution would otherwise read rx/ry/rz as 0.0 and produce a
    # pure-translation baseline transform - a plausible-looking but wrong
    # rightcam extrinsic (the reference aborts with NoOptionError too,
    # Meca_insertion_preprocessing.py:43-68). TY/TZ genuinely default to 0
    # in some factory files, so they keep a fallback.
    for key in (f"RX_{resolution}", f"CV_{resolution}", f"RZ_{resolution}"):
        if not cfg.has_option("STEREO", key):
            have = [k for k in s if k.upper().startswith(("RX_", "CV_", "RZ_"))]
            raise KeyError(
                f"[STEREO] {key} missing in {conf_path} - wrong --resolution? "
                f"(file has: {sorted(have)})"
            )
    return {
        "baseline": s.getfloat("Baseline"),
        "ty": s.getfloat("TY", fallback=0.0),
        "tz": s.getfloat("TZ", fallback=0.0),
        "rx": s.getfloat(f"RX_{resolution}"),
        "ry": s.getfloat(f"CV_{resolution}"),
        "rz": s.getfloat(f"RZ_{resolution}"),
    }
