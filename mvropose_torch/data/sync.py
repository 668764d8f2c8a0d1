"""Timestamp synchronization and the per-robot sync adapters: port of
`mvropose_tpu/data/sync.py` on the port's CSV `Table` (`data/table.py`) in
place of pandas, which the card's machine does not have.

One nearest-timestamp matcher (`match_nearest`, numpy's `searchsorted`:
the `merge_asof(direction="nearest")` core) and five adapters, each
returning a table in the schema of the synced CSVs the builders read
(`Table.to_csv` writes the bytes pandas' `to_csv` writes):
  * `sync_fr5`: per-file JSON joint lists (degrees), the camera delay added
    to the image timestamps, 50 ms tolerance;
  * `sync_fr3`: ROS2 `joint_states_*.yaml` streams (radians; PyYAML);
  * `sync_dream`: `xxxx.json` paired with `xxxx.rgb.jpg` by name, with the
    stored keypoints' 3D locations and 2D projections;
  * `sync_meca500`: `imageN.jpg` paired with `angleN.json` by index;
  * `sync_meca_insertion`: the rig's `robot_data.txt` CSV log.
The reference's native C++ matcher for large logs is not copied (ROADMAP.md,
"Left to copy"); the numpy branch gives the same indices.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from mvropose_torch.data.table import Table


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    tolerance_s: float = 0.05
    image_delay_s: float = 0.0333  # camera latency added to image timestamps


def parse_timestamp_from_filename(path: str | Path) -> float | None:
    """'<anything>_<epoch>.ext' -> float epoch (the capture's file names)."""
    token = Path(path).stem.split("_")[-1]
    try:
        return float(token)
    except ValueError:
        return None


def match_nearest(query_ts: np.ndarray, ref_ts: np.ndarray,
                  tolerance_s: float) -> tuple[np.ndarray, np.ndarray]:
    """For each query timestamp the index of the nearest reference timestamp
    (`ref_ts` sorted; the left one on a tie) -> (idx (N,), valid (N,): the
    distance below the tolerance)."""
    query_ts = np.asarray(query_ts, dtype=np.float64)
    ref_ts = np.asarray(ref_ts, dtype=np.float64)
    n = len(ref_ts)
    if n == 0:
        return np.zeros(len(query_ts), np.int64), np.zeros(len(query_ts), bool)
    pos = np.searchsorted(ref_ts, query_ts)
    left = np.clip(pos - 1, 0, n - 1)
    right = np.clip(pos, 0, n - 1)
    d_left = np.abs(query_ts - ref_ts[left])
    d_right = np.abs(query_ts - ref_ts[right])
    idx = np.where(d_right < d_left, right, left)
    return idx, np.minimum(d_left, d_right) < tolerance_s


def _find_images(dirs: Iterable[str | Path], subfolders: Sequence[str] | None = None,
                 exts=(".jpg", ".jpeg", ".png")) -> list[str]:
    paths: list[str] = []
    for d in dirs:
        d = Path(d)
        for root in ([d / s for s in subfolders] if subfolders else [d]):
            if root.exists():
                paths += [str(p) for p in sorted(root.rglob("*")) if p.suffix.lower() in exts]
    return paths


def _sync_images_to_joints(image_paths: Sequence[str], joints: Table, ts_col: str,
                           cfg: SyncConfig) -> Table:
    """The timestamp adapters' shared tail: each image (its file name's
    epoch plus the camera delay) matched to the nearest joint row within the
    tolerance -> image_path, image_timestamp, time_difference_s and the
    joint row's columns, ordered by image timestamp."""
    # A timestamp of 0.0 (a capture timed from its start) is a parse, not a failure.
    img_ts = np.array([np.nan if (ts := parse_timestamp_from_filename(p)) is None else ts
                       for p in image_paths], dtype=np.float64)
    ok = ~np.isnan(img_ts)
    image_paths = [p for p, o in zip(image_paths, ok) if o]
    img_ts = img_ts[ok]
    joints = joints.sort_values(ts_col)
    idx, valid = match_nearest(img_ts + cfg.image_delay_s, joints[ts_col], cfg.tolerance_s)
    rows = joints.take(idx[valid])
    paths = np.empty(int(valid.sum()), dtype=object)
    paths[:] = [p for p, v in zip(image_paths, valid) if v]
    out = Table({
        "image_path": paths,
        "image_timestamp": img_ts[valid],
        "time_difference_s": np.abs(img_ts[valid] + cfg.image_delay_s - rows[ts_col]),
    })
    for name in rows.columns:
        out[name] = rows[name]
    return out.sort_values("image_timestamp")


def sync_fr5(base_dirs: Sequence[str | Path], cfg: SyncConfig = SyncConfig(tolerance_s=0.05),
             n_joints: int = 6) -> Table:
    """Fr5: images in {left,right,top}/, joints in joint/*.json (a list of
    `n_joints` degree values a file, its timestamp in the file name)."""
    records = []
    for d in base_dirs:
        for p in sorted((Path(d) / "joint").glob("*.json")):
            ts = parse_timestamp_from_filename(p)
            if ts is None:
                continue
            try:
                angles = json.loads(p.read_text())
            except json.JSONDecodeError:
                continue
            if not isinstance(angles, list) or len(angles) != n_joints:
                continue
            rec = {"joint_timestamp": ts, "joint_path": str(p)}
            rec.update({f"joint_{i + 1}": a for i, a in enumerate(angles)})
            records.append(rec)
    joints = Table.from_records(records)
    images = _find_images(base_dirs, subfolders=("left", "right", "top"))
    if joints.empty or not images:
        return Table()
    return _sync_images_to_joints(images, joints, "joint_timestamp", cfg)


def _yaml_joint_records(yaml_path: str | Path) -> list[dict]:
    """One record per ROS2 JointState document: robot_timestamp from the
    header stamp (sec.nanosec cut to 14 characters, as the original sync),
    and position_/velocity_/effort_<joint name> (NaN where a list is short)."""
    import yaml

    records = []
    with open(yaml_path) as f:
        for doc in yaml.safe_load_all(f):
            if not doc:
                continue
            stamp = doc.get("header", {}).get("stamp", {})
            sec, nanosec = stamp.get("sec", 0), stamp.get("nanosec", 0)
            rec = {"robot_timestamp": float(f"{sec}.{nanosec:09d}"[:14])}
            names = doc.get("name", [])
            for field in ("position", "velocity", "effort"):
                vals = doc.get(field, [])
                for i, name in enumerate(names):
                    rec[f"{field}_{name}"] = vals[i] if i < len(vals) else np.nan
            records.append(rec)
    return records


def sync_fr3(image_dirs: Sequence[str | Path], joint_yaml_dir: str | Path,
             cfg: SyncConfig = SyncConfig(tolerance_s=0.02)) -> Table:
    """FR3: every image under the pose directories; joints from the ROS2
    joint_states_*.yaml streams (radians)."""
    records = []
    for p in sorted(Path(joint_yaml_dir).glob("joint_states_*.yaml")):
        records.extend(_yaml_joint_records(p))
    joints = Table.from_records(records)
    images = _find_images(image_dirs)
    if joints.empty or not images:
        return Table()
    return _sync_images_to_joints(images, joints, "robot_timestamp", cfg)


DREAM_KEYPOINT_NAMES = (
    "panda_link0",
    "panda_link2",
    "panda_link3",
    "panda_link4",
    "panda_link6",
    "panda_link7",
    "panda_hand",
)


def sync_dream(base_path: str | Path, n_joints: int = 7) -> Table:
    """DREAM: xxxx.json paired with xxxx.rgb.jpg by name -> joint_1..7 and
    the 7 keypoints' kpt_<name>_loc_x|y|z (camera frame) and
    kpt_<name>_proj_x|y (image px). Files starting with "_" (the camera and
    object settings) and frames missing a joint or keypoint are skipped."""
    records = []
    for jp in sorted(Path(base_path).glob("*.json")):
        if jp.name.startswith("_"):
            continue
        img = jp.with_suffix("")
        img = img.parent / f"{img.name}.rgb.jpg"
        if not img.exists():
            continue
        try:
            data = json.loads(jp.read_text())
        except json.JSONDecodeError:
            continue
        jmap = {j["name"]: j["position"] for j in data.get("sim_state", {}).get("joints", [])
                if "name" in j}
        required = [f"panda_joint{i}" for i in range(1, n_joints + 1)]
        if not all(n in jmap for n in required):
            continue
        objs = data.get("objects") or []
        if not objs or "keypoints" not in objs[0]:
            continue
        kmap = {k["name"]: k for k in objs[0]["keypoints"]}
        if not all(n in kmap for n in DREAM_KEYPOINT_NAMES):
            continue
        rec = {"image_path": str(img)}
        for i, n in enumerate(required, start=1):
            rec[f"joint_{i}"] = jmap[n]
        for n in DREAM_KEYPOINT_NAMES:
            k = kmap[n]
            rec[f"kpt_{n}_loc_x"], rec[f"kpt_{n}_loc_y"], rec[f"kpt_{n}_loc_z"] = k["location"]
            rec[f"kpt_{n}_proj_x"], rec[f"kpt_{n}_proj_y"] = k["projected_location"]
        records.append(rec)
    return Table.from_records(records)


def sync_meca500(image_dir: str | Path, angle_dir: str | Path, n_joints: int = 6) -> Table:
    """Meca500: imageN.jpg paired with angleN.json (`n_joints` degree values)."""
    records = []
    for jp in sorted(Path(angle_dir).glob("angle*.json")):
        m = re.match(r"angle(\d+)\.json", jp.name)
        if not m:
            continue
        img = Path(image_dir) / f"image{m.group(1)}.jpg"
        if not img.exists():
            continue
        try:
            angles = json.loads(jp.read_text())
        except json.JSONDecodeError:
            continue
        if not isinstance(angles, list) or len(angles) != n_joints:
            continue
        rec = {"image_path": str(img)}
        rec.update({f"joint_{i + 1}": a for i, a in enumerate(angles)})
        records.append(rec)
    return Table.from_records(records)


def sync_meca_insertion(image_dirs: Sequence[str | Path], robot_data_txt: str | Path,
                        cfg: SyncConfig = SyncConfig(tolerance_s=0.05),
                        n_joints: int = 7) -> Table:
    """Meca insertion: robot_data.txt rows of timestamp, 7 joint columns (the
    6 actuated Meca500 joints and the rig's tool channel) and the cartesian
    values, matched to the images' file-name timestamps. A line that is not
    all numbers (the header) is skipped."""
    records = []
    with open(robot_data_txt) as f:
        for line in f:
            parts = [p.strip() for p in line.strip().split(",") if p.strip()]
            if len(parts) < 1 + n_joints:
                continue
            try:
                vals = [float(p) for p in parts]
            except ValueError:
                continue
            rec = {"robot_timestamp": vals[0]}
            rec.update({f"joint_{i + 1}": v for i, v in enumerate(vals[1:1 + n_joints])})
            rec.update({f"cartesian_{i}": v for i, v in enumerate(vals[1 + n_joints:])})
            records.append(rec)
    joints = Table.from_records(records)
    images = _find_images(image_dirs)
    if joints.empty or not images:
        return Table()
    return _sync_images_to_joints(images, joints, "robot_timestamp", cfg)
