"""The port's captured-image data path against the reference, on the CPU.

Captures are made at 60 x 80 by the reference's own `cli sync` and `cli
calibrate` (FR3, FR5, Meca500, Meca insertion, DREAM) and one ROI CSV by
pandas. Held to the reference: the calibration copies and the rig registry;
the CSV table against pandas (values, types, concat, float parsing, sort
order of tied timestamps); the grouping; every builder's samples and groups
and the train/val split; `batches()` arrays for shuffle seeds 0 and 3 (images
equal but for pixels one level apart after the host undistortion, whose
count is bounded; keypoints within 1e-3 px); the device preprocessing with
and without the device remap (images within 1e-5, GT heatmaps within 1e-6);
the panels and the image writer.
"""

from __future__ import annotations

import io
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mvropose_tpu.calib import registry as jreg
from mvropose_tpu.calib import zed_conf as jzed
from mvropose_tpu.cli.main import main as jax_main
from mvropose_tpu.data import builders as jb
from mvropose_tpu.data import dataset as jds
from mvropose_tpu.data.grouping import group_by_time_tolerance as jax_group
from mvropose_tpu.utils import viz as jviz
from mvropose_torch.calib import registry as treg
from mvropose_torch.calib import zed_conf as tzed
from mvropose_torch.data import builders as tb
from mvropose_torch.data import dataset as tds
from mvropose_torch.data import table
from mvropose_torch.data.grouping import group_by_time_tolerance as port_group
from mvropose_torch.geometry.camera import remap_bilinear
from mvropose_torch.utils import viz as tviz
from mvropose_torch.utils.metrics_writer import MetricWriter
from torch_parity import CAPTURE_HW, FR3_CONF, _capture_image, fr3_capture

# Pixels one level apart after the host undistortion: cv2.remap quantizes
# the fractional weights to 1/32, so a map an ulp apart can move a pixel a
# level. At most this many per million values.
ONE_LEVEL_PER_MILLION = 10
KP_TOL_PX = 1e-3
IMAGE_TOL, HEATMAP_TOL = 1e-5, 1e-6

FR5_SERIALS = {"38007749": "left", "34850673": "right", "30779426": "top"}


def _images(d: Path, names, hw=CAPTURE_HW, seed: int = 0):
    import cv2

    rng = np.random.default_rng(seed)
    d.mkdir(parents=True, exist_ok=True)
    for name in names:
        cv2.imwrite(str(d / name), _capture_image(rng, hw))


def _calibrate(root: Path, serial_views, summary: Path, rvecs_deg=(96.0, 98.0, -45.0)):
    root.mkdir(parents=True, exist_ok=True)
    conf = root / "SN.conf"
    conf.write_text(FR3_CONF)
    for k, (serial, view) in enumerate(serial_views):
        jax_main(["calibrate", "intrinsics", "--conf", str(conf), "--serial", serial,
                  "--view", view, "--resolution", "FHD", "--out-dir", str(root / "calib")])
        for cam in ("leftcam", "rightcam"):
            jax_main(["calibrate", "manual", "--view", view, "--cam", cam,
                      "--tvec", str(0.05 * k), "-0.01", "0.75", "--rvec-deg",
                      *(str(v + 2 * k) for v in rvecs_deg), "--out", str(summary)])


def _fr5(root: Path) -> dict:
    rng = np.random.default_rng(1)
    base = root / "fr5"
    for serial, view in FR5_SERIALS.items():
        for i in range(4):
            _images(base / view, [f"zed_{serial}_left_{1700000100 + i + 0.01 * len(view):.9f}.jpg"],
                    seed=i + len(view))
    (base / "joint").mkdir()
    for i in range(4):
        (base / "joint" / f"joint_{1700000100.0333 + i:.4f}.json").write_text(
            json.dumps([float(v) for v in rng.uniform(-60, 60, 6)]))
    csv = root / "fr5.csv"
    assert jax_main(["sync", "fr5", "--base-dirs", str(base), "--out", str(csv),
                     "--tolerance", "0.05"]) == 0
    summary = root / "fr5_summary.json"
    _calibrate(root / "fr5_cal", FR5_SERIALS.items(), summary)
    roi = pd.read_csv(csv)
    boxes = [(10, 5, 70, 55), (-5, -3, 40, 90), (30, 20, 31, 50), (0, 0, 80, 60)]
    roi = roi.assign(**{f"roi.{k}": [boxes[i % 4][j] for i in range(len(roi))]
                        for j, k in enumerate(("x1", "y1", "x2", "y2"))})
    roi.to_csv(root / "fr5_roi.csv", index=False)
    return {"csv": csv, "roi_csv": root / "fr5_roi.csv", "calib_dir": root / "fr5_cal" / "calib",
            "summary": summary}


def _meca500(root: Path) -> dict:
    rng = np.random.default_rng(2)
    img, ang = root / "meca_img", root / "meca_ang"
    _images(img, [f"image{i}.jpg" for i in range(5)], seed=5)
    ang.mkdir()
    for i in range(5):
        (ang / f"angle{i}.json").write_text(json.dumps([float(v) for v in rng.uniform(-40, 40, 6)]))
    csv = root / "meca500.csv"
    assert jax_main(["sync", "meca500", "--base-dirs", str(img), "--joint-dir", str(ang),
                     "--out", str(csv)]) == 0
    summary = root / "meca_summary.json"
    _calibrate(root / "meca_cal", [("41182735", "front")], summary)
    return {"csv": csv, "calib_dir": root / "meca_cal" / "calib", "summary": summary}


def _meca_insertion(root: Path) -> dict:
    rng = np.random.default_rng(3)
    serials = {"41182735": "front", "49429257": "right"}
    names = [f"zed_{s}_{side}_{1700000200 + i + 0.002 * k:.9f}.jpg"
             for i in range(3) for k, s in enumerate(serials) for side in ("left", "right")]
    _images(root / "ins_img", names, seed=7)
    lines = ["timestamp,j1,j2,j3,j4,j5,j6,j7,c0,c1,c2,c3,c4"]
    for i in range(3):
        vals = rng.uniform(-30, 30, 12)
        lines.append(", ".join([f"{1700000200.0333 + i:.4f}", *(f"{v:.5f}" for v in vals)]))
    data = root / "robot_data.txt"
    data.write_text("\n".join(lines) + "\n")
    csv = root / "meca_insertion.csv"
    assert jax_main(["sync", "meca_insertion", "--base-dirs", str(root / "ins_img"),
                     "--joint-dir", str(data), "--out", str(csv)]) == 0
    summary = root / "ins_summary.json"
    _calibrate(root / "ins_cal", serials.items(), summary)
    return {"csv": csv, "calib_dir": root / "ins_cal" / "calib", "summary": summary}


def _dream(root: Path) -> dict:
    base = root / "panda-3cam_azure"
    base.mkdir()
    (base / "_camera_settings.json").write_text(json.dumps({"camera_settings": [
        {"intrinsic_settings": {"fx": 70.0, "fy": 71.0, "cx": 40.0, "cy": 30.5}}]}))
    from mvropose_tpu.data.sync import DREAM_KEYPOINT_NAMES

    rng = np.random.default_rng(4)
    for i in range(5):
        data = {
            "sim_state": {"joints": [{"name": f"panda_joint{j}", "position": float(v)}
                                     for j, v in enumerate(rng.uniform(-1, 1, 7), start=1)]},
            "objects": [{"keypoints": [
                {"name": n, "location": [float(v) for v in rng.uniform(-0.5, 0.5, 3)],
                 "projected_location": [float(v) for v in rng.uniform(0, 60, 2)]}
                for n in DREAM_KEYPOINT_NAMES]}],
        }
        (base / f"{i:04d}.json").write_text(json.dumps(data))
    _images(base, [f"{i:04d}.rgb.jpg" for i in range(5)], seed=9)
    csv = root / "dream.csv"
    assert jax_main(["sync", "dream", "--base-dirs", str(base), "--out", str(csv)]) == 0
    return {"csv": csv, "dream_dirs": [base]}


@pytest.fixture(scope="module")
def caps(tmp_path_factory) -> dict:
    root = tmp_path_factory.mktemp("captures")
    return {"fr3": fr3_capture(root / "fr3"), "fr5": _fr5(root), "meca500": _meca500(root),
            "meca_insertion": _meca_insertion(root), "dream": _dream(root)}


# ---------------------------------------------------------------- calibration


def test_zed_conf_copy_matches_reference(tmp_path):
    conf = tmp_path / "SN.conf"
    conf.write_text(FR3_CONF + "\n[STEREO]\nBaseline = 120.0\nTY = 0.5\n"
                    "RX_FHD = 0.001\nCV_FHD = -0.002\nRZ_FHD = 0.003\n")
    for side in ("LEFT", "RIGHT"):
        a, b = jzed.load_zed_intrinsics(conf, side, "FHD"), tzed.load_zed_intrinsics(conf, side)
        np.testing.assert_array_equal(a.camera_matrix, b.camera_matrix)
        np.testing.assert_array_equal(a.distortion_coeffs, b.distortion_coeffs)
        assert a.to_json_dict() == b.to_json_dict()
    assert jzed.load_stereo_params(conf, "FHD") == tzed.load_stereo_params(conf, "FHD")
    for mod in (jzed, tzed):
        with pytest.raises(KeyError, match="RX_FHD1200"):
            mod.load_stereo_params(conf, "FHD1200")
        with pytest.raises(FileNotFoundError):
            mod.load_zed_intrinsics(tmp_path / "missing.conf", "LEFT")
    settings = tmp_path / "_camera_settings.json"
    settings.write_text(json.dumps({"camera_settings": [
        {"intrinsic_settings": {"fx": 600.5, "fy": 601.0, "cx": 320.0, "cy": 240.25}}]}))
    a, b = jzed.load_dream_camera_settings(settings), tzed.load_dream_camera_settings(settings)
    np.testing.assert_array_equal(a.camera_matrix, b.camera_matrix)
    np.testing.assert_array_equal(a.distortion_coeffs, b.distortion_coeffs)


def _rigs(robot: str, cap: dict):
    if robot == "dream":
        return (jreg.load_dream_rig(cap["dream_dirs"], sigma=3.0),
                treg.load_dream_rig(cap["dream_dirs"], sigma=3.0))
    serials = {"fr3": jreg.FR3_SERIAL_TO_VIEW, "fr5": jreg.FR5_SERIAL_TO_VIEW,
               "meca500": {"41182735": "front"},
               "meca_insertion": jreg.MECA_INSERTION_SERIAL_TO_VIEW}[robot]
    name = {"meca_insertion": "meca500"}.get(robot, robot)
    summary = {"pose1": [cap["summary"]]} if robot == "fr3" else {"": [cap["summary"]]}
    return tuple(mod.load_rig(robot, name, serials, calib_dir=cap["calib_dir"],
                              aruco_summary_paths=summary, sigma=4.0) for mod in (jreg, treg))


@pytest.mark.parametrize("robot", ["fr3", "fr5", "meca500", "meca_insertion", "dream"])
def test_registry_matches_reference(caps, robot):
    assert treg.FR3_SERIAL_TO_VIEW == jreg.FR3_SERIAL_TO_VIEW
    assert treg.FR5_SERIAL_TO_VIEW == jreg.FR5_SERIAL_TO_VIEW
    assert treg.MECA_INSERTION_SERIAL_TO_VIEW == jreg.MECA_INSERTION_SERIAL_TO_VIEW
    a, b = _rigs(robot, caps[robot])
    assert (a.name, a.robot.name, dict(a.serial_to_view), a.heatmap_size, a.sigma, a.max_views,
            a.num_keypoints) == (b.name, b.robot.name, dict(b.serial_to_view), b.heatmap_size,
                                 b.sigma, b.max_views, b.num_keypoints)
    assert list(a.calibs) == list(b.calibs) and list(a.extrinsics) == list(b.extrinsics)
    for k in a.calibs:
        np.testing.assert_array_equal(a.calibs[k].camera_matrix, b.calibs[k].camera_matrix)
        np.testing.assert_array_equal(a.calibs[k].distortion_coeffs,
                                      b.calibs[k].distortion_coeffs)
    for k in a.extrinsics:
        np.testing.assert_array_equal(a.extrinsics[k].rvec, b.extrinsics[k].rvec)
        np.testing.assert_array_equal(a.extrinsics[k].tvec, b.extrinsics[k].tvec)
    for serial in a.serial_to_view:
        for cam in ("leftcam", "rightcam"):
            assert a.view_index(serial, cam) == b.view_index(serial, cam)
    assert a.camera_key("v", "leftcam", "pose1") == b.camera_key("v", "leftcam", "pose1")


# ------------------------------------------------------------------ CSV table


def assert_table_equals_frame(t: table.Table, df: pd.DataFrame) -> None:
    assert t.columns == list(df.columns) and len(t) == len(df)
    for c in df.columns:
        got, want = t[c], df[c].to_numpy()
        if want.dtype.kind in "if":
            assert got.dtype == want.dtype, (c, got.dtype, want.dtype)
            np.testing.assert_array_equal(got, want, err_msg=c)
        else:
            assert got.dtype == object, c
            na = pd.isna(df[c]).to_numpy()
            assert pd.isna(pd.Series(got)).to_numpy().tolist() == na.tolist(), c
            assert got[~na].tolist() == want[~na].tolist(), c


def _csv_paths(caps) -> dict:
    return {"fr3": caps["fr3"]["csv"], "fr5": caps["fr5"]["csv"],
            "fr5_roi": caps["fr5"]["roi_csv"], "meca500": caps["meca500"]["csv"],
            "meca_insertion": caps["meca_insertion"]["csv"], "dream": caps["dream"]["csv"]}


@pytest.mark.parametrize("name", ["fr3", "fr5", "fr5_roi", "meca500", "meca_insertion", "dream"])
def test_table_matches_pandas(caps, name):
    path = _csv_paths(caps)[name]
    t, df = table.read_csv(path), pd.read_csv(path)
    assert_table_equals_frame(t, df)
    assert not t.empty and t.empty == df.empty
    cols = [c for c in df.columns if df[c].dtype.kind in "if"]
    np.testing.assert_array_equal(t[cols].to_numpy(np.float32),
                                  df[cols].to_numpy(np.float32, copy=True))
    np.testing.assert_array_equal(t[cols].to_numpy(float), df[cols].to_numpy(dtype=float))
    assert t["image_path"].astype(str).tolist() == df["image_path"].astype(str).tolist()


def test_concat_matches_pandas(caps, tmp_path):
    paths = _csv_paths(caps)
    # Columns that one table lacks read as NaN; int columns with such a gap
    # turn float; a string column stays object.
    extra = tmp_path / "extra.csv"
    extra.write_text("image_path,count,label,robot_timestamp\n"
                     "a.jpg,3,x,1700000000.123456789\nb.jpg,4,,1700000001.5\n")
    for group in (["fr3", "fr5"], ["fr5", "fr5_roi", "meca500"], ["dream"]):
        files = [paths[g] for g in group] + [extra]
        assert_table_equals_frame(
            table.concat(table.read_csv(f) for f in files),
            pd.concat([pd.read_csv(f) for f in files], ignore_index=True))


def test_parse_float_matches_pandas():
    """pandas' parser is not Python's float: it differs by an ulp on a fifth
    of 9-decimal epochs and on a third of 17-digit values here."""
    rng = np.random.default_rng(0)
    epochs = 1.7e9 + rng.random(20000) * 1e6
    vals = rng.standard_normal(20000) * rng.choice([1e-300, 1e-3, 1.0, 1e9, 1e30], 20000)
    strs = ([f"{t:.9f}" for t in epochs] + [repr(float(v)) for v in vals]
            + [f"{v:.6e}" for v in vals[:2000]] + [f"{v:.25f}" for v in vals[:2000]]
            + ["1.", ".5", "-0.0", "+3.25", "1e-310", "12345678901234567890123", "-inf",
               "Infinity", "0.000000000000000000001234567"])
    want = pd.read_csv(io.StringIO("v\n" + "\n".join(strs)))["v"].to_numpy()
    got = np.array([table.parse_float(s) for s in strs])
    np.testing.assert_array_equal(got, want)
    assert (got[:20000] != np.array([float(s) for s in strs[:20000]])).sum() > 1000
    assert table.parse_float("image.jpg") is None and table.parse_float("") is None


def test_sort_values_matches_pandas_on_ties():
    """Tied timestamps (every view of a tick) keep pandas' unstable order."""
    rng = np.random.default_rng(5)
    ts = np.repeat(1700000000.0 + np.round(rng.random(12), 3), 8)
    ts[[3, 40]] = np.nan
    order = rng.permutation(len(ts))
    df = pd.DataFrame({"robot_timestamp": ts[order], "image_path": [f"im{i}.jpg" for i in order]})
    t = table.Table({c: df[c].to_numpy() for c in df.columns})
    assert_table_equals_frame(t.sort_values("robot_timestamp"),
                              df.sort_values("robot_timestamp", ignore_index=True))
    stable = np.argsort(ts[order], kind="stable")
    assert t.sort_values("robot_timestamp")["image_path"].tolist() != [
        f"im{order[i]}.jpg" for i in stable]


# ---------------------------------------------------------------- grouping


@pytest.mark.parametrize("tolerance,max_views,min_views", [(0.07, 8, 1), (0.004, 3, 2),
                                                           (0.05, 4, 2)])
def test_grouping_matches_reference(caps, tmp_path, tolerance, max_views, min_views):
    """Ties on robot_timestamp in 9-decimal epochs, shuffled rows, NaN-free;
    and the FR3 capture's sync CSV."""
    rng = np.random.default_rng(6)
    ticks = 1700000000.0 + np.arange(10) * 0.1 + rng.uniform(0, 1e-3, 10)
    ts = np.repeat(ticks, 5) + np.tile([0.0, 0.0, 0.003, 0.003, 0.0], 10)
    ties = tmp_path / "ties.csv"
    ties.write_text("image_path,robot_timestamp,position_fr3_joint1,joint_2,joint_timestamp\n"
                    + "".join(f"zed_1_left_{t + 1e-9 * i:.9f}.jpg,{t:.9f},{0.01 * i},"
                              f"{-0.02 * i},{t:.3f}\n"
                              for i, t in enumerate(ts[rng.permutation(len(ts))])))
    for csv in (ties, caps["fr3"]["csv"]):
        want = jax_group(pd.read_csv(csv), tolerance, max_views, min_views=min_views)
        got = port_group(table.read_csv(csv), tolerance, max_views, min_views=min_views)
        assert got == want and len(got) > 1
    assert port_group(table.Table(), 0.07, 8) == []


# ---------------------------------------------------------------- builders


def _frames(robot: str, caps) -> tuple:
    path = {"fr5_roi": caps["fr5"]["roi_csv"]}.get(robot) or caps[robot.split("/")[0]]["csv"]
    return pd.read_csv(path), table.read_csv(path)


BUILDERS = {
    "fr5": ("fr5", "build_fr5_single_view", CAPTURE_HW),
    "fr5_roi": ("fr5", "build_fr5_roi_single_view", (48, 64)),
    "meca500": ("meca500", "build_meca500_single_view", CAPTURE_HW),
    "meca_insertion": ("meca_insertion", "build_meca_insertion_single_view", CAPTURE_HW),
    "dream": ("dream", "build_dream_single_view", CAPTURE_HW),
    "fr3_single": ("fr3", "build_fr3_single_view", CAPTURE_HW),
    "fr3_multi": ("fr3", "build_fr3_multi_view", CAPTURE_HW),
}


def _datasets(name: str, caps):
    robot, fn, hw = BUILDERS[name]
    jrig, trig = _rigs(robot, caps[robot])
    path = caps["fr5"]["roi_csv"] if name == "fr5_roi" else caps[robot]["csv"]
    kw = {"tolerance_s": 0.05} if name == "fr3_multi" else {}
    return (getattr(jb, fn)(pd.read_csv(path), jrig, hw, **kw),
            getattr(tb, fn)(table.read_csv(path), trig, hw, **kw))


def _sample_fields(s) -> tuple:
    arr = lambda a: None if a is None else np.asarray(a).tolist()  # noqa: E731
    return (s.image_path, s.camera_key, s.view, arr(s.angles), arr(s.keypoints_2d),
            arr(s.keypoints_3d_cam), s.roi)


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builder_matches_reference(caps, name):
    a, b = _datasets(name, caps)
    assert type(a).__name__ == type(b).__name__ and len(a) == len(b) > 0
    if hasattr(a, "groups"):
        assert a.groups == b.groups and a.max_views == b.max_views
        paths = [v["image_path"] for g in a.groups for v in g["views"]]
        assert [a._resolve_view(p) for p in paths] == [b._resolve_view(p) for p in paths]
    else:
        assert [_sample_fields(s) for s in a.samples] == [_sample_fields(s) for s in b.samples]
        assert a.has_kp3d == b.has_kp3d
        if a.extr_key_fn is not None:
            assert [a.extr_key_fn(s) for s in a.samples] == [b.extr_key_fn(s) for s in b.samples]
    assert a.geometry.camera_keys == b.geometry.camera_keys
    np.testing.assert_array_equal(a.geometry.K, b.geometry.K)
    np.testing.assert_array_equal(a.geometry.dist, b.geometry.dist)


def test_normalize_reference_index_matches_reference(tmp_path):
    csv = tmp_path / "matched_index_with_roi.csv"
    csv.write_text("img.path,img.serial,img.view,img.ts,joint.path,joint.ts,abs_dt,joint.1,"
                   "joint.0,roi.path,roi.x1,roi.y1,roi.x2,roi.y2\n"
                   "a/zed_1_left_1.5.jpg,1,left,1700000000.123456789,j.json,1.0,0.01,2,1.5,"
                   "r.png,1,2,30,40\n"
                   "b/zed_1_left_2.5.jpg,1,left,1700000001.25,j2.json,2.0,0.02,3.25,-1,"
                   "r2.png,0,0,10,12\n")
    want = jb.normalize_reference_index(pd.read_csv(csv))
    got = tb.normalize_reference_index(table.read_csv(csv))
    assert got.columns == list(want.columns)
    for c in want.columns:
        assert np.asarray(got[c]).tolist() == want[c].tolist(), c
    same = table.read_csv(csv)
    same["image_path"] = same["img.path"]
    assert tb.normalize_reference_index(same) is same


@pytest.mark.parametrize("name", ["fr3_multi", "fr5", "dream"])
def test_train_val_split_matches_reference(caps, name):
    a, b = _datasets(name, caps)
    for frac in (0.1, 0.34, 0.5):
        for x, y in zip(jb.train_val_split(a, frac), tb.train_val_split(b, frac)):
            if hasattr(x, "groups"):
                assert x.groups == y.groups
            else:
                assert [s.image_path for s in x.samples] == [s.image_path for s in y.samples]


# ---------------------------------------------------------------- batches


def assert_batches_match(jbatches, tbatches, jgeom, tgeom, undistorted: bool = True):
    """Every array equal but keypoints (within KP_TOL_PX) and images: one
    level apart at most, and only on pixels whose undistortion maps differ
    (the reference fuses its map's arithmetic into FMAs, the port does not)
    where the host `undistorted` them -> (pixels one level apart, pixels)."""
    maps_differ = (jgeom.remaps != tgeom.remaps).any(axis=1) & undistorted  # (C, H, W)
    off, total, n = 0, 0, 0
    for x, y in zip(jbatches, tbatches, strict=True):
        assert list(x) == list(y)
        for k in x:
            assert x[k].shape == y[k].shape and x[k].dtype == y[k].dtype, k
            if k == "images_u8":
                d = np.abs(x[k].astype(np.int16) - y[k].astype(np.int16)).max(axis=-1)
                assert d.max() <= 1
                assert not (d.astype(bool) & ~maps_differ[x["cam_idx"]]).any()
                off, total = off + int((d > 0).sum()), total + d.size
            elif k == "keypoints_2d":
                np.testing.assert_allclose(y[k], x[k], atol=KP_TOL_PX, rtol=0)
            else:
                np.testing.assert_array_equal(y[k], x[k], err_msg=k)
        n += 1
    assert n > 0
    return off, total


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", ["fr3_multi", "fr3_single", "fr5", "fr5_roi", "meca500",
                                  "meca_insertion", "dream"])
def test_batches_match_reference(caps, name, seed):
    a, b = _datasets(name, caps)
    if name in ("fr3_multi", "fr3_single"):
        a.with_extrinsics = b.with_extrinsics = True
    for size, kw in ((2, {"shuffle": True, "seed": seed}), (3, {"drop_last": True})):
        # A sample cropped to its ROI is not undistorted.
        assert_batches_match(a.batches(size, **kw), b.batches(size, **kw), a.geometry,
                             b.geometry, undistorted=name != "fr5_roi")


def test_host_undistortion_within_one_level(caps):
    """The host undistortion of 300 random frames per camera of the FR3
    capture (60 x 80), reference maps against the port's: no value more than
    one level apart, at most ONE_LEVEL_PER_MILLION per million one level
    apart (cv2.remap quantizes the weights to 1/32: a map an ulp apart moves
    a few values a level). Measured: 100 of 17,280,000 values, 5.8 per
    million."""
    a, b = _datasets("fr3_multi", caps)
    rng = np.random.default_rng(0)
    off = total = 0
    for _ in range(300):
        img = _capture_image(rng)
        for c in range(len(a.geometry.camera_keys)):
            d = np.abs(a.geometry.undistort_host(img, c).astype(np.int16)
                       - b.geometry.undistort_host(img, c).astype(np.int16))
            assert d.max() <= 1
            off, total = off + int((d > 0).sum()), total + d.size
    assert 0 < off <= ONE_LEVEL_PER_MILLION * total / 1e6, (off, total)


def test_failed_captures_weigh_zero(caps):
    """The fixture's unreadable image, off-convention file name and
    wrong-size image are masked views, and a view-less group weighs 0."""
    _, b = _datasets("fr3_multi", caps)
    masks = np.concatenate([x["view_mask"] for x in b.batches(2)])
    assert masks.sum(1).tolist() == [4, 3, 4, 3, 4, 4]
    b.groups = [{"views": [{"image_path": "nowhere/zed_1_left_1.0.jpg"}, {"image_path": "x.jpg"}],
                 "joint_angles": [0.0] * 7, "timestamp": 0.0}]
    batch = next(b.batches(1))
    assert batch["sample_weight"].tolist() == [0.0] and not batch["view_mask"].any()


# -------------------------------------------------------- device preprocessing


@pytest.mark.parametrize("on_device", [False, True])
def test_device_preprocess_matches_reference(caps, on_device):
    a, b = _datasets("fr3_multi", caps)
    a.undistort_on_host = b.undistort_on_host = not on_device
    jpre = jds.make_device_preprocessor(a.geometry, 64, (32, 40), 2.5,
                                        undistort_on_device=on_device)
    tpre = tds.make_device_preprocessor(b.geometry, 64, (32, 40), 2.5,
                                        undistort_on_device=on_device)
    for x in a.batches(3, shuffle=True, seed=1):
        imgs, hms = jpre(jnp.asarray(x["images_u8"]), jnp.asarray(x["cam_idx"]),
                         jnp.asarray(x["keypoints_2d"]))
        got_i, got_h = tpre(*(torch.from_numpy(x[k]) for k in ("images_u8", "cam_idx",
                                                                 "keypoints_2d")))
        assert got_i.shape == imgs.shape and got_h.shape == hms.shape
        np.testing.assert_allclose(got_i.numpy(), np.asarray(imgs), atol=IMAGE_TOL, rtol=0)
        np.testing.assert_allclose(got_h.numpy(), np.asarray(hms), atol=HEATMAP_TOL, rtol=0)
        assert float(np.asarray(hms).max()) > 0.5


def test_remap_bilinear_matches_reference():
    from mvropose_tpu.geometry.camera import remap_bilinear as jremap

    rng = np.random.default_rng(8)
    imgs = rng.uniform(0, 1, (3, 13, 17, 3)).astype(np.float32)
    maps = np.stack([rng.uniform(-2, 14, (3, 11, 19)), rng.uniform(-2, 18, (3, 11, 19))],
                    1).astype(np.float32)
    maps[0, :, 0, 0] = [12.0, 16.0]  # on the last row and column: inside, clamped taps
    maps[0, :, 0, 1] = [12.0 + 1e-4, 3.0]  # just past the last row: zero
    want = np.stack([np.asarray(jremap(jnp.asarray(i), jnp.asarray(m))) for i, m in zip(imgs, maps)])
    got = remap_bilinear(torch.from_numpy(imgs), torch.from_numpy(maps)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert got[0, 0, 0].any() and not got[0, 0, 1].any()


# ---------------------------------------------------------------- panels


def test_viz_copy_matches_reference(tmp_path):
    rng = np.random.default_rng(10)
    imgs = rng.normal(0, 1, (3, 48, 64, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (3, 5, 24, 32)).astype(np.float32)
    pred = rng.normal(0, 1, (3, 5, 24, 32)).astype(np.float32)
    mask = np.array([True, False, True])
    np.testing.assert_array_equal(tviz.denormalize(imgs[0]), jviz.denormalize(imgs[0]))
    u8 = tviz.denormalize(imgs[1])
    np.testing.assert_array_equal(tviz.heatmap_overlay(u8, gt[0]), jviz.heatmap_overlay(u8, gt[0]))
    xy = rng.uniform(0, 30, (5, 2)).astype(np.float32)
    xy[2] = np.nan
    np.testing.assert_array_equal(tviz.keypoint_panel(u8, xy, xy[::-1], (24, 32)),
                                  jviz.keypoint_panel(u8, xy, xy[::-1], (24, 32)))
    np.testing.assert_array_equal(tviz.keypoint_panel(u8, xy, None), jviz.keypoint_panel(u8, xy, None))
    np.testing.assert_array_equal(tviz.prediction_panel(imgs[0], gt[0], pred[0]),
                                  jviz.prediction_panel(imgs[0], gt[0], pred[0]))
    np.testing.assert_array_equal(tviz.multi_view_panel(imgs, gt, pred, mask),
                                  jviz.multi_view_panel(imgs, gt, pred, mask))
    np.testing.assert_array_equal(tviz.multi_view_panel(imgs, gt, pred, ~mask & False),
                                  jviz.multi_view_panel(imgs, gt, pred, ~mask & False))


def test_write_image_png_and_npy_fallback(tmp_path, monkeypatch):
    import cv2

    img = np.random.default_rng(11).integers(0, 256, (12, 20, 3)).astype(np.uint8)
    with MetricWriter(tmp_path / "logs") as w:
        w.write_image(7, "panel", img)
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / "logs" / "images" / "panel_step7.png"))[:, :, ::-1], img)
        monkeypatch.setattr(cv2, "imwrite", lambda *a: False)
        w.write_image(8, "panel", img)
    np.testing.assert_array_equal(np.load(tmp_path / "logs" / "images" / "panel_step8.npy"), img)
