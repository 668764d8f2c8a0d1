"""`cli sync` and `cli group` of the torch port against the reference's, on the CPU.

The five sync adapters run on capture trees made as `tests/test_sync.py`
makes them; the port's `Table.to_csv` writes the same bytes as pandas'
`to_csv(index=False)` of the reference's DataFrame, and the two CLIs write
the same file and print the same lines (`--strict`'s exit 1 included).
`cli group` prints the reference's lines and writes its `--out` JSON;
`tolerance_grid_search` gives its distributions. `Table.from_records` and
`to_csv` hold pandas' types and float text on planted values (ints, NaN,
strings that need quoting, shortest float repr).
"""

from __future__ import annotations

import importlib
import json

import numpy as np
import pandas as pd
import pytest

from mvropose_tpu.data import sync as jsync
from mvropose_tpu.data.grouping import tolerance_grid_search as jax_grid_search
from mvropose_torch.cli.main import main
from mvropose_torch.data import sync as tsync
from mvropose_torch.data.grouping import tolerance_grid_search
from mvropose_torch.data.table import Table, read_csv
import torch_parity  # noqa: F401  (one torch thread a test process)

jax_cli = importlib.import_module("mvropose_tpu.cli.main")  # the package exports main()


def _touch_image(path):
    import cv2

    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), np.zeros((8, 8, 3), np.uint8))


def _fr5(root):
    base = root / "Fr5_1th"
    (base / "joint").mkdir(parents=True)
    for i in range(5):
        ts = 1000.0 + i * 0.1
        # ints in one file, floats in the others: pandas types the column float64
        angles = [i] * 6 if i == 2 else [float(i) + 0.123456789] * 6
        (base / "joint" / f"joint_{ts:.3f}.json").write_text(json.dumps(angles))
    (base / "joint" / "j_1000.9.json").write_text(json.dumps([1.0] * 4))  # wrong arity
    (base / "joint" / "j_1001.0.json").write_text("not json")
    for side in ("left", "right", "top"):
        for i in range(5):
            _touch_image(base / side / f"zed_38007749_{side}_{1000.0 + i * 0.1 - 0.03:.3f}.jpg")
    _touch_image(base / "left" / "zed_38007749_left_0.0.jpg")  # a 0.0 timestamp, unmatched
    _touch_image(base / "left" / "zed_38007749_left_bad.jpg")  # no timestamp
    return ["fr5", "--base-dirs", str(base)], lambda: ([base], jsync.SyncConfig(0.05))


def _fr3(root):
    jdir = root / "joints"
    jdir.mkdir()
    docs = []
    for i in range(4):
        docs.append("header:\n  stamp:\n    sec: %d\n    nanosec: %d\n"
                    "name: [fr3_joint1, fr3_joint2]\nposition: [%f, %f]\n"
                    "velocity: [0.0]\neffort: [0.0, 0.5]\n" % (1000 + i, 1234567 * i, 0.1 * i,
                                                                 0.2 * i))
    (jdir / "joint_states_0.yaml").write_text("---\n".join(docs))
    img_dir = root / "pose1"
    for i in range(4):
        for serial in ("41182735", "49429257"):
            _touch_image(img_dir / f"zed_{serial}_left_{1000 + i - 0.03 + 0.001 * i:.9f}.jpg")
    _touch_image(img_dir / "zed_41182735_left_1010.5.jpg")  # no joint record near it
    return (["fr3", "--base-dirs", str(img_dir), "--joint-dir", str(jdir)],
            lambda: ([img_dir], jdir, jsync.SyncConfig(0.05)))


def _dream(root):
    base = root / "panda-3cam_azure"
    base.mkdir()
    for i in range(4):
        data = {
            "sim_state": {"joints": [{"name": f"panda_joint{j}", "position": 0.1 * j + i}
                                     for j in range(1, 8)]},
            "objects": [{"keypoints": [
                {"name": n, "location": [1.0 * k, 2.0, 3.5e-7], "projected_location":
                 [10.0 * k + i, 20]} for k, n in enumerate(jsync.DREAM_KEYPOINT_NAMES)]}],
        }
        if i == 3:
            data["objects"][0]["keypoints"].pop()  # a keypoint missing: skipped
        (base / f"{i:04d}.json").write_text(json.dumps(data))
        _touch_image(base / f"{i:04d}.rgb.jpg")
    (base / "_camera_settings.json").write_text("{}")
    return ["dream", "--base-dirs", str(base)], lambda: (base,)


def _meca500(root):
    (root / "angle").mkdir()
    for i in (1, 2, 7, 12):
        (root / "angle" / f"angle{i}.json").write_text(json.dumps([float(i) * 1.5] * 6))
        _touch_image(root / "image" / f"image{i}.jpg")
    (root / "angle" / "angle9.json").write_text(json.dumps([9.0] * 6))  # no image
    return (["meca500", "--base-dirs", str(root / "image"), "--joint-dir", str(root / "angle")],
            lambda: (root / "image", root / "angle"))


def _meca_insertion(root):
    txt = root / "robot_data.txt"
    lines = ["timestamp,j1,j2,j3,j4,j5,j6,j7,x,y,z,a,b"]
    for i in range(3):
        lines.append(",".join(str(v) for v in [2000.0 + i] + [0.5 * i + 0.1] * 6 + [9.0]
                              + [1, 2, 3, 4, 5]))
    txt.write_text("\n".join(lines))
    img_dir = root / "imgs"
    for i in range(3):
        _touch_image(img_dir / f"zed_41182735_left_{2000.0 + i - 0.03:.3f}.jpg")
    return (["meca_insertion", "--base-dirs", str(img_dir), "--joint-dir", str(txt)],
            lambda: ([img_dir], txt, jsync.SyncConfig(0.05)))


ADAPTERS = {"fr5": _fr5, "fr3": _fr3, "dream": _dream, "meca500": _meca500,
            "meca_insertion": _meca_insertion}


@pytest.mark.parametrize("robot", sorted(ADAPTERS))
def test_sync_adapter_csv_is_pandas_bytes(robot, tmp_path):
    """The port's adapter, written by `Table.to_csv`, is byte-equal to
    pandas' `to_csv` of the reference adapter's DataFrame."""
    _, ref_args = ADAPTERS[robot](tmp_path)
    args = ref_args()
    port_fn = getattr(tsync, f"sync_{robot}")
    if robot in ("fr3", "fr5", "meca_insertion"):
        port_args = (*args[:-1], tsync.SyncConfig(0.05))
    else:
        port_args = args
    want = getattr(jsync, f"sync_{robot}")(*args)
    got = port_fn(*port_args)
    assert len(got) == len(want) > 0
    want.to_csv(tmp_path / "want.csv", index=False)
    got.to_csv(tmp_path / "got.csv")
    assert (tmp_path / "got.csv").read_bytes() == (tmp_path / "want.csv").read_bytes()


@pytest.mark.parametrize("robot", sorted(ADAPTERS))
def test_cli_sync_matches_reference(robot, tmp_path, capsys):
    argv, _ = ADAPTERS[robot](tmp_path)
    outs = {}
    for name, fn in (("ref", jax_cli.main), ("port", main)):
        out = tmp_path / name / "synced.csv"
        assert fn(["sync", *argv, "--out", str(out), "--tolerance", "0.05"]) == 0
        outs[name] = (out.read_bytes(), capsys.readouterr().out.replace(str(out), "OUT"))
    assert outs["port"] == outs["ref"]


def test_cli_sync_strict_exits_1_on_no_rows(tmp_path, capsys):
    (tmp_path / "angle").mkdir()
    (tmp_path / "image").mkdir()
    argv = ["sync", "meca500", "--base-dirs", str(tmp_path / "image"), "--joint-dir",
            str(tmp_path / "angle"), "--strict"]
    for fn, name in ((jax_cli.main, "ref"), (main, "port")):
        assert fn([*argv, "--out", str(tmp_path / f"{name}.csv")]) == 1
    captured = capsys.readouterr()
    assert captured.err.count("error: --strict and no rows matched") == 2
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes() == b"\n"


def _group_csv(path):
    ts = np.concatenate([np.arange(8) * 0.011 + k * 0.5 for k in range(4)] + [[3.0, 3.04, 3.2]])
    pd.DataFrame({"image_path": [f"im{i}.jpg" for i in range(len(ts))],
                  "robot_timestamp": 1700000000.0 + ts,
                  "position_fr3_joint1": np.arange(len(ts)) * 0.1,
                  "joint_timestamp": 9.0}).to_csv(path, index=False)


@pytest.mark.parametrize("flags", [[], ["--tolerance", "0.03", "--max-views", "4",
                                        "--min-views", "1"]])
def test_cli_group_matches_reference(flags, tmp_path, capsys):
    csv = tmp_path / "rows.csv"
    _group_csv(csv)
    outs = {}
    for name, fn in (("ref", jax_cli.main), ("port", main)):
        out = tmp_path / f"{name}.json"
        assert fn(["group", "--csv", str(csv), *flags, "--out", str(out)]) == 0
        outs[name] = (out.read_text(), capsys.readouterr().out.replace(str(out), "OUT"))
    assert outs["port"] == outs["ref"]
    assert json.loads(outs["port"][0])


def test_tolerance_grid_search_matches_reference(tmp_path):
    csv = tmp_path / "rows.csv"
    _group_csv(csv)
    cands = [0.005, 0.01, 0.05, 0.1]
    assert tolerance_grid_search(read_csv(csv), cands, 8) == jax_grid_search(
        pd.read_csv(csv), cands, 8)
    assert tolerance_grid_search(Table({"robot_timestamp": np.zeros(0),
                                        "image_path": np.zeros(0)}), [0.1], 8) == (0.1, {0.1: {}})


def test_match_nearest_matches_reference():
    rng = np.random.default_rng(0)
    ref = np.sort(rng.uniform(0, 10, 50))
    q = np.concatenate([rng.uniform(-1, 11, 200), ref[:5], (ref[:5] + ref[1:6]) / 2])
    for tol in (0.01, 0.1, 1.0):
        for a, b in zip(tsync.match_nearest(q, ref, tol), jsync.match_nearest(q, ref, tol)):
            np.testing.assert_array_equal(a, b)
    assert not tsync.match_nearest(np.array([1.0]), np.array([]), 0.1)[1].any()
    assert tsync.parse_timestamp_from_filename("zed_1_left_1748242800.123.jpg") == 1748242800.123
    assert tsync.parse_timestamp_from_filename("bad_name.jpg") is None


def test_table_records_and_csv_match_pandas(tmp_path):
    """pd.DataFrame(records).to_csv(index=False), byte for byte: int64 where
    every value is an int, float64 with NaN where one is missing or a float,
    strings quoted only where they must be, floats as their shortest repr."""
    records = [
        {"a": 1, "b": 0.1, "c": "x,y", "e": 1e16, "f": 3},
        {"a": 2, "c": 'say "hi"', "d": 1e-05, "e": 1700000000.1234567, "f": 2.5},
        {"a": -3, "b": float("nan"), "c": "", "d": -0.0, "e": 123456789012345678.0, "f": None},
        {"a": 4, "b": 2, "c": None, "d": float("inf"), "e": 0.30000000000000004, "f": 1},
    ]
    want = pd.DataFrame(records)
    got = Table.from_records(records)
    assert got.columns == list(want.columns)
    assert [got[c].dtype.kind for c in got.columns] == ["i", "f", "O", "f", "f", "f"]
    want.to_csv(tmp_path / "want.csv", index=False)
    got.to_csv(tmp_path / "got.csv")
    assert (tmp_path / "got.csv").read_bytes() == (tmp_path / "want.csv").read_bytes()
    Table.from_records([]).to_csv(tmp_path / "empty.csv")
    pd.DataFrame([]).to_csv(tmp_path / "empty_want.csv", index=False)
    assert (tmp_path / "empty.csv").read_bytes() == (tmp_path / "empty_want.csv").read_bytes()
    # What to_csv writes reads back as pandas reads it.
    np.testing.assert_array_equal(read_csv(tmp_path / "got.csv")["e"],
                                  pd.read_csv(tmp_path / "want.csv")["e"])
