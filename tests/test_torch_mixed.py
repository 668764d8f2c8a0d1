"""Mixed-robot training and data of the torch port against the reference, on the CPU.

On the fixture of `tests/test_mixed.py` (the reference's
`scripts/make_mixed_synthetic.py`, 8 samples per robot at 64 x 64, fr5 and
fr3): `MixedRobotDataset.batches` gives the reference's batches, every key,
unshuffled and shuffled (the keypoints within KP_TOL_PX: the two packages'
f32 FK and projection; the images equal, as the fixture's cameras have no
distortion); a PAD_KEYPOINT channel renders exactly 0 through the port's
render; `cli train --robot fr5,fr3` trains, writes a checkpoint the
reference's `load_params_npz` reads, whose forward agrees with the
reference's within 1e-4 (f32), and the mixed refusals are the reference's.
The port's two data generators, at the reference scripts' seed, write the
same CSV bytes and JSON values (angles equal, keypoints and cameras within
GEN_TOL) and images within 2 levels.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from mvropose_tpu.calib.registry import load_rig as jax_load_rig
from mvropose_tpu.data import builders as jbuilders
from mvropose_tpu.data.mixed import MixedRobotDataset as JaxMixed
from mvropose_torch.calib.registry import load_rig
from mvropose_torch.cli.main import main
from mvropose_torch.data import builders
from mvropose_torch.data.dataset import make_device_preprocessor
from mvropose_torch.data.mixed import PAD_KEYPOINT, MixedRobotDataset
from mvropose_torch.data.table import read_csv
from test_torch_cli_train import FORWARD_TOL, _jax_forward, _port_model
from torch_parity import load_script

jax_cli = importlib.import_module("mvropose_tpu.cli.main")  # the package exports main()
ROOT = Path(__file__).resolve().parents[1]
KP_TOL_PX = 1e-3
GEN_TOL = 1e-5


def _reference_script(name: str, out: Path, *argv) -> None:
    subprocess.run([sys.executable, str(ROOT / "scripts" / f"{name}.py"), "--out-dir", str(out),
                    *argv], check=True, capture_output=True, timeout=600)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory) -> Path:
    out = tmp_path_factory.mktemp("mixed")
    _reference_script("make_mixed_synthetic", out, "--robots", "fr5", "fr3", "--n-samples", "8",
                      "--image-hw", "64", "64")
    return out


def _children(out: Path, port: bool):
    """fr5's and fr3's single-view datasets, as test_mixed.py builds them."""
    rig_fn, b, read = (load_rig, builders, read_csv) if port else (jax_load_rig, jbuilders,
                                                                   pd.read_csv)
    rig5 = rig_fn("fr5", "fr5", {"38007749": "left"}, calib_dir=out / "calib",
                  aruco_summary_paths=out / "fr5_aruco_pose_summary.json")
    rig3 = rig_fn("fr3", "fr3", {"41182735": "view1"}, calib_dir=out / "calib",
                  aruco_summary_paths={"pose1": out / "pose1_aruco_pose_summary.json"})
    return (b.build_fr5_single_view(read(out / "fr5.csv"), rig5, (64, 64)),
            b.build_fr3_single_view(read(out / "fr3.csv"), rig3, (64, 64)))


@pytest.mark.parametrize("shuffle", [False, True])
def test_batches_match_reference(fixture, shuffle):
    ours = MixedRobotDataset(_children(fixture, True), ["fr5", "fr3"])
    ref = JaxMixed(_children(fixture, False), ["fr5", "fr3"])
    assert (ours.num_keypoints, ours.num_angles, len(ours)) == (8, 7, 16)
    assert ours.angle_scale == ref.angle_scale and ours.samples == ref.samples
    n = 0
    for x, y in zip(ref.batches(6, shuffle=shuffle, seed=3),
                    ours.batches(6, shuffle=shuffle, seed=3), strict=True):
        assert list(x) == list(y)
        for k in x:
            assert x[k].shape == y[k].shape and x[k].dtype == y[k].dtype, k
            if k == "keypoints_2d":
                np.testing.assert_allclose(y[k], x[k], atol=KP_TOL_PX, rtol=0)
            else:
                np.testing.assert_array_equal(y[k], x[k], err_msg=k)
        n += 1
    assert n == 3
    fr5 = y["robot_id"][:4] == 0
    assert (y["angle_mask"][:4][fr5, 6] == 0).all() and (y["sample_weight"][4:] == 0).all()


def test_pad_keypoint_renders_exactly_zero(fixture):
    ds = MixedRobotDataset(_children(fixture, True), ["fr5", "fr3"])
    batch = next(iter(ds.batches(16)))
    pre = make_device_preprocessor(ds.geometry, 64, (64, 64), sigma=3.0)
    _, hms = pre(*(torch.from_numpy(batch[k]) for k in ("images_u8", "cam_idx", "keypoints_2d")))
    fr5 = batch["robot_id"] == 0
    assert (batch["keypoints_2d"][fr5, 7] == PAD_KEYPOINT).all()
    assert hms.shape[1] == 8
    assert (hms[fr5, 7] == 0.0).all()
    assert (hms[fr5, :7].amax((1, 2, 3)) > 0.5).all()


def _train_argv(out: Path, workdir: Path, *extra) -> list:
    return ["train", "--robot", "fr5,fr3", "--csv", str(out / "fr5.csv"), str(out / "fr3.csv"),
            "--calib-dir", str(out / "calib"), "--aruco-summary",
            str(out / "fr5_aruco_pose_summary.json"), str(out / "pose1_aruco_pose_summary.json"),
            "--workdir", str(workdir), "--image-hw", "64", "64", "--model-size", "64",
            "--hidden-size", "64", "--num-layers", "1", "--batch-size", "4", "--epochs", "1",
            "--val-split", "0.25", "--no-augment", "--device", "cpu", "--num-workers", "0", *extra]


def test_cli_train_mixed_and_the_reference_reads_its_checkpoint(fixture, tmp_path, capsys):
    run = tmp_path / "run"
    assert main(_train_argv(fixture, run, "--num-workers", "2")) == 0
    printed = capsys.readouterr().out
    assert "  fr5: 8 samples" in printed and "  fr3: 8 samples" in printed
    assert "note: --num-workers parallel loading needs a non-mixed dataset" in printed
    rec = json.loads((run / "logs" / "metrics.jsonl").read_text().splitlines()[-1])
    # 12 train samples in batches of 4.
    assert rec["step"] == 3 and np.isfinite(rec["val_loss"])
    cfg = json.loads((run / "model_config.json").read_text())
    assert (cfg["kind"], cfg["num_joints"], cfg["num_angles"]) == ("single_view", 8, 7)
    model, _, _ = _port_model(run)
    imgs = np.random.default_rng(0).normal(size=(3, 64, 64, 3)).astype(np.float32)
    want = _jax_forward(run, imgs)
    with torch.no_grad():
        got = model(torch.from_numpy(imgs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FORWARD_TOL, rtol=0)


@pytest.mark.parametrize("extra", [["--fk-loss-weight", "0.5"], ["--angle-head", "geometric3d"],
                                   ["--csv", "one.csv"]])
def test_mixed_refusals_match_reference(fixture, tmp_path, extra):
    argv = _train_argv(fixture, tmp_path / "run", *extra)
    messages = []
    for fn, args in ((jax_cli.main, [a for a in argv if a not in ("--device", "cpu")]),
                     (main, argv)):
        with pytest.raises(SystemExit) as e:
            fn(args)
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    assert not (tmp_path / "run").exists()


def _csv_values(path: Path) -> pd.DataFrame:
    df = pd.read_csv(path)
    df["image_path"] = [Path(p).name for p in df["image_path"]]
    return df


def _images_close(a: Path, b: Path) -> None:
    import cv2

    ia, ib = cv2.imread(str(a)).astype(int), cv2.imread(str(b)).astype(int)
    assert np.abs(ia - ib).max() <= 2, (a, np.abs(ia - ib).max())


def test_mixed_generator_matches_reference(fixture, tmp_path):
    """The same seed: the same CSV rows and angles, cameras within GEN_TOL,
    images within 2 levels (fr5 and fr3 from the module's fixture, then
    meca_insertion through the port's sync)."""
    port = tmp_path / "port"
    assert load_script("torch_make_mixed_synthetic").main(
        ["--out-dir", str(port), "--robots", "fr5", "fr3", "--n-samples", "8", "--image-hw",
         "64", "64", "--device", "cpu"]) == 0
    for robot in ("fr5", "fr3"):
        pd.testing.assert_frame_equal(_csv_values(port / f"{robot}.csv"),
                                      _csv_values(fixture / f"{robot}.csv"))
    for name in ("fr5_aruco_pose_summary.json", "pose1_aruco_pose_summary.json"):
        got, want = (json.loads((d / name).read_text())[0] for d in (port, fixture))
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k] == v if isinstance(v, str) else abs(got[k] - v) <= GEN_TOL, k
    for a in sorted((fixture / "fr5" / "images").glob("*.jpg"))[:4]:
        _images_close(port / "fr5" / "images" / a.name, a)
    ref3, port3 = tmp_path / "ref3", tmp_path / "port3"
    _reference_script("make_mixed_synthetic", ref3, "--robots", "meca_insertion", "--n-samples",
                      "4", "--image-hw", "48", "48")
    assert load_script("torch_make_mixed_synthetic").main(
        ["--out-dir", str(port3), "--robots", "meca_insertion", "--n-samples", "4",
         "--image-hw", "48", "48", "--device", "cpu"]) == 0
    got, want = ((d / "meca_insertion.csv").read_text().replace(str(d), "ROOT")
                 for d in (port3, ref3))
    assert got == want


def test_dream_generator_matches_reference(tmp_path):
    ref, port = tmp_path / "ref", tmp_path / "port"
    _reference_script("make_dream_synthetic", ref, "--n-samples", "5", "--image-hw", "48", "64",
                      "--focal-scale", "0.96", "--seed", "3")
    assert load_script("torch_make_dream_synthetic").main(
        ["--out-dir", str(port), "--n-samples", "5", "--image-hw", "48", "64", "--focal-scale",
         "0.96", "--seed", "3", "--device", "cpu"]) == 0
    assert ((port / "panda_synth" / "_camera_settings.json").read_text()
            == (ref / "panda_synth" / "_camera_settings.json").read_text())
    for i in range(5):
        got, want = (json.loads((d / "panda_synth" / f"{i:04d}.json").read_text())
                     for d in (port, ref))
        assert got["sim_state"] == want["sim_state"]
        for kg, kw in zip(got["objects"][0]["keypoints"], want["objects"][0]["keypoints"],
                          strict=True):
            assert kg["name"] == kw["name"]
            np.testing.assert_allclose(kg["location"] + kg["projected_location"],
                                       kw["location"] + kw["projected_location"], atol=GEN_TOL,
                                       rtol=GEN_TOL)
        _images_close(port / "panda_synth" / f"{i:04d}.rgb.jpg",
                      ref / "panda_synth" / f"{i:04d}.rgb.jpg")
