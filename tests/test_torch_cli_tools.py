"""The port's CLI tools against the reference's, on the CPU.

`rig/viewer.py` bit-equal to the reference's copy; `serve --display dir`'s
canvases (count, names and pixels) against the reference's on the same
planted results, both loops driven by one deterministic stand-in for the
streaming pipeline; `cli profile`'s stage names and line formats; `cli
calibrate`'s five subcommands on the same inputs (intrinsics and manual
byte-equal, the extrinsics and stereo-transfer poses within 1e-6 m and 1e-6
rad, the corners' poses within LM_F32_TOL); the display's two mended
faults of the reference; `geometry/ik.py` on `tests/test_ik.py`'s cases against the
reference's solver; `utils/probe.py::pca_rgb` against the reference's
within one level; and `python -m mvropose_torch --help`.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvropose_torch.cli.main as port_cli
import mvropose_tpu.rig as jax_rig
from mvropose_tpu.cli.main import main as jax_main
from mvropose_tpu.geometry import ik as jax_ik
from mvropose_tpu.geometry.robots import FR3 as JAX_FR3
from mvropose_tpu.geometry.robots import MECA500 as JAX_MECA500
from mvropose_tpu.geometry.robots import forward_kinematics as jax_fk
from mvropose_tpu.rig import viewer as jax_viewer
from mvropose_tpu.utils.probe import pca_rgb as jax_pca_rgb
from mvropose_torch.cli.main import main as port_main
from mvropose_torch.geometry import ik
from mvropose_torch.geometry.robots import forward_kinematics, get_robot
from mvropose_torch.rig import StreamStats, viewer
from mvropose_torch.utils.probe import pca_rgb
from torch_parity import FR3_CONF

ROOT = Path(__file__).resolve().parents[1]
POSE_TOL_M, POSE_TOL_RAD = 1e-6, 1e-6
# `calibrate corners` solves each marker's PnP by an f32 LM in both packages;
# each lands up to 2.1e-5 (rad or m) from cv2's float64 solvePnPRefineLM
# optimum on this capture's markers, so 1e-6 between them is out of reach.
LM_F32_TOL = 5e-5
IK_FK_TOL_M = 1e-5  # FK of the two solvers' angles, f32


# ---------------------------------------------------------------- viewer


def test_viewer_copy_matches_reference():
    rng = np.random.default_rng(0)
    links = ((0, 1), (1, 2), (2, 3), (3, 7), (5, 6))
    frames, ours, theirs = {}, {}, {}
    for i, name in enumerate(("top", "left", "right")):
        img = rng.integers(0, 256, (48 + 8 * i, 64, 3), dtype=np.uint8)
        kp = rng.uniform(-5, 70, (7, 2)).astype(np.float32)
        kp[4] = np.nan
        scores = rng.uniform(0, 1, 7)
        for mod, out in ((viewer, ours), (jax_viewer, theirs)):
            out[name] = mod.draw_keypoints_overlay(img, kp, links, scores=scores, min_score=0.4)
            np.testing.assert_array_equal(
                mod.draw_keypoints_overlay(img, kp, links), jax_viewer.draw_keypoints_overlay(
                    img, kp, links))
        np.testing.assert_array_equal(ours[name], theirs[name])
        frames[name] = ours[name]
    frames["right"] = None  # a placeholder panel
    for max_wh in ((1800, 950), (100, 80)):
        np.testing.assert_array_equal(
            viewer.tile_frames(frames, frame_hw=(48, 64), max_wh=max_wh),
            jax_viewer.tile_frames(frames, frame_hw=(48, 64), max_wh=max_wh))


# ---------------------------------------------------------------- serve --display


class PlantedPipeline:
    """Stands in for `StreamingPipeline` in a serve loop: TICKS ticks of
    planted results and frames (a camera without a frame every fifth tick),
    each handed to on_result, then no new frames. The step never runs."""

    TICKS = 25

    def __init__(self, sources, step_fn, on_result=None, frame_hw=(60, 80), max_skew_s=None,
                 fetch_fn=None):
        self.sources, self.on_result, self.fetch_fn = list(sources), on_result, fetch_fn
        self.active, self.failed = list(sources), []
        self.hw = tuple(frame_hw)
        self.stats = StreamStats()
        self.rng = np.random.default_rng(7)

    def start(self):
        pass

    def stop(self):
        pass

    def drain(self):
        return None

    def tick(self):
        if self.stats.ticks >= self.TICKS:
            return None
        V, J = len(self.sources), 8
        H, W = self.hw
        frames = [None if (self.stats.ticks % 5 == 3 and v == 1) else SimpleNamespace(
            image=self.rng.integers(0, 256, (H, W, 3), dtype=np.uint8)) for v in range(V)]
        result = (self.rng.uniform(0, W, (V, J, 2)).astype(np.float32),
                  self.rng.uniform(0.3, 1.0, (V, J)).astype(np.float32),
                  np.zeros((1, 7), np.float32))
        self.on_result(result, frames)
        self.stats.ticks += 1
        return result


SERVE_ARGV = ["serve", "--views", "3", "--fps", "30", "--frame-hw", "60", "80", "--model-size",
              "32", "--hidden-size", "64", "--num-layers", "1", "--duration", "0.2",
              "--display", "dir", "--display-every", "10"]


def test_serve_display_dir_matches_reference(tmp_path, monkeypatch):
    """Both serve loops on the same planted results: canvases 1, 11 and 21
    of 25 ticks, the same names and pixels (a 2-over-1 layout with a
    placeholder panel on ticks 4, 9, ..)."""
    monkeypatch.setattr(jax_rig, "StreamingPipeline", PlantedPipeline)
    monkeypatch.setattr(port_cli, "StreamingPipeline", PlantedPipeline)
    assert jax_main([*SERVE_ARGV, "--display-dir", str(tmp_path / "ref")]) == 0
    assert port_main([*SERVE_ARGV, "--display-dir", str(tmp_path / "port"), "--device",
                      "cpu"]) == 0
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == ["canvas_000001.png", "canvas_000011.png", "canvas_000021.png"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in names:
        a, b = (cv2.imread(str(tmp_path / d / name)) for d in ("ref", "port"))
        assert a.shape == (120, 160, 3)
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_serve_display_window_acts_as_the_reference(monkeypatch):
    """--display window shows each canvas (cv2.imshow, 'q' quits): the same
    calls as the reference's, and 'q' ends the loop after its tick."""
    shown = {}
    for label, mod in (("ref", None), ("port", port_cli)):
        calls = shown[label] = []
        monkeypatch.setattr(cv2, "imshow", lambda title, img, c=calls: c.append(img.shape))
        monkeypatch.setattr(cv2, "waitKey", lambda ms, c=calls: ord("q") if len(c) == 3 else -1)
        monkeypatch.setattr(cv2, "destroyAllWindows", lambda c=calls: c.append("closed"))
        argv = [a if a != "dir" else "window" for a in SERVE_ARGV]
        if mod is None:
            monkeypatch.setattr(jax_rig, "StreamingPipeline", PlantedPipeline)
            assert jax_main(argv) == 0
        else:
            monkeypatch.setattr(port_cli, "StreamingPipeline", PlantedPipeline)
            assert port_main([*argv, "--device", "cpu"]) == 0
    assert shown["port"] == shown["ref"] == [(120, 160, 3)] * 3 + ["closed"]


def test_display_every_tick_draws_both_cameras(tmp_path):
    """The two mended faults of the reference's display: at `every` 1 each
    tick writes its canvas, and 2 cameras share one row, each panel the
    camera's own frame (no keypoint reaches 0.6 confidence)."""
    H, W = 60, 80
    on_result, _ = port_cli.make_display("dir", ["a", "b"], ((0, 1),), (H, W), tmp_path, 1)
    rng = np.random.default_rng(3)
    frames = [SimpleNamespace(image=rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
              for _ in range(2)]
    result = (rng.uniform(0, W, (2, 2, 2)).astype(np.float32), np.zeros((2, 2), np.float32))
    for _ in range(3):
        on_result(result, frames)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [f"canvas_{n:06d}.png" for n in (1, 2, 3)]
    canvas = cv2.imread(str(tmp_path / names[-1]))[:, :, ::-1]
    np.testing.assert_array_equal(canvas, np.hstack([f.image for f in frames]))


# ---------------------------------------------------------------- profile


PROFILE_ARGV = ["profile", "--views", "2", "--model-size", "32", "--hidden-size", "64",
                "--num-layers", "1", "--iters", "2"]
STAGE_LINE = re.compile(r"^(\w+) +total +\d+\.\d{3}s  n= +(\d+)  mean +\d+\.\d{2}ms$")
RATE_LINE = re.compile(r"^estimated frame-sets/s \(forward\+decode\): \d+\.\d{2}$")


def _profile_lines(out: str) -> tuple:
    lines = out.strip().splitlines()
    stages = [STAGE_LINE.match(line) for line in lines[:3]]
    assert all(stages) and lines[3] == "" and RATE_LINE.match(lines[4]), out
    return sorted((m.group(1), m.group(2)) for m in stages), len(lines[0])


def test_profile_prints_the_reference_stages_and_lines(capsys):
    assert jax_main(PROFILE_ARGV) == 0
    want = _profile_lines(capsys.readouterr().out)
    assert port_main([*PROFILE_ARGV, "--device", "cpu"]) == 0
    got = _profile_lines(capsys.readouterr().out)
    assert got == want == ([("backbone", "2"), ("decode", "2"), ("full_forward", "2")],
                           len(want[0] and "x" * want[1]))


def test_stage_timer_wall_clock_on_the_cpu():
    from mvropose_torch.utils.timing import StageTimer

    timer = StageTimer("cpu")
    assert timer.timed("a", lambda x: x + 1, 1) == 2
    with timer.stage("a"):
        pass
    report = timer.report()
    assert report["a"]["count"] == 2 and report["a"]["total_s"] >= 0.0
    assert timer.summary().startswith("a" + " " * 29 + " total")


# ---------------------------------------------------------------- calibrate


STEREO = """
[STEREO]
Baseline = 119.8
TY = 0.21
TZ = -0.35
CV_FHD = 0.0031
RX_FHD = -0.0012
RZ_FHD = 0.0007
"""
SERIALS = {"view1": "41182735", "view2": "49429257"}
MARKER = 0.05


def _quat(rvec) -> dict:
    R, _ = cv2.Rodrigues(np.asarray(rvec, np.float64))
    w = np.sqrt(max(1.0 + np.trace(R), 1e-12)) / 2.0
    q = np.array([(R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
                  (R[1, 0] - R[0, 1]) / (4 * w), w])
    return dict(zip("xyzw", map(float, q)))


def write_aruco_capture(root: Path) -> dict:
    """Calibration inputs for both views' cameras: the intrinsics conf (with
    a [STEREO] section), per camera 3 capture files of 3 markers (noisy
    repeats of one pose, one detection a rotation outlier, corner pixels
    projected through the camera's K), the board offsets and the serial
    map."""
    rng = np.random.default_rng(11)
    conf_dir, aruco = root / "conf", root / "aruco"
    conf_dir.mkdir(parents=True)
    aruco.mkdir()
    K = np.array([[700.0, 0, 640], [0, 705.0, 360], [0, 0, 1]])
    offsets = {}
    for view, serial in SERIALS.items():
        (conf_dir / f"SN{serial}.conf").write_text(FR3_CONF + STEREO)
        offsets[view] = {m: rng.uniform(-0.2, 0.2, 3).round(4).tolist() for m in ("3", "7", "12")}
        for cam in ("leftcam", "rightcam"):
            poses = {m: (rng.uniform(-0.4, 0.4, 3) + [2.8, 0.1, 0.2], rng.uniform(-0.3, 0.3, 3)
                         + [0.0, 0.0, 1.5]) for m in ("3", "7", "12")}
            for i in range(3):
                dets = {}
                for m, (rvec, tvec) in poses.items():
                    r = rvec + rng.normal(0, 0.002, 3)
                    if i == 1 and m == "7":
                        r = rvec + 0.2  # 11 degrees off: an outlier
                    t = tvec + rng.normal(0, 0.0003, 3)
                    obj = np.array([[0, 0, 0], [MARKER, 0, 0], [MARKER, MARKER, 0],
                                    [0, MARKER, 0]], np.float64)
                    px, _ = cv2.projectPoints(obj, r, t, K, None)
                    dets[m] = {"position_m": dict(zip("xyz", map(float, t))),
                               "rotation_quat": _quat(r),
                               "corners_pixel": (px[:, 0] + rng.normal(0, 0.05, (4, 2))).tolist()}
                (aruco / f"{view}_{serial}_{cam}_{i:03d}.json").write_text(json.dumps(dets))
    (root / "offsets.json").write_text(json.dumps(offsets))
    (root / "serials.json").write_text(json.dumps(SERIALS))
    return {"conf_dir": conf_dir, "aruco": aruco, "offsets": root / "offsets.json",
            "serials": root / "serials.json"}


def _calibrate(main, cap: dict, out: Path) -> dict:
    """Every subcommand into `out` -> {name: path}."""
    out.mkdir()
    for view, serial in SERIALS.items():
        assert main(["calibrate", "intrinsics", "--conf", str(cap["conf_dir"] / f"SN{serial}.conf"),
                     "--serial", serial, "--view", view, "--out-dir", str(out / "calib")]) == 0
    for cam, rv in (("leftcam", ["96", "98", "-45"]), ("rightcam", ["95.5", "97", "-44"])):
        assert main(["calibrate", "manual", "--view", "front", "--cam", cam, "--tvec", "0.1",
                     "-0.01", "0.75", "--rvec-deg", *rv, "--out", str(out / "manual.json")]) == 0
    assert main(["calibrate", "extrinsics", "--aruco-dir", str(cap["aruco"]), "--offsets",
                 str(cap["offsets"]), "--outlier-deg", "2.0", "--outlier-pos", "0.01", "--out",
                 str(out / "extrinsics.json")]) == 0
    assert main(["calibrate", "corners", "--aruco-dir", str(cap["aruco"]), "--calib-dir",
                 str(out / "calib"), "--serial-map", str(cap["serials"]), "--offsets",
                 str(cap["offsets"]), "--out", str(out / "corners.json")]) == 0
    left = [r for r in json.loads((out / "extrinsics.json").read_text())
            if r["cam"] == "leftcam"]
    (out / "stereo.json").write_text(json.dumps(left))
    assert main(["calibrate", "stereo-transfer", "--summary", str(out / "stereo.json"),
                 "--serial-map", str(cap["serials"]), "--conf-dir", str(cap["conf_dir"]),
                 "--resolution", "FHD", "--correction-offset", "-0.025", "0", "0"]) == 0
    return {p.name: p for p in (*out.glob("*.json"), *(out / "calib").glob("*.json"))}


def test_calibrate_matches_reference(tmp_path, capsys):
    cap = write_aruco_capture(tmp_path / "cap")
    want = _calibrate(jax_main, cap, tmp_path / "ref")
    ref_out = capsys.readouterr().out
    got = _calibrate(port_main, cap, tmp_path / "port")
    port_out = capsys.readouterr().out
    # The same printed lines, but for the output paths.
    assert port_out.replace(str(tmp_path / "port"), "") == ref_out.replace(str(tmp_path / "ref"), "")
    assert sorted(got) == sorted(want) and len(want) == 8
    for name in ("manual.json", *(n for n in want if n.endswith("_calib.json"))):
        assert got[name].read_bytes() == want[name].read_bytes(), name
    for name in ("extrinsics.json", "corners.json", "stereo.json"):
        a, b = json.loads(want[name].read_text()), json.loads(got[name].read_text())
        assert len(a) == len(b) == 4, name
        for ra, rb in zip(a, b, strict=True):
            assert {k: v for k, v in ra.items() if k[:5] not in ("rvec_", "tvec_")} == {
                k: v for k, v in rb.items() if k[:5] not in ("rvec_", "tvec_")}
            assert ra["rvec_unit"] == rb["rvec_unit"] == "rad"
            tols = ((LM_F32_TOL, LM_F32_TOL) if name == "corners.json"
                    else (POSE_TOL_M, POSE_TOL_RAD))
            for k, tol in zip(("tvec", "rvec"), tols):
                va = np.array([ra[f"{k}_{c}"] for c in "xyz"])
                vb = np.array([rb[f"{k}_{c}"] for c in "xyz"])
                np.testing.assert_allclose(vb, va, atol=tol, rtol=0, err_msg=f"{name} {k}")


# ---------------------------------------------------------------- ik, probe, entry point


def test_fk_jacobian_matches_reference():
    angles = np.full(7, 0.2, np.float32)
    want = np.asarray(jax_ik.fk_jacobian(JAX_FR3, jnp.asarray(angles)))
    got = ik.fk_jacobian(get_robot("fr3"), torch.from_numpy(angles)).numpy()
    assert got.shape == (8, 3, 7) and np.isfinite(got).all()
    np.testing.assert_allclose(got[0], 0.0, atol=1e-7)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("robot", ["fr3", "meca500"])
def test_solve_ik_matches_reference(robot):
    """tests/test_ik.py's cases: FR3 from the truth plus N(0, 0.15) rad,
    Meca500 (degrees) from the truth plus 5 degrees, 40 iterations; both
    solvers reach an RMSE below 1e-4 m and skeletons within IK_FK_TOL_M."""
    rng = np.random.default_rng(42)
    if robot == "fr3":
        gt = rng.uniform(-1.0, 1.0, size=7).astype(np.float32)
        init = gt + rng.normal(size=7).astype(np.float32) * 0.15
        jspec = JAX_FR3
    else:
        gt = rng.uniform(-40, 40, size=6).astype(np.float32)
        init = gt + 5.0
        jspec = JAX_MECA500
    spec = get_robot(robot)
    targets = forward_kinematics(spec, torch.from_numpy(gt))
    angles, rmse = ik.solve_ik(spec, targets, torch.from_numpy(init), iters=40)
    j_angles, j_rmse = jax_ik.solve_ik(jspec, jax_fk(jspec, jnp.asarray(gt)), jnp.asarray(init),
                                       iters=40)
    assert float(rmse) < 1e-4 and float(j_rmse) < 1e-4
    pts = forward_kinematics(spec, angles).numpy()
    np.testing.assert_allclose(pts, targets.numpy(), atol=1e-3, rtol=0)
    np.testing.assert_allclose(pts, np.asarray(jax_fk(jspec, j_angles)), atol=IK_FK_TOL_M, rtol=0)
    # Half the keypoints weighted out: the RMSE counts the fitted ones only.
    w = np.r_[np.ones(4), np.zeros(len(pts) - 4)].astype(np.float32)
    _, rmse_w = ik.solve_ik(spec, targets, torch.from_numpy(init), torch.from_numpy(w), iters=40)
    _, j_rmse_w = jax_ik.solve_ik(jspec, jax_fk(jspec, jnp.asarray(gt)), jnp.asarray(init),
                                  jnp.asarray(w), iters=40)
    assert abs(float(rmse_w) - float(j_rmse_w)) < 1e-5


@pytest.mark.parametrize("lead", [(), (2,)])
def test_pca_rgb_matches_reference(lead):
    """A planted low-rank token field (3 strong directions plus noise):
    each channel within one level of the reference's, or of its inverse
    (255 - v) where the reference's eigensolver gave that component the
    other sign (the port turns each component's largest loading positive)."""
    rng = np.random.default_rng(3)
    gh, gw, D = 6, 8, 32
    basis = rng.normal(size=(3, D)) * np.array([[6.0], [3.0], [1.5]])
    coef = rng.normal(size=(*lead, gh * gw, 3))
    toks = (coef @ basis + 0.05 * rng.normal(size=(*lead, gh * gw, D))).astype(np.float32)
    want = jax_pca_rgb(jnp.asarray(toks), (gh, gw))
    got = pca_rgb(torch.from_numpy(toks), (gh, gw))
    assert got.shape == want.shape == (*lead, gh, gw, 3) and got.dtype == np.uint8
    got, want = got.astype(int), want.astype(int)
    for c in range(3):
        d = min(np.abs(got[..., c] - want[..., c]).max(),
                np.abs(got[..., c] - (255 - want[..., c])).max())
        assert d <= 1, c


def test_python_m_mvropose_torch_runs_the_cli():
    out = subprocess.run([sys.executable, "-m", "mvropose_torch", "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("usage: mvropose_torch")
    for cmd in ("sync", "group", "calibrate", "train", "eval", "visualize", "profile", "serve"):
        assert cmd in out.stdout.split("\n")[0] or f"    {cmd}" in out.stdout, cmd
