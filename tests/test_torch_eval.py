"""`python -m mvropose_torch.cli eval` against the reference's `cli eval`, on the CPU.

Each case writes a toy f32 checkpoint (the reference's model, numpy-seeded
random weights, `model_config.json` with an f32 ViT) beside its data and
runs the reference's `main(["eval", ...])` once (its estimator config
switched to f32 compute, as the port computes on the CPU) and the port's
`evaluate` on the same arguments, with the reference's `jax.random` draws
passed in (`JaxEvalDraws`: the occlusion rectangles, the RANSAC and the
refinement draws).

A random model's heatmaps are flat (the top two values of a map a few 1e-5
apart, the packages' forwards 4e-7 apart), so its argmax flips between
packages now and then, and no keypoint is confident enough for PnP or the
triangulation. So each single-robot case plants its outputs (`Planted`, the
same arrays in both packages, one set a forward in batch order): logit
peaks of 10 on the batch's GT keypoints plus N(0, 0.5) heatmap px, added to
the model's heatmaps, and the GT angles plus a small error in place of the
model's. The forward itself is held to the reference by
test_torch_cli_train.py; the mixed case runs the raw model.

The reports have the same keys in the same order; PCK, the keypoint error,
angle MAE, ADD, its AUC and the triangulated ADD agree within REL (the
per-joint MAE, which the report rounds to 4 decimals, within one unit of
the 4th); the pose metrics within POSE_DEG / POSE_M.

Cases: FR3 multi-view, the geometric3d head with --occlusion-masks 2 (the
triangulated ADD), Meca500 single-view (its GT keypoints need the
summary's extrinsics, so its rig has them and the report has the
single-view PnP keys), DREAM with --refine-pose (the camera-frame
keypoints: the GT pose by Kabsch alignment, the _gt_angles variant, the
refinement), the int8 backbone and attention (the port's plain int8 path
against the reference's int8, at test_torch_int8.py's 1e-3), the mixed
fr5,fr3 checkpoint, and the reference's exits. The refinement is held on
DREAM, not on the FR3 capture: there its pose is ill-posed (PNP_KEYS) and
its 8 view slots make the refinement cost ~40 s alone and ~440 s in the
parallel suite.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvropose_tpu.models import EstimatorConfig as JaxEstimatorConfig
from mvropose_tpu.models import MultiViewPoseEstimator as JaxMultiView
from mvropose_tpu.models import SingleViewPoseEstimator as JaxSingleView
from mvropose_tpu.models.vit import ViTConfig as JaxViTConfig
from mvropose_torch.cli.eval import evaluate
from mvropose_torch.cli.main import build_parser
from mvropose_torch.data.augment import RectDraws
from mvropose_torch.models import MultiViewPoseEstimator, SingleViewPoseEstimator
from mvropose_torch.pose import PoseDraws
from torch_parity import (
    CAPTURE_HW,
    export_npz,
    fr3_capture,
    jax_refine_draws,
    jax_rig_gumbel,
    load_script,
    random_variables,
)

jax_cli = importlib.import_module("mvropose_tpu.cli.main")  # the package exports main()

REL, ABS = 1e-4, 1e-6  # relative, with an absolute floor for values near 0
INT8_REL = 1e-3  # test_torch_int8.py's tolerance for the int8 path
POSE_DEG, POSE_M = 1e-3, 1e-4
# The card against the CPU: bf16 heads, the SVD kernel against LAPACK.
CARD_REL, CARD_DEG, CARD_M = 1e-3, 0.06, 1e-3
ROOT = Path(__file__).resolve().parents[1]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def jax_rect(key, B: int, scale, ratio) -> RectDraws:
    """`_rect_mask`'s draws from `key`."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    u = jax.random.uniform
    return RectDraws(_t(u(k1, (B,), minval=scale[0], maxval=scale[1])),
                     _t(u(k2, (B,), minval=jnp.log(ratio[0]), maxval=jnp.log(ratio[1]))),
                     _t(u(k3, (B,))), _t(u(k4, (B,))))


class JaxEvalDraws:
    """The reference eval's draws: PRNGKey(7) split once a batch for the
    occlusion probe (`random_masking`'s keys within), PRNGKey(13) and
    PRNGKey(29) split into B keys at every batch for `solve_rig_pnp` and
    `refine_rig_pose_angles`."""

    def __init__(self):
        self.key = jax.random.PRNGKey(7)

    def occlusion(self, n_images: int, num_masks: int):
        self.key, key = jax.random.split(self.key)
        rects, colors = [], []
        for _ in range(num_masks):
            km, kc, key = jax.random.split(key, 3)
            rects.append(jax_rect(km, n_images, (0.1 ** 2, 0.3 ** 2), (0.5, 2.0)))
            colors.append(_t(jax.random.uniform(kc, (n_images, 1, 1, 3))).reshape(n_images, 3))
        return rects, colors

    def pose(self, B: int, V: int, J: int, A: int, refine: bool) -> PoseDraws:
        gumbel = _t(np.stack([jax_rig_gumbel(k, V, 16, J)
                              for k in jax.random.split(jax.random.PRNGKey(13), B)]))
        if not refine:
            return PoseDraws(gumbel)
        starts, regumbel = zip(*(jax_refine_draws(k, V, J, A)
                                 for k in jax.random.split(jax.random.PRNGKey(29), B)))
        return PoseDraws(gumbel, _t(np.stack(starts)), _t(np.stack(regumbel)))


def write_checkpoint(run: Path, kind: str, joints: int, angles: int, max_views: int = 8,
                     angle_head: str = "query", seed: int = 0) -> Path:
    """A toy f32 run directory: the reference's model at hidden 64, one
    layer, 64 px, heatmaps 128 x 128, numpy-seeded weights, model_config.json."""
    vit = JaxViTConfig(image_size=64, patch_size=16, hidden_size=64, num_layers=1,
                       num_heads=1, dtype="float32")
    cfg = JaxEstimatorConfig(vit=vit, num_joints=joints, num_angles=angles,
                             heatmap_size=(128, 128), max_views=max_views,
                             angle_head=angle_head, dtype="float32")
    if kind == "multi_view":
        model, V = JaxMultiView(cfg), 2
        args = (jnp.zeros((1, V, 64, 64, 3)), jnp.arange(V)[None], jnp.ones((1, V), bool))
        kw = {"proj_mats": jnp.zeros((1, V, 3, 4))} if angle_head == "geometric3d" else {}
    else:
        model, args, kw = JaxSingleView(cfg), (jnp.zeros((1, 64, 64, 3)),), {}
    shapes = jax.eval_shape(lambda k: model.init(k, *args, **kw), jax.random.PRNGKey(0))
    run.mkdir(parents=True)
    export_npz(random_variables(shapes, seed), run / "best_params.npz")
    jax_cli._write_model_config(run, cfg, kind == "multi_view", 64)
    return run / "best_params.npz"


def _f32_config(monkeypatch):
    """The reference's eval computes its heads in its EstimatorConfig's
    default bf16; the comparison runs both packages in f32."""
    real = jax_cli._read_model_config

    def f32(path):
        saved = real(path)
        return None if saved is None else (dataclasses.replace(saved[0], dtype="float32"),
                                           *saved[1:])
    monkeypatch.setattr(jax_cli, "_read_model_config", f32)


class Planted:
    """Per forward, in batch order: heatmap logits to add (10 exp(-d^2 /
    2 1.5^2) - 5 around each GT keypoint, moved by N(0, 0.5) heatmap px) and
    the angles to return in place of the model's (GT plus N(0, 0.02) rad,
    or 1 deg for a robot in degrees), made from the port's batches of the
    eval's dataset."""

    def __init__(self, argv: list, seed: int = 0, kp_noise: float = 0.5, ang_err: float = 1.0):
        from mvropose_torch.cli.main import build_single_robot_dataset, load_rig_from_args

        args = build_parser().parse_args(["eval", *argv, "--device", "cpu"])
        rig = load_rig_from_args(args)
        ds, _ = build_single_robot_dataset(args, rig, tuple(args.image_hw))
        H, W = args.image_hw
        hm_h, hm_w = rig.heatmap_size
        rng = np.random.default_rng(seed)
        err = ang_err * (1.0 if rig.robot.angle_unit == "deg" else 0.02)
        self.items = []
        for b in ds.batches(args.batch_size):
            xy = b["keypoints_2d"] * np.array([hm_w / W, hm_h / H], np.float32)
            xy = xy + rng.normal(scale=kp_noise, size=xy.shape)
            d2 = ((np.arange(hm_w)[None, :] - xy[..., 0, None, None]) ** 2
                  + (np.arange(hm_h)[:, None] - xy[..., 1, None, None]) ** 2)
            hm = 10.0 * np.exp(-d2 / (2 * 1.5 ** 2)) - 5.0
            ang = b["angles"] + rng.normal(scale=err, size=b["angles"].shape)
            self.items.append((hm.astype(np.float32), ang.astype(np.float32)))
        self.calls = 0

    def __call__(self, hm, ang, as_array):
        add, angles = self.items[self.calls]
        self.calls += 1
        return hm + as_array(add), as_array(angles)


def run_reference(argv: list, capsys, monkeypatch, planted: Planted | None = None) -> dict:
    _f32_config(monkeypatch)
    if planted is not None:
        real_jit = jax.jit

        def jit(f, *a, **kw):
            """The eval's forward (a lambda of `_cmd_eval`) with `planted`'s
            outputs; every other jit as it is."""
            jitted = real_jit(f, *a, **kw)
            if "_cmd_eval" not in getattr(f, "__qualname__", ""):
                return jitted
            return lambda *args: planted(*jitted(*args), jnp.asarray)
        monkeypatch.setattr(jax, "jit", jit)
    capsys.readouterr()
    assert jax_cli.main(["eval", *argv]) == 0
    monkeypatch.undo()
    if planted is not None:
        assert planted.calls == len(planted.items)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def run_port(argv: list, capsys, monkeypatch, planted: Planted | None = None) -> dict:
    if planted is not None:
        def call(self, *a, **kw):
            return planted(*self.forward(*a, **kw), torch.from_numpy)
        for cls in (MultiViewPoseEstimator, SingleViewPoseEstimator):
            monkeypatch.setattr(cls, "__call__", call)
    args = build_parser().parse_args(["eval", *argv, "--device", "cpu"])
    try:
        report = evaluate(args, JaxEvalDraws())
    finally:
        monkeypatch.undo()
    if planted is not None:
        assert planted.calls == len(planted.items)
    capsys.readouterr()
    return report


def run_both(argv: list, capsys, monkeypatch, plant: bool = True) -> tuple:
    """(port's report, reference's report), each on the same planted outputs."""
    want = run_reference(argv, capsys, monkeypatch, Planted(argv) if plant else None)
    got = run_port(argv, capsys, monkeypatch, Planted(argv) if plant else None)
    return got, want


POSE_KEYS = ("pose_rot_err_deg", "pose_trans_err_m")


# The recovered camera pose of the FR3 capture is ill-posed: its 60 x 80
# frames see the arm over ~30 px at f = 70 px, and FR3's chain origins 1 = 2
# and 5 = 6 coincide, so RANSAC's DLT systems have null spaces of dimension
# > 1 and each LAPACK returns its own vector of them. Even on planted
# keypoints without noise and the exact angles the two packages recover
# poses 16.8 and 24.0 deg off the calibration and disagree on 1 view of 22
# about success. There the pose keys must be present, finite and in range;
# DREAM and Meca500 hold them to POSE_DEG / POSE_M.
PNP_KEYS = ("pose_success_rate", "pose_rot_err", "pose_trans_err", "pnp_add", "refined_angle")


def assert_reports_match(got: dict, want: dict, rel: float = REL, pose: bool = True) -> None:
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        if key == "angle_mae_per_joint":
            np.testing.assert_allclose(g, w, rtol=0, atol=1.0001e-4, err_msg=key)
        elif not pose and key.startswith(PNP_KEYS):
            assert np.isfinite(g) and g >= 0 and (g <= 1 or "err" in key or "_m" in key), key
        elif key.startswith(POSE_KEYS):
            tol = POSE_DEG if "_deg" in key else POSE_M
            assert abs(g - w) <= tol, (key, g, w)
        elif isinstance(w, float):
            assert abs(g - w) <= rel * abs(w) + ABS, (key, g, w)
        else:
            assert g == w, (key, g, w)


# ------------------------------------------------------------------ fixtures


@pytest.fixture(scope="module")
def fr3(tmp_path_factory) -> dict:
    cap = fr3_capture(tmp_path_factory.mktemp("eval_fr3"))
    root = cap["root"]
    cap["mv"] = write_checkpoint(root / "mv", "multi_view", 8, 7, seed=1)  # the exits'
    cap["geo3d"] = write_checkpoint(root / "geo3d", "multi_view", 8, 7, angle_head="geometric3d",
                                    seed=2)
    return cap


def _fr3_argv(cap, params, *extra) -> list:
    return ["--robot", "fr3", "--csv", str(cap["csv"]), "--calib-dir", str(cap["calib_dir"]),
            "--aruco-summary", str(cap["summary"]), "--params", str(params), "--image-hw",
            *map(str, CAPTURE_HW), "--tolerance", "0.05", "--batch-size", "6", *extra]


@pytest.fixture(scope="module")
def meca500(tmp_path_factory) -> dict:
    import cv2

    root = tmp_path_factory.mktemp("eval_meca500")
    rng = np.random.default_rng(2)
    img, ang = root / "image", root / "angle"
    img.mkdir()
    ang.mkdir()
    for i in range(6):
        small = rng.integers(0, 256, (8, 10, 3)).astype(np.uint8)
        cv2.imwrite(str(img / f"image{i}.jpg"), cv2.resize(small, CAPTURE_HW[::-1]))
        (ang / f"angle{i}.json").write_text(json.dumps([float(v) for v in rng.uniform(-40, 40, 6)]))
    csv = root / "meca500.csv"
    assert jax_cli.main(["sync", "meca500", "--base-dirs", str(img), "--joint-dir", str(ang),
                         "--out", str(csv)]) == 0
    conf = root / "SN.conf"
    conf.write_text("[LEFT_CAM_FHD]\ncx = 40.0\ncy = 30.0\nfx = 70.0\nfy = 70.0\nk1 = 0.0\n"
                    "k2 = 0.0\nk3 = 0.0\np1 = 0.0\np2 = 0.0\n\n[RIGHT_CAM_FHD]\ncx = 40.0\n"
                    "cy = 30.0\nfx = 70.0\nfy = 70.0\nk1 = 0.0\nk2 = 0.0\nk3 = 0.0\np1 = 0.0\n"
                    "p2 = 0.0\n")
    jax_cli.main(["calibrate", "intrinsics", "--conf", str(conf), "--serial", "41182735",
                  "--view", "front", "--resolution", "FHD", "--out-dir", str(root / "calib")])
    jax_cli.main(["calibrate", "manual", "--view", "front", "--cam", "leftcam", "--tvec", "0",
                  "-0.01", "0.75", "--rvec-deg", "96", "98", "-45", "--out",
                  str(root / "summary.json")])
    return {"argv": ["--robot", "meca500", "--single-view", "--csv", str(csv), "--calib-dir",
                     str(root / "calib"), "--aruco-summary", str(root / "summary.json"),
                     "--params", str(write_checkpoint(root / "run", "single_view", 7, 6, seed=3)),
                     "--image-hw", *map(str, CAPTURE_HW), "--batch-size", "4"]}


@pytest.fixture(scope="module")
def dream(tmp_path_factory) -> dict:
    """7 DREAM-schema frames of the port's generator at 64 x 64, synced by
    the reference's `cli sync dream`."""
    root = tmp_path_factory.mktemp("eval_dream")
    assert load_script("torch_make_dream_synthetic").main(
        ["--out-dir", str(root), "--n-samples", "7", "--image-hw", "64", "64",
         "--focal-scale", "0.96", "--device", "cpu"]) == 0
    base = root / "panda_synth"
    csv = root / "dream.csv"
    assert jax_cli.main(["sync", "dream", "--base-dirs", str(base), "--out", str(csv)]) == 0
    params = write_checkpoint(root / "run", "single_view", 7, 7, seed=4)
    return {"argv": ["--robot", "dream", "--single-view", "--csv", str(csv), "--dream-dirs",
                     str(base), "--params", str(params), "--image-hw", "64", "64",
                     "--batch-size", "4"]}


@pytest.fixture(scope="module")
def mixed(tmp_path_factory) -> dict:
    """fr5 + fr3 sets of the port's generator (8 samples each, 64 x 64) and a
    single-view checkpoint as wide as fr3 (8 keypoints, 7 angles)."""
    root = tmp_path_factory.mktemp("eval_mixed")
    assert load_script("torch_make_mixed_synthetic").main(
        ["--out-dir", str(root), "--robots", "fr5", "fr3", "--n-samples", "8", "--image-hw",
         "64", "64", "--device", "cpu"]) == 0
    base = ["--robot", "fr5,fr3", "--csv", str(root / "fr5.csv"), str(root / "fr3.csv"),
            "--calib-dir", str(root / "calib"), "--aruco-summary",
            str(root / "fr5_aruco_pose_summary.json"),
            str(root / "pose1_aruco_pose_summary.json"), "--image-hw", "64", "64",
            "--batch-size", "6"]
    return {"root": root, "base": base,
            "params": write_checkpoint(root / "run", "single_view", 8, 7, seed=5)}


# --------------------------------------------------------------------- cases


def test_fr3_multi_view_matches_reference(fr3, capsys, monkeypatch):
    """The geometric3d head with the rig's projection matrices and the
    occlusion probe over the (B V) images; one batch of the capture's 6
    groups."""
    got, want = run_both(_fr3_argv(fr3, fr3["geo3d"], "--occlusion-masks", "2"), capsys,
                         monkeypatch)
    assert_reports_match(got, want, pose=False)
    assert "triangulated_add_m" in got and "pose_success_rate" in got
    assert got["occlusion_masks"] == 2


def test_meca500_single_view_matches_reference(meca500, capsys, monkeypatch):
    got, want = run_both(meca500["argv"], capsys, monkeypatch)
    assert_reports_match(got, want)
    assert "triangulated_add_m" not in got and "pnp_add_pass@10cm" not in got


@pytest.mark.parametrize("case", ["refine", "int8"])
def test_dream_matches_reference(dream, case, capsys, monkeypatch):
    """Float with --refine-pose (the joint refinement's pose and ADD keys,
    held to POSE_DEG / POSE_M here, where PnP is well-posed), and the int8
    backbone and attention."""
    extra = (["--int8-backbone", "--int8-attention"] if case == "int8"
             else ["--refine-pose"])
    got, want = run_both([*dream["argv"], *extra], capsys, monkeypatch)
    assert_reports_match(got, want, INT8_REL if case == "int8" else REL)
    assert "pnp_add_auc@10cm_gt_angles" in got and got["samples"] == 7
    assert ("pnp_add_auc@10cm_refined" in got) == (case == "refine")


def test_mixed_matches_reference(mixed, capsys, monkeypatch):
    got, want = run_both([*mixed["base"], "--params", str(mixed["params"])], capsys,
                         monkeypatch, plant=False)
    assert list(got) == list(want) == ["robots", "samples", "fr5", "fr3"]
    assert got["robots"] == want["robots"] and got["samples"] == want["samples"] == 16
    for robot in ("fr5", "fr3"):
        assert list(got[robot]) == list(want[robot])
        for key, w in want[robot].items():
            g = got[robot][key]
            if isinstance(w, float):
                assert abs(g - w) <= REL * abs(w) + ABS, (robot, key, g, w)
            else:
                assert g == w, (robot, key)


def _exit_message(fn) -> str:
    with pytest.raises(SystemExit) as e:
        fn()
    return str(e.value)


def test_exits_match_reference(fr3, dream, mixed, tmp_path, monkeypatch, capsys):
    """The kind mismatch, a run where no image loads (n == 0), and the mixed
    eval's three exits, with the reference's messages."""
    _f32_config(monkeypatch)
    no_config = tmp_path / "bare"
    no_config.mkdir()
    (no_config / "best_params.npz").write_bytes(Path(mixed["params"]).read_bytes())
    multi = write_checkpoint(tmp_path / "multi", "multi_view", 8, 7)
    narrow = write_checkpoint(tmp_path / "narrow", "single_view", 7, 6)
    cases = [
        _fr3_argv(fr3, fr3["mv"], "--single-view"),
        dream["argv"][:-5] + ["--image-hw", "48", "64", "--batch-size", "4"],
        [*mixed["base"], "--params", str(no_config / "best_params.npz")],
        [*mixed["base"], "--params", str(multi)],
        [*mixed["base"], "--params", str(narrow)],
        [*mixed["base"][:4], "--params", str(mixed["params"])],  # one --csv for two robots
    ]
    for argv in cases:
        want = _exit_message(lambda: jax_cli.main(["eval", *argv]))
        got = _exit_message(lambda: evaluate(build_parser().parse_args(
            ["eval", *argv, "--device", "cpu"])))
        assert got == want, argv
    capsys.readouterr()


def test_eval_without_a_card_names_it(fr3):
    args = build_parser().parse_args(["eval", *_fr3_argv(fr3, fr3["mv"])])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert "no CUDA device" in _exit_message(lambda: evaluate(args))


def test_int8_attention_alone_exits(fr3):
    args = build_parser().parse_args(["eval", *_fr3_argv(fr3, fr3["mv"], "--int8-attention"),
                                      "--device", "cpu"])
    assert "--int8-backbone" in _exit_message(lambda: evaluate(args))


def test_namespace_defaults_match_reference():
    """The eval parser's flags and defaults are the reference's, plus --device."""
    def flags(parser_args):
        ns = vars(parser_args)
        ns.pop("fn")
        return ns
    argv = ["eval", "--robot", "fr3", "--csv", "a.csv", "--params", "p.npz"]
    want = flags(jax_cli.build_parser().parse_args(argv))
    got = flags(build_parser().parse_args(argv))
    want.pop("backend")
    assert got.pop("device") == "cuda"
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_eval_on_card_matches_cpu(tmp_path, monkeypatch, int8):
    """`cli eval` of a DREAM run (the port's generator, sync and weights; no
    JAX) on the card, the render, peak decode, SVD and int8 kernels, against
    the same eval on the CPU's plain routes, both on the same planted
    outputs: the same keys, PCK and the angle metrics equal within REL, the
    keypoint error within CARD_REL (the card's heads compute in bf16), the
    camera poses within CARD_DEG / CARD_M (the SVD kernel against LAPACK),
    a pass rate or AUC within two frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mvropose_torch.cli.main import main as port_main
    from mvropose_torch.cli.main import write_run_dir
    from mvropose_torch.models import EstimatorConfig, ViTConfig
    from mvropose_torch.utils.weights import random_flat

    assert load_script("torch_make_dream_synthetic").main(
        ["--out-dir", str(tmp_path), "--n-samples", "10", "--image-hw", "64", "64",
         "--focal-scale", "0.96", "--device", "cpu"]) == 0
    base = tmp_path / "panda_synth"
    assert port_main(["sync", "dream", "--base-dirs", str(base), "--out",
                      str(tmp_path / "d.csv")]) == 0
    cfg = EstimatorConfig(vit=ViTConfig(image_size=64, patch_size=16, hidden_size=64,
                                        num_layers=1, num_heads=1, dtype="float32"),
                          num_joints=7, num_angles=7, max_views=2)
    write_run_dir(tmp_path / "run", cfg, 64,
                  random_flat(SingleViewPoseEstimator(cfg), seed=6), kind="single_view")
    argv = ["--robot", "dream", "--single-view", "--csv", str(tmp_path / "d.csv"),
            "--dream-dirs", str(base), "--params", str(tmp_path / "run" / "best_params.npz"),
            "--image-hw", "64", "64", "--batch-size", "4", "--refine-pose",
            *(["--int8-backbone", "--int8-attention"] if int8 else [])]
    reports = {}
    for device in ("cpu", "cuda"):
        planted = Planted(argv)
        put = (lambda a: torch.from_numpy(a).to(device))  # noqa: E731

        def call(self, *a, **kw):
            return planted(*self.forward(*a, **kw), put)
        monkeypatch.setattr(SingleViewPoseEstimator, "__call__", call)
        reports[device] = evaluate(build_parser().parse_args(
            ["eval", *argv, "--device", device]))
        monkeypatch.undo()
    got, want = reports["cuda"], reports["cpu"]
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        if key == "angle_mae_per_joint":
            np.testing.assert_allclose(g, w, rtol=0, atol=1.0001e-4)
        elif "pass" in key or "auc" in key or "success" in key:
            assert abs(g - w) <= 2.0 / want["samples"] + ABS, (key, g, w)
        elif key.startswith(POSE_KEYS):
            assert abs(g - w) <= (CARD_DEG if "_deg" in key else CARD_M), (key, g, w)
        elif key.startswith(("kp_px", "pnp_add_m")):
            assert abs(g - w) <= CARD_REL * abs(w) + ABS, (key, g, w)
        elif isinstance(w, float):
            assert abs(g - w) <= REL * abs(w) + ABS, (key, g, w)
        else:
            assert g == w, key
