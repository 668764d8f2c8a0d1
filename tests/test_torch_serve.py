"""The serve slice: the port's serve step vs the reference's, plus the CLI.

The reference's serve step is the body of `infer` in
`mvropose_tpu/cli/main.py::_cmd_serve` (u8/255, bilinear resize, ImageNet
normalize, model, decode); it is a closure there, so `_jax_infer` below
restates it line for line. Tolerances, in f32 on the CPU:
  * heatmaps and angles 1e-3: the whole model's f32 reductions in another
    order (each module alone agrees to 1e-4, see test_torch_heads.py);
  * keypoints exact: the argmax of heatmaps whose top two values are ten
    times further apart than the two packages' heatmaps, which the test checks.
"""

import ast
import dataclasses
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvropose_tpu.cli.main import _write_model_config
from mvropose_tpu.data.dataset import IMAGENET_MEAN, IMAGENET_STD
from mvropose_tpu.decode import decode_keypoints as jax_decode_keypoints
from mvropose_tpu.models import EstimatorConfig as JaxEstimatorConfig
from mvropose_tpu.models import MultiViewPoseEstimator as JaxEstimator
from mvropose_tpu.models.vit import ViTConfig as JaxViTConfig

from mvropose_torch.cli.main import (
    build_parser,
    main,
    preprocess,
    read_model_config,
    serve,
    serve_step,
    write_run_dir,
)
from mvropose_torch.models import EstimatorConfig, MultiViewPoseEstimator, ViTConfig
from mvropose_torch.utils.weights import load_jax_params, plan_jax_params, random_flat
from torch_parity import export_npz, np32, random_variables

PORT_ROOT = Path(__file__).resolve().parents[1] / "mvropose_torch"
MODEL_SIZE = 32
FRAME_HW = (40, 56)  # non-square frames, downscaled to the model size
JAX_CFG = JaxEstimatorConfig(
    vit=JaxViTConfig(image_size=MODEL_SIZE, patch_size=8, hidden_size=64, num_layers=2,
                     num_heads=4, dtype="float32"),
    num_joints=4, num_angles=3, heatmap_size=(32, 32), max_views=4, num_fusion_queries=4,
    dtype="float32",
)


def port_config(cfg) -> EstimatorConfig:
    d = dataclasses.asdict(cfg)
    return EstimatorConfig(vit=ViTConfig(**d.pop("vit")), **d)


def _jax_infer(model, variables, images_u8, mask, views, hw):
    """`infer` of the reference's serve (cli/main.py:1712-1733), multi-view."""
    imgs = images_u8.astype(jnp.float32) / 255.0
    imgs = jax.image.resize(imgs, (views, MODEL_SIZE, MODEL_SIZE, 3), "bilinear")
    imgs = (imgs - jnp.asarray(IMAGENET_MEAN)) / jnp.asarray(IMAGENET_STD)
    view_ids = jnp.arange(views, dtype=jnp.int32)[None]
    hm, ang = model.apply(variables, imgs[None], view_ids, mask[None])
    xy, conf = jax_decode_keypoints(hm[0], image_hw=hw, use_pallas=False)
    return hm, xy, conf, ang


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A random JAX multi-view model exported as a training run would leave
    it: best_params.npz beside model_config.json."""
    model = JaxEstimator(JAX_CFG)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, 3, MODEL_SIZE, MODEL_SIZE, 3)),
                             jnp.zeros((1, 3), jnp.int32), jnp.ones((1, 3), bool)),
        jax.random.PRNGKey(0),
    )
    variables = random_variables(shapes, seed=12)
    workdir = tmp_path_factory.mktemp("run")
    _write_model_config(workdir, JAX_CFG, multi_view=True, model_size=MODEL_SIZE)
    return model, variables, export_npz(variables, workdir / "best_params.npz")


def test_serve_step_matches_jax(checkpoint):
    jax_model, variables, npz = checkpoint
    rng = np.random.default_rng(12)
    frames = rng.integers(0, 256, size=(3, *FRAME_HW, 3), dtype=np.uint8)
    mask = np.array([True, False, True])
    hm_ref, xy_ref, conf_ref, ang_ref = _jax_infer(
        jax_model, variables, jnp.asarray(frames), jnp.asarray(mask), 3, FRAME_HW
    )
    model = MultiViewPoseEstimator(port_config(JAX_CFG)).eval()
    load_jax_params(model, npz)
    tf, tm = torch.from_numpy(frames), torch.from_numpy(mask)
    with torch.no_grad():
        imgs = preprocess(tf, MODEL_SIZE)
        hm, _ = model(imgs[None], torch.arange(3)[None], tm[None])
        xy, conf, ang = serve_step(model, tf, tm, MODEL_SIZE, FRAME_HW)

    hm_ref = np32(hm_ref)
    np.testing.assert_allclose(np32(hm), hm_ref, rtol=1e-3, atol=1e-3)
    top2 = np.sort(hm_ref.reshape(*hm_ref.shape[:3], -1), axis=-1)[..., -2:]
    margin = np.min(top2[..., 1] - top2[..., 0])
    assert margin > 10 * np.abs(np32(hm) - hm_ref).max(), "argmax margin too thin to compare"
    np.testing.assert_allclose(np32(ang), np32(ang_ref), rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(np32(xy), np32(xy_ref))
    np.testing.assert_allclose(np32(conf), np32(conf_ref), atol=1e-3)


def test_preprocess_matches_jax_resize():
    """u8 -> /255 -> antialiased bilinear downscale -> normalize, as jax.image.resize."""
    frames = np.random.default_rng(13).integers(0, 256, size=(2, 72, 128, 3), dtype=np.uint8)
    want = jax.image.resize(jnp.asarray(frames, jnp.float32) / 255.0, (2, 48, 48, 3), "bilinear")
    want = (want - IMAGENET_MEAN) / IMAGENET_STD
    got = preprocess(torch.from_numpy(frames), 48)
    # f32 resampling weights computed two ways: agreement to ~1e-6.
    np.testing.assert_allclose(got.numpy(), np32(want), atol=1e-5)


def test_full_width_structure_matches_jax():
    """The serve default (ViT-B/16 at 512 px, 4 views) has the same leaves
    and shapes in both packages, after the layout map; nothing is computed
    (JAX eval_shape, torch meta device)."""
    vit = JaxViTConfig(image_size=512, patch_size=16, hidden_size=768, num_layers=12,
                       num_heads=12, dtype="bfloat16")
    cfg = JaxEstimatorConfig(vit=vit, num_joints=8, num_angles=7, max_views=4)
    shapes = jax.eval_shape(
        lambda k: JaxEstimator(cfg).init(k, jnp.zeros((1, 4, 512, 512, 3)),
                                         jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), bool)),
        jax.random.PRNGKey(0),
    )
    flat = {}
    for prefix, tree in (("", shapes["params"]), ("batch_stats/", shapes["batch_stats"])):
        for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
            name = prefix + "/".join(str(k.key) for k in path)
            flat[name] = np.broadcast_to(np.float32(0), s.shape)
    model = MultiViewPoseEstimator(port_config(cfg), device="meta")
    plan = plan_jax_params(model, flat)
    assert len(plan) == len(flat)
    n_jax = sum(int(np.prod(a.shape)) for a in flat.values())
    n_torch = sum(t.numel() for t, _ in plan.values())
    assert n_jax == n_torch > 85_000_000


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """No file of the port, `chip_smoke.py` or `scripts/torch_*.py` imports
    jax, flax or anything of the JAX package, not even a numpy-only module:
    the port keeps its own copies."""
    root_dir = PORT_ROOT.parent
    files = sorted([*PORT_ROOT.rglob("*.py"), root_dir / "chip_smoke.py",
                    *(root_dir / "scripts").glob("torch_*.py")])
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "orbax", "mvropose_tpu"), (f, mod)


def test_rig_copy_matches_reference():
    """The port's copy of the rig layer gives the reference's frames and
    stream statistics for the same `SyntheticSource` arguments."""
    from mvropose_tpu import rig as jax_rig
    from mvropose_torch import rig as port_rig

    stats, frames = {}, {}
    for name, rig in (("jax", jax_rig), ("port", port_rig)):
        sources = [rig.SyntheticSource(f"cam{i}", hw=(24, 40), fps=0.0) for i in range(3)]
        pipe = rig.StreamingPipeline(sources, lambda images, mask: (images.copy(), mask.copy()),
                                     frame_hw=(24, 40))
        pipe.start()
        try:
            # A source reports ready just before it publishes its first
            # frame, and a tick dispatches as soon as any source has one:
            # wait for all three, so both packages tick on three cameras.
            deadline = time.perf_counter() + 10.0
            while not all(s.latest() is not None for s in sources):
                assert time.perf_counter() < deadline, (
                    f"{name}: a synthetic source published no frame within 10 s")
                time.sleep(0.01)
            first = None
            while first is None:
                first = pipe.tick()
        finally:
            pipe.stop()
        frames[name] = first
        stats[name] = dataclasses.asdict(pipe.stats)
        # The bases of the procedural frames: seq 0 of every source.
        frames[name + "_base"] = [np.roll(s.latest().image, -(s.latest().seq % 24), axis=0)
                                  for s in sources]
    np.testing.assert_array_equal(frames["port"][1], frames["jax"][1])
    for a, b in zip(frames["port_base"], frames["jax_base"]):
        np.testing.assert_array_equal(a, b)
    timing = ("total_step_time_s", "start_time_s", "end_time_s", "total_fetch_time_s")
    assert set(stats["port"]) == set(stats["jax"])
    assert {k: v for k, v in stats["port"].items() if k not in timing} == {
        k: v for k, v in stats["jax"].items() if k not in timing}


def test_model_config_round_trips(checkpoint):
    _, _, npz = checkpoint
    cfg, model_size, kind = read_model_config(npz)
    assert (model_size, kind) == (MODEL_SIZE, "multi_view")
    # The file does not hold the heads' compute dtype: it reads back as the
    # default, bf16, in both packages.
    want = dataclasses.replace(port_config(JAX_CFG), dtype="bfloat16")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)


def test_write_run_dir_matches_reference(tmp_path):
    """The port's run directory: model_config.json as the reference's
    `_write_model_config` writes it for the same config, and best_params.npz
    that loads back into the weights it was written from."""
    cfg = port_config(JAX_CFG)
    model = MultiViewPoseEstimator(cfg)
    write_run_dir(tmp_path / "port", cfg, MODEL_SIZE, random_flat(model, seed=3))
    _write_model_config(tmp_path / "ref", JAX_CFG, multi_view=True, model_size=MODEL_SIZE)
    assert (json.loads((tmp_path / "port" / "model_config.json").read_text())
            == json.loads((tmp_path / "ref" / "model_config.json").read_text()))
    with np.load(tmp_path / "port" / "best_params.npz") as data:
        flat = {k: data[k] for k in data.files}
    loaded = MultiViewPoseEstimator(cfg)
    load_jax_params(loaded, flat)
    want = model.state_dict()
    assert all(torch.equal(t, want[k]) for k, t in loaded.state_dict().items())


SERVE_TINY = ["serve", "--views", "2", "--fps", "60", "--frame-hw", "32", "48",
              "--model-size", "32", "--hidden-size", "64", "--num-layers", "1",
              "--duration", "1.0", "--device", "cpu"]


@pytest.mark.parametrize("overlap", [True, False])
def test_cli_serve_synthetic(capsys, overlap):
    rc = main(SERVE_TINY + ([] if overlap else ["--no-overlap"]))
    assert rc == 0
    out = capsys.readouterr().out
    assert "random weights from seed 0" in out
    assert "tick/s" in out and "camera-frames/s" in out


def test_cli_serve_with_params(checkpoint, capsys):
    _, _, npz = checkpoint
    argv = ["serve", "--views", "3", "--fps", "60", "--frame-hw", *map(str, FRAME_HW),
            "--duration", "1.0", "--device", "cpu", "--params", npz]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "model architecture restored" in out
    served = int(out.split("served ")[1].split(" ticks")[0])
    assert served >= 1


@pytest.mark.parametrize(
    "extra, item",
    [
        (["--calib-dir", "calib"], "item 7"),
        (["--summary", "aruco_pose_summary.json"], "item 7"),
        (["--angle-head", "geometric"], "item 4"),
    ],
)
def test_cli_serve_rejects_unported(extra, item):
    with pytest.raises(SystemExit, match=f"ROADMAP.md queue 1, {item}"):
        main(SERVE_TINY + extra)


def test_cli_serve_recover_pose_refine_pose(capsys):
    """serve --recover-pose --refine-pose at the tiny size on the CPU: the
    heads take fr3's arity (8 keypoints, 7 angles), and a tick returns the
    reference's `infer` 6-tuple: keypoints, confidences, angles, then
    per-camera rvec, tvec and a boolean success."""
    args = build_parser().parse_args(SERVE_TINY + ["--recover-pose", "--refine-pose"])
    stats, last = serve(args)
    assert stats.ticks >= 1 and len(last) == 6
    xy, conf, ang, rvec, tvec, success = last
    assert xy.shape == (2, 8, 2) and conf.shape == (2, 8) and ang.shape == (1, 7)
    assert rvec.shape == tvec.shape == (2, 3) and success.shape == (2,)
    assert success.dtype == np.bool_
    assert all(np.isfinite(a).all() for a in last[:5])
    assert main(SERVE_TINY + ["--recover-pose", "--pose-robot", "fr5"]) == 0
    assert "tick/s" in capsys.readouterr().out


def test_cli_serve_pose_robot_checks_the_head_arity(checkpoint):
    """A checkpoint whose heads (4 keypoints, 3 angles) do not match
    --pose-robot's exits, as the reference's serve does."""
    _, _, npz = checkpoint
    argv = ["serve", "--views", "3", "--frame-hw", *map(str, FRAME_HW), "--duration", "1.0",
            "--device", "cpu", "--params", npz, "--recover-pose"]
    with pytest.raises(SystemExit, match="--pose-robot fr3 expects 8 keypoints/7 angles but "
                                         "the checkpoint has 4/3"):
        main(argv)


def test_cli_serve_refine_pose_needs_recover_pose():
    with pytest.raises(SystemExit, match="--refine-pose runs only with --recover-pose"):
        main(SERVE_TINY + ["--refine-pose"])


def test_cli_serve_replay_dir_without_cv2_names_the_decoder(tmp_path, monkeypatch):
    """Where cv2 cannot be imported (the GPU machine may lack it), serve
    --replay-dir exits naming the missing decoder and the ROADMAP item of a
    frame reader, before any source is made or started."""
    import mvropose_torch.cli.main as cli

    made = []
    monkeypatch.setattr(cli, "FileReplaySource", lambda *a, **k: made.append(a))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(SystemExit, match="cv2.*ROADMAP.md queue 1, item 7"):
        main(SERVE_TINY + ["--replay-dir", str(tmp_path)])
    assert made == []


def test_cli_serve_replay_dir(tmp_path):
    """serve --replay-dir replays 4 PNG frames (2 per view) and returns a
    result of the expected shapes."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(15)
    for i in range(4):
        cv2.imwrite(str(tmp_path / f"frame{i}.png"),
                    rng.integers(0, 256, size=(32, 48, 3), dtype=np.uint8))
    args = build_parser().parse_args(SERVE_TINY + ["--replay-dir", str(tmp_path)])
    stats, last = serve(args)
    assert stats.ticks >= 1 and last is not None
    xy, conf, ang = last
    assert xy.shape[:1] == conf.shape[:1] == (2,) and xy.shape[-1] == 2 and ang.shape[0] == 1
    assert all(np.isfinite(a).all() for a in last)


def test_cli_serve_int8_attention_needs_int8_backbone():
    with pytest.raises(SystemExit, match="--int8-attention runs only with --int8-backbone"):
        main(SERVE_TINY + ["--int8-attention"])


def test_cli_serve_int8_fused_ln_run_directory(tmp_path, capsys):
    """`serve --int8-backbone --int8-attention` on a run directory whose
    model_config.json (written by the reference) says fused_ln: true."""
    cfg = dataclasses.replace(
        JAX_CFG, vit=dataclasses.replace(JAX_CFG.vit, hidden_size=128, num_heads=2,
                                         num_layers=1, fused_ln=True)
    )
    shapes = jax.eval_shape(
        lambda k: JaxEstimator(cfg).init(k, jnp.zeros((1, 2, MODEL_SIZE, MODEL_SIZE, 3)),
                                         jnp.zeros((1, 2), jnp.int32), jnp.ones((1, 2), bool)),
        jax.random.PRNGKey(0),
    )
    _write_model_config(tmp_path, cfg, multi_view=True, model_size=MODEL_SIZE)
    npz = export_npz(random_variables(shapes, seed=14), tmp_path / "best_params.npz")
    assert read_model_config(npz)[0].vit.fused_ln
    argv = ["serve", "--views", "2", "--fps", "60", "--frame-hw", *map(str, FRAME_HW),
            "--duration", "1.0", "--device", "cpu", "--params", npz,
            "--int8-backbone", "--int8-attention"]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "backbone quantized to int8" in out and "+ int8-prob attention" in out
    assert int(out.split("served ")[1].split(" ticks")[0]) >= 1


def test_cli_serve_rejects_single_view_checkpoint(tmp_path):
    (tmp_path / "model_config.json").write_text(json.dumps({
        "kind": "single_view", "model_size": 32, "vit": dataclasses.asdict(JAX_CFG.vit),
        "num_joints": 4, "num_angles": 3, "heatmap_size": [32, 32], "max_views": 4,
        "num_fusion_queries": 4, "num_angle_queries": 4, "angle_head": "query",
    }))
    with pytest.raises(SystemExit, match="item 4"):
        main(SERVE_TINY + ["--params", str(tmp_path / "best_params.npz")])
