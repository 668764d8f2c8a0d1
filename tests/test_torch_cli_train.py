"""`python -m mvropose_torch.cli train` on captured images, on the CPU.

The FR3 capture (2 serials x left/right, 60 x 80 frames, made by the
reference's own `cli sync` / `calibrate`) trains the multi-view estimator
and, with `--single-view`, the single-view one at toy size (hidden 64, one
layer). Each run writes logs/metrics.jsonl with a finite val_loss,
best_params.npz and model_config.json; the reference's `load_params_npz`
reads that file and its forward agrees with the port's within 1e-4 (f32).
Two epochs and one epoch plus one resumed give bit-equal states. The
flags that are not ported exit naming their ROADMAP item, as do the
reference's own refusals; `serve --params` reads the trained run.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvropose_tpu.geometry.heatmap import argmax_decode as jax_argmax_decode
from mvropose_tpu.models import EstimatorConfig as JaxEstimatorConfig
from mvropose_tpu.models import MultiViewPoseEstimator as JaxMultiView
from mvropose_tpu.models import SingleViewPoseEstimator as JaxSingleView
from mvropose_tpu.models.vit import ViTConfig as JaxViTConfig
from mvropose_tpu.train.checkpoint import load_batch_stats_npz
from mvropose_tpu.train.checkpoint import load_params_npz as jax_load_params_npz
from mvropose_tpu.train.metrics import pck_at_k as jax_pck_at_k
from mvropose_torch.cli.main import main, read_model_config
from mvropose_torch.models import MultiViewPoseEstimator, SingleViewPoseEstimator
from mvropose_torch.train.checkpoint import CheckpointManager, CheckpointMeta, load_params_npz
from mvropose_torch.train.loop import epoch_generator, val_pck5
from torch_parity import fr3_capture

FORWARD_TOL = 1e-4


@pytest.fixture(scope="module")
def cap(tmp_path_factory):
    return fr3_capture(tmp_path_factory.mktemp("train_fr3"))


def train_argv(cap, workdir, *extra) -> list:
    return ["train", "--robot", "fr3", "--csv", str(cap["csv"]), "--calib-dir",
            str(cap["calib_dir"]), "--aruco-summary", str(cap["summary"]), "--workdir",
            str(workdir), "--image-hw", "60", "80", "--model-size", "64", "--hidden-size", "64",
            "--num-layers", "1", "--batch-size", "2", "--epochs", "1", "--val-split", "0.34",
            "--tolerance", "0.05", "--device", "cpu", *extra]


def _records(workdir) -> list:
    return [json.loads(line)
            for line in (Path(workdir) / "logs" / "metrics.jsonl").read_text().splitlines()]


def _jax_forward(run: Path, images, view_ids=None, view_mask=None):
    """The reference's model from the run's model_config.json in f32, its
    weights read by the reference's own loaders, applied in eval mode."""
    d = json.loads((run / "model_config.json").read_text())
    cfg = JaxEstimatorConfig(
        vit=JaxViTConfig(**{**d["vit"], "dtype": "float32"}), num_joints=d["num_joints"],
        num_angles=d["num_angles"], heatmap_size=tuple(d["heatmap_size"]),
        max_views=d["max_views"], num_fusion_queries=d["num_fusion_queries"],
        num_angle_queries=d["num_angle_queries"], angle_head=d["angle_head"], dtype="float32")
    if d["kind"] == "multi_view":
        model, args = JaxMultiView(cfg), (images, view_ids, view_mask)
    else:
        model, args = JaxSingleView(cfg), (images,)
    shapes = jax.eval_shape(lambda k: model.init(k, *args), jax.random.PRNGKey(0))
    params = jax_load_params_npz(run / "best_params.npz", shapes["params"])
    stats, n_loaded, n_total = load_batch_stats_npz(run / "best_params.npz",
                                                    shapes["batch_stats"])
    assert n_loaded == n_total > 0
    return model.apply({"params": params, "batch_stats": stats}, *args, train=False)


def _port_model(run: Path):
    cfg, size, kind = read_model_config(run / "best_params.npz")
    cls = MultiViewPoseEstimator if kind == "multi_view" else SingleViewPoseEstimator
    cfg = dataclasses.replace(cfg, dtype="float32",
                              vit=dataclasses.replace(cfg.vit, dtype="float32"))
    return load_params_npz(run / "best_params.npz", cls(cfg).eval()), size, kind


@pytest.mark.parametrize("mode", ["multi_view", "single_view"])
def test_cli_train_runs_and_the_reference_reads_its_checkpoint(cap, tmp_path, mode):
    run = tmp_path / "run"
    extra = ["--viz-every", "1"] + (["--single-view"] if mode == "single_view" else [])
    assert main(train_argv(cap, run, *extra)) == 0
    recs = _records(run)
    assert len(recs) == 1 and recs[0]["epoch"] == 1
    assert np.isfinite(recs[0]["val_loss"]) and 0.0 <= recs[0]["val_pck5"] <= 1.0
    # int(0.66 * (6 groups | 24 images)) train samples in batches of 2, the
    # last one padded: ceil(len / 2) steps.
    assert recs[0]["step"] == {"multi_view": 2, "single_view": 8}[mode]
    assert (run / "logs" / "images" / f"val_predictions_step{recs[0]['step']}.png").exists()
    assert sorted(p.name for p in (run / "ckpt").glob("*.pt")) == [f"{recs[0]['step']}.pt"]

    model, size, kind = _port_model(run)
    assert (kind, size) == (mode, 64)
    rng = np.random.default_rng(0)
    if kind == "multi_view":
        imgs = rng.normal(size=(2, 3, 64, 64, 3)).astype(np.float32)
        ids = np.array([[0, 1, 3], [2, 0, 1]], np.int32)
        mask = np.array([[True, True, True], [True, False, True]])
        want = _jax_forward(run, jnp.asarray(imgs), jnp.asarray(ids), jnp.asarray(mask))
        with torch.no_grad():
            got = model(torch.from_numpy(imgs), torch.from_numpy(ids).long(),
                        torch.from_numpy(mask))
    else:
        imgs = rng.normal(size=(3, 64, 64, 3)).astype(np.float32)
        want = _jax_forward(run, jnp.asarray(imgs))
        with torch.no_grad():
            got = model(torch.from_numpy(imgs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FORWARD_TOL, rtol=0)


class Interrupted(Exception):
    pass


@pytest.mark.parametrize("augment", [False, True])
def test_resumed_run_is_bit_equal_to_an_uninterrupted_one(cap, tmp_path, monkeypatch, augment):
    """A 2-epoch run against the same run interrupted after its first epoch
    and run again: the second call resumes at epoch 2 and ends with
    bit-equal parameters, BatchNorm statistics, optimizer moments, records
    and best_params.npz."""
    import mvropose_torch.cli.main as cli

    argv = lambda run: train_argv(cap, run, "--epochs", "2",  # noqa: E731
                                  *([] if augment else ["--no-augment"]))
    whole, halves = tmp_path / "whole", tmp_path / "halves"
    assert main(argv(whole)) == 0
    fit = cli.fit

    def fit_stopped_after_one_epoch(*args, on_epoch_end, **kw):
        def stop(*a):
            on_epoch_end(*a)
            raise Interrupted
        return fit(*args, on_epoch_end=stop, **kw)

    monkeypatch.setattr(cli, "fit", fit_stopped_after_one_epoch)
    with pytest.raises(Interrupted):
        main(argv(halves))
    monkeypatch.setattr(cli, "fit", fit)
    assert [r["epoch"] for r in _records(halves)] == [1]
    assert main(argv(halves)) == 0
    recs = _records(halves)
    assert [r["epoch"] for r in recs] == [1, 2] and [r["step"] for r in recs] == [2, 4]
    for a, b in zip(_records(whole), recs, strict=True):
        assert {k: v for k, v in a.items() if "time" not in k} == {
            k: v for k, v in b.items() if "time" not in k}
    ckpts = [torch.load(run / "ckpt" / "4.pt", weights_only=True) for run in (whole, halves)]
    assert ckpts[0]["step"] == ckpts[1]["step"] == 4
    assert ckpts[0]["meta"] == ckpts[1]["meta"]
    for k, v in ckpts[0]["model"].items():
        assert torch.equal(v, ckpts[1]["model"][k]), k
    states = [c["optimizer"]["state"] for c in ckpts]
    assert len(states[0]) == len(states[1]) > 0
    for i, a in states[0].items():
        assert all(torch.equal(a[k], states[1][i][k]) for k in a), i
    with np.load(whole / "best_params.npz") as a, np.load(halves / "best_params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    # A third call has nothing left to train.
    assert main(argv(halves)) == 0
    assert len(_records(halves)) == 2


def test_geometric3d_multi_view_trains_and_single_view_geometric3d_exits(cap, tmp_path):
    run = tmp_path / "geo3d"
    assert main(train_argv(cap, run, "--angle-head", "geometric3d", "--no-augment")) == 0
    assert np.isfinite(_records(run)[0]["val_loss"])
    assert json.loads((run / "model_config.json").read_text())["angle_head"] == "geometric3d"
    with pytest.raises(SystemExit, match="geometric3d.*multi-view only"):
        main(train_argv(cap, tmp_path / "sv3d", "--angle-head", "geometric3d", "--single-view"))


def test_fk_loss_weight_trains_single_view_and_refuses_what_the_reference_refuses(cap, tmp_path):
    run = tmp_path / "fk"
    assert main(train_argv(cap, run, "--single-view", "--fk-loss-weight", "0.1",
                           "--no-augment")) == 0
    assert np.isfinite(_records(run)[0]["val_loss"])
    with pytest.raises(SystemExit, match="term of the single-view step"):
        main(train_argv(cap, tmp_path / "mv", "--fk-loss-weight", "0.1"))
    argv = train_argv(cap, tmp_path / "noextr", "--single-view", "--fk-loss-weight", "0.1")
    argv[argv.index("--aruco-summary"):argv.index("--aruco-summary") + 2] = []
    with pytest.raises(SystemExit, match="needs calibrated extrinsics"):
        main(argv)


# flag values that are not ported yet: (extra argv, the message's ROADMAP item);
# mixed robots and --backbone-ckpt run since they were ported: a mixed run with
# one --csv for two robots, and a DINO checkpoint whose grid the model size
# does not fit, exit as the reference's do.
DINO_192X4 = Path(__file__).resolve().parents[1] / "runs" / "synth_sv_frozen" / "dino_192x4.npz"
UNPORTED = {
    "mixed_robots": (["--robot", "fr3,fr5"], "fr3,fr5 needs exactly 2 --csv files"),
    "num_workers": (["--num-workers", "2"], "grain loader.*queue 1, item 12"),
    "backbone_ckpt": (["--backbone-ckpt", str(DINO_192X4), "--hidden-size", "192"],
                      r"backbone checkpoint shape mismatch at \['pos_embed'\]"),
    "mesh": (["--mesh", "2", "1"], "--mesh.*queue 1, item 10"),
    "wandb": (["--wandb"], "--wandb.*queue 1, item 12"),
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_cli_train_refuses_unported_flags(cap, tmp_path, name):
    extra, message = UNPORTED[name]
    with pytest.raises(SystemExit, match=message):
        main(train_argv(cap, tmp_path / "run", *extra))  # the last --robot wins
    assert not (tmp_path / "run").exists()


def test_cli_train_grafts_a_dino_checkpoint(cap, tmp_path):
    """--backbone-ckpt: a seeded timm checkpoint of the run's ViT (hidden 64,
    one layer, LayerScale, the model size's 4 x 4 grid) grafted before
    training; the backbone is frozen (the default), so the run's weights
    hold the checkpoint's exactly (a drift of 0)."""
    from mvropose_tpu.models.vit import ViTConfig as JaxVit
    from mvropose_torch.models.dino_convert import convert_dino_state_dict
    from mvropose_torch.utils.weights import load_jax_params
    from test_dino_convert import make_timm_state_dict

    sd = make_timm_state_dict(np.random.default_rng(5), JaxVit(
        image_size=64, patch_size=16, hidden_size=64, num_layers=1, num_register_tokens=0))
    del sd["reg_token"]
    ckpt = tmp_path / "dino.pth"
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}, ckpt)
    run = tmp_path / "run"
    assert main(train_argv(cap, run, "--backbone-ckpt", str(ckpt))) == 0
    cfg, _, kind = read_model_config(run / "best_params.npz")
    model = MultiViewPoseEstimator(cfg)
    load_jax_params(model, run / "best_params.npz")
    want = convert_dino_state_dict(sd, 1, 1, 64)
    got = model.backbone.state_dict()
    assert got.keys() == want.keys()
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[name], np.float32), err_msg=name)


def test_cli_train_without_cv2_or_card_names_them(cap, tmp_path, monkeypatch):
    argv = train_argv(cap, tmp_path / "run")
    argv[argv.index("--device") + 1] = "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(argv)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(SystemExit, match="cv2"):
        main(train_argv(cap, tmp_path / "run"))
    assert not (tmp_path / "run").exists()


def test_serve_reads_the_trained_run(cap, tmp_path):
    run = tmp_path / "run"
    assert main(train_argv(cap, run, "--no-augment")) == 0
    assert main(["serve", "--params", str(run / "best_params.npz"), "--views", "2",
                 "--fps", "60", "--frame-hw", "60", "80", "--duration", "1",
                 "--device", "cpu"]) == 0


@pytest.mark.parametrize("case", ["multi_view", "single_view", "padded_channel"])
def test_val_pck5_matches_the_reference_rule(case):
    """PCK@5 over real views / weighted samples and GT maps whose peak is
    above 0.1, as the reference's fit computes it (`train/loop.py:95-113`)."""
    rng = np.random.default_rng(3)
    shape = (3, 4, 5, 16, 16) if case != "single_view" else (3, 5, 16, 16)
    gt = rng.uniform(0, 1, shape).astype(np.float32)
    gt[..., -1, :, :] = 0.0 if case == "padded_channel" else gt[..., -1, :, :]
    gt[..., 0, :, :] *= 0.05  # peak below 0.1: not scored
    pred = gt + rng.normal(0, 0.3, shape).astype(np.float32)
    batch = {"heatmaps": gt}
    if case == "single_view":
        batch["sample_weight"] = np.array([1.0, 0.0, 1.0], np.float32)
        valid = batch["sample_weight"][:, None] > 0
    else:
        batch["view_mask"] = rng.uniform(size=shape[:2]) > 0.3
        valid = batch["view_mask"][..., None]
    pred_xy, _ = jax_argmax_decode(jnp.asarray(pred))
    gt_xy, _ = jax_argmax_decode(jnp.asarray(gt))
    gt_peak = gt.max(axis=(-2, -1)) > 0.1
    valid = np.broadcast_to(valid, gt_peak.shape) & gt_peak
    want = float(jax_pck_at_k(pred_xy, gt_xy, k_px=5.0, valid=valid))
    got = val_pck5({"pred_heatmaps": torch.from_numpy(pred)},
                   {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    assert abs(float(got) - want) < 1e-6 and 0.0 < want < 1.0


def test_checkpoint_manager_keeps_restores_and_reports(tmp_path):
    from mvropose_torch.train.state import TrainConfig, create_train_state

    model = torch.nn.Module()
    model.keypoint_head = torch.nn.Linear(3, 2)
    model.angle_head = torch.nn.Linear(3, 1)
    state = create_train_state(model, TrainConfig(steps_per_epoch=1))
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    assert mgr.restore(state) is None
    for step in (1, 2, 3):
        model.keypoint_head(torch.ones(1, 3)).sum().backward()
        state.apply_gradients()
        mgr.save(step, state, CheckpointMeta(epoch=step, best_val_loss=1.0 / step))
    mgr.wait()
    assert mgr.steps() == [2, 3]
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        model.keypoint_head.weight.zero_()
    fresh = create_train_state(model, TrainConfig(steps_per_epoch=1))
    assert mgr.restore(fresh) == CheckpointMeta(epoch=3, best_val_loss=1.0 / 3)
    assert fresh.step == 3 and all(torch.equal(v, model.state_dict()[k])
                                   for k, v in saved.items())
    assert len(fresh.optimizer.state) == len(state.optimizer.state)
    assert mgr.restore(fresh, step=2).epoch == 2
    # A failed write surfaces on the caller's thread, at the next wait.
    mgr.directory = tmp_path / "missing" / "dir"
    mgr.save(4, state, CheckpointMeta())
    with pytest.raises(RuntimeError, match="does not exist"):
        mgr.wait()
    mgr.wait()


def test_epoch_generators_depend_on_seed_epoch_and_stream_only():
    draw = lambda *a: torch.rand(4, generator=epoch_generator(*a, "cpu"))  # noqa: E731
    assert torch.equal(draw(0, 3), draw(0, 3))
    assert not torch.equal(draw(0, 3), draw(0, 4))
    assert not torch.equal(draw(0, 3), draw(1, 3))
    assert not torch.equal(draw(0, 3), torch.rand(4, generator=epoch_generator(0, 3, "cpu", 1)))
