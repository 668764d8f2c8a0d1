"""The single-view training slice: the torch port vs the JAX reference on the
CPU, and the trainer script's single-view and geometric modes.

Tolerances as `test_torch_train.py::test_multi_view_train_step_matches_jax`
(one VIT_TINY_TEST step in f32, dropout off on both sides): losses 1e-5
relative; gradients 1e-3 relative plus 1e-4 of each tensor's largest entry
plus 1e-8 of the model's largest; updated parameters in units of the
learning rate, 1e-3 where the gradient is clear of rounding noise and at
most 2 elsewhere; BatchNorm statistics 1e-5. The FK-consistency loss 1e-5
relative and its gradient 1e-4 relative (f32 FK and projection, the same
operations in another order).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvropose_tpu.models.estimator as jax_estimator
import mvropose_tpu.models.heads as jax_heads
from mvropose_tpu.geometry import robots as jrob
from mvropose_tpu.models import EstimatorConfig as JaxEstimatorConfig
from mvropose_tpu.models import SingleViewPoseEstimator as JaxSingleView
from mvropose_tpu.models.vit import VIT_TINY_TEST
from mvropose_tpu.train import TrainConfig as JaxTrainConfig
from mvropose_tpu.train import create_train_state as jax_create_train_state
from mvropose_tpu.train import make_eval_step as jax_make_eval_step
from mvropose_tpu.train import make_single_view_train_step as jax_single_step
from mvropose_tpu.train.losses import fk_consistency_loss as jax_fk_loss

from mvropose_torch.geometry import robots as trob
from mvropose_torch.models import SingleViewPoseEstimator
from mvropose_torch.models.heads import DecoderLayer
from mvropose_torch.train import (
    TrainConfig,
    create_train_state,
    fk_consistency_loss,
    make_eval_step,
    make_single_view_train_step,
)
from mvropose_torch.train.state import param_groups
from mvropose_torch.utils.weights import load_jax_params, plan_jax_params
from test_torch_serve import port_config
from test_torch_train import _trainer
from torch_parity import export_npz, np32, random_variables

ROBOT = "fr5"  # 6 joints, 7 keypoints (the whole FK chain), degrees
LR_KPT, LR_ANG = 1e-2, 5e-3


class _NoDropoutDecoderLayer(jax_heads.DecoderLayer):
    dropout: float = 0.0


@pytest.fixture
def jax_without_dropout(monkeypatch):
    for module in (jax_heads, jax_estimator):
        monkeypatch.setattr(module, "DecoderLayer", _NoDropoutDecoderLayer)


def _batch(rng, fk: bool, weighted: bool) -> dict:
    B, J, A = 3, 7, 6
    b = {"images": rng.normal(size=(B, 64, 64, 3)).astype(np.float32),
         "heatmaps": rng.uniform(0, 1, size=(B, J, 32, 32)).astype(np.float32),
         "angles": rng.uniform(-60, 60, size=(B, A)).astype(np.float32)}
    if weighted:
        b["sample_weight"] = np.array([1.0, 0.0, 1.0], np.float32)
        b["angle_mask"] = np.ones((B, A), np.float32)
        b["angle_mask"][:, -1] = 0.0
    if fk:
        b["rvec"] = rng.normal(scale=0.3, size=(B, 3)).astype(np.float32)
        b["tvec"] = np.tile(np.array([0.0, 0.0, 2.5], np.float32), (B, 1))
        b["K"] = np.tile(np.array([[100.0, 0, 32], [0, 100, 32], [0, 0, 1]], np.float32), (B, 1, 1))
        b["base_rotation"] = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
        b["keypoints_2d"] = rng.uniform(0, 64, size=(B, J, 2)).astype(np.float32)
    return b


def _flat(path, params, batch_stats) -> dict:
    export_npz({"params": params, "batch_stats": batch_stats}, path)
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


# name: (angle head, FK term weight, sample_weight + angle_mask)
STEP_CASES = {"query": ("query", 0.0, False), "geometric_fk_weighted": ("geometric", 0.1, True)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_single_view_train_step_matches_jax(jax_without_dropout, tmp_path, case):
    head, fk_weight, weighted = STEP_CASES[case]
    rng = np.random.default_rng(51)
    batch = _batch(rng, fk_weight > 0, weighted)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    robot = trob.get_robot(ROBOT)
    cfg = JaxEstimatorConfig(vit=VIT_TINY_TEST, num_joints=robot.n_keypoints,
                             num_angles=robot.n_joints, heatmap_size=(32, 32),
                             num_angle_queries=2, freeze_backbone=False, dtype="float32",
                             angle_head=head)
    model = JaxSingleView(cfg)
    shapes = jax.eval_shape(lambda k: model.init(k, jbatch["images"][:1]), jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed=52)
    tcfg = dict(num_epochs=1, steps_per_epoch=10, lr_kpt=LR_KPT, lr_ang=LR_ANG,
                loss_weight_fk=fk_weight, freeze_backbone=False)
    step = jax_single_step(JaxTrainConfig(**tcfg), robot=jrob.get_robot(ROBOT))

    port = SingleViewPoseEstimator(port_config(cfg))
    load_jax_params(port, export_npz(variables, tmp_path / "p.npz"))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    state = jax_create_train_state(model, variables, JaxTrainConfig(**tcfg))
    ev_ref = jax_make_eval_step(JaxTrainConfig(**tcfg), multi_view=False)(state, jbatch)
    state, metrics = step(state, jbatch, jax.random.PRNGKey(0))
    after = _flat(tmp_path / "a.npz", state.params, state.batch_stats)

    for m in port.modules():
        if isinstance(m, DecoderLayer):
            m.dropout = 0.0
    tstate = create_train_state(port, TrainConfig(**tcfg))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    ev = make_eval_step(tstate.cfg, multi_view=False)(tstate, tbatch)  # before the update
    for k in ("loss", "loss_kpt", "loss_ang"):
        np.testing.assert_allclose(float(ev[k]), float(ev_ref[k]), rtol=1e-5, err_msg=k)
    assert ev["pred_heatmaps"].shape == (3, 7, 32, 32)
    got = make_single_view_train_step(tstate.cfg, robot=robot)(
        tstate, tbatch, torch.Generator().manual_seed(0))
    assert all(v.dim() == 0 for v in got.values())
    for k in ("loss", "loss_kpt", "loss_ang", "loss_fk"):
        np.testing.assert_allclose(float(got[k]), float(metrics[k]), rtol=1e-5, err_msg=k)
    assert (float(got["loss_fk"]) > 0) == (fk_weight > 0)

    lr = {n: LR_ANG if n.startswith("angle_head.") else LR_KPT for n in before}
    want = {n: v for n, (_, v) in plan_jax_params(port, after).items()}
    params = dict(port.named_parameters())
    top = max(float(p.grad.abs().max()) for p in params.values() if p.grad is not None)
    for name, p in params.items():
        step_got = (np32(p) - np32(before[name])) / lr[name]
        step_want = (want[name] - np32(before[name])) / lr[name]
        g = np.abs(np32(p.grad)) if p.grad is not None else np.zeros(p.shape, np.float32)
        clear = (g >= 1e-3 * g.max()) & (g >= 1e-6 * top)  # gradients: the next test
        np.testing.assert_allclose(step_got[clear], step_want[clear], atol=1e-3, err_msg=name)
        assert np.abs(step_got - step_want).max() <= 2.001, name
    for name in before:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(np32(port.state_dict()[name]), want[name], atol=1e-5,
                                       err_msg=name)


def test_single_view_gradients_match_jax(jax_without_dropout, tmp_path):
    """The FK term's, the weighted losses' and the geometric head's gradients
    through the whole model, against jax.grad of the reference's loss."""
    from mvropose_tpu.train.step import _huber_per_sample, _weighted_mean

    rng = np.random.default_rng(53)
    batch = _batch(rng, fk=True, weighted=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    robot = trob.get_robot(ROBOT)
    cfg = JaxEstimatorConfig(vit=VIT_TINY_TEST, num_joints=7, num_angles=6,
                             heatmap_size=(32, 32), freeze_backbone=False, dtype="float32",
                             angle_head="geometric")
    model = JaxSingleView(cfg)
    variables = random_variables(jax.eval_shape(lambda k: model.init(k, jb["images"][:1]),
                                                jax.random.PRNGKey(0)), seed=54)
    jrobot = jrob.get_robot(ROBOT)

    def loss_fn(params):  # the reference step's loss, its lines
        (hm, ang), _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   jb["images"], train=True, mutable=["batch_stats"])
        w = jb["sample_weight"]
        kpt = _weighted_mean(jnp.mean((hm - jb["heatmaps"]) ** 2, axis=(1, 2, 3)), w)
        a = _weighted_mean(_huber_per_sample(ang, jb["angles"], 1.0, jb["angle_mask"]), w)
        return kpt * 100.0 + a + 0.1 * _weighted_mean(_fk_per(jrobot, ang, jb), w)

    grads = _flat(tmp_path / "g.npz", jax.jit(jax.grad(loss_fn))(variables["params"]),
                  variables["batch_stats"])
    port = SingleViewPoseEstimator(port_config(cfg))
    load_jax_params(port, export_npz(variables, tmp_path / "p.npz"))
    state = create_train_state(port, TrainConfig(loss_weight_fk=0.1, freeze_backbone=False))
    make_single_view_train_step(state.cfg, robot=robot)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    g_want = {n: v for n, (_, v) in plan_jax_params(port, grads).items()}
    params = dict(port.named_parameters())
    top = max(float(np.abs(g_want[n]).max()) for n in params)
    for name, p in params.items():
        g = g_want[name]
        np.testing.assert_allclose(np32(p.grad), g, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(g).max()) + 1e-8 * top, err_msg=name)
    assert any(n.startswith("angle_head.fc") for n in params)
    assert float(np.abs(g_want["angle_head.fc0.weight"]).max()) > 0


def _fk_per(robot, ang, jb):
    """The reference step's per-sample FK term (`fk_proj` in
    `make_single_view_train_step`)."""
    from mvropose_tpu.geometry.camera import project_points

    proj = jax.vmap(lambda a, b, r, t, k: project_points(jrob.forward_kinematics(robot, a, b),
                                                         r, t, k, None))(
        ang, jb["base_rotation"], jb["rvec"], jb["tvec"], jb["K"])
    return jnp.mean((proj - jb["keypoints_2d"]) ** 2, axis=(1, 2))


@pytest.mark.parametrize("robot_name, per_sample", [("fr5", True), ("fr3", False)])
def test_fk_consistency_loss_and_gradient_match_jax(robot_name, per_sample):
    rng = np.random.default_rng(55)
    robot, jrobot = trob.get_robot(robot_name), jrob.get_robot(robot_name)
    B, J = 4, len(robot.dh_params) + 1
    scale = 60.0 if robot.angle_unit == "deg" else 1.0
    ang = (rng.uniform(-1, 1, size=(B, robot.n_joints)) * scale).astype(np.float32)
    gt = rng.uniform(0, 640, size=(B, J, 2)).astype(np.float32)
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    rv = rng.normal(scale=0.3, size=(B, 3) if per_sample else (3,)).astype(np.float32)
    tv = (np.array([0.0, 0.0, 3.0]) + rng.normal(scale=0.1, size=rv.shape)).astype(np.float32)
    Ks = np.broadcast_to(K, (B, 3, 3)).copy() if per_sample else K
    base = np.asarray(robot.base_rotation(next(iter(robot.view_base_rotations_zyx_deg), None)))
    jargs = [jnp.asarray(a) for a in (gt, rv, tv, Ks)]
    want, want_g = jax.value_and_grad(
        lambda a: jax_fk_loss(jrobot, a, *jargs, jnp.asarray(base)))(jnp.asarray(ang))
    a = torch.from_numpy(ang).requires_grad_(True)
    got = fk_consistency_loss(robot, a, *(torch.from_numpy(np.asarray(x)) for x in
                                          (gt, rv, tv, Ks, base)))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(np32(a.grad), np32(want_g), rtol=1e-4,
                               atol=1e-4 * float(np.abs(np32(want_g)).max()))


def test_fk_loss_trains_after_an_inference_mode_fk():
    """The FK term's gradient after the robot's FK ran under inference mode
    (a serve's pose step in the same process): the cached DH tables are not
    inference tensors, which autograd could not save."""
    from mvropose_torch.geometry.robots import _spec_tables, forward_kinematics

    robot = trob.get_robot(ROBOT)
    _spec_tables.cache_clear()
    with torch.inference_mode():
        forward_kinematics(robot, torch.zeros(1, robot.n_joints))
    ang = torch.zeros(2, robot.n_joints, requires_grad=True)
    fk_consistency_loss(robot, ang, torch.zeros(2, 7, 2), torch.zeros(3),
                        torch.tensor([0.0, 0.0, 2.0]), torch.eye(3)).backward()
    assert ang.grad is not None and bool(torch.isfinite(ang.grad).all())


def test_fk_term_refuses_to_run_without_its_inputs():
    """A requested FK term never silently drops out: without the robot, or
    with a batch that lacks a field, the step raises, as the reference's."""
    cfg = port_config(JaxEstimatorConfig(vit=VIT_TINY_TEST, num_joints=7, num_angles=6,
                                         heatmap_size=(32, 32), dtype="float32"))
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(np.random.default_rng(56), fk=True, weighted=False).items()}
    state = create_train_state(SingleViewPoseEstimator(cfg), TrainConfig(loss_weight_fk=0.5))
    with pytest.raises(ValueError, match="requires robot="):
        make_single_view_train_step(state.cfg)(state, batch)
    del batch["base_rotation"]
    with pytest.raises(ValueError, match="lacks \\['base_rotation'\\]"):
        make_single_view_train_step(state.cfg, robot=trob.get_robot(ROBOT))(state, batch)


def test_geometric_head_trains_at_the_angle_rate():
    """The geometric head's MLP is in the "ang" group (its own learning
    rate), the single-view model's other modules in "kpt"."""
    cfg = port_config(JaxEstimatorConfig(vit=VIT_TINY_TEST, num_joints=7, num_angles=6,
                                         dtype="float32", angle_head="geometric"))
    model = SingleViewPoseEstimator(cfg)
    groups = param_groups(model, freeze_backbone=True)
    ids = {g: {id(p) for p in ps} for g, ps in groups.items()}
    assert {id(p) for p in model.angle_head.parameters()} == ids["ang"]
    assert {id(p) for p in model.backbone.parameters()} == ids["frozen"]
    assert id(model.keypoint_head.heatmap_predictor.weight) in ids["kpt"]


# --- the trainer script ------------------------------------------------------------

TRAINER_CASES = {
    "single_query": ["--mode", "single"],
    "single_geometric": ["--mode", "single", "--angle-head", "geometric"],
    "single_fk": ["--mode", "single", "--fk-loss-weight", "0.1"],
    "multi_geometric3d": ["--mode", "multi", "--angle-head", "geometric3d", "--views", "2"],
}


@pytest.mark.parametrize("case", list(TRAINER_CASES))
def test_trainer_runs_the_single_view_and_geometric_modes(tmp_path, case):
    """A few f32 CPU steps of each mode: the metrics log and final_metrics.json
    with the reference's keys (single-view: no triangulated ADD), finite
    losses, and the pose evaluation's keys."""
    final = _trainer().main([*TRAINER_CASES[case], "--cpu", "--steps", "2", "--batch", "2",
                             "--image-size", "64", "--eval-every", "2", "--eval-batches", "1",
                             "--workdir", str(tmp_path)])
    log = [json.loads(line) for line in
           (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert len(log) == 2 and all(np.isfinite(r["loss"]) for r in log)
    single = case.startswith("single")
    assert ("triangulated_add_m" in final) == (not single)
    assert final["mode"] == ("single" if single else "multi")
    assert final["views"] == (1 if single else 2)
    assert np.isfinite(final["add_m"]) and len(final["angle_mae_per_joint"]) == 6
    assert 0.0 <= final["pose_success_rate"] <= 1.0
    residuals = np.load(tmp_path / "decode_residuals.npy")
    assert residuals.shape == (2 * (1 if single else 2), 7, 2)


@pytest.mark.parametrize("argv, message", [
    (["--mode", "single", "--angle-head", "geometric3d"], "geometric3d is multi-view only"),
    (["--mode", "multi", "--fk-loss-weight", "0.5"], "a term of the single-view step"),
    (["--mode", "single", "--fk-loss-weight", "0.5", "--robot", "dream_panda"],
     "keypoint set is a subset of chain origins"),
])
def test_trainer_refuses_flag_values_that_cannot_train(argv, message, tmp_path):
    with pytest.raises(SystemExit, match=message):
        _trainer().main([*argv, "--cpu", "--workdir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_trainer_grafts_the_dino_checkpoint_frozen(tmp_path):
    """--backbone-ckpt runs/synth_sv_frozen/dino_192x4.npz --freeze-backbone
    (the reference's runs/synth_sv_frozen at toy length): the model has
    LayerScale and the checkpoint's 4 heads of 48; after the steps the
    backbone drifted by exactly 0, in final_metrics.json and in the run's
    best_params.npz (the reference's layout, beside model_config.json);
    --int8-eval scores the same weights with the int8 backbone and attention."""
    from mvropose_torch.cli.main import read_model_config
    from mvropose_torch.models.dino_convert import convert_dino_state_dict, load_torch_checkpoint

    ckpt = Path(__file__).resolve().parents[1] / "runs" / "synth_sv_frozen" / "dino_192x4.npz"
    final = _trainer().main(["--freeze-backbone", "--backbone-ckpt", str(ckpt), "--int8-eval",
                             "--cpu", "--steps", "2", "--batch", "2", "--image-size", "128",
                             "--eval-every", "2", "--eval-batches", "1", "--workdir",
                             str(tmp_path)])
    assert final["frozen_backbone"] and final["frozen_backbone_max_drift"] == 0.0
    assert final["backbone_ckpt"] == str(ckpt) and final["params_m"] == 5.612  # the reference's
    assert set(final["int8_gap"]) >= {"pck5", "angle_mae", "add_m"}
    cfg, size, kind = read_model_config(tmp_path / "best_params.npz")
    assert (kind, size, cfg.vit.num_heads, cfg.vit.layerscale_init) == ("single_view", 128, 4,
                                                                         1e-5)
    model = SingleViewPoseEstimator(cfg)
    load_jax_params(model, tmp_path / "best_params.npz")
    want = convert_dino_state_dict(load_torch_checkpoint(ckpt), 4, 4, 192)
    for name, t in model.backbone.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)
