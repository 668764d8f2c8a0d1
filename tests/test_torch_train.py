"""The multi-view training slice: the torch port vs the JAX reference on the CPU.

Tolerances and their reasons:
  * train-mode BatchNorm: 1e-5 on outputs, 1e-6 on running statistics (f32
    reductions in another order);
  * the optimizer over 3 updates: 1e-6 on parameters of magnitude <= 4
    (torch divides sqrt(v) by sqrt(1 - b2^t) where optax divides v by
    1 - b2^t first; a few f32 ulps per update), the learning rates 1e-7
    relative (f64 here, f32 in optax);
  * one train step of VIT_TINY_TEST in f32, dropout off on both sides: loss
    1e-5 relative; gradients 1e-3 relative plus 1e-4 of each tensor's
    largest entry (f32 convolutions, matmuls and reductions in another
    order; measured ~1e-6) plus 1e-8 of the model's largest gradient (the
    attention key biases' gradients are 0 in exact arithmetic, softmax being
    invariant to a per-query constant, and come out as noise of that size);
    updated parameters in units of the learning rate: Adam's first update is
    -lr g / (|g| + eps), of size lr whatever |g|, so it is compared at 1e-3
    lr where |g| is at least 1e-3 of its tensor's largest gradient and 1e-6
    of the model's, and only bounded by 2 lr elsewhere, where a gradient
    within rounding noise of 0 has a sign that is noise; BatchNorm
    statistics 1e-5.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import flax.linen as jnn
from flax.linen.attention import dot_product_attention_weights

import mvropose_tpu.models.estimator as jax_estimator
import mvropose_tpu.models.fusion as jax_fusion
import mvropose_tpu.models.heads as jax_heads
import mvropose_tpu.train.losses as jax_losses
import mvropose_tpu.train.metrics as jax_metrics
from mvropose_tpu.models import EstimatorConfig as JaxEstimatorConfig
from mvropose_tpu.models import MultiViewPoseEstimator as JaxEstimator
from mvropose_tpu.models.vit import VIT_TINY_TEST
from mvropose_tpu.train import TrainConfig as JaxTrainConfig
from mvropose_tpu.train import create_train_state as jax_create_train_state
from mvropose_tpu.train import make_multi_view_train_step as jax_train_step
from mvropose_tpu.train.losses import masked_multiview_heatmap_loss as jax_mv_loss
from mvropose_tpu.train.state import make_optimizer as jax_make_optimizer
from mvropose_tpu.train.step import _huber_per_sample, _weighted_mean

import mvropose_torch.train.losses as torch_losses
import mvropose_torch.train.metrics as torch_metrics
from mvropose_torch.models import MultiViewPoseEstimator
from mvropose_torch.models.heads import DecoderLayer
from mvropose_torch.models.layers import dropout
from mvropose_torch.models.stem import batch_norm
from mvropose_torch.models.vit import attention_dropout_multiplier
from mvropose_torch.train import (
    TrainConfig,
    create_train_state,
    make_eval_step,
    make_multi_view_train_step,
)
from mvropose_torch.train.state import cosine_decay, param_groups
from mvropose_torch.utils.weights import load_jax_params, plan_jax_params
from torch_parity import export_npz, np32, random_variables
from test_torch_serve import port_config

ROOT = Path(__file__).resolve().parents[1]


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


# --- BatchNorm -----------------------------------------------------------------


def test_train_batchnorm_matches_flax():
    """Output and running statistics of one train-mode call, then eval mode
    on the updated statistics. The input has a mean of 3 so that
    E[x^2] - E[x]^2 (flax's fast variance) is exercised."""
    rng = np.random.default_rng(21)
    x = (3.0 + 2.0 * rng.normal(size=(6, 5, 7, 3))).astype(np.float32)  # NHWC
    scale = (1.0 + 0.1 * rng.normal(size=3)).astype(np.float32)
    shift = (0.1 * rng.normal(size=3)).astype(np.float32)
    mean0 = (0.1 * rng.normal(size=3)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, size=3).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": shift},
                 "batch_stats": {"mean": mean0, "var": var0}}
    flax_bn = jnn.BatchNorm(use_running_average=False, dtype=jnp.float32)
    want, mutated = flax_bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = torch.nn.BatchNorm2d(3, eps=1e-5)
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, shift), (bn.running_mean, mean0),
                     (bn.running_var, var0)):
            t.copy_(torch.from_numpy(v))
    got = batch_norm(bn.train(), _nchw(x))
    np.testing.assert_allclose(np32(got.permute(0, 2, 3, 1)), np32(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np32(bn.running_mean), np32(mutated["batch_stats"]["mean"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np32(bn.running_var), np32(mutated["batch_stats"]["var"]),
                               rtol=0, atol=1e-6)
    eval_want = jnn.BatchNorm(use_running_average=True, dtype=jnp.float32).apply(
        {"params": variables["params"], "batch_stats": mutated["batch_stats"]}, jnp.asarray(x))
    eval_got = batch_norm(bn.eval(), _nchw(x))
    np.testing.assert_allclose(np32(eval_got.permute(0, 2, 3, 1)), np32(eval_want), atol=1e-5)


def test_train_batchnorm_moves_running_variance_by_the_biased_variance():
    """Two values 0 and 2: biased batch variance 1, unbiased 2. flax moves
    the running variance by the biased one (0.99 * 1 + 0.01 * 1 = 1);
    torch's own train-mode batch_norm would give 1.01."""
    x = torch.tensor([0.0, 2.0]).reshape(2, 1, 1, 1)
    bn = torch.nn.BatchNorm2d(1).train()
    out = batch_norm(bn, x)
    assert float(bn.running_var) == pytest.approx(1.0, abs=1e-7)
    assert float(bn.running_mean) == pytest.approx(0.01, abs=1e-9)
    torch_var = torch.ones(1)
    torch.nn.functional.batch_norm(x, torch.zeros(1), torch_var, training=True, momentum=0.01)
    assert float(torch_var) == pytest.approx(1.01, abs=1e-7)
    np.testing.assert_allclose(np32(out).flatten(), [-1.0, 1.0], atol=1e-5)


# --- dropout --------------------------------------------------------------------


def test_attention_dropout_is_one_mask_per_call_shared_by_batch_and_heads():
    """flax drops attention weights with broadcast_dropout=True: one (Tq, Tk)
    mask for every batch element and head, kept weights times 1/(1 - rate)
    in the attention dtype. The port's multiplier has that shape, those
    values and that rate."""
    Tq, Tk, rate = 40, 50, 0.1
    rng = np.random.default_rng(22)
    q = jnp.asarray(rng.normal(size=(2, Tq, 3, 8)), jnp.bfloat16)
    k = jnp.asarray(rng.normal(size=(2, Tk, 3, 8)), jnp.bfloat16)
    kept = dot_product_attention_weights(q, k, dropout_rng=jax.random.PRNGKey(0),
                                         dropout_rate=rate, deterministic=False)
    full = dot_product_attention_weights(q, k, deterministic=True)
    dropped = np.asarray(kept == 0)
    assert (dropped == dropped[:1, :1]).all()  # (B, H, Tq, Tk): shared over B and H
    jax_scale = np.unique(np.asarray(kept.astype(jnp.float32) / full.astype(jnp.float32))
                          [~dropped].round(3))
    mult = attention_dropout_multiplier((Tq, Tk), rate, torch.bfloat16, "cpu",
                                        torch.Generator().manual_seed(0))
    assert mult.shape == (Tq, Tk) and mult.dtype == torch.bfloat16
    values = sorted(set(mult.float().flatten().tolist()))
    assert values[0] == 0.0 and len(values) == 2
    assert values[1] == float(torch.tensor(1.0, dtype=torch.bfloat16) /
                              torch.tensor(0.9, dtype=torch.bfloat16))
    np.testing.assert_allclose(jax_scale, values[1], atol=1e-2)  # ratios of bf16 weights
    for frac in (dropped[0, 0].mean(), float((mult == 0).float().mean())):
        assert abs(frac - rate) < 0.03  # 4 standard deviations at 2000 draws


def test_ffn_dropout_is_elementwise_and_only_in_train_mode():
    x = torch.ones(4, 6, 32)
    out = dropout(x, 0.1, torch.Generator().manual_seed(1))
    values = sorted(set(out.flatten().tolist()))
    assert values == [0.0, pytest.approx(1 / 0.9)]
    assert not torch.equal(out[0] == 0, out[1] == 0)  # not shared across the batch
    ref = jnn.Dropout(0.1, deterministic=False).apply({}, jnp.ones((4, 6, 32)),
                                                        rngs={"dropout": jax.random.PRNGKey(1)})
    assert np.unique(np.asarray(ref)).tolist() == [0.0, pytest.approx(1 / 0.9)]
    assert not (np.asarray(ref)[0] == 0).tolist() == (np.asarray(ref)[1] == 0).tolist()

    layer = DecoderLayer(32, 4, torch.float32)
    tgt, mem = torch.randn(2, 5, 32), torch.randn(2, 7, 32)
    run = lambda seed: layer(tgt, mem, generator=torch.Generator().manual_seed(seed))  # noqa: E731
    layer.train()
    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    layer.eval()
    plain = run(3)
    layer.train()
    layer.dropout = 0.0
    assert torch.allclose(run(4), plain, atol=1e-6)


# --- losses and metrics ------------------------------------------------------------


@pytest.mark.parametrize("name", ["heatmap_mse_loss", "masked_multiview_heatmap_loss",
                                  "smooth_l1_loss"])
def test_losses_match_jax(name, rng):
    """f32 losses on the same inputs: 1e-6 relative (f32 means in another order)."""
    pred = rng.normal(size=(2, 3, 4, 8, 8)).astype(np.float32)
    target = rng.uniform(0, 1, size=pred.shape).astype(np.float32)
    mask = np.array([[True, False, True], [False, False, False]])
    args = {"heatmap_mse_loss": (pred, target),
            "masked_multiview_heatmap_loss": (pred, target, mask),
            "smooth_l1_loss": (3.0 * pred[..., 0, 0], target[..., 0, 0], 0.7)}[name]
    want = getattr(jax_losses, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                       for a in args))
    got = getattr(torch_losses, name)(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                        for a in args))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("name, valid", [
    ("pck_at_k", False), ("pck_at_k", True), ("add_metric", False), ("add_metric", True),
    ("pass_rate_auc", False), ("pass_rate_auc", True), ("add_auc", True), ("angle_mae", True),
])
def test_metrics_match_jax(name, valid, rng):
    """Metrics on the same inputs, with and without validity weights: 1e-6
    (f32 sums in another order); a failed frame (inf) counts as failed."""
    xy = rng.uniform(0, 64, size=(4, 3, 8, 2)).astype(np.float32)
    pts = rng.normal(scale=0.3, size=(4, 8, 3)).astype(np.float32)
    dists = rng.uniform(0, 0.15, size=(6,)).astype(np.float32)
    dists[2] = np.inf
    w = {"pck_at_k": rng.uniform(size=(4, 3, 8)) > 0.3, "add_metric": rng.uniform(size=(4, 8)) > 0.3,
         "pass_rate_auc": np.arange(6) % 3 != 1, "add_auc": np.arange(4) != 2,
         "angle_mae": np.arange(4) != 0}[name]
    args, kwargs = {
        "pck_at_k": ((xy, xy + rng.normal(scale=4.0, size=xy.shape).astype(np.float32)),
                     {"k_px": 5.0}),
        "add_metric": ((pts, pts + rng.normal(scale=0.05, size=pts.shape).astype(np.float32)),
                       {}),
        "pass_rate_auc": ((dists,), {"max_threshold_m": 0.10}),
        "add_auc": ((pts, pts + rng.normal(scale=0.03, size=pts.shape).astype(np.float32)),
                    {"max_threshold_m": 0.10}),
        "angle_mae": ((pts[..., 0], pts[..., 1]), {}),
    }[name]
    want = getattr(jax_metrics, name)(*map(jnp.asarray, args), **kwargs,
                                      valid=jnp.asarray(w) if valid else None)
    got = getattr(torch_metrics, name)(*map(torch.from_numpy, args), **kwargs,
                                       valid=torch.from_numpy(w) if valid else None)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)


# --- optimizer ------------------------------------------------------------------


class _Groups(torch.nn.Module):
    """One Dense per optimizer group, named as the estimator's modules."""

    def __init__(self):
        super().__init__()
        self.backbone = torch.nn.Linear(3, 4)
        self.cnn_stem = torch.nn.Linear(4, 5)
        self.angle_head = torch.nn.Linear(5, 2)


def test_optimizer_matches_optax_over_three_updates():
    """Two AdamW groups at their own learning rates on cosine schedules,
    and a frozen backbone, against the reference's optax transform, fed the
    same gradients."""
    cfg = dict(num_epochs=1, steps_per_epoch=4, lr_kpt=1e-2, lr_ang=3e-3, eta_min=1e-4)
    rng = np.random.default_rng(23)
    model = _Groups()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32)))
    params = {name: {"kernel": m.weight.detach().numpy().T.copy(), "bias": m.bias.detach().numpy().copy()}
              for name, m in model.named_children()}
    tx = jax_make_optimizer(JaxTrainConfig(**cfg))
    opt_state = tx.init(params)
    state = create_train_state(model, TrainConfig(**cfg))
    frozen = {k: v.clone() for k, v in model.backbone.state_dict().items()}
    schedule = optax.cosine_decay_schedule(1e-2, 4, alpha=1e-4 / 1e-2)
    for t in range(3):
        grads = {name: {k: (rng.choice([-1.0, 1.0], size=v.shape) *
                            rng.uniform(1e-3, 1.0, size=v.shape)).astype(np.float32)
                        for k, v in leaves.items()} for name, leaves in params.items()}
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, m in model.named_children():
            m.weight.grad = torch.from_numpy(grads[name]["kernel"].T.copy())
            m.bias.grad = torch.from_numpy(grads[name]["bias"])
        state.apply_gradients()
        lr = {g["name"]: g["lr"] for g in state.optimizer.param_groups}
        assert lr["kpt"] == pytest.approx(float(schedule(t)), rel=1e-7)
        assert lr["kpt"] == pytest.approx(cosine_decay(1e-2, t, 4, 1e-4), rel=1e-12)
        for name, m in model.named_children():
            np.testing.assert_allclose(m.weight.detach().numpy(), np.asarray(params[name]["kernel"]).T,
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(m.bias.detach().numpy(), np.asarray(params[name]["bias"]),
                                       rtol=0, atol=1e-6)
    assert state.step == 3
    for k, v in model.backbone.state_dict().items():
        assert torch.equal(v, frozen[k])  # bit-identical
    assert not model.backbone.weight.requires_grad
    assert state.optimizer.defaults["weight_decay"] == 0.0
    assert state.optimizer.defaults["eps"] == 1e-8


def test_param_groups_reject_an_unknown_module():
    model = _Groups()
    model.extra = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="'extra' is not in any optimizer group"):
        param_groups(model)
    groups = param_groups(_Groups(), freeze_backbone=False)
    assert [len(groups[g]) for g in ("kpt", "ang", "frozen")] == [4, 2, 0]


# --- one train step against the reference ---------------------------------------


class _NoDropoutDecoderLayer(jax_heads.DecoderLayer):
    dropout: float = 0.0


@pytest.fixture
def jax_without_dropout(monkeypatch):
    """The reference's decoder layers with dropout 0.0, in every module that
    names the class; nothing in mvropose_tpu changes."""
    for module in (jax_heads, jax_fusion, jax_estimator):
        monkeypatch.setattr(module, "DecoderLayer", _NoDropoutDecoderLayer)


TINY = JaxEstimatorConfig(vit=VIT_TINY_TEST, num_joints=4, num_angles=3, heatmap_size=(32, 32),
                          max_views=4, num_fusion_queries=4, num_angle_queries=2,
                          freeze_backbone=False, dtype="float32")
LR_KPT, LR_ANG = 1e-2, 5e-3


def _batch(rng):
    B, V = 2, 3
    mask = np.array([[True, False, True], [True, True, True]])
    return {
        "images": rng.normal(size=(B, V, 64, 64, 3)).astype(np.float32),
        "view_ids": np.tile(np.arange(V, dtype=np.int32), (B, 1)),
        "view_mask": mask,
        "heatmaps": rng.uniform(0, 1, size=(B, V, 4, 32, 32)).astype(np.float32),
        "angles": rng.uniform(-1, 1, size=(B, 3)).astype(np.float32),
    }


def _flat(path: Path, params, batch_stats) -> dict:
    export_npz({"params": params, "batch_stats": batch_stats}, path)
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def test_multi_view_train_step_matches_jax(jax_without_dropout, tmp_path):
    rng = np.random.default_rng(24)
    batch = _batch(rng)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JaxEstimator(TINY)
    shapes = jax.eval_shape(lambda k: model.init(k, jbatch["images"][:1], jbatch["view_ids"][:1],
                                                 jbatch["view_mask"][:1]), jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed=25)
    tcfg = dict(num_epochs=1, steps_per_epoch=10, lr_kpt=LR_KPT, lr_ang=LR_ANG,
                freeze_backbone=False)

    def loss_fn(params):
        (hm, ang), _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jbatch["images"],
            jbatch["view_ids"], jbatch["view_mask"], train=True, mutable=["batch_stats"])
        loss_ang = _weighted_mean(_huber_per_sample(ang, jbatch["angles"], 1.0),
                                  jnp.any(jbatch["view_mask"], axis=1))
        return jax_mv_loss(hm, jbatch["heatmaps"], jbatch["view_mask"]) * 100.0 + loss_ang

    grads = _flat(tmp_path / "g.npz", jax.jit(jax.grad(loss_fn))(variables["params"]),
                  variables["batch_stats"])
    port = MultiViewPoseEstimator(port_config(TINY))
    load_jax_params(port, export_npz(variables, tmp_path / "p.npz"))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    state = jax_create_train_state(model, variables, JaxTrainConfig(**tcfg))
    state, metrics = jax_train_step(JaxTrainConfig(**tcfg))(state, jbatch, jax.random.PRNGKey(0))
    after = _flat(tmp_path / "a.npz", state.params, state.batch_stats)

    for m in port.modules():
        if isinstance(m, DecoderLayer):
            m.dropout = 0.0
    tstate = create_train_state(port, TrainConfig(**tcfg))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = make_multi_view_train_step(tstate.cfg)(tstate, tbatch, torch.Generator().manual_seed(0))
    for k in ("loss", "loss_kpt", "loss_ang"):
        np.testing.assert_allclose(float(got[k]), float(metrics[k]), rtol=1e-5)

    lr = {n: LR_ANG if n.startswith("angle_head.") else LR_KPT for n in before}
    g_want = {n: v for n, (_, v) in plan_jax_params(port, grads).items()}
    want = {n: v for n, (_, v) in plan_jax_params(port, after).items()}
    params = dict(port.named_parameters())
    top = max(float(np.abs(g_want[name]).max()) for name in params)
    for name, p in params.items():
        g = g_want[name]
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(np32(p.grad), g, rtol=1e-3, atol=1e-4 * scale + 1e-8 * top,
                                   err_msg=name)
        step = (np32(p) - np32(before[name])) / lr[name]
        step_want = (want[name] - np32(before[name])) / lr[name]
        clear = (np.abs(g) >= 1e-3 * scale) & (np.abs(g) >= 1e-6 * top)
        np.testing.assert_allclose(step[clear], step_want[clear], atol=1e-3, err_msg=name)
        assert np.abs(step - step_want).max() <= 2.001, name
    for name in before:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(np32(port.state_dict()[name]), want[name], atol=1e-5,
                                       err_msg=name)
    ev = make_eval_step(tstate.cfg)(tstate, tbatch)
    assert ev["pred_heatmaps"].shape == (2, 3, 4, 32, 32) and bool(torch.isfinite(ev["loss"]))


def test_frozen_backbone_takes_no_gradient_and_stays_identical():
    cfg = port_config(TINY)
    import dataclasses

    model = MultiViewPoseEstimator(dataclasses.replace(cfg, freeze_backbone=True))
    batch = {k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(26)).items()}
    before = {k: v.clone() for k, v in model.backbone.state_dict().items()}
    state = create_train_state(model, TrainConfig(freeze_backbone=True))
    step = make_multi_view_train_step(state.cfg)
    for seed in range(2):
        step(state, batch, torch.Generator().manual_seed(seed))
    assert all(p.grad is None for p in model.backbone.parameters())
    for k, v in model.backbone.state_dict().items():
        assert torch.equal(v, before[k])
    assert model.keypoint_head.heatmap_predictor.weight.grad is not None


# --- faults of the parent: f32 parameters, the import chain -----------------------


def test_bf16_model_trains_f32_parameters():
    """flax keeps parameters in f32 and casts at use; AdamW at lr 1e-4 must
    move a weight of magnitude 1, which bf16 storage (ulp 2^-7) would not."""
    import dataclasses

    cfg = port_config(TINY)
    cfg = dataclasses.replace(cfg, dtype="bfloat16",
                              vit=dataclasses.replace(cfg.vit, dtype="bfloat16"))
    model = MultiViewPoseEstimator(cfg)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    w = model.keypoint_head.heatmap_predictor.weight
    with torch.no_grad():
        w.fill_(1.0)
    state = create_train_state(model, TrainConfig(lr_kpt=1e-4, lr_ang=1e-4))
    batch = {k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(27)).items()}
    out = make_multi_view_train_step(state.cfg)(state, batch, torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(out["loss"]))
    assert w.dtype == torch.float32
    moved = (w.detach() - 1.0).abs()
    assert float(moved.max()) == pytest.approx(1e-4, rel=0.05)


BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "pandas", "PIL", "grain")


def test_port_trainer_and_smoke_import_no_forbidden_package():
    """Every module of the port, the trainer script and chip_smoke.py import
    in a process where jax, flax, optax, orbax, cv2, pandas, PIL and grain
    cannot be imported, and none of them is loaded afterwards."""
    code = f"""
import importlib, importlib.util, pkgutil, sys
BLOCKED = {BLOCKED!r}
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(ROOT)!r})
import mvropose_torch
for info in pkgutil.walk_packages(mvropose_torch.__path__, "mvropose_torch."):
    if not info.name.endswith("__main__"):  # the CLI entry runs on import
        importlib.import_module(info.name)
for name, path in (("trainer", "scripts/torch_train_synthetic.py"), ("smoke", "chip_smoke.py")):
    spec = importlib.util.spec_from_file_location(name, {str(ROOT)!r} + "/" + path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
import mvropose_torch.utils.metrics_writer, mvropose_torch.train.step
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]


# --- the trainer script ------------------------------------------------------------


def _trainer():
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_train_synthetic",
                                                  ROOT / "scripts" / "torch_train_synthetic.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_trainer_runs_end_to_end_on_cpu(tmp_path):
    """A few f32 CPU steps through the script, with a finite train pool and a
    frozen backbone: the metrics log and final_metrics.json with the
    reference's keys (plus the device's name)."""
    final = _trainer().main([
        "--mode", "multi", "--cpu", "--steps", "3", "--batch", "2", "--image-size", "64",
        "--views", "2", "--eval-every", "2", "--eval-batches", "1", "--dataset-size", "5",
        "--freeze-backbone", "--workdir", str(tmp_path)])
    log = (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()
    assert len(log) == 2  # steps 1 and 2
    assert (tmp_path / "decode_residuals.npy").exists()
    on_disk = __import__("json").loads((tmp_path / "final_metrics.json").read_text())
    metrics = {"pck5", "pck_tight", "add_m", "add_auc_10cm", "angle_mae", "angle_mae_per_joint",
               "triangulated_add_m"}
    assert set(on_disk) == metrics | {f"trainset_{k}" for k in metrics} | {
        "frozen_backbone", "frozen_backbone_max_drift", "backbone_ckpt", "dataset_size", "mode",
        "robot", "steps", "batch", "views", "image_size", "params_m", "backend", "device",
        "wall_s", "train_samples_per_sec", "held_out"} | POSE_KEYS
    assert final["frozen_backbone_max_drift"] == 0.0 and np.isfinite(final["add_m"])
    assert final["backend"] == "cpu" and len(final["angle_mae_per_joint"]) == 6


POSE_KEYS = {"pose_rot_err_deg", "pose_trans_err_m", "pose_success_rate",
             "pose_rot_err_deg_gt_angles", "pose_trans_err_m_gt_angles"}


def test_trainer_writes_the_reference_pose_keys(tmp_path):
    """final_metrics.json holds the pose keys that the reference's script
    writes (read from its source), each a float or None (no recovery
    succeeded), the success rate in [0, 1]."""
    import re

    source = (Path(__file__).resolve().parents[1] / "scripts" / "train_synthetic.py").read_text()
    assert set(re.findall(r'final\["(pose_[a-z_]+)"\]', source)) == POSE_KEYS
    final = _trainer().main([
        "--mode", "multi", "--cpu", "--steps", "1", "--batch", "2", "--image-size", "64",
        "--views", "2", "--eval-every", "1", "--eval-batches", "1", "--workdir", str(tmp_path)])
    for key in POSE_KEYS:
        assert final[key] is None or np.isfinite(final[key]), (key, final[key])
    assert 0.0 <= final["pose_success_rate"] <= 1.0


class _PlantedModel(torch.nn.Module):
    """Stands in for the trained model in `pose_eval`: it returns the planted
    heatmaps that the batch carries as its images, and the predicted angles."""

    def __init__(self, pred: np.ndarray):
        super().__init__()
        self.pred = torch.from_numpy(pred)

    def forward(self, images, view_ids, view_mask, proj_mats=None):
        return images, self.pred.expand(images.shape[0], -1)


def _reference_pose_eval(batches, pred, rig, robot, size: int, use_gt_angles: bool) -> dict:
    """The reference script's `pose_eval` (`scripts/train_synthetic.py`, the
    closure in `main`) for the multi-view model, its lines on given heatmaps
    and predicted angles."""
    from mvropose_tpu.pose import recover_pose_batch
    from mvropose_tpu.train import pose_rotation_err_deg, pose_translation_err_m

    K_rig, rv_rig, tv_rig = (jnp.asarray(a) for a in rig)
    V = rv_rig.shape[0]
    eye_base = jnp.tile(jnp.eye(3, dtype=jnp.float32)[None], (V, 1, 1))
    Ks = jnp.tile(K_rig[None], (V, 1, 1))
    rots, trans, succ = [], [], []
    for b in batches:
        hm_b = jnp.asarray(b["images"].numpy())
        ang_b = jnp.tile(jnp.asarray(pred)[None], (hm_b.shape[0], 1))
        angles_b = jnp.asarray(b["angles"].numpy()) if use_gt_angles else ang_b
        hm_b = hm_b[:, :, : robot.n_keypoints]
        out = jax.vmap(
            lambda hm_s, ang_s, k: recover_pose_batch(
                hm_s, ang_s, eye_base[: hm_b.shape[1]], Ks[: hm_b.shape[1]],
                robot, (size, size), key=k, decode_mode="refine"))(
            hm_b, angles_b, jax.random.split(jax.random.PRNGKey(3), hm_b.shape[0]))
        gt_rv, gt_tv = rv_rig[None, : hm_b.shape[1]], tv_rig[None, : hm_b.shape[1]]
        rots.append(np.asarray(pose_rotation_err_deg(out["rvec"], gt_rv)).ravel())
        trans.append(np.asarray(pose_translation_err_m(out["tvec"], gt_tv)).ravel())
        succ.append(np.asarray(out["success"]).ravel())
    ok = np.concatenate(succ) > 0
    r, t = np.concatenate(rots), np.concatenate(trans)
    return {"rot_err_deg": float(r[ok].mean()) if ok.any() else None,
            "trans_err_m": float(t[ok].mean()) if ok.any() else None,
            "success_rate": float(ok.mean())}


def test_pose_eval_matches_the_reference_script(monkeypatch):
    """The trainer's `pose_eval` against the reference script's on a planted
    fr5 rig (2 views at 1280 x 1280, the nominal K, 128 x 128 heatmaps):
    2 batches of 2 samples, each the rig's heatmaps with its own keypoint
    noise, one view with no confident keypoint. The same draws (the
    reference's: PRNGKey(3) split over a batch, the same keys every batch).
    With the predicted and with the true angles: the success rate equal (7
    of 8), the mean errors within 1e-3 rad (in degrees) and 1e-3 of |t|."""
    from torch_parity import jax_rig_gumbel, pose_scene
    from mvropose_tpu.geometry.robots import get_robot as jax_get_robot
    from mvropose_torch.geometry.robots import get_robot
    from mvropose_torch.pose import PoseDraws

    size, V, B = 1280, 2, 2
    scenes = [pose_scene("fr5", V, seed=21, noise_px=n, image_hw=(size, size))
              for n in (0.5, 1.0, 1.5, 2.0)]  # one rig: the noise is drawn last
    scenes[2]["heatmaps"][1] = -5.0  # no confident keypoint: that view fails
    batches = [{"images": torch.from_numpy(np.stack([s["heatmaps"] for s in pair])),
                "angles": torch.from_numpy(np.stack([s["angles"] for s in pair])),
                "view_ids": None, "view_mask": None}
               for pair in (scenes[:2], scenes[2:])]
    rig = (scenes[0]["Ks"][0], scenes[0]["rvecs"], scenes[0]["tvecs"])
    pred = scenes[0]["pred_angles"]
    robot = get_robot("fr5")
    gumbel = np.stack([jax_rig_gumbel(k, V, 16, robot.n_keypoints)
                       for k in jax.random.split(jax.random.PRNGKey(3), B)])

    class _ReferenceDraws:
        @staticmethod
        def draw(lead, views, joints, angles, refine, generator, device):
            assert (lead, views, joints, refine) == ((B,), V, robot.n_keypoints, False)
            return PoseDraws(torch.from_numpy(gumbel))

    trainer = _trainer()
    monkeypatch.setattr(trainer, "PoseDraws", _ReferenceDraws)
    for use_gt_angles in (False, True):
        port = trainer.pose_eval(_PlantedModel(pred), robot, batches,
                                 tuple(torch.from_numpy(a) for a in rig), size, use_gt_angles)
        ref = _reference_pose_eval(batches, pred, rig, jax_get_robot("fr5"), size, use_gt_angles)
        assert port["success_rate"] == ref["success_rate"] == 7 / 8, (port, ref)
        assert abs(port["rot_err_deg"] - ref["rot_err_deg"]) <= np.degrees(1e-3), (port, ref)
        t_scale = 1e-3 * np.linalg.norm(rig[2], axis=-1).min()
        assert abs(port["trans_err_m"] - ref["trans_err_m"]) <= t_scale, (port, ref)


@pytest.mark.parametrize("argv, item", [
    (["--mode", "multi", "--render", "link"], "item 11"),
    (["--mode", "multi", "--backbone-ckpt", "x.npz"], "item 11"),
])
def test_trainer_rejects_unported_flags(argv, item, tmp_path):
    """The trainer's flag values left to port (the single-view mode, the
    geometric heads and the FK term run: test_torch_single_view_train.py)."""
    with pytest.raises(SystemExit, match=f"not ported yet \\(ROADMAP.md queue 1, {item}"):
        _trainer().main([*argv, "--cpu", "--workdir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_trainer_fk_loss_weight_names_the_single_view_item():
    """The FK-consistency term belongs to the single-view step (the reference
    applies it there, scripts/train_synthetic.py:177, and its multi-view step
    drops it without a word), so multi mode refuses it, naming the
    single-view step, and names no ROADMAP item: the term is ported."""
    trainer = _trainer()
    args = trainer.build_parser().parse_args(["--mode", "multi", "--fk-loss-weight", "1"])
    trainer.check_ported(args)
    with pytest.raises(SystemExit) as refused:
        trainer.check_flags(args, trainer.get_robot(args.robot))
    message = str(refused.value)
    assert "--fk-loss-weight" in message and "single-view step" in message, message
    assert "item" not in message
