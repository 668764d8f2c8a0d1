"""The geometric angle heads, the single-view estimator and the DLT: the torch
port vs the JAX reference, f32 on the CPU.

The heads run on planted heatmaps (`torch_parity.heatmap_rig_scene`: one
logit blob a map, peaked on a stereo-like rig's projections), so both
packages decode the same peaks. Tolerances:
  * the heads' angles 1e-5: the same f32 decode, DLT and 3-layer MLP, whose
    reductions run in another order (measured ~1e-6); the tanh GELU that
    flax's `nn.gelu` defaults to is part of what the bound holds, an erf
    GELU misses it;
  * the triangulated points 1e-4 m (f32 SVDs of the same systems, in both
    packages LAPACK's), the observer counts and the clipped coordinate
    exact, the far point's other two 1e-3 relative (its null vector's last
    entry is ~1/300, which amplifies the SVDs' rounding);
  * the estimators' heatmaps 1e-4 (as test_torch_heads.py); the query head's
    angles 1e-4; the geometric heads' angles 1e-5 on the reference's own
    heatmaps, and from the port's own heatmaps where the test asserts that
    every map's argmax margin is ten times the heatmaps' gap;
  * heatmap-pixel projection matrices 1e-5 relative.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import mvropose_torch.models.estimator as port_estimator
from mvropose_tpu.decode import decode_keypoints as jax_decode
from mvropose_tpu.geometry import triangulation as jtri
from mvropose_tpu.models import EstimatorConfig as JaxEstimatorConfig
from mvropose_tpu.models import MultiViewPoseEstimator as JaxMultiView
from mvropose_tpu.models import SingleViewPoseEstimator as JaxSingleView
from mvropose_tpu.models.estimator import GeometricAngleHead as JaxGeometricHead
from mvropose_tpu.models.vit import ViTConfig as JaxViTConfig

from mvropose_torch.geometry import triangulation as ttri
from mvropose_torch.geometry.camera import RemapTaps, undistort_map
from mvropose_torch.models import (
    GeometricAngleHead,
    MultiViewPoseEstimator,
    SingleViewPoseEstimator,
)
from mvropose_torch.ops import small_svd
from mvropose_torch.cli.main import read_model_config, write_run_dir
from mvropose_torch.utils.weights import (
    export_jax_params,
    flax_init_state,
    load_jax_params,
    plan_jax_params,
    random_state,
)
from test_torch_serve import port_config
from torch_parity import export_npz, heatmap_rig_scene, np32, random_variables

ANGLES, JOINTS, MAX_VIEWS = 3, 4, 5


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def scene():
    return heatmap_rig_scene(seed=31, batch=2, views=4, joints=JOINTS)


HEAD_CASES = {  # name: (max_views, use_triangulation, multi-view input)
    "geometric_sv": (0, False, False),
    "geometric_mv": (MAX_VIEWS, False, True),
    "geometric3d": (MAX_VIEWS, True, True),
}


def _head_inputs(scene, multi: bool):
    if multi:
        return scene["heatmaps"], scene["mask"], scene["proj_mats"]
    return scene["heatmaps"][:, 0], None, None


@pytest.fixture(scope="module")
def head_refs(scene, tmp_path_factory):
    """Per case: the reference head's weights (numpy-seeded) and its angles."""
    refs = {}
    for name, (max_views, tri, multi) in HEAD_CASES.items():
        module = JaxGeometricHead(ANGLES, max_views=max_views, use_triangulation=tri)
        hm, mask, pm = _head_inputs(scene, multi)
        args = [jnp.asarray(hm)] + ([jnp.asarray(mask), jnp.asarray(pm)] if multi else [])
        shapes = jax.eval_shape(lambda k: module.init(k, *args), jax.random.PRNGKey(0))
        variables = random_variables(shapes, seed=32)
        npz = export_npz(variables, tmp_path_factory.mktemp(name) / "p.npz")
        refs[name] = (npz, np32(jax.jit(module.apply)(variables, *args)))
    return refs


def _port_head(name: str, npz) -> GeometricAngleHead:
    max_views, tri, _ = HEAD_CASES[name]
    head = GeometricAngleHead(ANGLES, JOINTS, max_views=max_views, use_triangulation=tri)
    load_jax_params(head, npz)
    return head.eval()


def _port_angles(name: str, npz, scene) -> torch.Tensor:
    hm, mask, pm = _head_inputs(scene, HEAD_CASES[name][2])
    with torch.no_grad():
        return _port_head(name, npz)(_t(hm), None if mask is None else _t(mask),
                                     None if pm is None else _t(pm))


@pytest.mark.parametrize("name", list(HEAD_CASES))
def test_geometric_head_matches_jax(head_refs, scene, name):
    npz, want = head_refs[name]
    got = _port_angles(name, npz, scene)
    assert got.shape == (2, ANGLES) and got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), want, rtol=1e-5, atol=1e-5)


def test_geometric_head_with_erf_gelu_misses_the_bound(head_refs, scene, monkeypatch):
    """The head's GELU is flax's default, the tanh approximation; with torch's
    default (erf) GELU the same head misses the 1e-5 bound."""
    npz, want = head_refs["geometric3d"]
    erf = types.SimpleNamespace(gelu=lambda x, approximate="none": F.gelu(x), pad=F.pad)
    monkeypatch.setattr(port_estimator, "F", erf)
    gap = np.abs(np32(_port_angles("geometric3d", npz, scene)) - want).max()
    assert gap > 1e-5 * (1 + np.abs(want).max()), gap


def test_triangulation_branch_matches_jax(scene):
    """The geometric3d branch's points and observer counts, the reference's
    lines on the reference's decode: joint 1 (one confident view) zeroed,
    joint 2 (300 m out) clipped to 100, the rest near the planted points."""
    hm, mask, pm = (jnp.asarray(scene[k]) for k in ("heatmaps", "mask", "proj_mats"))
    xy, conf = jax_decode(hm, mode="refine", use_pallas=False)
    wgt = conf * mask.astype(jnp.float32)[..., None]
    pts = jax.vmap(jtri.triangulate_keypoints)(xy, pm, wgt)
    obs = jnp.sum((wgt > 0.05).astype(jnp.float32), axis=1)
    want = jnp.clip(jnp.where((obs >= 2.0)[..., None], pts, 0.0), -100.0, 100.0)
    t_xy, t_conf = port_estimator.decode_keypoints(_t(scene["heatmaps"]), mode="refine")
    got, got_obs = GeometricAngleHead.triangulated(t_xy, t_conf, _t(scene["mask"]),
                                                   _t(scene["proj_mats"]))
    got, want = np32(got), np32(want)
    np.testing.assert_array_equal(np32(got_obs), np32(obs))
    np.testing.assert_array_equal(np32(got_obs)[:, 1], [1.0, 1.0])
    near = [0, 3]
    np.testing.assert_allclose(got[:, near], want[:, near], atol=1e-4)
    # Near the planted points: the 5 x 5 centroid of a blob off the pixel
    # grid is biased by a fraction of a pixel, a few cm of depth here.
    np.testing.assert_allclose(got[:, near], scene["points"][:, near], atol=0.1)
    assert (got[:, 1] == 0).all() and (want[:, 1] == 0).all()
    # The far point: x clipped alike on both sides; its null vector's last
    # entry is ~1/300, so f32 SVD noise reaches y and z amplified ~300 x.
    np.testing.assert_array_equal(np.abs(got[:, 2, 0]), [100.0, 100.0])
    np.testing.assert_array_equal(got[:, 2, 0], want[:, 2, 0])
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-3, atol=1e-4)


def test_triangulate_keypoints_matches_jax_with_zero_weight_views():
    """The CPU route (LAPACK) against the reference's DLT: per-view and
    per-keypoint weights with zeros, one P for all samples and one a sample."""
    s = heatmap_rig_scene(seed=33, batch=3, views=4, joints=5)
    rng = np.random.default_rng(34)
    xy = s["xy"] + rng.normal(scale=0.05, size=s["xy"].shape).astype(np.float32)
    w = rng.uniform(0.2, 1.0, size=xy.shape[:-1]).astype(np.float32)
    w[0, 1] = 0.0  # a whole view out
    w[1, :, 3] = 0.0
    w[1, 0, 3] = w[1, 2, 3] = 0.7  # keypoint 3 of sample 1 from views 0 and 2 only
    want = np.stack([np32(jtri.triangulate_keypoints(jnp.asarray(xy[b]), jnp.asarray(
        s["proj_mats"][0]), jnp.asarray(w[b]))) for b in range(3)])
    got = ttri.triangulate_keypoints(_t(xy), _t(s["proj_mats"]), _t(w))
    shared = ttri.triangulate_keypoints(_t(xy), _t(s["proj_mats"][0]), _t(w))
    ok = np.abs(want).max(-1) < 50  # the far point: its depth is ill-conditioned
    np.testing.assert_allclose(np32(got)[ok], want[ok], atol=1e-4)
    np.testing.assert_allclose(np32(shared)[ok], want[ok], atol=1e-4)
    view_weights = ttri.triangulate_keypoints(_t(xy[0]), _t(s["proj_mats"][0]), _t(w[0, :, 0]))
    want_v = np32(jtri.triangulate_keypoints(jnp.asarray(xy[0]), jnp.asarray(s["proj_mats"][0]),
                                             jnp.asarray(w[0, :, 0])))
    ok = np.abs(want_v).max(-1) < 50
    np.testing.assert_allclose(np32(view_weights)[ok], want_v[ok], atol=1e-4)


def test_heatmap_projection_matrices_match_jax():
    rng = np.random.default_rng(35)
    rv, tv = rng.normal(size=(3, 3)).astype(np.float32), rng.normal(size=(3, 3)).astype(np.float32)
    K = np.array([[1000.0, 0, 640], [0, 990, 360], [0, 0, 1]], np.float32)
    Ks = np.stack([K, K * 1.1, K * 0.9]).astype(np.float32)
    Ks[:, 2, 2] = 1.0
    for k in (K, Ks):
        want = np32(jtri.heatmap_projection_matrices(jnp.asarray(rv), jnp.asarray(tv),
                                                     jnp.asarray(k), (720, 1280), (128, 96)))
        got = np32(ttri.heatmap_projection_matrices(_t(rv), _t(tv), _t(k), (720, 1280),
                                                    (128, 96)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# --- the estimators ------------------------------------------------------------

VIT = JaxViTConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=1, num_heads=4,
                   dtype="float32")


def _cfg(head: str) -> JaxEstimatorConfig:
    return JaxEstimatorConfig(vit=VIT, num_joints=JOINTS, num_angles=ANGLES,
                              heatmap_size=(32, 32), max_views=MAX_VIEWS, num_fusion_queries=4,
                              num_angle_queries=2, dtype="float32", angle_head=head)


MODEL_CASES = ["sv_query", "sv_geometric", "mv_geometric", "mv_geometric3d"]


@pytest.fixture(scope="module")
def model_refs(scene, tmp_path_factory):
    """Per case: the reference model's weights, inputs and outputs (eval mode)."""
    rng = np.random.default_rng(36)
    refs = {}
    for case in MODEL_CASES:
        kind, head = case.split("_")
        cfg = _cfg(head)
        if kind == "sv":
            model = JaxSingleView(cfg)
            args = (rng.normal(size=(2, 32, 32, 3)).astype(np.float32),)
            kwargs = {}
        else:
            model = JaxMultiView(cfg)
            args = (rng.normal(size=(2, 4, 32, 32, 3)).astype(np.float32),
                    np.tile(np.arange(4, dtype=np.int32), (2, 1)), scene["mask"])
            kwargs = {"proj_mats": scene["proj_mats"]}
        jargs = [jnp.asarray(a) for a in args]
        jkw = {k: jnp.asarray(v) for k, v in kwargs.items()}
        shapes = jax.eval_shape(lambda k: model.init(k, *jargs, **jkw), jax.random.PRNGKey(0))
        variables = random_variables(shapes, seed=37)
        hm, ang = jax.jit(model.apply)(variables, *jargs, **jkw)
        npz = export_npz(variables, tmp_path_factory.mktemp(case) / "p.npz")
        refs[case] = (cfg, npz, args, kwargs, np32(hm), np32(ang))
    return refs


@pytest.mark.parametrize("case", MODEL_CASES)
def test_estimator_matches_jax(model_refs, case):
    cfg, npz, args, kwargs, hm_ref, ang_ref = model_refs[case]
    cls = SingleViewPoseEstimator if case.startswith("sv") else MultiViewPoseEstimator
    model = cls(port_config(cfg)).eval()
    load_jax_params(model, npz)
    with torch.no_grad():
        hm, ang = model(*map(_t, args), **{k: _t(v) for k, v in kwargs.items()})
    np.testing.assert_allclose(np32(hm), hm_ref, rtol=1e-4, atol=1e-4)
    if cfg.angle_head == "query":
        np.testing.assert_allclose(np32(ang), ang_ref, rtol=1e-4, atol=1e-4)
        return
    # The head on the reference's own heatmaps: the same decode on both sides.
    with torch.no_grad():
        mv = case.startswith("mv")
        on_ref = model.angle_head(_t(hm_ref), *((_t(args[2]), _t(kwargs["proj_mats"]))
                                                 if mv else ()))
    np.testing.assert_allclose(np32(on_ref), ang_ref, rtol=1e-5, atol=1e-5)
    # From the port's own heatmaps where every peak is the reference's.
    top2 = np.sort(hm_ref.reshape(*hm_ref.shape[:-2], -1), axis=-1)[..., -2:]
    margin = float((top2[..., 1] - top2[..., 0]).min())
    gap = float(np.abs(np32(hm) - hm_ref).max())
    if margin > 10 * gap:
        np.testing.assert_allclose(np32(ang), ang_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["single_view", "multi_view"])
def test_run_dir_carries_the_kind_as_the_reference(tmp_path, kind):
    """`write_run_dir` writes the reference's `_write_model_config` layout
    for either kind, and `read_model_config` reads the kind back."""
    from mvropose_tpu.cli.main import _write_model_config

    cfg = _cfg("geometric")
    write_run_dir(tmp_path / "port", port_config(cfg), 32, {}, kind=kind)
    _write_model_config(tmp_path / "ref", cfg, multi_view=kind == "multi_view", model_size=32)
    assert (json.loads((tmp_path / "port" / "model_config.json").read_text())
            == json.loads((tmp_path / "ref" / "model_config.json").read_text()))
    got, size, got_kind = read_model_config(tmp_path / "port" / "best_params.npz")
    assert (size, got_kind, got.angle_head) == (32, kind, "geometric")
    with pytest.raises(ValueError, match="kind"):
        write_run_dir(tmp_path / "bad", port_config(cfg), 32, {}, kind="two_view")


def test_single_view_geometric3d_raises_as_the_reference():
    cfg = port_config(_cfg("geometric3d"))
    with pytest.raises(ValueError, match="multi-view only"):
        JaxSingleView(_cfg("geometric3d")).init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 32, 32, 3)))
    with pytest.raises(ValueError, match="multi-view only"):
        SingleViewPoseEstimator(cfg)


@pytest.mark.parametrize("case", MODEL_CASES)
def test_weight_bridge_is_strict_for_every_kind(model_refs, case):
    """Each kind's checkpoint fills every tensor of the port's model, leaf for
    leaf; a leaf more, or one missing, raises."""
    cfg, npz, *_ = model_refs[case]
    cls = SingleViewPoseEstimator if case.startswith("sv") else MultiViewPoseEstimator
    model = cls(port_config(cfg))
    with np.load(npz) as data:
        flat = {k: data[k] for k in data.files}
    assert len(plan_jax_params(model, flat)) == len(flat)
    multi = any(k.startswith(("view_embeddings", "fusion_module", "keypoint_enricher"))
                for k in flat)
    assert multi == case.startswith("mv")
    with pytest.raises(KeyError):
        plan_jax_params(model, {**flat, "angle_head/extra/kernel": np.zeros((1, 1), np.float32)})
    with pytest.raises(KeyError):
        drop = next(k for k in flat if k.startswith("angle_head/"))
        plan_jax_params(model, {k: v for k, v in flat.items() if k != drop})
    load_jax_params(model, flat)
    again = cls(port_config(cfg))
    load_jax_params(again, export_jax_params(model))  # the inverse map, leaf for leaf
    assert all(torch.equal(t, model.state_dict()[k]) for k, t in again.state_dict().items())
    assert set(flax_init_state(cls(port_config(cfg)))) == set(model.state_dict())
    if cfg.angle_head != "query":
        assert flat["angle_head/fc0/kernel"].shape[1] == 256
        assert model.angle_head.fc0.weight.dtype == torch.float32
        bf16 = cls(dataclasses.replace(port_config(cfg), dtype="bfloat16"))
        assert bf16.angle_head.out.weight.dtype == torch.float32


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SVD kernel has no CPU mode")
    return torch.device("cuda")


def _never_syncs(fn):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_remap_on_card_matches_cpu(cuda_device):
    """The serve's undistortion of 4 720 x 1280 frames (a ZED-like grid, one
    scaled past the border) on the card against the CPU: at most one level
    apart, never synchronizing."""
    K = torch.tensor([[530.0, 0, 640], [0, 530, 360], [0, 0, 1]])
    grid = undistort_map(K, torch.tensor([-0.05, 0.02, 1e-3, -1e-3, 0.0]), 720, 1280)
    grids = torch.stack([grid, grid * 1.1 - 10, grid + 3.5, grid])
    frames = torch.from_numpy(np.random.default_rng(61).integers(
        0, 256, size=(4, 720, 1280, 3), dtype=np.uint8))
    cpu = RemapTaps.from_maps(grids)(frames)
    taps = RemapTaps.from_maps(grids.to(cuda_device))
    on_card = frames.to(cuda_device)
    card = _never_syncs(lambda: taps(on_card))
    off = (card.cpu().int() - cpu.int()).abs()
    assert int(off.max()) <= 1 and float((off > 0).float().mean()) <= 1e-4


@pytest.mark.cuda
def test_triangulation_on_card_matches_cpu(cuda_device):
    """triangulate_keypoints through the SVD kernel (one launch) against
    LAPACK on the CPU, with zero-weight views: the points within 1e-3 m where
    2 or more views weigh (the far point aside: its depth is ill-conditioned)."""
    s = heatmap_rig_scene(seed=62, batch=16, views=4, joints=8)
    rng = np.random.default_rng(63)
    xy = s["xy"] + rng.normal(scale=0.05, size=s["xy"].shape).astype(np.float32)
    w = rng.uniform(0.2, 1.0, size=xy.shape[:-1]).astype(np.float32)
    w[:, :, 1] = 0.0  # no view
    w[:, 1:, 3] = 0.0  # one view
    w[:, 2:, 4] = 0.0  # two views
    args = [_t(a) for a in (xy, s["proj_mats"], w)]
    cpu = ttri.triangulate_keypoints(*args)
    on_card = [a.to(cuda_device) for a in args]
    before = small_svd.launches
    card = _never_syncs(lambda: ttri.triangulate_keypoints(*on_card))
    assert small_svd.launches - before == 1
    obs = (w > 0).sum(1) >= 2
    ok = obs & (np.abs(np32(cpu)).max(-1) < 50)
    assert ok.sum() >= 16 * 5
    np.testing.assert_allclose(np32(card)[ok], np32(cpu)[ok], atol=1e-3)


@pytest.mark.cuda
def test_geometric3d_head_on_card_matches_cpu(cuda_device):
    """The geometric3d head on the card (its DLT on the SVD kernel) against
    the CPU route on the same weights and planted heatmaps: angles 1e-4,
    never synchronizing."""
    scene = heatmap_rig_scene(seed=64, batch=2, views=4, joints=JOINTS)
    head = GeometricAngleHead(ANGLES, JOINTS, max_views=MAX_VIEWS, use_triangulation=True)
    head.load_state_dict(random_state(head, seed=65, scale=0.3))
    args = [_t(scene[k]) for k in ("heatmaps", "mask", "proj_mats")]
    with torch.no_grad():
        cpu = head.eval()(*args)
        card_head = head.to(cuda_device)
        on_card = [a.to(cuda_device) for a in args]
        card = _never_syncs(lambda: card_head(*on_card))
    np.testing.assert_allclose(np32(card), np32(cpu), rtol=1e-4, atol=1e-4)
