"""The weight bridge (`load_jax_params`, `export_jax_params`) and seeded random weights.

A random JAX multi-view estimator is exported with the reference's own
`save_params_npz`; the port must consume every leaf, fill every parameter
and buffer, and map each layout exactly (values compared bit for bit), and
its export must give the same file back.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvropose_tpu.models import EstimatorConfig as JaxEstimatorConfig
from mvropose_tpu.models import MultiViewPoseEstimator as JaxEstimator
from mvropose_tpu.models.vit import ViTConfig as JaxViTConfig

from mvropose_torch.models import EstimatorConfig, MultiViewPoseEstimator, ViTConfig
from mvropose_torch.utils.weights import (
    export_jax_params,
    int8ify,
    load_jax_params,
    plan_jax_params,
    random_state,
)
from torch_parity import export_npz, random_variables

JAX_CFG = JaxEstimatorConfig(
    vit=JaxViTConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2, num_heads=4,
                     num_register_tokens=1, dtype="float32"),
    num_joints=4, num_angles=3, heatmap_size=(32, 32), max_views=4, num_fusion_queries=4,
    dtype="float32",
)


def port_config(cfg, **overrides) -> EstimatorConfig:
    d = dataclasses.asdict(cfg)
    vit = ViTConfig(**d.pop("vit"))
    return EstimatorConfig(vit=vit, **{**d, **overrides})


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(flat name -> array dict, npz path) of a random JAX estimator."""
    model = JaxEstimator(JAX_CFG)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, 2, 32, 32, 3)), jnp.zeros((1, 2), jnp.int32),
                             jnp.ones((1, 2), bool)),
        jax.random.PRNGKey(0),
    )
    path = export_npz(random_variables(shapes, seed=3), tmp_path_factory.mktemp("w") / "p.npz")
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return flat, path


def test_every_leaf_fills_one_tensor(exported):
    flat, path = exported
    model = MultiViewPoseEstimator(port_config(JAX_CFG))
    plan = plan_jax_params(model, flat)
    assert len(plan) == len(flat)
    state = {n: t for n, t in model.state_dict().items() if not n.endswith("num_batches_tracked")}
    assert set(plan) == set(state)
    load_jax_params(model, path)
    sd = model.state_dict()
    kernel = flat["backbone/block_1/attn/query/kernel"]  # (D, H, dh)
    np.testing.assert_array_equal(sd["backbone.block_1.attn.query.weight"].numpy(), kernel.reshape(64, 64).T)
    out = flat["backbone/block_0/attn/out/kernel"]  # (H, dh, D)
    np.testing.assert_array_equal(sd["backbone.block_0.attn.out.weight"].numpy(), out.reshape(64, 64).T)
    np.testing.assert_array_equal(
        sd["backbone.block_0.attn.key.bias"].numpy(), flat["backbone/block_0/attn/key/bias"].reshape(-1)
    )
    np.testing.assert_array_equal(
        sd["cnn_stem.conv2.conv.weight"].numpy(),
        flat["cnn_stem/conv2/Conv_0/kernel"].transpose(3, 2, 0, 1),
    )
    np.testing.assert_array_equal(
        sd["cnn_stem.conv2.bn.running_var"].numpy(), flat["batch_stats/cnn_stem/conv2/BatchNorm_0/var"]
    )
    np.testing.assert_array_equal(
        sd["angle_head.mlp_fc1.weight"].numpy(), flat["angle_head/mlp_fc1/kernel"].T
    )
    np.testing.assert_array_equal(
        sd["view_embeddings.weight"].numpy(), flat["view_embeddings/embedding"]
    )
    np.testing.assert_array_equal(sd["backbone.pos_embed"].numpy(), flat["backbone/pos_embed"])


def test_dict_and_path_load_the_same(exported):
    flat, path = exported
    a = MultiViewPoseEstimator(port_config(JAX_CFG))
    b = MultiViewPoseEstimator(port_config(JAX_CFG))
    load_jax_params(a, flat)
    load_jax_params(b, path)
    for (n, ta), tb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(ta, tb), n


def test_bf16_model_holds_the_rounded_weights(exported):
    """A bf16 model stores the checkpoint's f32 weights exactly, as flax's
    param_dtype does, and computes with their bf16 rounding: each layer
    casts its weights at use."""
    flat, _ = exported
    model = MultiViewPoseEstimator(port_config(JAX_CFG, dtype="bfloat16"))
    load_jax_params(model, flat)
    layer = model.fusion_module.layer_0.ffn1
    want = torch.from_numpy(flat["fusion_module/layer_0/ffn1/kernel"].T.copy())
    bias = torch.from_numpy(flat["fusion_module/layer_0/ffn1/bias"].copy())
    assert layer.weight.dtype == torch.float32 and torch.equal(layer.weight, want)
    x = torch.randn(3, layer.in_features, generator=torch.Generator().manual_seed(0))
    bf16 = torch.bfloat16
    got = layer(x)
    assert got.dtype == bf16
    assert torch.equal(got, torch.nn.functional.linear(x.to(bf16), want.to(bf16), bias.to(bf16)))
    assert model.fusion_module.layer_0.norm1.weight.dtype == torch.float32  # norms stay f32


def _mutated(flat, **changes):
    out = dict(flat)
    for k, v in changes.items():
        if v is None:
            out.pop(k)
        else:
            out[k] = v
    return out


@pytest.mark.parametrize(
    "kind",
    ["extra_leaf", "missing_leaf", "wrong_shape", "partial_batch_stats", "no_batch_stats"],
)
def test_strict_both_ways(exported, kind):
    flat, _ = exported
    model = MultiViewPoseEstimator(port_config(JAX_CFG))
    stats = [k for k in flat if k.startswith("batch_stats/")]
    bad, error, match = {
        "extra_leaf": (_mutated(flat, **{"backbone/extra/kernel": np.zeros((2, 2))}), KeyError, "no module"),
        "missing_leaf": (_mutated(flat, **{"keypoint_head/heatmap_predictor/bias": None}), KeyError, "no checkpoint leaf"),
        "wrong_shape": (_mutated(flat, **{"backbone/cls_token": np.zeros((1, 1, 32), np.float32)}), ValueError, "cls_token"),
        "partial_batch_stats": ({k: v for k, v in flat.items() if k != stats[0]}, KeyError, "partially"),
        "no_batch_stats": ({k: v for k, v in flat.items() if k not in stats}, KeyError, "no checkpoint leaf"),
    }[kind]
    with pytest.raises(error, match=match):
        load_jax_params(model, bad)


def test_random_state_is_seeded_and_shared_across_dtypes():
    f32 = MultiViewPoseEstimator(port_config(JAX_CFG))
    bf16 = MultiViewPoseEstimator(port_config(JAX_CFG, dtype="bfloat16"))
    a, b, c = random_state(f32, seed=0), random_state(bf16, seed=0), random_state(f32, seed=1)
    assert list(a) == list(f32.state_dict())
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert not torch.equal(a["backbone.cls_token"], c["backbone.cls_token"])
    w = a["backbone.block_0.mlp.fc1.weight"]
    assert abs(float(w.std()) - 0.02) < 0.002 and abs(float(w.mean())) < 0.002
    var = a["cnn_stem.conv1.bn.running_var"]
    assert torch.all((var - 1.0).abs() < 0.2)
    bf16.load_state_dict(b)
    ffn1 = bf16.fusion_module.layer_0.ffn1.weight
    assert ffn1.dtype == torch.float32  # f32 storage; cast to bf16 at use
    assert torch.equal(ffn1, a["fusion_module.layer_0.ffn1.weight"])


def test_export_is_the_inverse_of_the_bridge(exported):
    """export(load(flat)) gives back the reference's file: the same names,
    shapes (DenseGeneral kernels 3-D again) and values, bit for bit."""
    flat, _ = exported
    model = MultiViewPoseEstimator(port_config(JAX_CFG))
    load_jax_params(model, flat)
    back = export_jax_params(model)
    assert sorted(back) == sorted(flat)
    for name, arr in flat.items():
        assert back[name].shape == arr.shape, name
        np.testing.assert_array_equal(back[name], arr, err_msg=name)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_load_of_export_is_the_identity(exported, quant):
    """load(export(model)) fills a fresh model with every tensor equal, for a
    float model and for one with an int8 backbone (`kernel_q`, `scale`, flat
    `bias` leaves)."""
    flat, _ = exported
    cfg = port_config(JAX_CFG)
    if quant:
        cfg = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, quant=quant,
                                                               quant_attn="int8"))
    model = MultiViewPoseEstimator(port_config(JAX_CFG))
    load_jax_params(model, flat)
    if quant:
        int8ify(model, flat, attn=True)
        assert model.backbone.block_0.attn.query.kernel_q.dtype == torch.int8
    out = export_jax_params(model)
    if quant:
        assert out["backbone/block_0/attn/out/kernel_q"].shape == (64, 64)
        assert "backbone/block_0/attn/out/kernel" not in out
    fresh = MultiViewPoseEstimator(cfg)
    load_jax_params(fresh, out)
    for (n, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a, b), n


def test_int8_layout_is_strict(exported):
    """A float checkpoint does not load into an int8 model (its first
    quantized leaf is a (H, dh) bias or a `kernel` with no place), nor the
    reverse."""
    flat, _ = exported
    f32 = port_config(JAX_CFG)
    q = dataclasses.replace(f32, vit=dataclasses.replace(f32.vit, quant="int8"))
    with pytest.raises((KeyError, ValueError), match="backbone/block_0/(attn|mlp)/"):
        load_jax_params(MultiViewPoseEstimator(q), flat)
    model = MultiViewPoseEstimator(f32)
    load_jax_params(model, flat)
    int8ify(model, flat)
    with pytest.raises(KeyError, match="backbone/block_0/(attn|mlp)/.*(kernel_q|scale)"):
        load_jax_params(MultiViewPoseEstimator(f32), export_jax_params(model))
