"""DINO checkpoints in the port (`models/dino_convert.py`) against the JAX
package's converter and graft, on the CPU.

Same numpy-seeded state dicts in both packages, with the real names and
shapes of each scheme, saved in the formats the graft reads:
  * timm (`.pth`), HF DINOv2 (`.npz`) and HF DINOv3 (`.bin`, RoPE, no
    pos_embed, biasless k) grafted into a bare backbone: the port's tokens
    and the reference's (`convert_dino_state_dict` + `_graft_backbone_ckpt`)
    within 1e-5 (f32 on both sides; the same operations in another order);
  * a config the checkpoint does not fit: both packages refuse it with the
    same message, the port's naming its own tensors;
  * `runs/synth_sv_frozen/dino_192x4.npz` (HF DINOv2, 4 heads of 48) in the
    synthetic trainer's single-view estimator against the reference's with
    the same weights: float heatmaps and angles within 1e-4, and under
    `--int8-backbone --int8-attention` (each package's int8ify on its own
    graft) heatmaps within 1e-3, the int8 estimator test's bound
    (`test_torch_int8.py`), angles within INT8_ANGLE_TOL (see the test).
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvropose_tpu.cli.main import _graft_backbone_ckpt, _int8ify
from mvropose_tpu.models import EstimatorConfig as JaxEstimatorConfig
from mvropose_tpu.models import SingleViewPoseEstimator as JaxSingleView
from mvropose_tpu.models.vit import ViTBackbone as JaxViT
from mvropose_tpu.models.vit import ViTConfig as JaxViTConfig

from mvropose_torch.models import EstimatorConfig, SingleViewPoseEstimator
from mvropose_torch.models.dino_convert import (
    convert_dino_state_dict,
    graft_backbone_ckpt,
    is_dinov3_state_dict,
    load_torch_checkpoint,
)
from mvropose_torch.models.vit import ViTBackbone, ViTConfig
from mvropose_torch.utils.weights import int8ify, load_jax_params
from test_dino_convert import make_timm_state_dict
from torch_parity import export_npz, np32, random_variables

DINO_192X4 = Path(__file__).resolve().parents[1] / "runs" / "synth_sv_frozen" / "dino_192x4.npz"
VIT = dict(image_size=32, patch_size=8, hidden_size=48, num_layers=2, num_heads=2,
           num_register_tokens=2, layerscale_init=1e-5, dtype="float32")
ROPE = dict(VIT, use_rope=True, layer_norm_eps=1e-5)


def _hf_dinov2(sd: dict) -> dict:
    """A timm state dict in HF Dinov2 naming (separate q/k/v, layer_scale,
    `layernorm`, a mask token)."""
    out = {"embeddings.mask_token": np.zeros((1, sd["cls_token"].shape[-1]))}
    for k, v in sd.items():
        if ".attn.qkv." in k:
            pre, kind = k.split("attn.qkv.")
            pre = pre.replace("blocks.", "encoder.layer.")
            for name, part in zip(("query", "key", "value"), np.split(v, 3, axis=0)):
                out[f"{pre}attention.attention.{name}.{kind}"] = part
            continue
        n = k.replace("blocks.", "encoder.layer.").replace("attn.proj.", "attention.output.dense.")
        n = n.replace("ls1.gamma", "layer_scale1.lambda1")
        n = n.replace("ls2.gamma", "layer_scale2.lambda1")
        n = {"cls_token": "embeddings.cls_token", "reg_token": "embeddings.register_tokens",
             "pos_embed": "embeddings.position_embeddings"}.get(n, n)
        n = n.replace("patch_embed.proj.", "embeddings.patch_embeddings.projection.")
        n = n.replace("norm.weight", "layernorm.weight") if n.startswith("norm.") else n
        n = n.replace("norm.bias", "layernorm.bias") if n.startswith("norm.") else n
        out[n] = v
    return out


def _hf_dinov3(rng, cfg: dict) -> dict:
    """A seeded HF DINOv3ViTModel state dict (transformers' dinov3_vit names:
    q/k/v/o projections, k without bias, up/down MLP, no position embedding)."""
    D, p, R = cfg["hidden_size"], cfg["patch_size"], cfg["num_register_tokens"]
    w = lambda *s: rng.normal(size=s) * 0.05  # noqa: E731
    sd = {"embeddings.cls_token": w(1, 1, D), "embeddings.mask_token": w(1, 1, D),
          "embeddings.register_tokens": w(1, R, D),
          "embeddings.patch_embeddings.weight": w(D, 3, p, p),
          "embeddings.patch_embeddings.bias": w(D),
          "norm.weight": rng.uniform(0.5, 1.5, size=D), "norm.bias": w(D)}
    for i in range(cfg["num_layers"]):
        pre = f"layer.{i}."
        for n in ("norm1", "norm2"):
            sd[pre + f"{n}.weight"], sd[pre + f"{n}.bias"] = rng.uniform(0.5, 1.5, size=D), w(D)
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[pre + f"attention.{n}.weight"] = w(D, D)
            if n != "k_proj":
                sd[pre + f"attention.{n}.bias"] = w(D)
        sd[pre + "layer_scale1.lambda1"] = rng.uniform(0.05, 0.15, size=D)
        sd[pre + "layer_scale2.lambda1"] = rng.uniform(0.05, 0.15, size=D)
        sd[pre + "mlp.up_proj.weight"], sd[pre + "mlp.up_proj.bias"] = w(4 * D, D), w(4 * D)
        sd[pre + "mlp.down_proj.weight"], sd[pre + "mlp.down_proj.bias"] = w(D, 4 * D), w(D)
    return sd


def _save(sd: dict, path: Path) -> Path:
    if path.suffix == ".npz":
        np.savez(path, **sd)
    else:
        torch.save({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}, path)
    return path


def _checkpoint(scheme: str, tmp_path: Path) -> tuple:
    """(checkpoint file, the config it fits) of one naming scheme."""
    rng = np.random.default_rng(7)
    if scheme == "hf_dinov3":
        return _save(_hf_dinov3(rng, ROPE), tmp_path / "dinov3.bin"), ROPE
    sd = {k: np.asarray(v, np.float32)
          for k, v in make_timm_state_dict(rng, JaxViTConfig(**VIT)).items()}
    if scheme == "timm":
        return _save(sd, tmp_path / "timm.pth"), VIT
    return _save(_hf_dinov2(sd), tmp_path / "dinov2.npz"), VIT


def _jax_grafted(path: Path, cfg: dict):
    """The reference's graft into a bare backbone -> (model, variables)."""
    model = JaxViT(JaxViTConfig(**cfg))
    size = cfg["image_size"]
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, size, size, 3))),
                            jax.random.PRNGKey(0))
    variables = _graft_backbone_ckpt({"params": {"backbone": shapes["params"]}}, path,
                                     JaxViTConfig(**cfg))
    return model, {"params": variables["params"]["backbone"]}


def _port_grafted(path: Path, cfg: dict) -> ViTBackbone:
    model = ViTBackbone(ViTConfig(**cfg)).eval()
    graft_backbone_ckpt(model, path)
    return model


@pytest.mark.parametrize("scheme", ["timm", "hf_dinov2", "hf_dinov3"])
def test_grafted_backbone_matches_jax(scheme, tmp_path):
    path, cfg = _checkpoint(scheme, tmp_path)
    assert is_dinov3_state_dict(load_torch_checkpoint(path)) == (scheme == "hf_dinov3")
    jax_model, variables = _jax_grafted(path, cfg)
    model = _port_grafted(path, cfg)
    images = np.random.default_rng(8).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = jax_model.apply(variables, jnp.asarray(images))
    with torch.no_grad():
        got = model(torch.from_numpy(images).permute(0, 3, 1, 2))
    for key in ("cls_token", "register_tokens", "patch_tokens"):
        np.testing.assert_allclose(np32(got[key]), np32(want[key]), atol=1e-5, rtol=1e-5,
                                   err_msg=key)


def test_naming_schemes_convert_alike(tmp_path):
    """timm's fused qkv and HF's separate q/k/v give the same arrays; a
    checkpoint layer past the config's depth is not read, as in the reference."""
    timm, _ = _checkpoint("timm", tmp_path)
    hf, _ = _checkpoint("hf_dinov2", tmp_path)
    a = convert_dino_state_dict(load_torch_checkpoint(timm), 2, 2, 48)
    b = convert_dino_state_dict(load_torch_checkpoint(hf), 2, 2, 48)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not any(k.startswith("block_1.") for k in
                   convert_dino_state_dict(load_torch_checkpoint(timm), 1, 2, 48))


# Configs the timm checkpoint (VIT) does not fit, each refused by both packages.
MISMATCHES = {
    "no_layerscale": dict(VIT, layerscale_init=None),  # the checkpoint's ls1/ls2 left over
    "other_grid": dict(VIT, image_size=48),  # pos_embed (1, 17, D) against (1, 37, D)
    "no_registers": dict(VIT, num_register_tokens=0),
    "rope": dict(VIT, use_rope=True),  # a RoPE model has no pos_embed
}


@pytest.mark.parametrize("case", list(MISMATCHES))
def test_mismatched_config_is_refused_as_the_reference_refuses_it(case, tmp_path):
    path, _ = _checkpoint("timm", tmp_path)
    cfg = MISMATCHES[case]
    with pytest.raises(ValueError) as ref:
        _jax_grafted(path, cfg)
    with pytest.raises(ValueError) as port:
        _port_grafted(path, cfg)
    ref_msg, port_msg = str(ref.value), str(port.value)
    kind = re.match(r"backbone checkpoint (structure|shape) mismatch", ref_msg)
    assert kind and port_msg.startswith(kind.group()), (port_msg, ref_msg)
    # The hint after the names (structure), or the shapes (shape), alike.
    assert port_msg.split(" (check")[1:] == ref_msg.split(" (check")[1:]
    if kind.group(1) == "shape":
        assert port_msg.rsplit(": ", 1)[1] == ref_msg.rsplit(": ", 1)[1]


def test_gated_dinov3_checkpoints_are_refused():
    sd = {"layer.0.attention.q_proj.weight": np.zeros((8, 8), np.float32),
          "layer.0.mlp.gate_proj.weight": np.zeros((16, 8), np.float32)}
    with pytest.raises(NotImplementedError, match="gated"):
        convert_dino_state_dict(sd, 1, 1, 8)


# The synthetic trainer's single-view model (scripts/train_synthetic.py:49-54)
# with the DINO checkpoint's LayerScale: 192 wide, 4 layers, 4 heads of 48, fr5.
EST = JaxEstimatorConfig(
    vit=JaxViTConfig(image_size=128, patch_size=16, hidden_size=192, num_layers=4,
                     num_heads=4, layerscale_init=1e-5, dtype="float32"),
    num_joints=7, num_angles=6, heatmap_size=(64, 64), max_views=4, num_fusion_queries=8,
    num_angle_queries=4, dtype="float32")


@pytest.fixture(scope="module")
def dino_estimators(tmp_path_factory):
    """(reference variables with the DINO graft, their float heatmaps and
    angles, the port's model with its own graft into the same random heads,
    images)."""
    tmp = tmp_path_factory.mktemp("dino")
    model = JaxSingleView(EST)
    images = np.random.default_rng(9).uniform(-2, 2, size=(2, 128, 128, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.asarray(images)), jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed=10)
    port = SingleViewPoseEstimator(EstimatorConfig(
        vit=ViTConfig(**dataclasses.asdict(EST.vit)),
        **{k: v for k, v in dataclasses.asdict(EST).items() if k != "vit"})).eval()
    load_jax_params(port, export_npz(variables, tmp / "random.npz"))
    graft_backbone_ckpt(port.backbone, DINO_192X4)
    variables = _graft_backbone_ckpt(variables, DINO_192X4, EST.vit)
    return variables, jax.jit(model.apply)(variables, jnp.asarray(images)), port, images


def test_dino_192x4_estimator_matches_jax(dino_estimators):
    _, (hm_ref, ang_ref), port, images = dino_estimators
    assert port.backbone.cfg.num_heads == 4 and port.backbone.cfg.hidden_size // 4 == 48
    with torch.no_grad():
        hm, ang = port(torch.from_numpy(images))
    np.testing.assert_allclose(np32(hm), np32(hm_ref), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np32(ang), np32(ang_ref), atol=1e-4, rtol=1e-4)


# The int8 angles' bound: 1.2 x the largest gap between the packages over
# six draws of images and heads (image seeds 9, 1, 2, 3, 4, 5 with head
# seeds one above; the fixture's is the first): 2.06e-3, 1.77e-3, 1.50e-3,
# 1.85e-3, 1.01e-3, 1.95e-3.
INT8_ANGLE_TOL = 2.5e-3


def test_dino_192x4_int8_estimator_matches_jax(dino_estimators):
    """`--int8-backbone --int8-attention` on the grafted estimator: the
    int8 attention at d = 48 in both packages (the plain version here).
    Heatmaps within 1e-3. Angles (up to 1.56 here, 0.72 on average) within
    INT8_ANGLE_TOL: the packages' f32 sums differ in their last bits, which
    now and then moves an activation across an int8 rounding boundary in one
    and not the other, and the angle head reads every token of the backbone,
    so their gap (2.06e-3 here) is wider than the heatmaps' (3.1e-4). The
    quantization's own change of the angles here (4.1e-3; 2.5e-3 to 7.5e-3
    over the six draws) is asserted to exceed the bound, so a port whose
    angles missed the int8 path would fail on this draw."""
    variables, (_, ang_float), port, images = dino_estimators
    qmodel, _, qvars = _int8ify(JaxSingleView, EST, variables, attn=True)
    hm_ref, ang_ref = jax.jit(qmodel.apply)(qvars, jnp.asarray(images))
    int8ify(port, attn=True)
    assert port.cfg.vit.quant == "int8" and port.cfg.vit.quant_attn == "int8"
    with torch.no_grad():
        hm, ang = port(torch.from_numpy(images))
    np.testing.assert_allclose(np32(hm), np32(hm_ref), atol=1e-3, rtol=1e-3)
    assert np.abs(np32(ang_ref) - np32(ang_float)).max() > INT8_ANGLE_TOL
    np.testing.assert_allclose(np32(ang), np32(ang_ref), atol=INT8_ANGLE_TOL, rtol=0)
