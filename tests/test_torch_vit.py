"""ViT backbone: the torch port vs the JAX reference, in f32 on the CPU.

Same numpy-seeded weights (through the reference's flat checkpoint file) and
the same images go through both. Tolerance rtol/atol 1e-4 on the normalized
tokens: the two frameworks reduce the f32 matmuls, softmax and LayerNorm
statistics in different orders (and flax computes the variance as
E[x^2] - mean^2), which moves O(1) tokens by ~1e-6 per layer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvropose_tpu.models.vit import VIT_TINY_TEST, ViTBackbone as JaxViT

from mvropose_torch.models.vit import ViTBackbone, ViTConfig, _torch_bicubic_matrix
from mvropose_torch.utils.weights import load_jax_params
from torch_parity import export_npz, np32, random_variables

VARIANTS = {
    "plain": {},
    "registers_layerscale": {"num_register_tokens": 2, "layerscale_init": 1e-5},
    "rope": {"use_rope": True, "num_register_tokens": 1, "layer_norm_eps": 1e-5},
}
# (H, W) inputs: the config grid (4x4), and a rectangular grid (6x3) that
# needs the bicubic position-embedding interpolation.
INPUTS = {"config_grid": (64, 64), "other_grid": (96, 48)}


@pytest.fixture(scope="module")
def backbones(tmp_path_factory):
    """{variant: (jax model, jax variables, torch model)} with shared weights."""
    out = {}
    for name, overrides in VARIANTS.items():
        cfg = dataclasses.replace(VIT_TINY_TEST, **overrides)
        jax_model = JaxViT(cfg)
        shapes = jax.eval_shape(
            lambda k: jax_model.init(k, jnp.zeros((1, 64, 64, 3))), jax.random.PRNGKey(0)
        )
        variables = random_variables(shapes, seed=1)
        model = ViTBackbone(ViTConfig(**dataclasses.asdict(cfg))).eval()
        load_jax_params(model, export_npz(variables, tmp_path_factory.mktemp(name) / "p.npz"))
        out[name] = (jax_model, variables, model)
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("grid", sorted(INPUTS))
def test_backbone_tokens_match_jax(backbones, variant, grid):
    jax_model, variables, model = backbones[variant]
    H, W = INPUTS[grid]
    images = np.random.default_rng(2).normal(size=(2, H, W, 3)).astype(np.float32)
    want = jax_model.apply(variables, jnp.asarray(images))
    with torch.no_grad():
        got = model(torch.from_numpy(images).permute(0, 3, 1, 2))
    assert got["grid_hw"] == tuple(want["grid_hw"])
    for key in ("patch_tokens", "cls_token", "register_tokens"):
        np.testing.assert_allclose(
            np32(got[key]), np32(want[key]), rtol=1e-4, atol=1e-4, err_msg=key
        )


def test_bicubic_matrix_reproduces_torch_interpolate():
    """The copied resize matrix is torch's own bicubic: applying it equals
    F.interpolate(mode="bicubic", align_corners=False) on a grid."""
    grid = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 5, 4, 4)).astype(np.float32))
    want = torch.nn.functional.interpolate(grid, size=(6, 3), mode="bicubic", align_corners=False)
    Mh = torch.from_numpy(_torch_bicubic_matrix(4, 6)).float()
    Mw = torch.from_numpy(_torch_bicubic_matrix(4, 3)).float()
    got = torch.einsum("Hh,bchw,Ww->bcHW", Mh, grid, Mw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
