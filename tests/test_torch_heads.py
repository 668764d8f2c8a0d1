"""Stem, heads and fusion: the torch port vs the JAX reference, f32 on the CPU.

Each module gets numpy-seeded weights through the reference's flat
checkpoint file and the same inputs in both packages (NHWC for JAX, NCHW for
the port). Tolerance rtol/atol 1e-4: f32 convolutions, matmuls, softmax and
normalization statistics reduced in different orders; bilinear resizes
(antialiased on a shrink) agree to ~1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvropose_tpu.models.fusion import MultiViewFusion as JaxFusion
from mvropose_tpu.models.heads import (
    DecoderLayer as JaxDecoderLayer,
    JointAngleHead as JaxAngleHead,
    UNetViTKeypointHead as JaxUNet,
)
from mvropose_tpu.models.stem import LightCNNStem as JaxStem

from mvropose_torch.models.fusion import MultiViewFusion
from mvropose_torch.models.heads import DecoderLayer, JointAngleHead, UNetViTKeypointHead
from mvropose_torch.models.stem import LightCNNStem
from mvropose_torch.utils.weights import load_jax_params
from torch_parity import export_npz, np32, random_variables

F32 = jnp.float32
TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(jax_module, torch_module, jax_args, tmp_path):
    """Shared numpy-seeded weights: (jax variables, torch module in eval mode)."""
    shapes = jax.eval_shape(lambda k: jax_module.init(k, *jax_args), jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed=4)
    load_jax_params(torch_module, export_npz(variables, tmp_path / "p.npz"))
    return variables, torch_module.eval()


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def test_stem_matches_jax(tmp_path):
    images = np.random.default_rng(5).normal(size=(2, 32, 48, 3)).astype(np.float32)
    variables, stem = _pair(JaxStem(dtype=F32), LightCNNStem(torch.float32), (images,), tmp_path)
    want = JaxStem(dtype=F32).apply(variables, jnp.asarray(images))
    with torch.no_grad():
        got = stem(_nchw(images))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np32(g.permute(0, 2, 3, 1)), np32(w), **TOL)


# heatmap size, feat_8 and feat_4 sizes for a 4x4 token grid: the decoder
# reaches 16x16; "shrink" resizes mismatched skips (one up, one down) and
# shrinks the final map (antialiased).
HEAD_CASES = {
    "matching": ((32, 32), 8, 16),
    "shrink": ((24, 20), 6, 40),
}


@pytest.mark.parametrize("case", sorted(HEAD_CASES))
def test_unet_head_matches_jax(tmp_path, case):
    hm_size, s8, s4 = HEAD_CASES[case]
    rng = np.random.default_rng(6)
    tokens = rng.normal(size=(2, 16, 64)).astype(np.float32)
    feat_8 = rng.normal(size=(2, s8, s8, 64)).astype(np.float32)
    feat_4 = rng.normal(size=(2, s4, s4, 32)).astype(np.float32)
    jax_head = JaxUNet(5, hm_size, dtype=F32)
    args = (tokens, (4, 4), (feat_4, feat_8))
    variables, head = _pair(
        jax_head, UNetViTKeypointHead(64, 5, hm_size, torch.float32), args, tmp_path
    )
    want = jax_head.apply(variables, *args)
    with torch.no_grad():
        got = head(torch.from_numpy(tokens), (4, 4), (_nchw(feat_4), _nchw(feat_8)))
    assert got.shape == (2, 5, *hm_size)
    np.testing.assert_allclose(np32(got), np32(want), **TOL)


def test_decoder_layer_with_memory_mask_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    tgt = rng.normal(size=(2, 5, 64)).astype(np.float32)
    memory = rng.normal(size=(2, 12, 64)).astype(np.float32)
    key_mask = np.ones((2, 12), bool)
    key_mask[0, 4:] = False
    key_mask[1, :9] = False
    jax_layer = JaxDecoderLayer(8, dtype=F32)
    variables, layer = _pair(
        jax_layer, DecoderLayer(64, 8, torch.float32), (tgt, memory, key_mask[:, None, None, :]),
        tmp_path,
    )
    want = jax_layer.apply(variables, tgt, memory, memory_mask=key_mask[:, None, None, :])
    with torch.no_grad():
        got = layer(torch.from_numpy(tgt), torch.from_numpy(memory), torch.from_numpy(key_mask))
    np.testing.assert_allclose(np32(got), np32(want), **TOL)


def test_fusion_with_masked_view_matches_jax(tmp_path):
    rng = np.random.default_rng(8)
    tokens = rng.normal(size=(2, 3, 4, 64)).astype(np.float32)
    view_mask = np.array([[True, False, True], [True, True, True]])
    jax_fusion = JaxFusion(num_queries=6, dtype=F32)
    variables, fusion = _pair(
        jax_fusion, MultiViewFusion(64, 6, dtype=torch.float32), (tokens, view_mask), tmp_path
    )
    want = jax_fusion.apply(variables, tokens, view_mask)
    with torch.no_grad():
        got = fusion(torch.from_numpy(tokens), torch.from_numpy(view_mask))
        # The masked view is excluded exactly: its tokens do not matter.
        poked = tokens.copy()
        poked[0, 1] += 100.0
        got_poked = fusion(torch.from_numpy(poked), torch.from_numpy(view_mask))
    np.testing.assert_allclose(np32(got), np32(want), **TOL)
    np.testing.assert_array_equal(np32(got_poked), np32(got))


def test_joint_angle_head_matches_jax(tmp_path):
    memory = np.random.default_rng(9).normal(size=(2, 10, 64)).astype(np.float32)
    jax_head = JaxAngleHead(7, num_queries=4, dtype=F32)
    variables, head = _pair(
        jax_head, JointAngleHead(64, 7, num_queries=4, dtype=torch.float32), (memory,), tmp_path
    )
    want = jax_head.apply(variables, memory)
    with torch.no_grad():
        got = head(torch.from_numpy(memory))
    assert got.dtype == torch.float32 and got.shape == (2, 7)
    np.testing.assert_allclose(np32(got), np32(want), **TOL)
