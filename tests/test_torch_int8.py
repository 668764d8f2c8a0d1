"""int8 serving: the port vs the reference's quantization, on the CPU.

Same numpy-seeded weights and inputs in both packages. What is compared, and
how closely:
  * the weight quantizer: bit for bit (a numpy copy of the reference's);
  * int8_matmul: the int8 activations and the int32 product exactly, the
    dequantized output to 1e-6 relative (f32 multiplies in the same order);
  * int8_prob_attention: within one quantization step of the values' channel,
    sv = max|v| / 127 (a probability or a value that lands on a rounding
    boundary in one package moves the output by at most that), plus one
    bf16 ulp for a bf16 output;
  * an int8 + fused-LN backbone and the multi-view estimator built on it,
    on JAX-quantized weights: bounds stated at each test.
The int8 attention kernels' checks against their plain versions are in
`test_torch_int8_attention.py` and `chip_smoke.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvropose_tpu.cli.main import _int8ify
from mvropose_tpu.decode import decode_keypoints as jax_decode_keypoints
from mvropose_tpu.models import EstimatorConfig as JaxEstimatorConfig
from mvropose_tpu.models import MultiViewPoseEstimator as JaxEstimator
from mvropose_tpu.models.quantize import int8_matmul as jax_int8_matmul
from mvropose_tpu.models.quantize import quantize_backbone_params
from mvropose_tpu.models.vit import ViTBackbone as JaxViT
from mvropose_tpu.models.vit import ViTConfig as JaxViTConfig
from mvropose_tpu.ops.attention import int8_prob_attention as jax_int8_attention
from mvropose_tpu.train.checkpoint import _flatten_names

from mvropose_torch.decode import decode_keypoints
from mvropose_torch.models import EstimatorConfig, MultiViewPoseEstimator
from mvropose_torch.models.quantize import (
    int8_matmul,
    quantize_backbone,
    quantize_kernel,
    quantize_rows,
)
from mvropose_torch.models.vit import ViTBackbone, ViTConfig
from mvropose_torch.ops import int8_attention
from mvropose_torch.ops.int8_attention import int8_prob_attention, int8_pv_reference
from mvropose_torch.utils.weights import export_jax_params, int8ify, load_jax_params
from torch_parity import export_npz, np32, random_variables

TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}
VIT = JaxViTConfig(image_size=64, patch_size=16, hidden_size=128, num_layers=2, num_heads=2,
                   fused_ln=True, dtype="float32")


def to_torch(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(np32(a)))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def float_backbone():
    """(float JAX ViT params, images) at hidden 128, 2 layers, 2 heads."""
    images = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda k: JaxViT(VIT).init(k, jnp.asarray(images)),
                            jax.random.PRNGKey(0))
    return random_variables(shapes, seed=1)["params"], images


def test_quantizer_is_bit_equal_to_jax(float_backbone):
    params, _ = float_backbone
    params = jax.tree_util.tree_map(np.array, params)
    # Planted halves: a column whose max is 127 has scale 1, so these land
    # exactly on .5 and must round half to even (0, 2, -2, 64, -4).
    fc1 = params["block_0"]["mlp"]["fc1"]["kernel"]
    fc1[:, 3] = 0.0
    fc1[:6, 3] = [127.0, 0.5, 1.5, -2.5, 63.5, -3.5]
    want = _flatten_names(quantize_backbone_params(params))
    got = quantize_backbone(_flatten_names(params))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    kq = got["block_0/mlp/fc1/kernel_q"][:6, 3]
    np.testing.assert_array_equal(kq, [127, 0, 2, -2, 64, -4])
    kq2, scale2 = quantize_kernel(fc1, in_dims=1)
    np.testing.assert_array_equal(kq2, got["block_0/mlp/fc1/kernel_q"])
    assert scale2[3] == np.float32(1.0)


def _jax_quantize_rows(x):
    """The activation quantization inside the reference's int8_matmul."""
    xf = x.astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-6) / 127.0
    return jnp.round(xf / sx).astype(jnp.int8), sx


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_matmul_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(3, 7, 64)), jnp.float32).astype(DTYPES[dtype])
    x = x.at[0, 0].set(0.0)  # an all-zero token: the 1e-6 scale floor
    kq, scale = quantize_kernel(rng.normal(size=(64, 48)).astype(np.float32), in_dims=1)
    bias = rng.normal(size=48).astype(np.float32)
    xq_want, sx_want = _jax_quantize_rows(x)
    prod_want = jax.lax.dot_general(xq_want, jnp.asarray(kq), (((2,), (0,)), ((), ())),
                                    preferred_element_type=jnp.int32)
    xt = to_torch(x, TORCH[DTYPES[dtype]])
    xq, sx = quantize_rows(xt)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_want))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(sx_want))
    prod = torch._int_mm(xq.reshape(-1, 64), torch.from_numpy(kq)).reshape(3, 7, 48)
    np.testing.assert_array_equal(prod.numpy(), np.asarray(prod_want))
    want = jax_int8_matmul(x, jnp.asarray(kq), jnp.asarray(scale), jnp.asarray(bias), jnp.float32)
    got = int8_matmul(xt, torch.from_numpy(kq), torch.from_numpy(scale),
                      torch.from_numpy(bias), torch.float32)
    np.testing.assert_allclose(got.numpy(), np32(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_prob_attention_matches_jax(dtype, masked):
    rng = np.random.default_rng(3)
    jdt = DTYPES[dtype]
    q, k, v = (jnp.asarray(s * rng.normal(size=(2, 37, 2, 64)), jnp.float32).astype(jdt)
               for s in (2.0, 2.0, 1.0))
    mask = rng.uniform(size=(2, 37)) > 0.3 if masked else None
    want = jax_int8_attention(q, k, v, key_mask=None if mask is None else jnp.asarray(mask))
    got = int8_prob_attention(*(to_torch(a, TORCH[jdt]) for a in (q, k, v)),
                              key_mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == TORCH[jdt] and got.shape == (2, 37, 2, 64)
    step = np.abs(np32(v)).max(axis=1) / 127.0  # (B, H, d): one value step
    bound = step[:, None]
    if dtype == "bf16":
        bound = bound + np.exp2(np.floor(np.log2(np.abs(np32(want)) + 1e-30)) - 7)
    gap = np.abs(np32(got) - np32(want))
    assert (gap <= bound).all(), (gap / bound).max()


def test_int8_pv_reference_sums_exactly():
    """With z = 1/127 (127 * z is exactly 1 in f32) and sv = 1 the output is
    the integer sums, rounded once to f32: equal to numpy's int64 sums at
    T = 1100, where T * 127**2 > 2**24."""
    T = 1100
    rng = np.random.default_rng(7)
    pq = rng.integers(0, 128, size=(2, T, T), dtype=np.int8)
    vq = rng.integers(-127, 128, size=(2, T, 64), dtype=np.int8)
    exact = np.einsum("bqk,bkd->bqd", pq.astype(np.int64), vq.astype(np.int64))
    z, sv = torch.full((2, T), 1.0 / 127.0), torch.ones(2, 64)
    assert (127.0 * z == 1.0).all()
    out = int8_pv_reference(torch.from_numpy(pq), torch.from_numpy(vq), z, sv, torch.float32)
    np.testing.assert_array_equal(out.numpy(), exact.astype(np.float32))


def _jax_int8_backbone(params, attn=True):
    cfg = dataclasses.replace(VIT, quant="int8", quant_attn="int8" if attn else None)
    qparams = jax.tree_util.tree_map(jnp.asarray, quantize_backbone_params(params))
    return JaxViT(cfg), {"params": qparams}, cfg


def test_int8_fused_ln_backbone_matches_jax(float_backbone, tmp_path):
    """quant="int8", quant_attn="int8", fused_ln=True, f32 compute, on the
    reference's quantized weights loaded through the bridge. Tokens within
    1e-3: the two packages' f32 sums differ in the last bits, which now and
    then moves an activation across an int8 rounding boundary (one step,
    ~1/127 of the token's max, in one of 128 channels)."""
    params, images = float_backbone
    jax_model, variables, cfg = _jax_int8_backbone(params)
    want = jax_model.apply(variables, jnp.asarray(images))
    model = ViTBackbone(ViTConfig(**dataclasses.asdict(cfg))).eval()
    load_jax_params(model, export_npz(variables, tmp_path / "q.npz"))
    assert model.block_1.mlp.fc2.kernel_q.dtype == torch.int8
    with torch.no_grad():
        got = model(to_torch(images).permute(0, 3, 1, 2))
    for key in ("patch_tokens", "cls_token"):
        np.testing.assert_allclose(np32(got[key]), np32(want[key]), atol=1e-3, rtol=1e-3,
                                   err_msg=key)


# The multi-view estimator on the int8 + fused-LN backbone, f32 compute.
EST = JaxEstimatorConfig(vit=dataclasses.replace(VIT, image_size=32), num_joints=4,
                         num_angles=3, heatmap_size=(32, 32), max_views=4,
                         num_fusion_queries=4, dtype="float32")


def test_int8_estimator_matches_jax(tmp_path):
    """`int8ify` on the float checkpoint against the reference's `_int8ify`:
    the same int8 leaves, heatmaps and angles within 1e-3 (as the serve
    slice's float tolerance), keypoints equal on maps whose top two values
    are 10x the gap apart."""
    model = JaxEstimator(EST)
    images = np.random.default_rng(4).normal(size=(1, 3, 32, 32, 3)).astype(np.float32)
    view_ids, mask = jnp.arange(3)[None], jnp.asarray([[True, False, True]])
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.asarray(images), view_ids, mask),
                            jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed=5)
    npz = export_npz(variables, tmp_path / "best_params.npz")
    qmodel, _, qvars = _int8ify(JaxEstimator, EST, variables, attn=True)
    hm_ref, ang_ref = qmodel.apply(qvars, jnp.asarray(images), view_ids, mask)
    xy_ref, _ = jax_decode_keypoints(hm_ref[0], use_pallas=False)

    port = MultiViewPoseEstimator(
        EstimatorConfig(vit=ViTConfig(**dataclasses.asdict(EST.vit)),
                        **{k: v for k, v in dataclasses.asdict(EST).items() if k != "vit"})
    ).eval()
    with np.load(npz) as data:
        flat = {k: data[k] for k in data.files}
    load_jax_params(port, flat)
    int8ify(port, flat, attn=True)
    assert port.cfg.vit.quant == "int8" and port.cfg.vit.quant_attn == "int8"
    got_leaves = export_jax_params(port)
    for name, leaf in _flatten_names(qvars["params"]).items():
        if "kernel_q" in name or name.endswith("/scale") and "/attn/" in name:
            np.testing.assert_array_equal(got_leaves[name], np.asarray(leaf), err_msg=name)
    with torch.no_grad():
        hm, ang = port(to_torch(images), torch.arange(3)[None], torch.from_numpy(np.array(mask)))
        xy, _ = decode_keypoints(hm[0])
    hm_ref = np32(hm_ref)
    gap = np.abs(np32(hm) - hm_ref).max()
    assert gap <= 1e-3, gap
    np.testing.assert_allclose(np32(ang), np32(ang_ref), atol=1e-3, rtol=1e-3)
    top2 = np.sort(hm_ref[0].reshape(3, 4, -1), axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 10 * gap
    assert clear.sum() >= 6, "too few maps with a clear peak to compare"
    np.testing.assert_array_equal(np32(xy)[clear], np32(xy_ref)[clear])


def test_cpu_tensors_take_the_plain_version():
    """The int8 attention on CPU tensors, f32 and bf16: the plain version,
    no kernel launched or counted."""
    def counters():
        return dict(int8_attention.width_launches), int8_attention.quantize_v_launches

    before = counters()
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(2, 5, 2, 64).to(dtype)
        out = int8_prob_attention(q, q, q)
        assert out.dtype == dtype and out.shape == (2, 5, 2, 64)
    assert counters() == before
