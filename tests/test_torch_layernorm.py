"""Fused LayerNorm: the port vs the reference's Pallas kernels, on the CPU.

The reference's `fused_layernorm` / `fused_residual_layernorm` run in
interpret mode (as tests/test_ops.py runs them); the port's plain versions,
and a `fused_ln=True` ViT block, get the same numpy-seeded inputs.

Tolerances:
  * the residual output x + h: exact (one rounding of an exact f32 sum);
  * f32 outputs: 1e-5, except where the squares are not exact in f32 and
    the mean is large (50 + N(0, 1) in f32, or a residual sum): there
    E[x^2] - mean^2 cancels ~2500 down to ~1, and any two summation orders
    leave var apart by ~1e-3 relative, so 5e-3;
  * bf16 outputs: that tolerance plus one bf16 ulp of the larger of the two
    values, as the f32 results round to bf16 on either side now and then.
The large-mean inputs are where the reference's fast variance and torch's
two-pass LayerNorm differ (checked below), and where the bf16-rounded
residual sum that the port normalized before differs from the f32 sum.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvropose_tpu.models.vit import Block as JaxBlock
from mvropose_tpu.models.vit import ViTConfig as JaxViTConfig
from mvropose_tpu.ops.layernorm import fused_layernorm as jax_ln
from mvropose_tpu.ops.layernorm import fused_residual_layernorm as jax_res_ln

from mvropose_torch.models.vit import Block, ViTConfig
from mvropose_torch.ops import layernorm as ln_ops
from mvropose_torch.ops.layernorm import (
    fused_layernorm,
    fused_residual_layernorm,
    layernorm_reference,
    residual_layernorm_reference,
)
from mvropose_torch.utils.weights import load_jax_params
from torch_parity import export_npz, np32, random_variables

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# (input, output) dtype pairs: the blocks' norms (bf16 -> bf16), the final
# norm (bf16 -> f32) and the f32 model.
PAIRS = {"f32_f32": ("f32", "f32"), "bf16_bf16": ("bf16", "bf16"), "bf16_f32": ("bf16", "f32")}
INPUTS = {"normal": (0.5, 3.0), "large_mean": (50.0, 1.0)}  # x = mean + std * N(0, 1)


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def assert_close(got, want, out: str, exact_squares: bool = True):
    got, want = np32(got), np32(want)
    tol = 1e-5 if exact_squares else 5e-3
    if out == "bf16":
        gap = np.abs(got - want) - tol
        ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert (gap <= ulp).all(), f"{(gap / ulp).max():.2f} bf16 ulps apart beyond {tol}"
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _operands(kind: str, dtype: str, D: int = 256, seed: int = 0):
    """x, h (2, 37, D) rounded to `dtype`, f32 scale and bias, as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    mean, std = INPUTS[kind]
    jdt, tdt = DTYPES[dtype]
    x = jnp.asarray(mean + std * rng.standard_normal((2, 37, D)), jnp.float32).astype(jdt)
    h = jnp.asarray(rng.standard_normal((2, 37, D)), jnp.float32).astype(jdt)
    g = rng.uniform(0.5, 1.5, D).astype(np.float32)
    b = rng.uniform(-0.2, 0.2, D).astype(np.float32)
    to_torch = lambda a: torch.from_numpy(np32(a).copy()).to(tdt)  # noqa: E731
    return (x, h, jnp.asarray(g), jnp.asarray(b)), (to_torch(x), to_torch(h),
                                                    torch.from_numpy(g), torch.from_numpy(b))


@pytest.mark.parametrize("kind", sorted(INPUTS))
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_layernorm_matches_jax_kernel(pair, kind):
    inp, out = PAIRS[pair]
    (x, _, g, b), (xt, _, gt, bt) = _operands(kind, inp)
    want = jax_ln(x, g, b, eps=1e-6, out_dtype=DTYPES[out][0])
    got = fused_layernorm(xt, gt, bt, 1e-6, out_dtype=DTYPES[out][1])
    assert got.dtype == DTYPES[out][1]
    assert_close(got, want, out, exact_squares=not (kind == "large_mean" and inp == "f32"))
    if (kind, pair) == ("large_mean", "bf16_f32"):
        # The case tells fast from two-pass variance apart: torch's own
        # LayerNorm misses the reference by far more than the tolerance.
        two_pass = torch.nn.functional.layer_norm(xt.float(), (256,), gt, bt, 1e-6)
        assert np.abs(np32(two_pass) - np32(want)).max() > 10 * 1e-5


@pytest.mark.parametrize("kind", sorted(INPUTS))
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_residual_layernorm_matches_jax_kernel(pair, kind):
    inp, out = PAIRS[pair]
    (x, h, g, b), (xt, ht, gt, bt) = _operands(kind, inp, seed=1)
    want_x, want_y = jax_res_ln(x, h, g, b, eps=1e-6, out_dtype=DTYPES[out][0])
    got_x, got_y = fused_residual_layernorm(xt, ht, gt, bt, 1e-6, out_dtype=DTYPES[out][1])
    assert got_x.dtype == xt.dtype and got_y.dtype == DTYPES[out][1]
    np.testing.assert_array_equal(np32(got_x), np32(want_x))
    assert_close(got_y, want_y, out, exact_squares=kind == "normal")


def test_narrow_width_and_h_cast():
    """D = 192 (not the TPU's lane multiple) and an f32 h on a bf16 stream:
    h is cast to x's dtype before the sum, as the reference does."""
    (x, _, g, b), (xt, _, gt, bt) = _operands("normal", "bf16", D=192, seed=2)
    h = np.random.default_rng(3).standard_normal((2, 37, 192)).astype(np.float32)
    want_x, want_y = jax_res_ln(x, jnp.asarray(h), g, b, eps=1e-6)
    got_x, got_y = residual_layernorm_reference(xt, torch.from_numpy(h), gt, bt, 1e-6)
    np.testing.assert_array_equal(np32(got_x), np32(want_x))
    assert_close(got_y, want_y, "bf16")
    assert_close(layernorm_reference(xt, gt, bt, 1e-6), jax_ln(x, g, b, eps=1e-6), "bf16")


# The fused_ln block at hidden 128 (the reference's FusedLayerNorm needs a
# multiple of 128), LayerScale on.
BLOCK_CFG = JaxViTConfig(image_size=32, patch_size=16, hidden_size=128, num_layers=1,
                         num_heads=2, fused_ln=True)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_ln_block_matches_jax(tmp_path, dtype):
    """A `fused_ln=True` block on a residual stream of mean 50: the block's
    output and norm2's output (the MLP's input) against the reference's
    block. bf16: norm2's output within 0.03 (two bf16 ulps of the largest
    normalized values, |y| < 4; the attention branch, bf16 in both packages,
    moves the residual sum by ~1e-3 before the norm) and within 2e-3 on
    average; normalizing the bf16-rounded sum misses by ~0.17 and ~0.025.
    The block's output within one bf16 ulp. f32: 5e-3 (large-mean
    cancellation, see the module docstring)."""
    jdt, tdt = DTYPES[dtype]
    cfg = dataclasses.replace(BLOCK_CFG, dtype="float32" if dtype == "f32" else "bfloat16")
    x = jnp.asarray(50.0 + np.random.default_rng(4).standard_normal((2, 17, 128)),
                    jnp.float32).astype(jdt)
    jax_block = JaxBlock(cfg)
    shapes = jax.eval_shape(lambda k: jax_block.init(k, x), jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed=5)
    want, state = jax_block.apply(variables, x, capture_intermediates=True,
                                  mutable=["intermediates"])
    _, want_norm2 = state["intermediates"]["norm2"]["__call__"][0]

    block = Block(ViTConfig(**dataclasses.asdict(cfg))).eval()
    load_jax_params(block, export_npz(variables, tmp_path / "p.npz"))
    seen = []
    block.mlp.register_forward_pre_hook(lambda _m, args: seen.append(args[0]))
    with torch.no_grad():
        got = block(torch.from_numpy(np32(x).copy()).to(tdt))
    assert got.dtype == tdt and seen[0].dtype == tdt
    if dtype == "bf16":
        gap = np.abs(np32(seen[0]) - np32(want_norm2))
        assert gap.max() <= 0.03 and gap.mean() <= 2e-3, (gap.max(), gap.mean())
        gap = np.abs(np32(got) - np32(want))
        assert (gap <= _bf16_ulp(np.maximum(np.abs(np32(got)), np.abs(np32(want))))).all()
    else:
        np.testing.assert_allclose(np32(seen[0]), np32(want_norm2), rtol=5e-3, atol=5e-3)
        np.testing.assert_allclose(np32(got), np32(want), rtol=5e-3, atol=5e-3)


def test_cpu_tensors_take_the_plain_version():
    before = (ln_ops.launches, ln_ops.residual_launches)
    x, g, b = torch.ones(3, 8), torch.ones(8), torch.zeros(8)
    fused_layernorm(x, g, b)
    fused_residual_layernorm(x, x, g, b)
    assert (ln_ops.launches, ln_ops.residual_launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        ln_ops.layernorm_cuda(x, g, b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ln_ops.residual_layernorm_cuda(x, x, g, b)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the LayerNorm kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_launches_count_kernel_launches_only(cuda_device):
    """An empty input launches nothing and counts nothing; one launch counts one."""
    g, b = torch.ones(8, device=cuda_device), torch.zeros(8, device=cuda_device)
    before = (ln_ops.launches, ln_ops.residual_launches)
    empty = torch.empty(0, 8, dtype=torch.bfloat16, device=cuda_device)
    assert ln_ops.layernorm_cuda(empty, g, b).shape == (0, 8)
    assert all(t.shape == (0, 8) for t in ln_ops.residual_layernorm_cuda(empty, empty, g, b))
    assert (ln_ops.launches, ln_ops.residual_launches) == before
    x = torch.ones(2, 8, dtype=torch.bfloat16, device=cuda_device)
    ln_ops.layernorm_cuda(x, g, b)
    ln_ops.residual_layernorm_cuda(x, x, g, b)
    assert (ln_ops.launches, ln_ops.residual_launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [768, 192, 100])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_kernels_match_plain_on_card(cuda_device, pair, D):
    """Kernel vs plain version on the card: f32 outputs 1e-5, bf16 within one
    bf16 ulp, the residual exact. D = 100 takes the scalar tail."""
    inp, out = (DTYPES[d][1] for d in PAIRS[pair])
    gen = torch.Generator().manual_seed(7)
    x = (0.5 + 3.0 * torch.randn(37, D, generator=gen)).to(inp).to(cuda_device)
    h = torch.randn(37, D, generator=gen).to(inp).to(cuda_device)
    g = (1.0 + 0.1 * torch.randn(D, generator=gen)).to(cuda_device)
    b = (0.1 * torch.randn(D, generator=gen)).to(cuda_device)
    got = ln_ops.layernorm_cuda(x, g, b, 1e-6, out)
    got_x, got_y = ln_ops.residual_layernorm_cuda(x, h, g, b, 1e-6, out)
    torch.cuda.synchronize()
    assert torch.equal(got_x, residual_layernorm_reference(x, h, g, b, 1e-6, out)[0])
    name = "bf16" if out == torch.bfloat16 else "f32"
    assert_close(got, layernorm_reference(x, g, b, 1e-6, out), name)
    assert_close(got_y, residual_layernorm_reference(x, h, g, b, 1e-6, out)[1], name)
