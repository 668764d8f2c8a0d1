"""The int8 serve step's quantizations, on the CPU: the LayerNorm entries
that write the per-token int8 pair, the int8 + fused-LN block that reads it,
and the division that the three quantization kernels share.

What is compared, and how closely:
  * the division: the kernels' Markstein steps (csrc/int8_quantize.cuh),
    emulated in numpy with an exact f32 fma, against f32 true division,
    value by value: equal wherever |x| >= s / 4, and rint of both equal
    everywhere, on random values and on quotients planted at and next to
    f32 midpoints and half-integers (where one product with the reciprocal
    rounds apart);
  * `fused_layernorm_int8` and `fused_residual_layernorm_int8` on the CPU:
    bit for bit `layernorm_reference` / `residual_layernorm_reference` then
    `quantize_rows`, bf16 and f32; against the reference's chain (its Pallas
    LayerNorms in interpret mode, then `int8_matmul`'s s_x and x_q lines in
    jnp): those lines on the port's LayerNorm output bit for bit, the
    LayerNorm outputs within `test_torch_layernorm.py`'s bounds (the two
    packages' f32 sums differ in the last bits), x_q within one step;
  * an int8 + fused-LN `Block`: bit for bit the composition it replaces
    (LayerNorm, then `Int8Linear.quantize` for q/k/v; residual LayerNorm,
    then fc1's own quantization), each int8 LayerNorm entry called once and
    `quantize_rows` only for out and fc2;
  * the entries' route, `int8_mm_route` without a Dout.
The kernels against their plain versions on the card carry the `cuda`
marker and skip without a card (`chip_smoke.py` runs the same checks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvropose_tpu.ops.layernorm import fused_layernorm as jax_ln
from mvropose_tpu.ops.layernorm import fused_residual_layernorm as jax_res_ln

from mvropose_torch.models import quantize, vit
from mvropose_torch.models.quantize import Int8Linear
from mvropose_torch.models.vit import Block, ViTConfig
from mvropose_torch.ops import int8_attention
from mvropose_torch.ops import int8_matmul as int8_mm
from mvropose_torch.ops import layernorm as ln_ops
from mvropose_torch.ops.int8_matmul import int8_mm_route, int_mm_route, quantize_rows
from mvropose_torch.ops.layernorm import (
    fused_layernorm,
    fused_layernorm_int8,
    fused_residual_layernorm,
    fused_residual_layernorm_int8,
    layernorm_reference,
    residual_layernorm_reference,
)
from torch_parity import np32

F32, F64 = np.float32, np.float64
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
PAIRS = {"f32_f32": ("f32", "f32"), "bf16_bf16": ("bf16", "bf16"), "bf16_f32": ("bf16", "f32")}

# ------------------------------------------------------------------ division


def fma32(a, b, c) -> np.ndarray:
    """f32 fma(a, b, c), one rounding: a b is exact in f64 and a two-sum keeps
    the error of the f64 sum, which settles the f32 rounding at a midpoint."""
    a, b, c = (np.asarray(v, F32).astype(F64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    f = s.astype(F32)
    other = np.where(f.astype(F64) < s, np.nextafter(f, F32(np.inf)),
                     np.nextafter(f, F32(-np.inf)))
    at_mid = (s == (f.astype(F64) + other.astype(F64)) / 2) & (f.astype(F64) != s)
    hi, lo = np.maximum(f, other), np.minimum(f, other)
    return np.where(at_mid & (err > 0), hi, np.where(at_mid & (err < 0), lo, f))


def markstein_quotient(x, s) -> np.ndarray:
    """`quotient` of csrc/int8_quantize.cuh: r = RN(1 / s), q0 = RN(x r),
    then two correction steps q = RN(q + RN(x - s q) r)."""
    r = (1.0 / s.astype(F64)).astype(F32)  # one rounding (53 >= 2 * 24 + 2 bits)
    q = (x.astype(F64) * r.astype(F64)).astype(F32)
    for _ in range(2):
        q = fma32(fma32(-s, q, x), r, q)
    return q


def true_division(x, s) -> np.ndarray:
    return (x.astype(F64) / s.astype(F64)).astype(F32)


def _division_operands(kind: str, seed: int, n: int = 200_000):
    """(x, s) f32 as the kernels meet them: s = max(m, 1e-6) / 127 for a row
    max m, |x| <= m."""
    rng = np.random.default_rng(seed)
    m = np.exp2(rng.uniform(-30, 30, n)).astype(F32)
    s = np.maximum(m, F32(1e-6)) / F32(127.0)
    if kind == "random":
        x = (rng.uniform(-1, 1, n) * m).astype(F32)
    elif kind == "midpoints":  # x / s next to a midpoint of two f32 quotients
        t = rng.uniform(0.25, 127.4, n).astype(F32)
        mid = (t.astype(F64) + np.nextafter(t, F32(np.inf)).astype(F64)) / 2
        x = (mid * s.astype(F64)).astype(F32)
        x = (x.view(np.int32) + rng.integers(-2, 3, n).astype(np.int32)).view(F32)
    elif kind == "half_integers":  # x / s next to n + 1/2, where rint decides
        half = rng.integers(-127, 127, n) + 0.5
        x = (half * s.astype(F64)).astype(F32)
        x = (x.view(np.int32) + rng.integers(-3, 4, n).astype(np.int32)).view(F32)
    else:  # "extremes": the row max itself, zeros and values far below s
        x = np.where(rng.uniform(size=n) < 0.5, m, np.where(
            rng.uniform(size=n) < 0.5, F32(0.0), m * np.exp2(-rng.uniform(8, 60, n)).astype(F32)))
        x = (x * rng.choice([-1.0, 1.0], n)).astype(F32)
    keep = np.abs(x.astype(F64)) <= 127.5 * s.astype(F64)
    return x[keep], s[keep]


@pytest.mark.parametrize("kind", ["random", "midpoints", "half_integers", "extremes"])
def test_markstein_steps_are_the_division(kind):
    x, s = _division_operands(kind, seed=len(kind))
    got, want = markstein_quotient(x, s), true_division(x, s)
    normal = np.abs(x) >= s / 4
    assert normal.sum() > 1000 or kind == "extremes"
    np.testing.assert_array_equal(got[normal], want[normal])
    np.testing.assert_array_equal(np.rint(got), np.rint(want))
    assert (np.abs(np.rint(want)) <= 127).all()
    if kind in ("midpoints", "half_integers"):  # where one product with RN(1 / s) misses
        product = (x.astype(F64) * (1.0 / s.astype(F64)).astype(F32).astype(F64)).astype(F32)
        assert (product != want).sum() > 100


# ------------------------------------------------------- int8 LayerNorms


def _jax_quantize_rows(y):
    """The activation quantization inside the reference's int8_matmul."""
    yf = y.astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(yf), axis=-1, keepdims=True), 1e-6) / 127.0
    return jnp.round(yf / sx).astype(jnp.int8), sx


def _ln_operands(inp: str, mean: float, D: int = 256, seed: int = 0):
    """x, h (2, 37, D) in `inp`, f32 scale and bias, as (jax, torch); x's
    row (0, 5) constant (its LayerNorm is the bias)."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[inp]
    x = mean + 3.0 * rng.standard_normal((2, 37, D))
    x[0, 5] = mean
    x = jnp.asarray(x, jnp.float32).astype(jdt)
    h = jnp.asarray(rng.standard_normal((2, 37, D)), jnp.float32).astype(jdt)
    g = rng.uniform(0.5, 1.5, D).astype(np.float32)
    b = rng.uniform(-0.2, 0.2, D).astype(np.float32)
    to_torch = lambda a: torch.from_numpy(np32(a).copy()).to(tdt)  # noqa: E731
    return (x, h, jnp.asarray(g), jnp.asarray(b)), (to_torch(x), to_torch(h),
                                                    torch.from_numpy(g), torch.from_numpy(b))


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("mean", [0.5, 50.0])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_int8_layernorm_is_the_layernorm_quantized(pair, mean, residual):
    inp, out = PAIRS[pair]
    jout, tout = DTYPES[out]
    (x, h, g, b), (xt, ht, gt, bt) = _ln_operands(inp, mean, seed=int(mean) + residual)
    if residual:
        xnew, (xq, sx) = fused_residual_layernorm_int8(xt, ht, gt, bt, 1e-6, out_dtype=tout)
        xnew_ref, y = residual_layernorm_reference(xt, ht, gt, bt, 1e-6, tout)
        assert torch.equal(xnew, xnew_ref)
        xnew_jax, y_jax = jax_res_ln(x, h, g, b, eps=1e-6, out_dtype=jout)
        np.testing.assert_array_equal(np32(xnew), np32(xnew_jax))
    else:
        xq, sx = fused_layernorm_int8(xt, gt, bt, 1e-6, out_dtype=tout)
        y = layernorm_reference(xt, gt, bt, 1e-6, tout)
        y_jax = jax_ln(x, g, b, eps=1e-6, out_dtype=jout)
    xq_ref, sx_ref = quantize_rows(y)
    assert xq.dtype == torch.int8 and sx.dtype == torch.float32 and sx.shape == (2, 37, 1)
    assert torch.equal(xq, xq_ref) and torch.equal(sx, sx_ref)
    # The reference's quantization lines on the port's LayerNorm output: bit for bit.
    xq_lines, sx_lines = _jax_quantize_rows(jnp.asarray(np32(y)).astype(jout))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_lines))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(sx_lines))
    # The reference's whole chain: its LayerNorm apart by the last bits of
    # its sums (the bounds of test_torch_layernorm.py), so x_q within one step.
    large = mean == 50.0 and (residual or inp == "f32")
    tol = 5e-3 if large else 1e-5
    got, ref = np32(y), np32(y_jax)
    if out == "bf16":
        mag = np.maximum(np.maximum(np.abs(got), np.abs(ref)), np.finfo(np.float32).tiny)
        assert (np.abs(got - ref) - tol <= np.exp2(np.floor(np.log2(mag)) - 7)).all()
    else:
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    xq_jax, sx_jax = _jax_quantize_rows(y_jax)
    assert np.abs(xq.numpy().astype(int) - np.asarray(xq_jax).astype(int)).max() <= 1
    np.testing.assert_allclose(sx.numpy(), np.asarray(sx_jax), rtol=tol, atol=0)


def test_int8_layernorm_takes_any_width_on_the_cpu_and_launches_nothing():
    before = (ln_ops.int8_launches, ln_ops.residual_int8_launches, int8_mm.quantize_launches)
    x, g, b = torch.randn(3, 24), torch.ones(24), torch.zeros(24)
    xq, sx = fused_layernorm_int8(x, g, b)
    assert torch.equal(xq, quantize_rows(layernorm_reference(x, g, b))[0])
    fused_residual_layernorm_int8(x, x, g, b)
    assert (ln_ops.int8_launches, ln_ops.residual_int8_launches,
            int8_mm.quantize_launches) == before
    for call in (lambda: ln_ops.layernorm_int8_cuda(x, g, b),
                 lambda: ln_ops.residual_layernorm_int8_cuda(x, x, g, b)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()


@pytest.mark.parametrize("residual", [False, True])
def test_int8_layernorm_routes_as_the_int8_matmul(monkeypatch, residual):
    """The entries ask `int8_mm_route` with the LayerNorm's output dtype and
    width. Routed as a CUDA operand would be: bf16 or f32 at the kernels'
    widths launch the kernel variant, inside `int_mm_route()` the plain chain
    (the LayerNorm entry, then `quantize_rows`), any other width or dtype
    raises, with no fallback."""
    asked, launched = [], []
    monkeypatch.setattr(ln_ops, "int8_mm_route", lambda dev, dt, din, dout=None: (
        asked.append((dev, dt, din, dout)) or int8_mm_route("cuda", dt, din, dout)))
    monkeypatch.setattr(ln_ops, "layernorm_int8_cuda", lambda *a: launched.append("ln") or "kernel")
    monkeypatch.setattr(ln_ops, "residual_layernorm_int8_cuda",
                        lambda *a: launched.append("res") or "kernel")

    def call(x, out_dtype=None):
        g, b = torch.ones(x.shape[-1]), torch.zeros(x.shape[-1])
        if residual:
            return fused_residual_layernorm_int8(x, x, g, b, 1e-6, out_dtype)
        return fused_layernorm_int8(x, g, b, 1e-6, out_dtype)

    x = torch.randn(5, 768, dtype=torch.bfloat16)
    assert call(x) == "kernel" and call(x, torch.float32) == "kernel"
    assert launched == ["res" if residual else "ln"] * 2
    assert asked == [("cpu", torch.bfloat16, 768, None), ("cpu", torch.float32, 768, None)]
    with int_mm_route():
        got = call(x)
    y = (residual_layernorm_reference(x, x, torch.ones(768), torch.zeros(768))[1] if residual
         else layernorm_reference(x, torch.ones(768), torch.zeros(768)))
    xq = got[1][0] if residual else got[0]
    assert torch.equal(xq, quantize_rows(y)[0]) and len(launched) == 2
    for bad in (torch.randn(5, 24, dtype=torch.bfloat16), torch.randn(5, 768, dtype=torch.float16),
                torch.randn(5, 4112)):
        with pytest.raises(ValueError, match="int8"):
            call(bad)
        with int_mm_route(), pytest.raises(ValueError, match="int8"):
            call(bad)


@pytest.mark.parametrize("device, dtype, din, route", [
    ("cpu", torch.float16, 24, "plain"), ("cuda", torch.bfloat16, 768, "kernel"),
    ("cuda", torch.float32, 128, "kernel"), ("cuda", torch.bfloat16, 16, "kernel"),
    ("cuda", torch.bfloat16, 4096, "kernel"),
])
def test_int8_mm_route_without_dout(device, dtype, din, route):
    assert int8_mm_route(device, dtype, din) == route
    with int_mm_route():
        assert int8_mm_route(device, dtype, din) == "plain"


# ----------------------------------------------------- the int8 + fused-LN block


def _int8_block(dtype: str, seed: int = 9) -> Block:
    """A fused-LN block at hidden 64, 2 heads, MLP 256, its int8 layers from
    quantized N(0, 1/fan_in) weights, LayerNorm gains near 1, LayerScale 0.5."""
    cfg = ViTConfig(image_size=32, patch_size=16, hidden_size=64, num_layers=1, num_heads=2,
                    dtype=dtype, quant="int8", fused_ln=True, layerscale_init=0.5)
    block = Block(cfg).eval()
    rng = np.random.default_rng(seed)
    for layer in block.modules():
        if isinstance(layer, Int8Linear):
            din, dout = layer.kernel_q.shape
            kq, scale = quantize.quantize_kernel(
                (rng.normal(size=(din, dout)) / np.sqrt(din)).astype(np.float32), in_dims=1)
            layer.kernel_q.copy_(torch.from_numpy(kq))
            layer.scale.data.copy_(torch.from_numpy(scale))
            layer.bias.data.copy_(torch.from_numpy(0.1 * rng.normal(size=dout).astype(np.float32)))
    for norm in (block.norm1, block.norm2):
        norm.weight.data.copy_(torch.from_numpy(1 + 0.1 * rng.normal(size=64).astype(np.float32)))
        norm.bias.data.copy_(torch.from_numpy(0.1 * rng.normal(size=64).astype(np.float32)))
    return block


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int8_fused_ln_block_is_the_composition_it_replaces(monkeypatch, dtype):
    block = _int8_block(dtype)
    n1, n2 = block.norm1, block.norm2
    x = torch.from_numpy(0.5 + 2.0 * np.random.default_rng(10).standard_normal((2, 17, 64))
                         .astype(np.float32)).to(block.attn.query.dtype)
    with torch.no_grad():
        h = fused_layernorm(x, n1.weight, n1.bias, n1.eps, out_dtype=x.dtype)
        h = block.ls1(block.attn(h))  # quantizes h once for q, k and v
        x_mid, h = fused_residual_layernorm(x, h, n2.weight, n2.bias, n2.eps, out_dtype=x.dtype)
        want = x_mid + block.ls2(block.mlp(h))  # fc1 quantizes h itself

    calls = {"ln": 0, "res": 0, "quantize": 0, "rows": []}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(vit, "fused_layernorm_int8", counted("ln", fused_layernorm_int8))
    monkeypatch.setattr(vit, "fused_residual_layernorm_int8",
                        counted("res", fused_residual_layernorm_int8))
    monkeypatch.setattr(Int8Linear, "quantize", counted("quantize", Int8Linear.quantize))
    plain = quantize.quantize_rows
    monkeypatch.setattr(quantize, "quantize_rows",
                        lambda t: calls["rows"].append(t.shape[-1]) or plain(t))
    with torch.no_grad():
        got = block(x)
    assert got.dtype == x.dtype and torch.equal(got, want)
    assert (calls["ln"], calls["res"], calls["quantize"]) == (1, 1, 0)
    assert calls["rows"] == [64, 256]  # out's input, then fc2's


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the quantization kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M", [0, 1, 37, 4101])
@pytest.mark.parametrize("D", [16, 768, 1024, 3072])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_int8_layernorm_kernels_bit_equal_on_card(cuda_device, pair, D, M):
    """x_q, s_x (and x + h) bit-equal to the LayerNorm kernel followed by
    `quantize_rows`; with a zero bias a constant row quantizes at the 1e-6
    floor; two calls bit-identical."""
    inp, out = (DTYPES[k][1] for k in PAIRS[pair])
    gen = torch.Generator().manual_seed(D + M)
    x = (0.5 + 3.0 * torch.randn(M, D, generator=gen)).to(cuda_device, inp)
    h = torch.randn(M, D, generator=gen).to(cuda_device, inp)
    g = (1.0 + 0.1 * torch.randn(D, generator=gen)).to(cuda_device)
    biases = (0.1 * torch.randn(D, generator=gen).to(cuda_device), torch.zeros(D, device=cuda_device))
    for b in biases:
        if M > 2:
            x[M // 2] = 1.0
        runs = [ln_ops.layernorm_int8_cuda(x, g, b, 1e-6, out) for _ in range(2)]
        want = quantize_rows(ln_ops.layernorm_cuda(x, g, b, 1e-6, out))
        xnew, got_r = ln_ops.residual_layernorm_int8_cuda(x, h, g, b, 1e-6, out)
        xnew_ref, y_r = ln_ops.residual_layernorm_cuda(x, h, g, b, 1e-6, out)
        torch.cuda.synchronize()
        for got, ref in ((runs[0], want), (runs[1], want), (got_r, quantize_rows(y_r))):
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert torch.equal(xnew, xnew_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [16, 768, 3072, 4096])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_rows_kernel_bit_equal_on_card(cuda_device, dtype, K):
    """Odd row counts, a zero row and values planted next to half-integer
    quotients: x_q and s_x bit-equal to `quantize_rows`."""
    rng = np.random.default_rng(K)
    M = 4101
    x = rng.standard_normal((M, K)).astype(np.float32) * np.exp2(rng.uniform(-8, 8, (M, 1)))
    x = torch.from_numpy(x.astype(np.float32)).to(dtype).float().numpy()
    m = np.maximum(np.abs(x).max(axis=1, keepdims=True), F32(1e-6))
    s = m / F32(127.0)
    near = (rng.integers(-126, 126, (M, K)) + 0.5) * s.astype(F64)
    x = np.where(rng.uniform(size=(M, K)) < 0.3, near.astype(F32), x)
    x[M // 2] = 0.0
    xt = torch.from_numpy(x).to(cuda_device, dtype)
    got = int8_mm.int8_quantize_rows_cuda(xt)
    want = quantize_rows(xt)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("T", [1, 127, 1025, 2049])
def test_quantize_v_kernel_bit_equal_on_card(cuda_device, T, layout):
    """vt (the fused kernel's layout, zero past T) and sv bit-equal to
    `quantize_v_plain`, for a contiguous v and for the (B, T, H, 64) view of
    a q/k/v projection; two calls bit-identical."""
    gen = torch.Generator().manual_seed(T)
    v = torch.randn(2, T, 3 if layout == "strided" else 1, 3, 64, generator=gen)
    v = (v * torch.exp2(4 * torch.rand(1, 1, 1, 3, 64, generator=gen))).to(cuda_device,
                                                                           torch.bfloat16)
    v = v[:, :, 1] if layout == "strided" else v[:, :, 0].contiguous()
    Tp = int8_attention._fused_tp(T)
    runs = [int8_attention.int8_quantize_v_cuda(v) for _ in range(2)]
    want = int8_attention.quantize_v_plain(v, Tp)
    torch.cuda.synchronize()
    for got in runs:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

