"""The int8 matmul of the serve path: the port's plain version against the
reference's `int8_matmul`, its route rule, and its kernels on the card.

Same numpy-seeded inputs in both packages. The plain version repeats the
reference's rounding points, so x_q, s_x, the int32 product and the output
are compared bit for bit, in bf16 and f32, at M = 1, 37 and 129 rows and
K = 64, 128 and 768, each x with an all-zero row (the 1e-6 scale floor) and
rows planted so that m / 127 and m * fl(1/127) round apart (the division
that torch on CUDA once made a reciprocal product). The kernels of
`csrc/int8_gemm.cu` against the plain version carry the `cuda` marker and
skip without a card (`chip_smoke.py` runs the same checks on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvropose_tpu.models.quantize import int8_matmul as jax_int8_matmul

from mvropose_torch.models.quantize import (
    int8_gemm_reference,
    int8_matmul,
    int8_matmul_reference,
    quantize_kernel,
    quantize_rows,
)
from mvropose_torch.models.vit import FusedMHA
from mvropose_torch.ops import int8_matmul as int8_mm
from mvropose_torch.ops.attention import fused_self_attention
from mvropose_torch.ops.int8_matmul import int8_mm_route, int_mm_route
from torch_parity import np32

DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}
RECIPROCAL = np.float32(1.0) / np.float32(127.0)  # what torch on CUDA multiplies by for "/ 127.0"


def division_row_maxima() -> np.ndarray:
    """bf16-representable maxima in [4, 8) whose m / 127 and m * fl(1/127)
    differ in f32."""
    m = (np.arange(4.0, 8.0, 2.0**-5)).astype(np.float32)
    return m[(m / np.float32(127.0)) != (m * RECIPROCAL)]


def planted_x(M: int, K: int, seed: int) -> np.ndarray:
    """(M, K) f32 of bf16-representable values, |x| < 4 but for one value a
    row from `division_row_maxima` (random sign); with M > 1 row M // 2 all
    zero."""
    rng = np.random.default_rng(seed)
    x = np.clip(rng.normal(size=(M, K)), -3.9, 3.9).astype(np.float32)
    x = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    maxima = division_row_maxima()
    rows = np.arange(M)
    x[rows, rng.integers(0, K, size=M)] = (rng.choice(maxima, size=M)
                                           * rng.choice([-1.0, 1.0], size=M)).astype(np.float32)
    if M > 1:
        x[M // 2] = 0.0
    return x


def test_planted_rows_round_apart_as_a_reciprocal_product():
    """The planted maxima exist, and `quantize_rows` divides them exactly."""
    maxima = division_row_maxima()
    assert maxima.size >= 4
    x = planted_x(37, 64, seed=0)
    _, sx = quantize_rows(torch.from_numpy(x))
    m = np.maximum(np.abs(x).max(axis=1), np.float32(1e-6))
    np.testing.assert_array_equal(sx.numpy()[:, 0], m / np.float32(127.0))
    planted = np.arange(37) != 37 // 2
    assert ((m * RECIPROCAL) != sx.numpy()[:, 0])[planted].all()


def _jax_quantize_rows(x):
    """The activation quantization inside the reference's int8_matmul."""
    xf = x.astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-6) / 127.0
    return jnp.round(xf / sx).astype(jnp.int8), sx


@pytest.mark.parametrize("K", [64, 128, 768])
@pytest.mark.parametrize("M", [1, 37, 129])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_int8_matmul_is_bit_equal_to_jax(dtype, M, K):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(M * 1000 + K)
    x = jnp.asarray(planted_x(M, K, seed=K + M)).astype(jdt)
    kq, scale = quantize_kernel(rng.normal(size=(K, 48)).astype(np.float32), in_dims=1)
    bias = rng.normal(size=48).astype(np.float32)
    xq_want, sx_want = _jax_quantize_rows(x)
    prod_want = jax.lax.dot_general(xq_want, jnp.asarray(kq), (((1,), (0,)), ((), ())),
                                    preferred_element_type=jnp.int32)
    xt = torch.from_numpy(np.array(np32(x))).to(tdt)
    xq, sx = quantize_rows(xt)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_want))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(sx_want))
    np.testing.assert_array_equal(torch._int_mm(xq, torch.from_numpy(kq)).numpy(),
                                  np.asarray(prod_want))
    if M > 1:
        assert xq[M // 2].eq(0).all() and sx[M // 2, 0] == np.float32(1e-6) / np.float32(127.0)
    for out_j, out_t in ((jnp.float32, torch.float32), (jdt, tdt)):
        want = jax_int8_matmul(x, jnp.asarray(kq), jnp.asarray(scale), jnp.asarray(bias), out_j)
        got = int8_matmul(xt, torch.from_numpy(kq), torch.from_numpy(scale),
                          torch.from_numpy(bias), out_t)
        assert got.dtype == out_t and got.shape == (M, 48)
        np.testing.assert_array_equal(np32(got), np32(want))


ROUTES = [
    ("cpu", torch.bfloat16, 768, 768, "plain"),
    ("cpu", torch.float16, 24, 12, "plain"),  # the plain version takes any dtype and width
    ("cuda", torch.bfloat16, 768, 768, "kernel"),  # q, k, v, out of the serve step
    ("cuda", torch.bfloat16, 768, 3072, "kernel"),  # fc1
    ("cuda", torch.bfloat16, 3072, 768, "kernel"),  # fc2
    ("cuda", torch.float32, 128, 128, "kernel"),  # the small f32 int8 model of chip_smoke
    ("cuda", torch.float32, 128, 512, "kernel"),
    ("cuda", torch.float32, 512, 128, "kernel"),
    ("cuda", torch.bfloat16, 16, 8, "kernel"),
    ("cuda", torch.bfloat16, 4096, 4104, "kernel"),
]


@pytest.mark.parametrize("device, dtype, din, dout, route", ROUTES)
def test_int8_mm_route(device, dtype, din, dout, route):
    assert int8_mm_route(device, dtype, din, dout) == route


@pytest.mark.parametrize("device, dtype, din, dout", [
    ("cuda", torch.float16, 768, 768), ("cuda", torch.int8, 768, 768),
    ("cuda", torch.bfloat16, 24, 768), ("cuda", torch.bfloat16, 8, 768),
    ("cuda", torch.bfloat16, 4112, 768), ("cuda", torch.bfloat16, 768, 12),
    ("cuda", torch.float32, 768, 0), ("meta", torch.bfloat16, 768, 768),
])
def test_int8_mm_route_raises_for_what_no_kernel_takes(device, dtype, din, dout):
    with pytest.raises(ValueError, match="int8"):
        int8_mm_route(device, dtype, din, dout)
    with int_mm_route(), pytest.raises(ValueError, match="int8"):
        int8_mm_route(device, dtype, din, dout)


def test_int_mm_route_sends_cuda_operands_to_the_plain_chain():
    with int_mm_route():
        assert int8_mm_route("cuda", torch.bfloat16, 768, 3072) == "plain"
        assert int8_mm_route("cpu", torch.bfloat16, 768, 3072) == "plain"
    assert int8_mm_route("cuda", torch.bfloat16, 768, 3072) == "kernel"


def test_cpu_operands_take_the_plain_version_and_launch_nothing():
    before = (int8_mm.launches, int8_mm.quantize_launches)
    x = torch.randn(2, 5, 64, dtype=torch.bfloat16)
    kq = torch.randint(-127, 128, (64, 16), dtype=torch.int8)
    scale, bias = torch.rand(16) / 127, torch.randn(16)
    out = int8_matmul(x, kq, scale, bias, torch.bfloat16)
    assert torch.equal(out, int8_matmul_reference(x, kq, scale, bias, torch.bfloat16))
    assert out.shape == (2, 5, 16) and out.dtype == torch.bfloat16
    assert (int8_mm.launches, int8_mm.quantize_launches) == before


@pytest.mark.parametrize("call", ["quantize", "gemm"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """The wrappers raise on CPU tensors: they never fall back to the plain version."""
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        if call == "quantize":
            int8_mm.int8_quantize_rows_cuda(x)
        else:
            int8_mm.int8_gemm_cuda(x.to(torch.int8), torch.ones(4, 1),
                                   torch.zeros(16, 64, dtype=torch.int8).t(), torch.ones(16),
                                   None, torch.float32)


def _int8_mha(dim: int = 64, heads: int = 2, seed: int = 5) -> FusedMHA:
    rng = np.random.default_rng(seed)
    mha = FusedMHA(dim, heads, torch.float32, quant="int8")
    for layer in (mha.query, mha.key, mha.value, mha.out):
        kq, scale = quantize_kernel(rng.normal(size=(dim, dim)).astype(np.float32), in_dims=1)
        layer.kernel_q.copy_(torch.from_numpy(kq))
        layer.scale.data.copy_(torch.from_numpy(scale))
        layer.bias.data.copy_(torch.from_numpy(rng.normal(size=dim).astype(np.float32)))
    return mha


def test_fused_mha_quantizes_once_bit_equal_to_three_calls(monkeypatch):
    """One quantization of h for q, k and v gives what three `Int8Linear`
    calls give, bit for bit; a forward quantizes twice (q/k/v, out), not four
    times."""
    from mvropose_torch.models import quantize

    mha = _int8_mha()
    x = torch.from_numpy(planted_x(2 * 9, 64, seed=3).reshape(2, 9, 64))
    q, k, v = (mha._heads(layer(x)) for layer in (mha.query, mha.key, mha.value))
    o = fused_self_attention(q, k, v, key_mask=None)
    want = mha.out(o.reshape(2, 9, -1))
    pair = mha.query.quantize(x)
    for layer in (mha.query, mha.key, mha.value):
        assert torch.equal(layer(pair), layer(x))
    calls = []
    plain = quantize.quantize_rows
    monkeypatch.setattr(quantize, "quantize_rows", lambda t: calls.append(t.shape) or plain(t))
    got = mha(x)
    assert torch.equal(got, want)
    assert len(calls) == 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the int8 GEMM kernels have no CPU mode")
    return torch.device("cuda")


def _card_operands(M: int, din: int, dout: int, dtype, device, seed: int):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(planted_x(M, din, seed)).to(device, dtype)
    kq, scale = quantize_kernel(rng.normal(size=(din, dout)).astype(np.float32), in_dims=1)
    kq = torch.from_numpy(np.ascontiguousarray(kq.T)).to(device).t()  # column-major, as Int8Linear
    bias = torch.from_numpy(rng.normal(size=dout).astype(np.float32)).to(device)
    return x, kq, torch.from_numpy(scale).to(device), bias


@pytest.mark.cuda
@pytest.mark.parametrize("M, din, dout", [
    (4100, 768, 768), (4100, 768, 3072), (4100, 3072, 768),  # the serve step (33 row tiles)
    (37, 768, 768), (37, 128, 512), (1, 512, 128),
    (16400, 768, 768), (16400, 768, 3072), (16400, 3072, 768),  # the eval capture (129)
    (1040, 192, 192), (1040, 192, 768), (1040, 768, 192),  # the DREAM twin's eval (9)
    (3250, 192, 192), (3250, 192, 768), (3250, 768, 192),  # its receipt (26)
    (519, 768, 576),  # 5 x 3 tiles, ragged in both directions
    (200, 16, 8), (300, 4096, 4104),  # the narrowest and widest operands the route takes
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_bit_equal_to_plain_on_card(cuda_device, dtype, M, din, dout):
    x, kq, scale, bias = _card_operands(M, din, dout, dtype, cuda_device, seed=M + din)
    xq, sx = int8_mm.int8_quantize_rows_cuda(x)
    xq_ref, sx_ref = quantize_rows(x)
    assert torch.equal(xq, xq_ref) and torch.equal(sx, sx_ref)
    for out_dtype in (torch.bfloat16, torch.float32):
        got = [int8_mm.int8_gemm_cuda(xq, sx, kq, scale, bias, out_dtype) for _ in range(2)]
        want = int8_gemm_reference(xq_ref, sx_ref, kq, scale, bias, out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(got[0], got[1]) and torch.equal(got[0], want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_rows_divides_exactly_on_card(cuda_device, dtype):
    """s_x of the plain version and of the kernel on the card equal numpy's
    f32 true division on rows whose reciprocal product rounds apart."""
    x = planted_x(4100, 768, seed=7)
    m = np.maximum(np.abs(x).max(axis=1), np.float32(1e-6))
    xt = torch.from_numpy(x).to(cuda_device, dtype)
    for _, sx in (quantize_rows(xt), int8_mm.int8_quantize_rows_cuda(xt)):
        np.testing.assert_array_equal(sx.cpu().numpy()[:, 0], m / np.float32(127.0))
