"""int8-probability attention: the port's plain version against the reference,
its routes, and the fused kernel's layouts, on the CPU.

Same numpy-seeded inputs in both packages. What is compared, and how closely:
  * planted rows (every logit the row's max or 128 below it, so e in {0, 1}
    and z an exact count; q = 0 rows uniform; one batch element all masked):
    the port's plain version equals `mvropose_tpu.ops.attention.
    int8_prob_attention` bit for bit, f32 and bf16, with and without a mask;
  * random operands at the serve T = 1025 (the fused kernel's last key tile
    holds 1 key of 128): within one quantization step of the values'
    channel, sv = max|v| / 127, plus one bf16 ulp for a bf16 output (the
    bound of `test_torch_int8.py::test_int8_prob_attention_matches_jax`),
    except in the few bf16 rows whose logits the two packages round apart
    (bound stated at the test);
  * the other head widths (d = 32, 48, 96, 128) at T = 65, masked and not,
    f32 and bf16: the same bound, with q scaled by 1/sqrt(d) rounded to q's
    dtype (not a power of two there, so the scaled q rounds); planted rows
    bit-equal at d = 48;
  * `int8_route`, the one routing rule; the wrappers' refusals;
  * the fused kernel's value layout: the plain `quantize_v_plain` holds the
    reference's quantized values in the key order that makes each thread's
    probabilities its 8-bit A fragment (the packing of `tile_probs` in
    `csrc/int8_attention.cu`, emulated here), exactly, bf16 and f32;
  * the f32 probabilities' two roundings, rint(fl(127 e)): the plain
    version's, the reference's and the f32 kernel's arithmetic (emulated in
    numpy) equal, at values where one rounding of 127 e gives another byte.
The kernels against their plain versions on the card carry the `cuda` marker
and skip without a card (`chip_smoke.py::phase_int8_attention` runs them on
the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvropose_tpu.ops.attention import int8_prob_attention as jax_int8_attention

from mvropose_torch.ops import int8_attention
from mvropose_torch.ops.int8_attention import (
    int8_prob_attention,
    int8_route,
    probability_bytes,
    quantize_v_plain,
    quantize_v_reference,
)
from torch_parity import np32

TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _both(arrays, jdt):
    """numpy arrays -> (JAX arrays in jdt, torch tensors in its counterpart)."""
    jax_arrays = [jnp.asarray(a, jnp.float32).astype(jdt) for a in arrays]
    return jax_arrays, [torch.from_numpy(np.array(np32(a))).to(TORCH[jdt]) for a in jax_arrays]


def _planted(B, T, H, seed, d=64):
    """q, k nonzero in channel 0 only: q in {0, +-512}, k in {+-1}, so every
    logit (q k / sqrt(d)) is 0 or +-512 s (+-64 at d = 64, +-74 at d = 48):
    a row's max, or so far below it that its exponent is 0."""
    rng = np.random.default_rng(seed)
    q, k = np.zeros((B, T, H, d)), np.zeros((B, T, H, d))
    q[..., 0] = 512.0 * rng.integers(-1, 2, size=(B, T, H))
    k[..., 0] = rng.choice([-1.0, 1.0], size=(B, T, H))
    v = rng.normal(size=(B, T, H, d))
    return q, k, v, rng


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_planted_rows_equal_jax_bit_for_bit(dtype, masked):
    q, k, v, rng = _planted(3, 70, 2, seed=11)
    mask = None
    if masked:
        mask = rng.uniform(size=(3, 70)) > 0.3
        mask[1] = False  # every key of batch element 1 masked: v averaged over T
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), DTYPES[dtype])
    want = jax_int8_attention(jq, jk, jv, key_mask=None if mask is None else jnp.asarray(mask))
    got = int8_prob_attention(tq, tk, tv, key_mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == TORCH[DTYPES[dtype]] and got.shape == (3, 70, 2, 64)
    np.testing.assert_array_equal(np32(got), np32(want))
    if masked:  # the all-masked element: pq = 127 at each of the 70 real keys, z = 70
        vq, sv = quantize_v_reference(tv)
        acc = (127 * vq.double().sum(1)).float()[2:4]  # (H, d) of batch element 1
        mean = (acc * torch.tensor(1.0 / (127.0 * 70.0)) * sv[2:4]).to(got.dtype)
        np.testing.assert_array_equal(np32(got[1]), np32(mean)[None].repeat(70, 0))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_serve_t_1025_matches_jax(dtype, masked):
    """B = 1, H = 2, d = 64 at T = 1025, the serve backbone's token count.
    f32, and bf16 rows whose logits the two packages round alike: the bound
    of `test_int8_prob_attention_matches_jax`. A bf16 row holding a logit
    that the two packages' f32 sums (the same products in another order)
    round to neighbouring bf16 values: e moves by up to e^ulp(s) - 1, under
    6.5 % for |s| < 16, so that key's pq by up to 8 steps and z by up to
    6.5 %: 8 value steps plus 2^-3 |out| (68 of the 2.1 M logits here)."""
    rng = np.random.default_rng(12)
    q, k, v = (s * rng.normal(size=(1, 1025, 2, 64)) for s in (2.0, 2.0, 1.0))
    mask = rng.uniform(size=(1, 1025)) > 0.3 if masked else None
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), DTYPES[dtype])
    want = np32(jax_int8_attention(jq, jk, jv,
                                   key_mask=None if mask is None else jnp.asarray(mask)))
    got = int8_prob_attention(tq, tk, tv, key_mask=None if mask is None else torch.from_numpy(mask))
    jax_logits = jnp.einsum("bqhd,bkhd->bhqk", jq * (1.0 / 8.0), jk)  # the reference's
    port_logits = (tq.transpose(1, 2) * 0.125) @ tk.permute(0, 2, 3, 1)  # the port's
    apart = (np32(jax_logits) != np32(port_logits)).any(-1).transpose(0, 2, 1)[..., None]
    apart &= dtype == "bf16"  # (B, T, H, 1); f32 logits differ in their last bits only
    assert apart.mean() < 0.1, apart.mean()
    step = (np.abs(np32(jv)).max(axis=1) / 127.0)[:, None]  # (B, 1, H, d): one value step
    ulp = np.exp2(np.floor(np.log2(np.abs(want) + 1e-30)) - 7) if dtype == "bf16" else 0.0
    bound = np.where(apart, 8 * step + 0.125 * np.abs(want), step + ulp)
    gap = np.abs(np32(got) - want)
    assert (gap <= bound).all(), (gap / bound).max()


WIDTHS = (32, 48, 96, 128)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", WIDTHS)
def test_other_widths_match_jax(d, dtype, masked):
    """B = 2, H = 3 at T = 65 (the 128-px ViT/16's token count) at each
    other head width: the bound of `test_serve_t_1025_matches_jax`. The
    scale 1/sqrt(d) is rounded to q's dtype and q * scale rounds in it, in
    both packages (`int8_attention.sm_scale`); the rows whose bf16 logits
    the two packages' f32 sums round apart get that test's wider bound."""
    rng = np.random.default_rng(20 + d)
    q, k, v = (s * rng.normal(size=(2, 65, 3, d)) for s in (2.0, 2.0, 1.0))
    mask = rng.uniform(size=(2, 65)) > 0.3 if masked else None
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), DTYPES[dtype])
    want = np32(jax_int8_attention(jq, jk, jv,
                                   key_mask=None if mask is None else jnp.asarray(mask)))
    got = int8_prob_attention(tq, tk, tv, key_mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == TORCH[DTYPES[dtype]] and got.shape == (2, 65, 3, d)
    scale = int8_attention.sm_scale(d, TORCH[DTYPES[dtype]])
    assert scale == float(jnp.asarray(1.0 / d**0.5, DTYPES[dtype]))
    jax_logits = jnp.einsum("bqhd,bkhd->bhqk", jq * (1.0 / d**0.5), jk)
    port_logits = (tq.transpose(1, 2) * scale) @ tk.permute(0, 2, 3, 1)
    apart = (np32(jax_logits) != np32(port_logits)).any(-1).transpose(0, 2, 1)[..., None]
    apart &= dtype == "bf16"
    assert apart.mean() < 0.2, apart.mean()
    step = (np.abs(np32(jv)).max(axis=1) / 127.0)[:, None]
    ulp = np.exp2(np.floor(np.log2(np.abs(want) + 1e-30)) - 7) if dtype == "bf16" else 0.0
    bound = np.where(apart, 8 * step + 0.125 * np.abs(want), step + ulp)
    gap = np.abs(np32(got) - want)
    assert (gap <= bound).all(), (gap / bound).max()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_planted_rows_equal_jax_bit_for_bit_at_d48(dtype):
    """d = 48, the DINO checkpoint's 4 heads over 192 channels: scale
    bf16(1/sqrt(48)) = 0.14453125 (f32: 0.14433756), so q * scale rounds in
    q's dtype; planted logits 0 or +-74 (bf16) stay exact, and the port
    equals the reference bit for bit, masked, with one batch element all
    masked."""
    q, k, v, rng = _planted(3, 65, 4, seed=21, d=48)
    mask = rng.uniform(size=(3, 65)) > 0.3
    mask[1] = False
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), DTYPES[dtype])
    for m in (None, mask):
        want = jax_int8_attention(jq, jk, jv, key_mask=None if m is None else jnp.asarray(m))
        got = int8_prob_attention(tq, tk, tv, key_mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(np32(got), np32(want))


ROUTES = [
    ("cpu", torch.bfloat16, 64, "plain"),
    ("cpu", torch.float32, 64, "plain"),
    ("cpu", torch.float16, 48, "plain"),  # the plain version takes any dtype and width
    ("cpu", torch.bfloat16, 80, "plain"),
    ("cuda", torch.bfloat16, 64, "fused"),  # every int8 serve step
    ("cuda", torch.float32, 64, "fused_f32"),  # the same kernels for f32: split-TF32 logits
    # every other width of HEAD_DIMS, each instantiated in both types
    *[("cuda", dtype, d, route) for d in (32, 48, 96, 128)
      for dtype, route in ((torch.bfloat16, "fused"), (torch.float32, "fused_f32"))],
]


@pytest.mark.parametrize("device, dtype, d, route", ROUTES)
def test_int8_route(device, dtype, d, route):
    assert int8_route(device, dtype, d) == route


@pytest.mark.parametrize("device, dtype, d", [
    ("cuda", torch.float16, 64), ("cuda", torch.bfloat16, 80), ("cuda", torch.float32, 80),
    ("meta", torch.bfloat16, 64),
])
def test_int8_route_raises_for_what_no_kernel_takes(device, dtype, d):
    with pytest.raises(ValueError, match="int8"):
        int8_route(device, dtype, d)


def _counters():
    return dict(int8_attention.width_launches), int8_attention.quantize_v_launches


def test_cpu_operands_take_the_plain_version_and_launch_nothing():
    before = _counters()
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(1, 5, 2, 64, dtype=dtype)
        out = int8_prob_attention(q, q, q)
        assert out.shape == (1, 5, 2, 64) and out.dtype == dtype
    assert _counters() == before


@pytest.mark.parametrize("make, match", [
    (lambda: torch.zeros(1, 5, 2, 64, dtype=torch.bfloat16), "CUDA tensors"),
    (lambda: torch.zeros(1, 5, 2, 64, dtype=torch.float16), "bf16 or f32"),
    (lambda: torch.zeros(1, 5, 2, 80, dtype=torch.bfloat16), "head width"),
])
def test_fused_entry_points_refuse(make, match):
    """The kernels' wrappers raise on CPU tensors (bf16 or f32), another
    dtype or a head width outside HEAD_DIMS: they never fall back to the
    plain version."""
    x = make()
    with pytest.raises(ValueError, match=match):
        int8_attention.int8_quantize_v_cuda(x)
    vt = torch.zeros(2, 64, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match=match):
        int8_attention.int8_attention_cuda(x, x, vt, torch.ones(2, 64))


def test_fused_values_order_matches_the_fragment_packing():
    """The probabilities of a 16-row warp tile, packed as `tile_probs` packs
    the S accumulator (thread (g, t) holds columns 8 n + 2 t + c of rows g
    and g + 8; register r of 32-key group kk holds column tiles 4 kk + 2 (r
    >> 1) + {0, 1}, two bytes each), read as the m64nNk32 8-bit A fragment
    (register r: row g + 8 (r & 1), k = 4 t + 16 (r >> 1) + byte), times
    `quantize_v_plain`'s values at those k, is P V exactly; and its values
    are the reference's quantized values."""
    rng = np.random.default_rng(13)
    P = rng.integers(0, 128, size=(16, 128))
    v = torch.from_numpy(rng.normal(size=(1, 128, 1, 64)).astype(np.float32)).to(torch.bfloat16)
    vt, sv = quantize_v_plain(v, 128)
    vq, sv_ref = quantize_v_reference(v)
    assert torch.equal(sv, sv_ref)
    V = vq[0].numpy().astype(np.int64)  # (keys, channels)
    A = np.zeros((16, 128), dtype=np.int64)  # P in the A fragments' k order
    for g in range(8):
        for t in range(4):
            for kk in range(4):
                for r in range(4):
                    row = g + 8 * (r & 1)
                    for byte in range(4):
                        n = 4 * kk + 2 * (r >> 1) + (byte >> 1)
                        k = 32 * kk + 4 * t + 16 * (r >> 1) + byte
                        A[row, k] = P[row, 8 * n + 2 * t + (byte & 1)]
    B = vt[0].numpy().astype(np.int64).T  # (k positions, channels)
    assert (A @ B == P @ V).all()
    assert sorted(int8_attention.key_positions(128).tolist()) == list(range(128))


def _jax_values(v):
    """The reference's quantized values and their scales
    (mvropose_tpu/ops/attention.py:70-71): (B, T, H, d) -> vq (B, T, H, d)
    int8, sv (B, H, d) f32."""
    sv = jnp.maximum(jnp.max(jnp.abs(v.astype(jnp.float32)), axis=1), 1e-6) / 127.0
    return jnp.round(v.astype(jnp.float32) / sv[:, None]).astype(jnp.int8), sv


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_values_layout_matches_jax(dtype):
    """`quantize_v_plain`, what `int8_quantize_v_cuda` writes for bf16 and
    f32 v, is the reference's vq in the fused layout (transposed, keys in
    `key_positions` order, zero past T) and its sv, exactly; with a channel
    planted on halves (max 127, so scale 1: 0.5, 1.5, -2.5, 63.5, -3.5 round
    half to even)."""
    B, T, H = 2, 150, 3
    v = np.random.default_rng(15).normal(size=(B, T, H, 64))
    v[0, :, 1, 3] = 0.0
    v[0, :6, 1, 3] = [127.0, 0.5, 1.5, -2.5, 63.5, -3.5]
    (jv,), (tv,) = _both((v,), DTYPES[dtype])
    vq_want, sv_want = (np.asarray(a) for a in _jax_values(jv))
    Tp = int8_attention._fused_tp(T)
    vt, sv = quantize_v_plain(tv, Tp)
    want = np.zeros((B * H, 64, Tp), np.int8)
    want[:, :, :T] = vq_want.transpose(0, 2, 3, 1).reshape(B * H, 64, T)
    want = want[:, :, int8_attention.key_positions(Tp).numpy()]
    np.testing.assert_array_equal(vt.numpy(), want)
    np.testing.assert_array_equal(sv.numpy(), sv_want.reshape(B * H, 64))
    assert sv.reshape(B, H, 64)[0, 1, 3] == 1.0
    np.testing.assert_array_equal(vq_want[0, :6, 1, 3], [127, 0, 2, -2, 64, -4])


# f32 exponents e where rint(fl(127 e)) and rint(127 e) (one rounding) differ:
# fl(127 e) lands on a half and rounds to even, the exact product lies past it.
TWICE_ROUNDED = [0.7440945, 0.7992126, 0.6023622, 0.4527559, 0.7677165, 0.8228347, 0.492126]


def test_probability_bytes_round_twice():
    """pq = rint(fl(127 e)) for f32 e: the plain version's `probability_bytes`
    equals the reference's `jnp.round(e * 127.0)` and the f32 kernel's
    arithmetic (`tile_probs_f32`: __fmul_rn(e, 127), then __fadd_rn with 1.5 *
    2^23, whose low byte is the integer), emulated in numpy, at the planted
    values and on 10^6 random e; at the planted values one rounding of the
    exact product gives the next byte."""
    planted = np.array(TWICE_ROUNDED, np.float32)
    e = np.concatenate([planted, np.random.default_rng(16).uniform(size=10**6).astype(np.float32),
                        np.array([0.0, 1.0], np.float32)])
    got = probability_bytes(torch.from_numpy(e)).numpy()
    want = np.asarray(jnp.round(jnp.asarray(e) * 127.0).astype(jnp.int8))
    np.testing.assert_array_equal(got, want)
    product = e * np.float32(127.0)  # f32, rounded once
    assert product.dtype == np.float32
    kround = np.float32(12582912.0)
    kernel = ((product + kround).astype(np.float32) - kround).astype(np.int8)  # exact subtraction
    np.testing.assert_array_equal(kernel, want)
    once = np.rint(planted.astype(np.float64) * 127.0).astype(np.int8)
    assert (once != got[:len(planted)]).all(), (once, got[:len(planted)])
    assert got[:len(planted)].tolist() == [94, 102, 76, 58, 98, 104, 62]


def test_fused_values_are_zero_past_t():
    v = torch.randn(2, 37, 3, 64).to(torch.bfloat16)
    vt, sv = quantize_v_plain(v, 128)
    assert vt.shape == (6, 64, 128) and sv.shape == (6, 64)
    keys = int8_attention.key_positions(128)
    assert (vt[:, :, keys >= 37] == 0).all() and (vt[:, :, keys < 37] != 0).any()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused int8 attention kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T, masked", [(1025, False), (37, True), (1, False), (2305, True)])
def test_fused_kernel_matches_plain_on_card(cuda_device, T, masked):
    """The values' quantization equal to its plain version; the fused kernel
    within the bound of `test_serve_t_1025_matches_jax` of the plain version
    on the same quantized values; two calls bit-identical."""
    gen = torch.Generator().manual_seed(14)
    q, k, v = (s * torch.randn(2, T, 4, 64, generator=gen) for s in (2.0, 2.0, 1.0))
    q, k, v = (t.to(cuda_device, torch.bfloat16) for t in (q, k, v))
    mask = (torch.rand(2, T, generator=gen) > 0.3).to(cuda_device) if masked else None
    vt, sv = int8_attention.int8_quantize_v_cuda(v)
    got = [int8_attention.int8_attention_cuda(q, k, vt, sv, mask) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1])
    vt_ref, sv_ref = quantize_v_plain(v, int8_attention._fused_tp(T))
    assert torch.equal(vt, vt_ref) and torch.equal(sv, sv_ref)
    vq, _ = quantize_v_reference(v)
    want = int8_attention.int8_attention_reference(q, k, vq, sv, mask).float()
    bound = sv.reshape(2, 1, 4, 64) + torch.exp2(torch.floor(torch.log2(want.abs() + 1e-30)) - 7)
    assert bool(((got[0].float() - want).abs() <= bound).all())


def _planted_on(device, B, T, H, seed, masked, dtype, d=64):
    q, k, v, rng = _planted(B, T, H, seed, d)
    mask = None
    if masked:
        mask = torch.from_numpy(rng.uniform(size=(B, T)) > 0.3).to(device)
        mask[-1] = False  # every key of the last batch element masked
    return [torch.from_numpy(a).to(device, dtype) for a in (q, k, v)] + [mask]


@pytest.mark.cuda
@pytest.mark.parametrize("T", [37, 1025, 2305])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_f32_kernel_matches_plain_on_card(cuda_device, T, masked):
    """f32: the values' quantization equal to its plain version; the whole
    route (`int8_prob_attention`: the values' kernel, the pre-pass and the
    kernel) within one value step (max |v| / 127 of the channel) of the plain
    route everywhere, two calls bit-identical; on planted operands (logits
    +-64 or 0, exact on both routes: e in {0, 1}, z an exact count) bit-equal."""
    gen = torch.Generator().manual_seed(17)
    q, k, v = (s * torch.randn(2, T, 4, 64, generator=gen) for s in (2.0, 2.0, 1.0))
    q, k, v = (t.to(cuda_device) for t in (q, k, v))
    mask = (torch.rand(2, T, generator=gen) > 0.3).to(cuda_device) if masked else None
    before = int8_attention.route_launches("fused_f32")
    got = [int8_prob_attention(q, k, v, mask) for _ in range(2)]
    torch.cuda.synchronize()
    assert int8_attention.route_launches("fused_f32") == before + 2
    assert got[0].dtype == torch.float32 and torch.equal(got[0], got[1])
    vt, sv = int8_attention.int8_quantize_v_cuda(v)
    vt_ref, sv_ref = quantize_v_plain(v, int8_attention._fused_tp(T))
    assert torch.equal(vt, vt_ref) and torch.equal(sv, sv_ref)
    want = int8_attention.int8_prob_attention_reference(q, k, v, mask)
    step = sv.reshape(2, 1, 4, 64)
    assert bool(((got[0] - want).abs() <= step).all())
    q, k, v, mask = _planted_on(cuda_device, 3, T, 2, seed=18, masked=masked, dtype=torch.float32)
    got = int8_prob_attention(q, k, v, mask)
    want = int8_attention.int8_prob_attention_reference(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("T", [65, 1025])
def test_fused_kernels_at_every_width_on_card(cuda_device, T, d, dtype):
    """The other head widths on the card, bf16 and f32, masked: the values'
    quantization equal to its plain version; the whole route within one
    value step (plus a bf16 ulp in bf16) of the plain route, the launch
    counted under its width; planted operands bit-equal."""
    gen = torch.Generator().manual_seed(22)
    H = 768 // d
    q, k, v = (s * torch.randn(2, T, H, d, generator=gen) for s in (2.0, 2.0, 1.0))
    q, k, v = (t.to(cuda_device, dtype) for t in (q, k, v))
    mask = (torch.rand(2, T, generator=gen) > 0.3).to(cuda_device)
    route = "fused" if dtype == torch.bfloat16 else "fused_f32"
    before = int8_attention.width_launches[route, d]
    got = int8_prob_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert int8_attention.width_launches[route, d] == before + 1
    vt, sv = int8_attention.int8_quantize_v_cuda(v)
    vt_ref, sv_ref = quantize_v_plain(v, int8_attention._fused_tp(T))
    assert torch.equal(vt, vt_ref) and torch.equal(sv, sv_ref)
    want = int8_attention.int8_prob_attention_reference(q, k, v, mask).float()
    bound = sv.reshape(2, 1, H, d).expand(2, T, H, d)
    if dtype == torch.bfloat16:
        bound = bound + torch.exp2(torch.floor(torch.log2(want.abs() + 1e-30)) - 7)
    assert bool(((got.float() - want).abs() <= bound).all())
    q, k, v, mask = _planted_on(cuda_device, 2, T, 3, seed=23, masked=True, dtype=dtype, d=d)
    got = int8_prob_attention(q, k, v, mask)
    want = int8_attention.int8_prob_attention_reference(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
