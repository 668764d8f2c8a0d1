"""The flash-attention slice: the port's `fused_self_attention`, `FusedMHA`
and `SelfAttentionFusion` against the reference's, on the CPU in f32.

The reference's flash branch (JAX's stock Pallas flash attention, forward
and backward) runs here in interpret mode under
`pltpu.force_tpu_interpret_mode()`; for the modules, which pick the branch
themselves, `mvropose_tpu.ops.attention.fused_self_attention` is replaced by
its `use_flash=True` form for the test (`FusedMHA` imports it at call time),
so nothing in the reference changes. On the CPU the port runs its plain
branch; its CUDA kernels are held against that on the card by the
`cuda`-marked tests below and by `chip_smoke.py`.

Tolerances, f32, for sums taken in another order: the attention forward
1e-5 and its q/k/v gradients 2e-5 absolute (measured gaps below 1e-6); the
module's output and token gradient 1e-5 absolute (measured 2.4e-6), its
parameter gradients 1e-5 absolute plus 1e-5 relative (measured 2.2e-5 on
gradients of up to 61); the estimator at T >= 2048 as the serve-parity
tests (`test_torch_serve.py`) and the train-step test (`test_torch_train.py`).
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import mvropose_tpu.ops.attention as jax_attention
from mvropose_tpu.models import EstimatorConfig as JaxEstimatorConfig
from mvropose_tpu.models import MultiViewPoseEstimator as JaxEstimator
from mvropose_tpu.models import SelfAttentionFusion as JaxSelfAttentionFusion
from mvropose_tpu.models.vit import ViTConfig as JaxViTConfig
from mvropose_tpu.train.losses import masked_multiview_heatmap_loss
from mvropose_tpu.train.step import _huber_per_sample, _weighted_mean

from mvropose_torch.models import MultiViewPoseEstimator, SelfAttentionFusion
from mvropose_torch.models.heads import DecoderLayer
from mvropose_torch.ops import attention
from mvropose_torch.train import TrainConfig, create_train_state, make_multi_view_train_step
from mvropose_torch.utils.weights import export_jax_params, load_jax_params, plan_jax_params
from test_torch_serve import port_config
from test_torch_train import jax_without_dropout  # noqa: F401 - a fixture
from torch_parity import export_npz, np32, random_variables


def _qkv(rng, B, T, H, d):
    return [rng.normal(size=(B, T, H, d)).astype(np.float32) for _ in range(3)]


def _jax_attention(q, k, v, ct, mask, use_flash):
    """Output and q/k/v gradients of sum(out * ct) through the reference."""
    km = None if mask is None else jnp.asarray(mask)
    fn = lambda q, k, v: jax_attention.fused_self_attention(  # noqa: E731
        q, k, v, use_flash=use_flash, key_mask=km)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
        grads = vjp(jnp.asarray(ct))
    return [np32(t) for t in (out, *grads)]


def _port_attention(q, k, v, ct, mask):
    """The same through the port (its plain branch, on the CPU)."""
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    km = None if mask is None else torch.from_numpy(mask)
    out = attention.fused_self_attention(*ts, key_mask=km)
    (out * torch.from_numpy(ct)).sum().backward()
    return [np32(t) for t in (out, *(t.grad for t in ts))]


@pytest.mark.parametrize("B, T, H, d, masked", [
    (2, 37, 2, 64, True),
    (1, 130, 3, 48, False),
    (1, 520, 2, 32, True),  # T padded to 1024: two key blocks of the reference's kernel
    (1, 2117, 1, 32, True),  # T >= 2048: the reference's flash crossover, f32
])
def test_fused_self_attention_matches_jax_flash(B, T, H, d, masked):
    rng = np.random.default_rng(T)
    q, k, v = _qkv(rng, B, T, H, d)
    ct = rng.normal(size=q.shape).astype(np.float32)
    mask = None
    if masked:
        mask = rng.uniform(size=(B, T)) > 0.3
        mask[:, 0] = True  # every batch element keeps a valid key
    got = _port_attention(q, k, v, ct, mask)
    for use_flash in (True, False):
        want = _jax_attention(q, k, v, ct, mask, use_flash)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5, err_msg=f"out {use_flash}")
        for name, g, w in zip("qkv", got[1:], want[1:]):
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-5, err_msg=f"d{name} {use_flash}")
    assert not attention.route_launches


def _all_masked_case():
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 2, 37, 2, 64)
    ct = rng.normal(size=q.shape).astype(np.float32)
    mask = rng.uniform(size=(2, 37)) > 0.3
    mask[1] = False  # batch element 1: no valid key
    return q, k, v, ct, mask


def test_all_masked_rows_follow_the_plain_branch():
    """A query with no valid key: the plain branch's value, the mean of v
    over the T real keys, with q and k gradients 0; the port equals the
    reference's use_flash=False branch everywhere."""
    q, k, v, ct, mask = _all_masked_case()
    got = _port_attention(q, k, v, ct, mask)
    want = _jax_attention(q, k, v, ct, mask, use_flash=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5)
    mean_v = v[1].mean(axis=0)  # (H, d)
    np.testing.assert_allclose(got[0][1], np.broadcast_to(mean_v, got[0][1].shape), atol=1e-6)
    assert np.abs(got[1][1]).max() == 0 and np.abs(got[2][1]).max() == 0
    # dv of each key of that element: the sum over its queries of ct / T.
    np.testing.assert_allclose(got[3][1], np.broadcast_to(ct[1].sum(0) / 37, got[3][1].shape),
                               atol=1e-5)


def test_reference_flash_branch_averages_all_masked_rows_over_the_padded_length():
    """The divergence the port does not follow, pinned: the reference's
    flash branch gives sum(v) / T_pad (T = 37 padded to 512) where its plain
    branch gives sum(v) / T. Should the reference change, this test shows it."""
    q, k, v, ct, mask = _all_masked_case()
    flash = _jax_attention(q, k, v, ct, mask, use_flash=True)
    np.testing.assert_allclose(flash[0][1], np.broadcast_to(v[1].sum(0) / 512, flash[0][1].shape),
                               atol=1e-6)
    plain = _jax_attention(q, k, v, ct, mask, use_flash=False)
    np.testing.assert_allclose(flash[0][0], plain[0][0], atol=1e-5)  # element 0 agrees


def test_flash_kernels_refuse_cpu_and_unsupported_inputs():
    """The wrapper never runs the plain version: a CPU tensor (bf16, f16 or
    f32), a head width without a kernel, f64 operands and mixed dtypes
    raise, and nothing is counted."""
    bf = lambda d, dtype=torch.bfloat16: [torch.zeros(1, 8, 2, d, dtype=dtype)] * 3  # noqa: E731
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        with pytest.raises(ValueError, match="CUDA tensors"):
            attention.flash_attention_cuda(*bf(64, dtype))
    with pytest.raises(ValueError, match="d = 40"):
        attention.flash_attention_cuda(*bf(40))
    with pytest.raises(ValueError, match="float64"):
        attention.flash_attention_cuda(*bf(64, torch.float64))
    with pytest.raises(ValueError, match="share one dtype"):
        attention.flash_attention_cuda(*bf(64)[:2], bf(64, torch.float32)[0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention.fused_self_attention(*bf(64), use_flash=True)
    assert not attention.route_launches


@pytest.mark.parametrize("B, T, H, d, masked, all_masked", [
    (2, 37, 2, 64, True, True),  # batch element 1 has no valid key
    (1, 130, 3, 48, True, False),  # T past a 128-row tile, d of three 16-column chunks
    (2, 129, 2, 64, False, False),  # one row past a 128-row tile
    (2, 45, 2, 32, False, False),  # d of one 32-column chunk
    (1, 70, 2, 96, True, False),  # T past a 64-row tile (d >= 96 streams 64 rows)
    (1, 131, 1, 128, False, False),  # d of two 64-column chunks
])
def test_flash_backward_plain_matches_autograd_and_jax_flash(B, T, H, d, masked, all_masked):
    """`flash_backward_plain` (the kernels' interface: saved m in base 2 and
    l, di = rowsum(dO o O)) against autograd of the plain branch and against
    the reference's flash backward in interpret mode, f32, at the gradient
    tolerance above; the reference's flash branch only on batch elements
    with a valid key (its all-masked rows average over T padded to 512, see
    below), its plain branch on all. An all-masked row saves m = bf16's
    lowest finite value and l = T, so its backward recomputes P = 1/T."""
    rng = np.random.default_rng(100 + T)
    q, k, v = _qkv(rng, B, T, H, d)
    ct = rng.normal(size=q.shape).astype(np.float32)
    mask = None
    if masked:
        mask = rng.uniform(size=(B, T)) > 0.3
        mask[:, 0] = True
        if all_masked:
            mask[1] = False
    mask_u8 = None if mask is None else attention.mask_bytes(torch.from_numpy(mask))
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, ct))
    o, m, l = attention.flash_forward_plain(qt, kt, vt, mask_u8)
    got = [np32(o), *map(np32, attention.flash_backward_plain(
        qt, kt, vt, mask_u8, dot, m, l, attention.row_dot(dot, o)))]
    autograd = _port_attention(q, k, v, ct, mask)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, autograd):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5, err_msg=f"{name} vs autograd")
    valid = slice(None) if not all_masked else slice(0, 1)
    for use_flash in (True, False):
        want = _jax_attention(q, k, v, ct, mask, use_flash)
        rows = valid if use_flash else slice(None)
        for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g[rows], w[rows], rtol=0, atol=2e-5,
                                       err_msg=f"{name} vs reference use_flash={use_flash}")
    if all_masked:
        np.testing.assert_array_equal(np32(m[1]), np.float32(attention.MASKED_LOGIT))
        np.testing.assert_allclose(np32(l[1]), T, rtol=1e-6)
    assert not attention.route_launches


# f16's half ulp is 2^-11 of a value. Each side rounds, on its way to a
# gradient, P or dS to f16 and the gradient itself (the reference also its
# O, whose rowsum with dO is di): four such roundings of the largest value.
F16_TOL = 2.0 ** -9


@pytest.mark.parametrize("d, masked", [(d, m) for d in (64, 48, 32, 96, 128)
                                        for m in (False, True)])
def test_f16_flash_backward_plain_matches_jax_flash_in_f16(d, masked):
    """`flash_backward_plain` on f16 operands (the f16 Hopper pair's rounding
    points: P and dS rounded to f16 before their products, sm_scale on the
    f32 sums, each output rounded once) on `flash_forward_plain`'s m and l,
    against the reference's stock flash backward run in f16 (interpret mode)
    at T = 2117, at every head width: dQ, dK and dV each within F16_TOL of
    the reference's largest magnitude, and O (both round P before P V and
    round O) too. Where sm_scale is not a power of two (d = 32, 96, 128) the
    reference rounds sm_scale dS where the port rounds dS, one more rounding
    apart. Measured: at most 2^-10.5 of it."""
    rng = np.random.default_rng(2117 + d)
    q, k, v, ct = (a.astype(np.float16) for a in (*_qkv(rng, 1, 2117, 2, d),
                                                  rng.normal(size=(1, 2117, 2, d))))
    mask = None
    if masked:
        mask = rng.uniform(size=(1, 2117)) > 0.3
        mask[:, 0] = True
    mask_u8 = None if mask is None else attention.mask_bytes(torch.from_numpy(mask))
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, ct))
    o, m, l = attention.flash_forward_plain(qt, kt, vt, mask_u8)
    got = [o, *attention.flash_backward_plain(qt, kt, vt, mask_u8, dot, m, l,
                                              attention.row_dot(dot, o))]
    assert all(t.dtype == torch.float16 for t in got)
    want = _jax_attention(q, k, v, ct, mask, use_flash=True)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(np32(g), w, rtol=0, atol=F16_TOL * np.abs(w).max(),
                                   err_msg=name)
    assert not attention.route_launches


def _jax_flash_forward(q, k, v, mask):
    """O, m and l of the reference's stock flash forward (interpret mode) on
    (B, T, H, d) operands, padded and masked by segment ids as
    `mvropose_tpu.ops.attention.fused_self_attention` calls it (block 512):
    O (B, T, H, d) in the operands' dtype, m (natural-log units of the
    scaled logits) and l (B, H, T) f32."""
    from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, _flash_attention_impl

    B, T, H, d = q.shape
    block = 512
    T_pad = -(-T // block) * block
    qh, kh, vh = (jnp.pad(jnp.transpose(jnp.asarray(t), (0, 2, 1, 3)),
                          ((0, 0), (0, 0), (0, T_pad - T), (0, 0))) for t in (q, k, v))
    in_range = jnp.broadcast_to((jnp.arange(T_pad) < T).astype(jnp.int32)[None], (B, T_pad))
    kv_seg = in_range
    if mask is not None:
        kv_seg = in_range * jnp.pad(jnp.asarray(mask).astype(jnp.int32), ((0, 0), (0, T_pad - T)))
    with pltpu.force_tpu_interpret_mode():
        o, l, m = _flash_attention_impl(qh, kh, vh, None, SegmentIds(q=in_range, kv=kv_seg), True,
                                        False, 1.0 / d ** 0.5, 1, block, block, block, False)
    return (np.asarray(jnp.transpose(o[:, :, :T], (0, 2, 1, 3))), np32(m[:, :, :T]),
            np32(l[:, :, :T]))


# bf16 keeps 8 significant bits: an ulp is up to 2^-7 of a value. Each side
# rounds its O once, so the two may lie one ulp apart, and each rounds its
# probabilities before P V (the reference against the running max of its
# 512-key blocks, the port against the row's max), which moves O a little
# more: O within 2^-6 of the reference's largest |O| (measured: 2^-7.1 at
# d = 128, 2^-7.5 at d = 32, 2^-8.2 at d = 48 and 64). m and l are f32 sums
# of the same products in another order, the reference's m in the
# natural-log units of the scaled logits, the port's in base 2: within 1e-5
# (measured: 2.4e-6).
BF16_O_TOL = 2.0 ** -6
STAT_TOL = 1e-5


@pytest.mark.parametrize("d", attention.HEAD_DIMS)
def test_bf16_flash_forward_plain_matches_jax_flash_in_bf16(d):
    """`flash_forward_plain` on bf16 operands (the Hopper forward's rounding
    points: P rounded to bf16 before P V, O rounded once) against the
    reference's stock flash forward in bf16 (interpret mode) at T = 2117 with
    a key mask, at every head width: O within BF16_O_TOL of the reference's
    largest |O|; m (base 2) within STAT_TOL of the reference's m times
    log2(e), absolute; l within STAT_TOL relative."""
    rng = np.random.default_rng(4117 + d)
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(rng, 1, 2117, 2, d))
    mask = rng.uniform(size=(1, 2117)) > 0.3
    mask[:, 0] = True
    o_ref, m_ref, l_ref = _jax_flash_forward(q, k, v, mask)
    qt, kt, vt = (torch.from_numpy(np32(t)).bfloat16() for t in (q, k, v))
    o, m, l = attention.flash_forward_plain(qt, kt, vt,
                                            attention.mask_bytes(torch.from_numpy(mask)))
    assert o.dtype == torch.bfloat16 and o_ref.dtype == jnp.bfloat16
    o_ref = np32(o_ref)
    np.testing.assert_allclose(np32(o), o_ref, rtol=0, atol=BF16_O_TOL * np.abs(o_ref).max())
    np.testing.assert_allclose(np32(m), m_ref * np.float32(attention.LOG2E), rtol=0,
                               atol=STAT_TOL)
    np.testing.assert_allclose(np32(l), l_ref, rtol=STAT_TOL)
    assert not attention.route_launches


CSRC = Path(attention.__file__).resolve().parents[1] / "csrc"


@pytest.mark.parametrize("d", [*attention.HEAD_DIMS, 16, 40, 256])
def test_backward_route_by_head_width(d):
    """Each part, the forward and the backward (dK/dV and dQ), routes by
    dtype at every width of HEAD_DIMS: bf16 takes the Hopper kernels
    ("wgmma"), f16 the same instantiated for f16 ("wgmma_f16"), f32 the
    split-TF32 Hopper forward, dK/dV and dQ of flash_attention_tf32.cu
    ("wgmma_tf32"); these are the only routes, each route's C entry points
    are declared in its source, and no source declares a simt kernel or an
    f32-arithmetic entry point any more; a width without kernels raises, on
    the rule and on the wrappers, which count nothing."""
    if d not in attention.HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32, torch.float16):
            for part in attention.FLASH_PARTS:
                with pytest.raises(ValueError, match=f"d = {d}"):
                    attention.kernel_route(d, dtype, part)
        q = torch.zeros(1, 8, 2, d, dtype=torch.bfloat16)
        stat = torch.ones(1, 2, 8)
        for fn in (attention.flash_backward_dkv_cuda, attention.flash_backward_dq_cuda):
            with pytest.raises(ValueError, match=f"d = {d}"):
                fn(q, q, q, None, q, stat, stat, stat)
        with pytest.raises(ValueError, match=f"d = {d}"):
            attention.flash_attention_cuda(q, q, q)
        with pytest.raises(ValueError, match=f"d = {d}"):
            attention.flash_forward_cuda(q, q, q)
        assert not attention.route_launches
        return
    routes = {dtype: tuple(attention.kernel_route(d, dtype, part) for part in attention.FLASH_PARTS)
              for dtype in (torch.bfloat16, torch.float16, torch.float32)}
    assert attention.kernel_route(d) == attention.kernel_route(d, torch.bfloat16) == "wgmma"
    assert routes == {torch.bfloat16: ("wgmma",) * 3, torch.float16: ("wgmma_f16",) * 3,
                      torch.float32: ("wgmma_tf32",) * 3}
    assert attention.kernel_route(d, torch.float32) == "wgmma_tf32"
    with pytest.raises(ValueError, match="float64"):
        attention.kernel_route(d, torch.float64)
    assert set(attention.ENTRY_POINTS) == {"wgmma", "wgmma_f16", "wgmma_tf32"}
    for route, source, suffix in (("wgmma", "flash_attention.cu", "_sm90"),
                                  ("wgmma_f16", "flash_attention.cu", "_sm90_f16"),
                                  ("wgmma_tf32", "flash_attention_tf32.cu", "_tf32")):
        names = attention.ENTRY_POINTS[route]
        assert names == tuple(f"flash_attention_{name}{suffix}"
                              for name in ("forward", "backward_dkv", "backward_dq"))
        text = (CSRC / source).read_text()
        for name in names:
            assert f'extern "C" int {name}(' in text, name
    # The f32-arithmetic kernels are gone: no source declares a simt kernel
    # or an f32-arithmetic entry point.
    assert not (CSRC / "flash_attention_simt.cu").exists()
    text = "".join(path.read_text() for path in CSRC.glob("*.cu"))
    assert 'extern "C" int flash_attention_forward_sm90_f16(' in text
    assert "simt_kernel" not in text
    for name in ("forward", "backward_dkv", "backward_dq"):
        assert f"flash_attention_{name}_f32(" not in text, name


@pytest.mark.parametrize("dtype, device_type, tokens, kernels", [
    (torch.bfloat16, "cuda", 2048, True),
    (torch.bfloat16, "cuda", 2305, True),
    (torch.bfloat16, "cuda", 2047, False),
    (torch.bfloat16, "cuda", 1025, False),
    (torch.float32, "cuda", 2305, True),  # the reference's flash branch takes f32 on a TPU
    (torch.float16, "cuda", 2305, True),
    (torch.bfloat16, "cpu", 2305, False),
    (torch.float32, "cpu", 2117, False),
])
def test_flash_rule(dtype, device_type, tokens, kernels):
    """use_flash=None takes the kernels for a CUDA q at T >= 2048, whatever
    its dtype, and the plain branch for every other q, decided from device
    type and T alone (no card needed); the dtype picks the kernels' routes:
    f16 the forward and the backward on the Hopper kernels instantiated for
    f16, f32 the forward and the backward on split-TF32 wgmma."""
    assert attention.flash_rule(device_type, tokens) is kernels
    assert tuple(attention.kernel_route(64, dtype, part) for part in attention.FLASH_PARTS) == {
        torch.bfloat16: ("wgmma",) * 3, torch.float32: ("wgmma_tf32",) * 3,
        torch.float16: ("wgmma_f16",) * 3}[dtype]


def test_cpu_tensors_take_the_plain_branch_at_any_t():
    """use_flash=None: the kernels for a CUDA q at T >= 2048 (the
    reference: a TPU at T >= 2048); a CPU q takes the plain branch at any T."""
    q = torch.zeros(1, attention.FLASH_MIN_TOKENS, 1, 32)
    out = attention.fused_self_attention(q, q, q)
    assert out.shape == q.shape and attention.part_launches("fwd") == 0
    assert attention.FLASH_MIN_TOKENS == 2048


# --- SelfAttentionFusion ------------------------------------------------------------


@pytest.fixture
def jax_flash_forced(monkeypatch):
    """The reference's modules take the flash branch (in interpret mode)."""
    monkeypatch.setattr(jax_attention, "fused_self_attention",
                        functools.partial(jax_attention.fused_self_attention, use_flash=True))
    with pltpu.force_tpu_interpret_mode():
        yield


B_F, V_F, N_F, D_F, H_F = 2, 3, 40, 128, 2


def _fusion_case(tmp_path):
    rng = np.random.default_rng(31)
    toks = rng.normal(size=(B_F, V_F, N_F, D_F)).astype(np.float32)
    mask = np.array([[True, False, True], [True, True, True]])
    model = JaxSelfAttentionFusion(num_heads=H_F, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda key: model.init(key, toks, mask), jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed=32)
    port = SelfAttentionFusion(D_F, num_heads=H_F, dtype=torch.float32)
    load_jax_params(port, export_npz(variables, tmp_path / "fusion.npz"))
    return model, variables, port, toks, mask, rng


def test_self_attention_fusion_matches_jax_flash(jax_flash_forced, tmp_path):
    """Forward, and the gradients of every parameter and of the tokens, with
    one view masked, against the reference's module on its flash branch."""
    model, variables, port, toks, mask, rng = _fusion_case(tmp_path)
    ct = rng.normal(size=toks.shape).astype(np.float32)

    def loss(params, toks):
        out = model.apply({"params": params}, toks, jnp.asarray(mask))
        return jnp.sum(out * ct), out

    (_, want), (g_params, g_toks) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(toks))
    t = torch.from_numpy(toks).requires_grad_()
    got = port(t, torch.from_numpy(mask))
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(np32(got), np32(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np32(t.grad), np32(g_toks), rtol=0, atol=1e-5)
    grads = export_npz({"params": g_params}, tmp_path / "grads.npz")
    with np.load(grads) as data:
        g_want = {n: v for n, (_, v) in plan_jax_params(port, dict(data)).items()}
    for name, p in port.named_parameters():
        np.testing.assert_allclose(np32(p.grad), g_want[name], rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_self_attention_fusion_masked_views_contribute_nothing():
    """The reference's mask-invariance check (tests/test_models.py:123-140)
    on the port: a masked view of large garbage changes no real view's
    output."""
    rng = np.random.default_rng(42)
    torch.manual_seed(0)
    model = SelfAttentionFusion(32, num_heads=4, dtype=torch.float32)
    toks = torch.from_numpy(rng.normal(size=(1, 2, 8, 32)).astype(np.float32))
    out2 = model(toks, torch.ones(1, 2, dtype=torch.bool))
    assert out2.shape == (1, 2, 8, 32)
    garbage = torch.from_numpy(rng.normal(size=(1, 1, 8, 32)).astype(np.float32) * 40)
    out3 = model(torch.cat([toks, garbage], dim=1), torch.tensor([[True, True, False]]))
    np.testing.assert_allclose(np32(out3[:, :2]), np32(out2), atol=1e-4)


def test_self_attention_fusion_weights_round_trip(tmp_path):
    """The reference's parameter tree loads strictly and exports back
    unchanged: the same names, shapes and values, DenseGeneral layouts
    included; a missing or an extra leaf raises."""
    _, variables, port, _, _, _ = _fusion_case(tmp_path)
    with np.load(tmp_path / "fusion.npz") as data:
        flat = dict(data)
    assert "self_attn/query/kernel" in flat and flat["self_attn/query/kernel"].shape == (
        D_F, H_F, D_F // H_F)
    back = export_jax_params(port)
    assert set(back) == set(flat)
    for name, arr in flat.items():
        np.testing.assert_array_equal(back[name], arr, err_msg=name)
    with pytest.raises(KeyError):
        load_jax_params(port, {k: v for k, v in flat.items() if k != "norm2/bias"})
    with pytest.raises(KeyError):
        load_jax_params(port, {**flat, "self_attn/extra/kernel": flat["mlp1/kernel"]})


# --- the slice at T >= 2048 -----------------------------------------------------------

# hidden 64, 1 layer, 2 heads (d = 32), 2 views; patch 2 at 92 px: T = 46^2 + 1 = 2117.
LONG = JaxEstimatorConfig(
    vit=JaxViTConfig(image_size=92, patch_size=2, hidden_size=64, num_layers=1, num_heads=2,
                     dtype="float32"),
    num_joints=4, num_angles=3, heatmap_size=(32, 32), max_views=2, num_fusion_queries=4,
    num_angle_queries=2, freeze_backbone=False, dtype="float32",
)


@pytest.fixture(scope="module")
def long_model(tmp_path_factory):
    rng = np.random.default_rng(33)
    images = rng.normal(size=(1, 2, 92, 92, 3)).astype(np.float32)
    view_ids = np.arange(2, dtype=np.int32)[None]
    mask = np.ones((1, 2), bool)
    model = JaxEstimator(LONG)
    shapes = jax.eval_shape(lambda key: model.init(key, images, view_ids, mask),
                            jax.random.PRNGKey(0))
    variables = random_variables(shapes, seed=34)
    npz = export_npz(variables, tmp_path_factory.mktemp("long") / "p.npz")
    return model, variables, npz, {"images": images, "view_ids": view_ids, "view_mask": mask}


def test_estimator_at_t_2117_matches_jax(long_model):
    """The backbone at T >= 2048: heatmaps and angles at the serve-parity
    tolerance. On the CPU both packages take their plain branch."""
    model, variables, npz, batch = long_model
    assert (92 // 2) ** 2 + 1 >= attention.FLASH_MIN_TOKENS
    hm_ref, ang_ref = jax.jit(model.apply)(variables, *map(jnp.asarray, batch.values()))
    port = MultiViewPoseEstimator(port_config(LONG)).eval()
    load_jax_params(port, npz)
    with torch.no_grad():
        hm, ang = port(*(torch.from_numpy(a) for a in batch.values()))
    np.testing.assert_allclose(np32(hm), np32(hm_ref), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np32(ang), np32(ang_ref), rtol=1e-3, atol=1e-3)
    assert attention.part_launches("fwd") == 0


def test_unfrozen_train_step_at_t_2117_matches_jax(long_model, jax_without_dropout, tmp_path):
    """`freeze_backbone=False`: one train step's backbone gradients against
    the reference's, at the tolerance of test_torch_train.py's step test."""
    model, variables, npz, batch = long_model
    rng = np.random.default_rng(35)
    batch = {**batch, "heatmaps": rng.uniform(0, 1, size=(1, 2, 4, 32, 32)).astype(np.float32),
             "angles": rng.uniform(-1, 1, size=(1, 3)).astype(np.float32)}
    tcfg = dict(num_epochs=1, steps_per_epoch=10, freeze_backbone=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):  # the reference's train-step loss (train/step.py)
        (hm, ang), _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   jbatch["images"], jbatch["view_ids"], jbatch["view_mask"],
                                   train=True, mutable=["batch_stats"])
        loss_ang = _weighted_mean(_huber_per_sample(ang, jbatch["angles"], 1.0),
                                  jnp.any(jbatch["view_mask"], axis=1))
        loss_kpt = masked_multiview_heatmap_loss(hm, jbatch["heatmaps"], jbatch["view_mask"])
        return loss_kpt * 100.0 + loss_ang

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    export_npz({"params": g, "batch_stats": variables["batch_stats"]}, tmp_path / "g.npz")
    with np.load(tmp_path / "g.npz") as data:
        flat = dict(data)

    port = MultiViewPoseEstimator(port_config(LONG))
    load_jax_params(port, npz)
    for m in port.modules():
        if isinstance(m, DecoderLayer):
            m.dropout = 0.0
    state = create_train_state(port, TrainConfig(**tcfg))
    got = make_multi_view_train_step(state.cfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
    g_want = {n: v for n, (_, v) in plan_jax_params(port, flat).items()}
    params = dict(port.named_parameters())
    top = max(float(np.abs(g_want[n]).max()) for n in params)
    backbone = [n for n in params if n.startswith("backbone.")]
    assert any("attn.query" in n for n in backbone)
    for name in backbone:
        want = g_want[name]
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(np32(params[name].grad), want, rtol=1e-3,
                                   atol=1e-4 * scale + 1e-8 * top, err_msg=name)
    assert not attention.route_launches


# --- the kernels on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash-attention kernels have no CPU mode")
    return torch.device("cuda")


def _card_case(device, B, T, H, d, masked, seed, dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, T, H, d, generator=gen).to(device, dtype) for _ in range(3))
    do = torch.randn(B, T, H, d, generator=gen).to(device, dtype)
    mask = None
    if masked:
        mask = (torch.rand(B, T, generator=gen) > 0.3).to(device)
        mask[-1] = False  # the last batch element has no valid key
    return q, k, v, do, mask


def _largest_grad(case, i):
    """max |gradient i| (1 dQ, 2 dK, 3 dV) of the f32 plain branch on `case`."""
    q, k, v, do, mask = case
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    attention.flash_attention_reference(*ref, mask).backward(do.float())
    return float(ref[i - 1].grad.abs().max()) + 1e-6


def _errors(fn, q, k, v, do, mask):
    """max |fn - f32 plain| of O, dQ, dK, dV."""
    ref = [t.detach().requires_grad_() for t in (q.float(), k.float(), v.float())]
    out_ref = attention.flash_attention_reference(*ref, mask)
    out_ref.backward(do.float())
    ts = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fn(*ts, mask)
    out.backward(do)
    return [float((a.float() - b).abs().max())
            for a, b in zip((out, *(t.grad for t in ts)), (out_ref, *(t.grad for t in ref)))]


@pytest.mark.cuda
@pytest.mark.parametrize("B, T, H, d, masked, dtype", [
    (2, 2305, 4, 64, False, torch.bfloat16), (2, 1000, 3, 64, True, torch.bfloat16),
    (1, 37, 2, 48, True, torch.bfloat16), (3, 1, 2, 32, False, torch.bfloat16),
    (1, 300, 2, 96, True, torch.bfloat16), (1, 200, 2, 128, False, torch.bfloat16),
    (2, 129, 3, 64, True, torch.bfloat16),  # one row past the Hopper kernels' 128-row tiles
    (2, 2305, 3, 64, True, torch.bfloat16),  # the 768-px token count with a mask
    (3, 1, 2, 64, False, torch.bfloat16),  # T = 1 on the Hopper route
    (2, 2052, 8, 96, True, torch.bfloat16),  # SelfAttentionFusion's default 8 heads at D = 768
    (2, 2305, 4, 64, True, torch.float16),  # the Hopper kernels in f16
    (1, 300, 3, 48, True, torch.float16),
])
def test_flash_kernels_match_plain_on_card(cuda_device, B, T, H, d, masked, dtype):
    """O, dQ, dK and dV of the kernels (one launch of each, on the dtype's
    route) are no further from the f32 plain branch than the plain branch in
    the operands' dtype is, or than 1e-6: at T = 1 the plain branch's dQ and
    dK are exactly 0 (a softmax over one key) and the kernels' a difference
    of two f32 sums of the same products. In f16 the gradients are held
    within F16_TOL of the largest instead (the f16 plain branch rounds its
    logits to f16, the kernels only P, dS and the outputs)."""
    case = _card_case(cuda_device, B, T, H, d, masked, seed=T, dtype=dtype)
    route = attention.kernel_route(d, dtype)
    before = attention.route_launches.copy()
    kernel = _errors(attention.flash_attention_cuda, *case)
    plain = _errors(attention.flash_attention_reference, *case)
    torch.cuda.synchronize()
    assert attention.route_launches - before == {("fwd", route): 1, ("dkv", route): 1,
                                                 ("dq", route): 1}
    for i, (name, e_kernel, e_plain) in enumerate(zip(("O", "dQ", "dK", "dV"), kernel, plain)):
        assert e_kernel <= max(e_plain, 1e-6) or (
            dtype == torch.float16 and i > 0 and e_kernel <= F16_TOL * _largest_grad(case, i)
        ), (name, e_kernel, e_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, d", [(torch.float32, 64), (torch.float32, 48),
                                      (torch.float16, 64), (torch.float32, 128),
                                      (torch.float32, 32), (torch.float32, 96)])
def test_simt_kernels_match_plain_on_card(cuda_device, dtype, d):
    """f32 and f16 operands at T = 2305 with a mask (an all-masked batch
    element included): `fused_self_attention` launches, for f32, the
    split-TF32 forward, dK/dV and dQ, for f16 the Hopper kernels
    instantiated for f16; O, dQ, dK, dV are within 1e-5 of
    the largest magnitude of the plain branch in f32 for f32 operands; for
    f16 O within 2^-10 (the forward rounds P and O to f16) and the gradients
    within F16_TOL (the pair rounds P, dS and the gradients to f16). The f32
    forward alone, at every width, against `flash_forward_plain`: O within
    1e-5 of its largest |O|, closer than the one-TF32-product model's O, m
    (base 2) within 2^-10 and exact on all-masked rows, l within 2^-9
    relative, two calls bit-identical."""
    q, k, v, do, mask = (t if t is None or t.dtype == torch.bool else t.to(dtype)
                         for t in _card_case(cuda_device, 2, 2305, 2, d, True, seed=d))
    routes = tuple(attention.kernel_route(d, dtype, part) for part in attention.FLASH_PARTS)
    before = attention.route_launches.copy()
    ts = [t.detach().requires_grad_() for t in (q, k, v)]
    out = attention.fused_self_attention(*ts, key_mask=mask)
    out.backward(do)
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    out_ref = attention.flash_attention_reference(*ref, mask)
    out_ref.backward(do.float())
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert attention.route_launches - before == {(p, r): 1 for p, r in
                                                 zip(attention.FLASH_PARTS, routes)}
    assert routes == (("wgmma_tf32",) * 3 if dtype == torch.float32 else ("wgmma_f16",) * 3)
    rel = [1e-5] * 4 if dtype == torch.float32 else [2.0 ** -10] + [F16_TOL] * 3
    for name, a, b, r in zip(("O", "dQ", "dK", "dV"), (out, *(t.grad for t in ts)),
                             (out_ref, *(t.grad for t in ref)), rel):
        err = float((a.float() - b).abs().max())
        assert err <= r * float(b.abs().max()) + 1e-6, (name, err)
    if dtype != torch.float32:
        return
    mask_u8 = attention.mask_bytes(mask)
    runs = [attention.flash_forward_cuda(q, k, v, mask_u8) for _ in range(2)]
    o_ref, m_ref, l_ref = attention.flash_forward_plain(q, k, v, mask_u8)
    one = attention.flash_forward_tf32_model(q, k, v, mask_u8, products=1)[0]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    o, m, l = runs[0]
    err = float((o - o_ref).abs().max())
    assert err <= 1e-5 * float(o_ref.abs().max()) + 1e-6, err
    assert err < float((one - o_ref).abs().max()), err
    attended = m_ref > attention.MASKED_LOGIT
    assert torch.equal(m[~attended], m_ref[~attended])
    assert float((m - m_ref)[attended].abs().max()) <= 2.0 ** -10
    assert float(((l - l_ref) / l_ref).abs().max()) <= 2.0 ** -9


@pytest.mark.cuda
@pytest.mark.parametrize("B, T, H, d, masked", [
    (2, 2305, 3, 64, True), (2, 129, 2, 64, False), (1, 300, 2, 48, True),
    (2, 2305, 4, 32, True), (2, 2305, 2, 96, True), (2, 2305, 2, 128, True),
    (2, 129, 3, 48, False),
])
def test_backward_kernels_alone_match_plain_on_card(cuda_device, B, T, H, d, masked):
    """Each backward kernel alone (the Hopper dK/dV and dQ at every width)
    against `flash_backward_plain` in f32 on the forward kernel's saved
    statistics: within 2^-6 of the plain gradient's largest magnitude (the
    kernels round P, dS and their outputs to bf16), plus 1e-6; two calls are
    bit-identical (no atomics)."""
    q, k, v, do, mask = _card_case(cuda_device, B, T, H, d, masked, seed=T + 1)
    mask_u8 = attention.mask_bytes(mask)
    o, m, l = attention.flash_forward_cuda(q, k, v, mask_u8)
    args = (q, k, v, mask_u8, do, m, l, attention.row_dot(do, o))
    want = attention.flash_backward_plain(q.float(), k.float(), v.float(), mask_u8, do.float(),
                                          *args[5:])
    before = attention.route_launches.copy()
    runs = [(attention.flash_backward_dq_cuda(*args), *attention.flash_backward_dkv_cuda(*args))
            for _ in range(2)]
    torch.cuda.synchronize()
    launched = attention.route_launches - before
    assert launched == {("dq", "wgmma"): 2, ("dkv", "wgmma"): 2}, launched
    for name, a, b, w in zip(("dQ", "dK", "dV"), *runs, want):
        assert torch.equal(a, b), name
        err = float((a.float() - w).abs().max())
        assert err <= 2.0 ** -6 * float(w.abs().max()) + 1e-6, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", attention.HEAD_DIMS)
def test_f16_backward_pair_alone_matches_plain_on_card(cuda_device, d):
    """The f16 Hopper pair alone at (2, 2305, 768 / d, d) with a mask (an
    all-masked batch element included) against `flash_backward_plain` in f32
    on the f16 Hopper forward's saved m and l: within F16_TOL of the plain
    gradient's largest magnitude, plus 1e-6; two calls bit-identical."""
    q, k, v, do, mask = _card_case(cuda_device, 2, 2305, 768 // d, d, True, seed=d + 2)
    q, k, v, do = (t.half() for t in (q, k, v, do))
    mask_u8 = attention.mask_bytes(mask)
    o, m, l = attention.flash_forward_cuda(q, k, v, mask_u8)
    args = (q, k, v, mask_u8, do, m, l, attention.row_dot(do, o))
    want = attention.flash_backward_plain(q.float(), k.float(), v.float(), mask_u8, do.float(),
                                          *args[5:])
    before = attention.route_launches.copy()
    runs = [(attention.flash_backward_dq_cuda(*args), *attention.flash_backward_dkv_cuda(*args))
            for _ in range(2)]
    torch.cuda.synchronize()
    launched = attention.route_launches - before
    assert launched == {("dq", "wgmma_f16"): 2, ("dkv", "wgmma_f16"): 2}, launched
    for name, a, b, w in zip(("dQ", "dK", "dV"), *runs, want):
        assert a.dtype == torch.float16 and torch.equal(a, b), name
        err = float((a.float() - w).abs().max())
        assert err <= F16_TOL * float(w.abs().max()) + 1e-6, (name, err)
