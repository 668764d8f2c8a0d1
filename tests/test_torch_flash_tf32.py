"""The f32 flash kernels' split-TF32 arithmetic, on the CPU.

On the card the f32 forward, dK/dV and dQ (`csrc/flash_attention_tf32.cu`)
form each f32 product as three TF32 products, a_big b_big + a_big b_small +
a_small b_big, accumulated in f32. `attention.flash_forward_tf32_model` and
`attention.flash_backward_tf32_model` are that arithmetic in plain torch;
here they are held, at T = 2117 in f32 with and without a key mask, against
the reference's flash branch (its stock Pallas forward, and its dK/dV and
dQ through `jax.vjp`, in interpret mode, as
`test_fused_self_attention_matches_jax_flash` runs them) and against
`flash_forward_plain` / `flash_backward_plain`, within F32_TOL of the
largest |O| or of each gradient's largest magnitude: the bound that
`chip_smoke.py` (F32_TOL) and the `cuda`-marked tests hold the kernels to.
The same models with one TF32 product in place of three miss that bound by
far, so the bound catches a kernel that drops the small terms. The kernels
themselves run on the card only (`chip_smoke.py`,
`tests/test_torch_attention.py::test_simt_kernels_match_plain_on_card`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import mvropose_tpu.ops.attention as jax_attention
from mvropose_torch.ops import attention
from torch_parity import np32

# O (and each gradient) against f32 on the same values, as a share of the
# largest |O| (of the gradient's largest magnitude): the f32 kernels' bound
# on the card. The split drops ~2^-20 of each product; on
# these inputs the model lies 1.5e-6 to 2.2e-6 of max |O| from the plain
# forward (which is itself ~1e-6 from f64), one TF32 product 2.2e-3 to 3e-3.
F32_TOL = 1e-5
# m (base 2) absolute and l relative, against `flash_forward_plain`: f32
# sums of nearly the same products (measured: below 1e-5).
STAT_TOL = 2.0 ** -10
CASES = [(32, True), (64, False), (48, True)]


def _case(d: int, masked: bool):
    """(1, 2117, 2, d) f32 q, k, v as numpy and torch, and a (1, 2117) key
    mask (key 0 always attended, so no row is all masked) or None."""
    rng = np.random.default_rng(2117 + 3 * d + masked)
    q, k, v = (rng.normal(size=(1, 2117, 2, d)).astype(np.float32) for _ in range(3))
    mask = None
    if masked:
        mask = rng.uniform(size=(1, 2117)) > 0.3
        mask[:, 0] = True
    return (q, k, v), [torch.from_numpy(a) for a in (q, k, v)], mask


def _jax_flash_grads(q, k, v, mask, ct) -> list:
    """dQ, dK, dV of sum(out * ct) through the reference's flash branch
    (use_flash=True: its stock flash backward), interpret mode."""
    km = None if mask is None else jnp.asarray(mask)
    fn = lambda q, k, v: jax_attention.fused_self_attention(  # noqa: E731
        q, k, v, use_flash=True, key_mask=km)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
        grads = vjp(jnp.asarray(ct))
    return [np32(t) for t in grads]


def _backward_case(d: int, masked: bool):
    """`_case`'s operands, a cotangent dO (numpy and torch), and the
    backward's inputs from `flash_forward_plain`: (mask_u8, m, l, di)."""
    arrays, (q, k, v), mask = _case(d, masked)
    ct = np.random.default_rng(4231 + d + masked).normal(size=arrays[0].shape).astype(np.float32)
    do = torch.from_numpy(ct)
    mask_u8 = None if mask is None else attention.mask_bytes(torch.from_numpy(mask))
    o, m, l = attention.flash_forward_plain(q, k, v, mask_u8)
    return arrays, ct, mask, (q, k, v, mask_u8, do, m, l, attention.row_dot(do, o))


def _jax_flash(q, k, v, mask) -> np.ndarray:
    """The reference's flash branch (use_flash=True), forward, interpret mode."""
    km = None if mask is None else jnp.asarray(mask)
    with pltpu.force_tpu_interpret_mode():
        out = jax_attention.fused_self_attention(*map(jnp.asarray, (q, k, v)), use_flash=True,
                                                 key_mask=km)
    return np32(out)


@pytest.mark.parametrize("x", [
    np.float32([1.0, -1.0, 1.0 / 3.0, 3.0e-30, 1.7e38, 0.0, -0.0]),  # small parts normal
    np.random.default_rng(0).normal(size=4096).astype(np.float32),
    np.random.default_rng(1).uniform(0, 1, size=4096).astype(np.float32),  # probabilities
])
def test_tf32_split_parts_are_exact_tf32_values(x):
    """big and small have their low 13 mantissa bits clear (exact TF32
    values), x - big is exact in f32, big has x's sign and is no larger, and
    x - big - small is within 2^-20 of |x|."""
    t = torch.from_numpy(x)
    big, small = attention.tf32_split(t)
    for part in (big, small):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rest = t - big
    assert torch.equal((rest.double() + big.double()).float(), t)  # rest is exact
    assert bool(((big.abs() <= t.abs()) & ((big == 0) | (big.sign() == t.sign()))).all())
    gap = (t.double() - big.double() - small.double()).abs()
    assert bool((gap <= 2.0 ** -20 * t.double().abs()).all())


@pytest.mark.parametrize("d, masked", CASES)
def test_tf32_model_matches_jax_flash_and_plain(d, masked):
    """The split-TF32 forward (three products) within F32_TOL of max |O| of
    the reference's flash branch and of `flash_forward_plain`; its m and l
    within STAT_TOL of the plain forward's."""
    arrays, (q, k, v), mask = _case(d, masked)
    mask_u8 = None if mask is None else attention.mask_bytes(torch.from_numpy(mask))
    o, m, l = attention.flash_forward_tf32_model(q, k, v, mask_u8)
    o_plain, m_plain, l_plain = attention.flash_forward_plain(q, k, v, mask_u8)
    o_jax = _jax_flash(*arrays, mask)
    for name, want in (("reference flash branch", o_jax), ("flash_forward_plain", np32(o_plain))):
        np.testing.assert_allclose(np32(o), want, rtol=0, atol=F32_TOL * np.abs(want).max(),
                                   err_msg=name)
    np.testing.assert_allclose(np32(m), np32(m_plain), rtol=0, atol=STAT_TOL)
    np.testing.assert_allclose(np32(l), np32(l_plain), rtol=2 * STAT_TOL)
    assert not attention.route_launches


@pytest.mark.parametrize("d, masked", CASES)
def test_one_tf32_product_misses_the_bound(d, masked):
    """The negative control: with a_big b_big alone (one TF32 product, as a
    kernel that dropped the small terms would compute) O lies more than
    F32_TOL of max |O| from `flash_forward_plain`, and over 100 times
    further than the three products' O."""
    _, (q, k, v), mask = _case(d, masked)
    mask_u8 = None if mask is None else attention.mask_bytes(torch.from_numpy(mask))
    o_plain = attention.flash_forward_plain(q, k, v, mask_u8)[0]
    top = float(o_plain.abs().max())
    err = {n: float((attention.flash_forward_tf32_model(q, k, v, mask_u8, n)[0] - o_plain)
                    .abs().max()) for n in (1, 3)}
    assert err[1] > F32_TOL * top, err
    assert err[1] > 100 * err[3], err


@pytest.mark.parametrize("d, masked", CASES)
def test_tf32_backward_model_matches_jax_flash_and_plain(d, masked):
    """The split-TF32 backward (three products each) on the plain forward's
    m and l: dQ, dK, dV within F32_TOL of each gradient's largest magnitude
    of the reference's flash backward (`jax.vjp` of its flash branch) and of
    `flash_backward_plain`. Measured on these inputs: 1.2e-6 to 4.7e-6 of
    the largest magnitude from the plain backward, 1.4e-6 to 4.8e-6 from
    the reference's."""
    arrays, ct, mask, args = _backward_case(d, masked)
    got = [np32(g) for g in attention.flash_backward_tf32_model(*args)]
    want_plain = [np32(g) for g in attention.flash_backward_plain(*args)]
    want_jax = _jax_flash_grads(*arrays, mask, ct)
    for source, want in (("reference flash backward", want_jax),
                         ("flash_backward_plain", want_plain)):
        for name, g, w in zip(("dQ", "dK", "dV"), got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=F32_TOL * np.abs(w).max(),
                                       err_msg=f"{name} vs {source}")
    assert not attention.route_launches


@pytest.mark.parametrize("d, masked", CASES)
def test_one_tf32_product_misses_the_backward_bound(d, masked):
    """The negative control of the backward: with a_big b_big alone in each
    of its five products (as a pair that dropped the small terms would
    compute) every gradient lies more than F32_TOL of its largest magnitude
    from `flash_backward_plain` (measured: 4.0e-3 to 7.8e-3), and over 100
    times further than the three products' gradient."""
    _, _, _, args = _backward_case(d, masked)
    want = attention.flash_backward_plain(*args)
    got = {n: attention.flash_backward_tf32_model(*args, products=n) for n in (1, 3)}
    for i, name in enumerate(("dQ", "dK", "dV")):
        top = float(want[i].abs().max())
        err = {n: float((got[n][i] - want[i]).abs().max()) for n in (1, 3)}
        assert err[1] > F32_TOL * top, (name, err)
        assert err[1] > 100 * err[3], (name, err)
