"""Peak decode and heatmap geometry: the torch port vs the JAX reference.

The JAX kernel runs as the JAX suite runs it on the CPU (Pallas interpret
mode); the port's wrapper takes its plain-torch version for CPU tensors.
Tolerances:
  * argmax coordinates exact: both take the first index of the maximum;
  * confidence 1e-6: sigmoid of the same f32 peak, exp implementations differ
    in the last ulp;
  * soft-argmax 1e-3 px: sums of up to 16k f32 terms in another order;
  * a NaN compares equal to a NaN: a map that holds one decodes, in the JAX
    kernel, to peak NaN, argmax index H*W (x = 0, y = H), NaN soft sums and
    confidence, and so must the port's on every route.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvropose_tpu.decode import decode_keypoints as jax_decode_keypoints
from mvropose_tpu.geometry import heatmap as jax_heatmap
from mvropose_tpu.ops.peak_decode import fused_peak_decode as jax_fused_peak_decode

from mvropose_torch.decode import decode_keypoints
from mvropose_torch.geometry import heatmap
from mvropose_torch.ops import peak_decode
from mvropose_torch.ops.peak_decode import fused_peak_decode, peak_decode_reference
import torch_parity  # noqa: F401  (one torch thread a test process)

FIXTURES = Path(__file__).parent / "fixtures" / "decode_fixtures.npz"


def _ties(rng) -> np.ndarray:
    """Maps with planted exact ties: two equal maxima (the earlier raster
    index must win), a constant map (index 0 wins), and a tie in one row."""
    maps = rng.normal(size=(4, 32, 32)).astype(np.float32)
    maps[0, 20, 3] = maps[0, 7, 30] = 9.0
    maps[1] = 0.5
    maps[2, 5, 10] = maps[2, 5, 11] = maps[2, 5, 12] = 7.0
    maps[3, 31, 31] = maps[3, 0, 31] = 8.0
    return maps


def _cases():
    rng = np.random.default_rng(0)
    fixtures = np.load(FIXTURES)
    return {
        "logits_t1": (rng.normal(size=(4, 8, 32, 32)).astype(np.float32), 1.0),
        "logits_t2": (3.0 * rng.normal(size=(4, 8, 32, 32)).astype(np.float32), 2.0),
        "nonmultiple_m": (rng.normal(size=(5, 32, 32)).astype(np.float32), 1.0),
        "ties": (_ties(rng), 1.0),
        **{f"fixture_{k}": (fixtures[k], 1.0) for k in fixtures.files},
    }


CASES = _cases()


def _poisoned(rng) -> dict:
    """Maps with a NaN (one at (x=3, y=2); one at the last index; two; every
    value), at temperatures 1 and 2, and maps of all -inf beside a finite one."""
    nan = rng.normal(size=(4, 8, 8)).astype(np.float32)
    nan[0, 2, 3] = np.nan
    nan[1, 7, 7] = np.nan
    nan[2, 0, 0] = nan[2, 5, 1] = np.nan
    nan[3] = np.nan
    neg_inf = rng.normal(size=(3, 8, 8)).astype(np.float32)
    neg_inf[0] = neg_inf[2] = -np.inf
    return {"nan_t1": (nan, 1.0), "nan_t2": (nan, 2.0), "all_neg_inf": (neg_inf, 1.0)}


# The JAX kernel's decode of NaN and -inf maps: kernel parity only (the
# reference's host decoders take torch's argmax rule, which these maps split).
KERNEL_CASES = {**CASES, **_poisoned(np.random.default_rng(5))}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_peak_decode_matches_jax_kernel(case):
    maps, temperature = KERNEL_CASES[case]
    want = jax_fused_peak_decode(jnp.asarray(maps), temperature=temperature)
    got = fused_peak_decode(torch.from_numpy(maps), temperature=temperature)
    np.testing.assert_array_equal(got["argmax_xy"].numpy(), np.asarray(want["argmax_xy"]))
    np.testing.assert_allclose(got["confidence"].numpy(), np.asarray(want["confidence"]), atol=1e-6)
    np.testing.assert_allclose(got["soft_xy"].numpy(), np.asarray(want["soft_xy"]), atol=1e-3)
    np.testing.assert_array_equal(got["peak"].numpy(), np.asarray(want["peak"]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_peak_decode_matches_jax_decoders(case):
    maps, temperature = CASES[case]
    xy_ref, conf_ref = jax_heatmap.argmax_decode(jnp.asarray(maps))
    soft_ref, _ = jax_heatmap.soft_argmax_decode(jnp.asarray(maps), temperature=temperature)
    rows = torch.from_numpy(maps).reshape(-1, *maps.shape[-2:])
    out = peak_decode_reference(rows, temperature).reshape(*maps.shape[:-2], 8).numpy()
    np.testing.assert_array_equal(out[..., 0:2], np.asarray(xy_ref))
    np.testing.assert_allclose(out[..., 4], np.asarray(conf_ref), atol=1e-6)
    np.testing.assert_allclose(out[..., 2:4], np.asarray(soft_ref), atol=1e-3)
    np.testing.assert_array_equal(out[..., 6:8], 0.0)


def test_nan_map_decodes_as_the_jax_kernel():
    """One NaN at (x=3, y=2) of an 8x8 map: the argmax is (0, 8), index H*W,
    and the peak, confidence and soft sums are NaN; the finite map beside it
    keeps its own decode."""
    maps = np.random.default_rng(6).normal(size=(2, 8, 8)).astype(np.float32)
    maps[0, 2, 3] = np.nan
    out = fused_peak_decode(torch.from_numpy(maps))
    np.testing.assert_array_equal(out["argmax_xy"][0].numpy(), [0.0, 8.0])
    for key in ("peak", "confidence"):
        assert np.isnan(out[key][0].item()) and np.isfinite(out[key][1].item()), key
    soft = out["soft_xy"].numpy()
    assert np.isnan(soft[0]).all() and np.isfinite(soft[1]).all()
    y, x = np.unravel_index(np.argmax(maps[1]), (8, 8))
    np.testing.assert_array_equal(out["argmax_xy"][1].numpy(), [x, y])


def test_ties_take_the_first_index():
    out = fused_peak_decode(torch.from_numpy(CASES["ties"][0]))["argmax_xy"].numpy()
    np.testing.assert_array_equal(out, [[30, 7], [0, 0], [10, 5], [31, 0]])


def test_cpu_tensor_takes_plain_version():
    before = peak_decode.launches
    fused_peak_decode(torch.zeros(2, 8, 8))
    assert peak_decode.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        peak_decode.peak_decode_cuda(torch.zeros(2, 8, 8))


@pytest.mark.parametrize("apply_sigmoid", [True, False])
def test_geometry_decoders_match_jax(apply_sigmoid):
    maps = CASES["logits_t2"][0]
    jm, tm = jnp.asarray(maps), torch.from_numpy(maps)
    for jax_fn, fn, kw in [
        (jax_heatmap.argmax_decode, heatmap.argmax_decode, {}),
        (jax_heatmap.soft_argmax_decode, heatmap.soft_argmax_decode, {"temperature": 2.0}),
        (jax_heatmap.peak_refine_decode, heatmap.peak_refine_decode, {"temperature": 2.0}),
    ]:
        xy_ref, conf_ref = jax_fn(jm, apply_sigmoid=apply_sigmoid, **kw)
        xy, conf = fn(tm, apply_sigmoid=apply_sigmoid, **kw)
        np.testing.assert_allclose(xy.numpy(), np.asarray(xy_ref), atol=1e-3, err_msg=fn.__name__)
        np.testing.assert_allclose(conf.numpy(), np.asarray(conf_ref), atol=1e-6, err_msg=fn.__name__)


@pytest.mark.parametrize("sigma", [5.0, "per_map"])
def test_render_heatmaps_matches_jax(sigma):
    rng = np.random.default_rng(1)
    kps = rng.uniform(0, 31, size=(2, 3, 2)).astype(np.float32)
    sig = np.array([2.0, 4.0, 6.0], np.float32) if sigma == "per_map" else sigma
    want = jax_heatmap.render_heatmaps(jnp.asarray(kps), 24, 32, sigma=jnp.asarray(sig))
    got = heatmap.render_heatmaps(torch.from_numpy(kps), 24, 32, sigma=torch.as_tensor(sig))
    # f32 exp of the same arguments: agreement to f32 rounding.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("mode", ["argmax", "soft", "refine"])
def test_decode_keypoints_matches_jax(mode):
    maps = CASES["logits_t1"][0]
    xy_ref, conf_ref = jax_decode_keypoints(
        jnp.asarray(maps), image_hw=(720, 1280), mode=mode, use_pallas=False
    )
    xy, conf = decode_keypoints(torch.from_numpy(maps), image_hw=(720, 1280), mode=mode)
    # Image px are heatmap px x 40: the soft modes' 1e-3 px becomes 4e-2.
    atol = 0.0 if mode == "argmax" else 4e-2
    np.testing.assert_allclose(xy.numpy(), np.asarray(xy_ref), atol=atol)
    np.testing.assert_allclose(conf.numpy(), np.asarray(conf_ref), atol=1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the peak-decode kernel has no CPU mode")
    return torch.device("cuda")


def _serve_size_maps(M: int, seed: int) -> np.ndarray:
    return 4.0 * np.random.default_rng(seed).normal(size=(M, 128, 128)).astype(np.float32)


def _poisoned_serve_maps() -> np.ndarray:
    """128x128 maps with a NaN in each cluster rank's slice (and none), all
    -inf, and ties split across the slices of a 4-block cluster."""
    maps = _serve_size_maps(8, 7)
    maps[0, 3, 5] = np.nan  # rank 0's quarter
    maps[1, 127, 127] = np.nan  # the last index: rank C - 1's
    maps[2, 64, 0] = maps[2, 100, 9] = np.nan
    maps[3] = -np.inf
    maps[4, 10, 10] = maps[4, 70, 70] = maps[4, 120, 3] = 40.0  # a tie across ranks
    maps[5] = 0.5  # a constant map: index 0
    maps[6, 120, 127] = 40.0  # the peak in the last slice
    return maps


CARD_CASES = {
    **KERNEL_CASES,
    "serve_poisoned": (_poisoned_serve_maps(), 1.0),
    # M where M * C does not fill the card (C = 8, 8, 4 on 132 SMs), and
    # C = 2 (64 maps: a serve at 8 views x 8 joints).
    **{f"m{M}": (_serve_size_maps(M, M), 1.0) for M in (1, 5, 33, 64)},
    # C = 1 (70 maps): a 192x192 slice, past 16 float4 a thread, read in two parts.
    "large_192": (np.random.default_rng(9).normal(size=(70, 192, 192)).astype(np.float32), 1.0),
}


def test_cluster_blocks():
    """The largest of 8, 4, 2, 1 blocks a map with M of them on the SMs."""
    cases = {(32, 132): 4, (33, 132): 4, (34, 132): 2, (1, 132): 8, (5, 132): 8, (16, 132): 8,
             (64, 132): 2, (66, 132): 2, (67, 132): 1, (500, 132): 1}
    for (M, sms), want in cases.items():
        assert peak_decode.cluster_blocks(M, sms) == want, (M, sms)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_matches_plain_on_card(cuda_device, case):
    """Argmax, peak and padding exact (NaN equal to NaN), confidence 1e-6,
    soft-argmax 1e-3 px."""
    maps, temperature = CARD_CASES[case]
    rows = torch.from_numpy(maps).reshape(-1, *maps.shape[-2:]).to(cuda_device)
    before = peak_decode.launches
    got = peak_decode.peak_decode_cuda(rows, temperature)
    torch.cuda.synchronize()
    assert peak_decode.launches == before + 1
    want = peak_decode_reference(rows, temperature)
    np.testing.assert_array_equal(got[:, 0:2].cpu().numpy(), want[:, 0:2].cpu().numpy())
    np.testing.assert_allclose(got[:, 4].cpu().numpy(), want[:, 4].cpu().numpy(), atol=1e-6)
    np.testing.assert_allclose(got[:, 2:4].cpu().numpy(), want[:, 2:4].cpu().numpy(), atol=1e-3)
    np.testing.assert_array_equal(got[:, 5:8].cpu().numpy(), want[:, 5:8].cpu().numpy())
    np.testing.assert_array_equal(np.isnan(got.cpu().numpy()), np.isnan(want.cpu().numpy()))
