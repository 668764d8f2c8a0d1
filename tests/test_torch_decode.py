"""Peak decode and heatmap geometry: the torch port vs the JAX reference.

The JAX kernel runs as the JAX suite runs it on the CPU (Pallas interpret
mode); the port's wrapper takes its plain-torch version for CPU tensors.
Tolerances:
  * argmax coordinates exact: both take the first index of the maximum;
  * confidence 1e-6: sigmoid of the same f32 peak, exp implementations differ
    in the last ulp;
  * soft-argmax 1e-3 px: sums of up to 16k f32 terms in another order.
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


@pytest.mark.parametrize("case", sorted(CASES))
def test_peak_decode_matches_jax_kernel(case):
    maps, temperature = CASES[case]
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card(cuda_device, case):
    maps, temperature = CASES[case]
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
