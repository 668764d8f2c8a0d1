"""Heatmap render: the port's plain version vs the JAX kernel and jnp render.

`fused_render_heatmaps` on CPU tensors runs `render_heatmaps_reference`, the
plain torch version of the Pallas body; it is held against
`render_heatmaps_pallas` in interpret mode (the same f32 operations: atol
1e-6, the bound of tests/test_ops.py:39, on values in [0, 1]) and against
the jnp `render_heatmaps` (which divides by 2 sigma^2 where the kernel
multiplies by its reciprocal: also 1e-6). The CUDA kernel is held against
the plain version on the card (`cuda` marker here, and `chip_smoke.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvropose_tpu.geometry.heatmap import render_heatmaps as jax_render
from mvropose_tpu.ops.heatmap_render import render_heatmaps_pallas

from mvropose_torch.ops import heatmap_render
from mvropose_torch.ops.heatmap_render import (
    fused_render_heatmaps,
    render_heatmaps_cuda,
    render_heatmaps_reference,
)
import torch_parity  # noqa: F401  (one torch thread a test process)

TOL = dict(rtol=0, atol=1e-6)


def _keypoints(case: str, rng) -> tuple[np.ndarray, object, int, int]:
    """(keypoints (2, J, 2), sigma, H, W) for a named case."""
    if case == "inside":
        return rng.uniform(0, 63, size=(2, 8, 2)).astype(np.float32), 5.0, 64, 64
    if case == "per_map_sigma":
        sig = np.array([0.3, 1.0, 2.0, 6.0], np.float32)  # 0.3: most of the map at the floor
        return rng.uniform(5, 40, size=(2, 4, 2)).astype(np.float32), sig, 48, 40
    if case == "outside":  # just and far outside the map, as the synthetic projections fall
        kp = np.array([[[-0.5, 20.0], [39.7, 10.0], [12.0, -2.5], [-900.0, -900.0]],
                       [[1e4, 3.0], [5.0, 1e5], [47.2, 47.9], [20.0, 30.0]]], np.float32)
        return kp, 2.0, 32, 40
    if case == "half_pixel_ties":  # (c - x)^2 equal for c = x -/+ 0.5
        return np.floor(rng.uniform(2, 30, size=(2, 6, 2))).astype(np.float32) + 0.5, 2.0, 32, 32
    raise ValueError(case)


@pytest.mark.parametrize("case", ["inside", "per_map_sigma", "outside", "half_pixel_ties"])
def test_plain_render_matches_pallas_and_jnp(case, rng):
    kp, sigma, H, W = _keypoints(case, rng)
    jsig = jnp.asarray(sigma) if isinstance(sigma, np.ndarray) else sigma
    tsig = torch.from_numpy(sigma) if isinstance(sigma, np.ndarray) else sigma
    got = fused_render_heatmaps(torch.from_numpy(kp), H, W, sigma=tsig).numpy()
    want_pallas = np.asarray(render_heatmaps_pallas(jnp.asarray(kp), H, W, sigma=jsig,
                                                    interpret=True))
    want_jnp = np.asarray(jax_render(jnp.asarray(kp), H, W, sigma=jsig))
    assert got.shape == (2, kp.shape[1], H, W) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_pallas, **TOL)
    np.testing.assert_allclose(got, want_jnp, **TOL)
    if case == "outside":  # every value underflows: peak 0, the map all zeros
        assert not got[0, 3].any() and not got[1, 0].any() and not got[1, 1].any()
        assert got[0, 0].max() > 0.1  # half a pixel outside still peaks inside


def test_per_map_sigma_broadcasts_over_lead_dims_not_width():
    """A (J,) sigma with J == W must pair with the keypoints, never with W."""
    kp = np.random.default_rng(3).uniform(2, 14, size=(2, 16, 2)).astype(np.float32)
    sig = np.linspace(1.0, 4.0, 16).astype(np.float32)
    got = fused_render_heatmaps(torch.from_numpy(kp), 16, 16, sigma=torch.from_numpy(sig))
    for j in (0, 7, 15):
        one = fused_render_heatmaps(torch.from_numpy(kp[:, j]), 16, 16, sigma=float(sig[j]))
        assert torch.equal(got[:, j], one)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = heatmap_render.launches
    rows = torch.tensor([[3.0, 4.0, 0.125], [1.5, 2.5, 0.125]])  # sigma 2
    out = fused_render_heatmaps(rows[:, :2], 6, 7, sigma=2.0)
    assert torch.equal(out, render_heatmaps_reference(rows, 6, 7))
    assert heatmap_render.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        render_heatmaps_cuda(rows, 6, 7)
    empty = fused_render_heatmaps(torch.zeros(0, 2), 5, 5)
    assert empty.shape == (0, 5, 5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["inside", "per_map_sigma", "outside", "half_pixel_ties"])
def test_kernel_matches_plain_on_card(cuda_device, case):
    kp, sigma, H, W = _keypoints(case, np.random.default_rng(5))
    tsig = torch.from_numpy(sigma) if isinstance(sigma, np.ndarray) else sigma
    before = heatmap_render.launches
    got = fused_render_heatmaps(torch.from_numpy(kp).to(cuda_device), H, W, sigma=tsig)
    torch.cuda.synchronize()
    assert heatmap_render.launches == before + 1
    kp_card = torch.from_numpy(kp).to(cuda_device).reshape(-1, 2)
    rows = torch.cat([kp_card, heatmap_render._inv_two_sigma_sq(tsig, [2, kp.shape[1]],
                                                                 cuda_device)], dim=1)
    plain = render_heatmaps_reference(rows, H, W).reshape(got.shape)
    assert torch.equal(got, plain)  # the same f32 operations and expf on the card
    cpu = fused_render_heatmaps(torch.from_numpy(kp), H, W, sigma=tsig)
    np.testing.assert_allclose(got.cpu().numpy(), cpu.numpy(), **TOL)
    with pytest.raises(ValueError, match=r"\(M, 3\) f32"):
        render_heatmaps_cuda(torch.zeros(2, 2, device=cuda_device), H, W)
