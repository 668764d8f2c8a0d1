"""The port's batched augmentation against the reference's, on its own draws.

Every op of `mvropose_torch/data/augment.py` gets the draws that
`mvropose_tpu/data/augment.py` makes from a `jax.random` key (rebuilt here
key split by key split, as each reference op consumes them) and must give
the reference's batch within 1e-5; so must `augment_batch` whole and the
device preprocessing with augmentation. `draw_augment` is checked for its
shapes, ranges and determinism (its numbers are torch's, not jax.random's).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mvropose_tpu.calib.registry import FR3_SERIAL_TO_VIEW
from mvropose_tpu.calib.registry import load_rig as jax_load_rig
from mvropose_tpu.data import augment as ja
from mvropose_tpu.data import builders as jb
from mvropose_tpu.data import dataset as jds
from mvropose_torch.calib.registry import load_rig as port_load_rig
from mvropose_torch.data import augment as ta
from mvropose_torch.data import builders as tb
from mvropose_torch.data import dataset as tds
from mvropose_torch.data import table
from torch_parity import fr3_capture

TOL = 1e-5
SHAPE = (4, 24, 32, 3)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _batch(seed: int, shape=SHAPE) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def jax_rect(key, B, scale, ratio) -> ta.RectDraws:
    """`_rect_mask`'s draws from `key`."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    u = jax.random.uniform
    return ta.RectDraws(
        _t(u(k1, (B,), minval=scale[0], maxval=scale[1])),
        _t(u(k2, (B,), minval=jnp.log(ratio[0]), maxval=jnp.log(ratio[1]))),
        _t(u(k3, (B,))), _t(u(k4, (B,))))


def jax_jitter(key, B, cfg: ta.AugmentConfig) -> tuple:
    kb, kc, ks, kh, _ = jax.random.split(key, 5)
    u = jax.random.uniform
    return (_t(u(kb, (B, 1, 1, 1), minval=1 - cfg.brightness, maxval=1 + cfg.brightness)),
            _t(u(kc, (B, 1, 1, 1), minval=1 - cfg.contrast, maxval=1 + cfg.contrast)),
            _t(u(ks, (B, 1, 1, 1), minval=1 - cfg.saturation, maxval=1 + cfg.saturation)),
            _t(u(kh, (B,), minval=-cfg.hue, maxval=cfg.hue)))


def jax_augment_draws(key, shape, cfg: ta.AugmentConfig) -> ta.AugmentDraws:
    """Everything `augment_batch(key, img, cfg)` draws, as the port's draws."""
    B = shape[0]
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    u = jax.random.uniform
    ks_sig, ks_apply = jax.random.split(k2)
    km, kf, ka = jax.random.split(k4, 3)
    rects, colors = [], []
    for _ in range(cfg.masking_num):
        kmm, kc, k5 = jax.random.split(k5, 3)
        rects.append(jax_rect(kmm, B, (ta.MASK_RATIO[0] ** 2, ta.MASK_RATIO[1] ** 2),
                              ta.MASK_ASPECT))
        colors.append(_t(u(kc, (B, 1, 1, 3))))
    return ta.AugmentDraws(
        *jax_jitter(k1, B, cfg),
        blur_sigma=_t(u(ks_sig, (), minval=ta.BLUR_SIGMA[0], maxval=ta.BLUR_SIGMA[1])),
        blur_apply=_t(u(ks_apply, (B, 1, 1, 1)) < cfg.blur_prob),
        gray_apply=_t(u(k3, (B, 1, 1, 1)) < cfg.grayscale_prob),
        erase=jax_rect(km, B, ta.ERASE_SCALE, ta.ERASE_RATIO),
        erase_fill=_t(u(kf, shape)),
        erase_apply=_t(u(ka, (B, 1, 1, 1)) < cfg.erasing_prob),
        mask_rects=rects, mask_colors=colors)


@pytest.mark.parametrize("seed", [0, 1])
def test_color_ops_match_reference(seed):
    img = _batch(seed)
    f = np.random.default_rng(seed + 10).uniform(0.7, 1.3, (SHAPE[0], 1, 1, 1)).astype(np.float32)
    delta = np.random.default_rng(seed + 20).uniform(-0.5, 0.5, SHAPE[0]).astype(np.float32)
    x, jx = _t(img), jnp.asarray(img)
    _close(ta.adjust_brightness(x, _t(f)), ja.adjust_brightness(jx, f))
    _close(ta.adjust_contrast(x, _t(f)), ja.adjust_contrast(jx, f))
    _close(ta.adjust_saturation(x, _t(f)), ja.adjust_saturation(jx, f))
    _close(ta.adjust_hue(x, _t(delta)), ja.adjust_hue(jx, delta))


@pytest.mark.parametrize("seed", [0, 5])
def test_color_jitter_matches_reference(seed):
    img, key, cfg = _batch(seed), jax.random.PRNGKey(seed), ta.AugmentConfig(hue=0.4)
    want = ja.color_jitter(key, jnp.asarray(img), cfg.brightness, cfg.contrast, cfg.saturation,
                           cfg.hue)
    _close(ta.color_jitter(_t(img), *jax_jitter(key, SHAPE[0], cfg)), want)


@pytest.mark.parametrize("seed,prob", [(0, 1.0), (1, 0.5), (2, 0.0)])
def test_gaussian_blur_matches_reference(seed, prob):
    img, key = _batch(seed), jax.random.PRNGKey(seed)
    want = ja.gaussian_blur(key, jnp.asarray(img), 5, prob=prob)
    ks_sig, ks_apply = jax.random.split(key)
    sigma = _t(jax.random.uniform(ks_sig, (), minval=0.1, maxval=5.0))
    apply = _t(jax.random.uniform(ks_apply, (SHAPE[0], 1, 1, 1)) < prob)
    _close(ta.gaussian_blur(_t(img), sigma, apply, 5), want)
    # The zero padding darkens the border, as XLA's SAME convolution does.
    if prob == 1.0:
        assert float(ta.gaussian_blur(torch.ones(SHAPE), sigma, apply)[0, 0, 0, 0]) < 1.0


@pytest.mark.parametrize("seed", [0, 3])
def test_grayscale_matches_reference(seed):
    img, key = _batch(seed), jax.random.PRNGKey(seed)
    want = ja.random_grayscale(key, jnp.asarray(img), 0.5)
    apply = _t(jax.random.uniform(key, (SHAPE[0], 1, 1, 1)) < 0.5)
    _close(ta.random_grayscale(_t(img), apply), want)


@pytest.mark.parametrize("seed", [0, 4, 9])
def test_rect_mask_matches_reference(seed):
    key = jax.random.PRNGKey(seed)
    for scale, ratio in ((ta.ERASE_SCALE, ta.ERASE_RATIO), ((0.01, 0.09), ta.MASK_ASPECT)):
        want = ja._rect_mask(key, 8, 24, 32, scale, ratio)
        got = ta.rect_mask(jax_rect(key, 8, scale, ratio), 24, 32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.any()


@pytest.mark.parametrize("seed,prob", [(0, 1.0), (2, 0.5)])
def test_random_erasing_matches_reference(seed, prob):
    img, key = _batch(seed), jax.random.PRNGKey(seed)
    want = ja.random_erasing(key, jnp.asarray(img), prob)
    km, kf, ka = jax.random.split(key, 3)
    got = ta.random_erasing(_t(img), jax_rect(km, SHAPE[0], ta.ERASE_SCALE, ta.ERASE_RATIO),
                            _t(jax.random.uniform(kf, SHAPE)),
                            _t(jax.random.uniform(ka, (SHAPE[0], 1, 1, 1)) < prob))
    _close(got, want)


@pytest.mark.parametrize("num", [1, 3])
def test_random_masking_matches_reference(num):
    img, key = _batch(num), jax.random.PRNGKey(num)
    want = ja.random_masking(key, jnp.asarray(img), num)
    rects, colors, k = [], [], key
    for _ in range(num):
        km, kc, k = jax.random.split(k, 3)
        rects.append(jax_rect(km, SHAPE[0], (0.01, 0.09), ta.MASK_ASPECT))
        colors.append(_t(jax.random.uniform(kc, (SHAPE[0], 1, 1, 3))))
    _close(ta.random_masking(_t(img), rects, colors), want)


@pytest.mark.parametrize("seed,cfg", [
    (0, ta.AugmentConfig()),
    (1, ta.AugmentConfig(blur_prob=1.0, grayscale_prob=0.5, erasing_prob=1.0, masking_num=2)),
    (7, ta.AugmentConfig(hue=0.5, blur_prob=0.0, erasing_prob=0.0)),
])
def test_augment_batch_matches_reference(seed, cfg):
    img, key = _batch(seed), jax.random.PRNGKey(seed)
    want = ja.augment_batch(key, jnp.asarray(img), ja.AugmentConfig(**vars(cfg)))
    got = ta.augment_batch(_t(img), cfg, draws=jax_augment_draws(key, SHAPE, cfg))
    _close(got, want)
    assert float((got - _t(img)).abs().max()) > 0.01


def test_draw_augment_shapes_ranges_and_determinism():
    cfg = ta.AugmentConfig(masking_num=2)
    a = ta.draw_augment(torch.Generator().manual_seed(3), SHAPE, cfg)
    b = ta.draw_augment(torch.Generator().manual_seed(3), SHAPE, cfg)
    c = ta.draw_augment(torch.Generator().manual_seed(4), SHAPE, cfg)
    B = SHAPE[0]
    for name, lo, hi in (("brightness", 0.8, 1.2), ("contrast", 0.8, 1.2),
                         ("saturation", 0.8, 1.2), ("hue", -0.1, 0.1)):
        v = getattr(a, name)
        assert v.shape == (B,) and lo <= float(v.min()) and float(v.max()) < hi
    assert a.blur_sigma.shape == () and 0.1 <= float(a.blur_sigma) < 5.0
    assert a.erase_fill.shape == SHAPE and a.blur_apply.dtype == torch.bool
    assert math.log(0.3) <= float(a.erase.log_aspect.min()) and len(a.mask_rects) == 2
    assert a.mask_colors[0].shape == (B, 3)
    assert torch.equal(a.erase_fill, b.erase_fill) and not torch.equal(a.erase_fill, c.erase_fill)
    img = _t(_batch(0))
    out = ta.augment_batch(img, cfg, generator=torch.Generator().manual_seed(3))
    assert torch.equal(out, ta.augment_batch(img, cfg, draws=a))
    assert 0.0 <= float(out.min()) and float(out.max()) <= 1.0


@pytest.fixture(scope="module")
def fr3(tmp_path_factory):
    cap = fr3_capture(tmp_path_factory.mktemp("aug_fr3"))
    rigs = [load("fr3", "fr3", FR3_SERIAL_TO_VIEW, cap["calib_dir"], {"pose1": [cap["summary"]]})
            for load in (jax_load_rig, port_load_rig)]
    return (jb.build_fr3_multi_view(pd.read_csv(cap["csv"]), rigs[0], (60, 80), 0.05),
            tb.build_fr3_multi_view(table.read_csv(cap["csv"]), rigs[1], (60, 80), 0.05))


@pytest.mark.parametrize("on_device", [False, True])
def test_device_preprocess_with_augmentation_matches_reference(fr3, on_device):
    """The whole device preprocessing with augmentation, on the reference's
    key: images within 1e-5, GT heatmaps (untouched by it) within 1e-6."""
    a, b = fr3
    a.undistort_on_host = b.undistort_on_host = not on_device
    cfg = ta.AugmentConfig(masking_num=1, blur_prob=1.0)
    jpre = jds.make_device_preprocessor(a.geometry, 48, (24, 32), 2.0,
                                        augment_cfg=ja.AugmentConfig(**vars(cfg)),
                                        undistort_on_device=on_device)
    tpre = tds.make_device_preprocessor(b.geometry, 48, (24, 32), 2.0, augment_cfg=cfg,
                                        undistort_on_device=on_device)
    x = next(a.batches(2, shuffle=True, seed=2))
    key = jax.random.PRNGKey(11)
    imgs, hms = jpre(*(jnp.asarray(x[k]) for k in ("images_u8", "cam_idx", "keypoints_2d")),
                     key)
    draws = jax_augment_draws(key, (16, 48, 48, 3), cfg)
    got_i, got_h = tpre(*(torch.from_numpy(x[k]) for k in ("images_u8", "cam_idx",
                                                             "keypoints_2d")), draws=draws)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(imgs), atol=TOL, rtol=0)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(hms), atol=1e-6, rtol=0)
    plain, _ = tpre(*(torch.from_numpy(x[k]) for k in ("images_u8", "cam_idx", "keypoints_2d")))
    assert float((plain - got_i).abs().max()) > 0.1
