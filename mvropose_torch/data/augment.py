"""Batched image augmentation on the device: port of `mvropose_tpu/data/augment.py`.

Every op works on a whole (B, H, W, 3) float batch in [0, 1] before
normalization, with the reference's arithmetic: color jitter (brightness,
contrast, saturation, and hue as a rotation in YIQ), a separable 5-tap
gaussian blur with zero padding, grayscale, random erasing (a rectangle of
uniform noise) and masking (solid random-color rectangles), rectangles by
coordinate comparison. Neither torchvision's nor kornia's versions compute
the same.

Each op takes its random draws as arguments (uniforms already scaled to
their ranges, as `jax.random.uniform(key, shape, minval, maxval)` returns
them), so a test can give it the reference's draws; `draw_augment` makes one
batch's draws from a `torch.Generator` on the batch's device, with
`jax.random`'s distributions but not its numbers.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from mvropose_torch.models.vit import device_constant


def _color_tables():
    """Luma weights, YIQ-from-RGB and its inverse, inverted in f32 as the
    reference does."""
    yiq_from_rgb = np.array([[0.299, 0.587, 0.114], [0.596, -0.274, -0.322],
                             [0.211, -0.523, 0.312]], np.float32)
    return yiq_from_rgb[0], yiq_from_rgb, np.linalg.inv(yiq_from_rgb)


def _luma(img: torch.Tensor) -> torch.Tensor:
    return device_constant(_color_tables, (), img.device)[0]


def adjust_brightness(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return img * factor


def adjust_contrast(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    mean = (img * _luma(img)).mean(dim=(-3, -2, -1), keepdim=True) * 3.0
    return (img - mean) * factor + mean


def adjust_saturation(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    gray = (img * _luma(img)).sum(dim=-1, keepdim=True)
    return gray + (img - gray) * factor


def adjust_hue(img: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Hue rotation by `delta` turns (one per image, (B,)) through YIQ."""
    _, yiq_from_rgb, rgb_from_yiq = device_constant(_color_tables, (), img.device)
    yiq = img @ yiq_from_rgb.T
    delta = delta.reshape(*img.shape[:-3], 1, 1)
    cos, sin = torch.cos(2 * math.pi * delta), torch.sin(2 * math.pi * delta)
    y, i, q = yiq[..., 0], yiq[..., 1], yiq[..., 2]
    return torch.stack([y, cos * i - sin * q, sin * i + cos * q], dim=-1) @ rgb_from_yiq.T


def color_jitter(img: torch.Tensor, brightness: torch.Tensor, contrast: torch.Tensor,
                 saturation: torch.Tensor, hue: torch.Tensor) -> torch.Tensor:
    """Per-image factors (B,) for brightness, contrast, saturation and the
    hue turn, in that order, then a clip to [0, 1]."""
    b = img.shape[0]
    img = adjust_brightness(img, brightness.reshape(b, 1, 1, 1))
    img = adjust_contrast(img, contrast.reshape(b, 1, 1, 1))
    img = adjust_saturation(img, saturation.reshape(b, 1, 1, 1))
    return adjust_hue(img, hue).clamp(0.0, 1.0)


def gaussian_blur(img: torch.Tensor, sigma: torch.Tensor, apply: torch.Tensor,
                  kernel_size: int = 5) -> torch.Tensor:
    """Separable gaussian blur (rows then columns, each channel alone, zero
    padding: XLA's "SAME") of one sigma for the batch, kept where `apply` (B,)."""
    B, H, W, C = img.shape
    r = kernel_size // 2
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    k1d = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    k1d = k1d / k1d.sum()
    z = img.permute(0, 3, 1, 2).reshape(B * C, 1, H, W)
    z = F.conv2d(z, k1d.reshape(1, 1, -1, 1), padding=(r, 0))
    z = F.conv2d(z, k1d.reshape(1, 1, 1, -1), padding=(0, r))
    blurred = z.reshape(B, C, H, W).permute(0, 2, 3, 1)
    return torch.where(apply.reshape(B, 1, 1, 1), blurred, img)


def random_grayscale(img: torch.Tensor, apply: torch.Tensor) -> torch.Tensor:
    gray = (img * _luma(img)).sum(dim=-1, keepdim=True).expand(img.shape)
    return torch.where(apply.reshape(-1, 1, 1, 1), gray, img)


@dataclasses.dataclass
class RectDraws:
    """One rectangle per image, (B,) each: its area as a share of the image,
    the log of its aspect ratio, and uniforms in [0, 1) placing its top-left
    corner."""

    area: torch.Tensor
    log_aspect: torch.Tensor
    y: torch.Tensor
    x: torch.Tensor


def rect_mask(d: RectDraws, H: int, W: int) -> torch.Tensor:
    """(B, H, W, 1) boolean rectangles, as the reference's `_rect_mask`."""
    area = d.area * H * W
    aspect = torch.exp(d.log_aspect)
    h = torch.sqrt(area * aspect).clamp(1, H - 1)
    w = torch.sqrt(area / aspect).clamp(1, W - 1)
    y0, x0 = d.y * (H - h), d.x * (W - w)
    ys = torch.arange(H, dtype=torch.float32, device=area.device)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=area.device)[None, None, :]
    inside = ((ys >= y0[:, None, None]) & (ys < (y0 + h)[:, None, None])
              & (xs >= x0[:, None, None]) & (xs < (x0 + w)[:, None, None]))
    return inside[..., None]


def random_erasing(img: torch.Tensor, rect: RectDraws, fill: torch.Tensor,
                   apply: torch.Tensor) -> torch.Tensor:
    """torchvision's RandomErasing as the reference draws it: the rectangle
    filled with `fill` (B, H, W, 3) noise where `apply` (B,)."""
    B, H, W, _ = img.shape
    return torch.where(rect_mask(rect, H, W) & apply.reshape(B, 1, 1, 1), fill, img)


def random_masking(img: torch.Tensor, rects: list, colors: list) -> torch.Tensor:
    """The original project's occlusion masking: for each (rectangle, color
    (B, 3)) in turn, a solid rectangle of that color."""
    B, H, W, _ = img.shape
    for rect, color in zip(rects, colors):
        img = torch.where(rect_mask(rect, H, W), color.reshape(B, 1, 1, 3), img)
    return img


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2
    hue: float = 0.1
    blur_prob: float = 0.5
    blur_kernel: int = 5
    grayscale_prob: float = 0.1
    erasing_prob: float = 0.2
    masking_num: int = 0  # the original project uses masking only as a robustness probe


ERASE_SCALE, ERASE_RATIO = (0.1, 0.2), (0.3, 2.0)
BLUR_SIGMA = (0.1, 5.0)
MASK_RATIO, MASK_ASPECT = (0.1, 0.3), (0.5, 2.0)


@dataclasses.dataclass
class AugmentDraws:
    """Every draw of one `augment_batch` call: the jitter factors (B,), the
    blur's sigma () and apply flags (B,), grayscale's flags (B,), erasing's
    rectangle, noise (B, H, W, 3) and flags (B,), and per mask a rectangle
    and a color (B, 3)."""

    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor
    blur_sigma: torch.Tensor
    blur_apply: torch.Tensor
    gray_apply: torch.Tensor
    erase: RectDraws
    erase_fill: torch.Tensor
    erase_apply: torch.Tensor
    mask_rects: list
    mask_colors: list


def _rect_draws(u, B: int, scale, ratio) -> RectDraws:
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    return RectDraws(u(B, lo=scale[0], hi=scale[1]), u(B, lo=lo, hi=hi), u(B), u(B))


def draw_masking(gen: torch.Generator, B: int, num_masks: int) -> tuple[list, list]:
    """The occlusion probe's draws for `random_masking` over B images: per
    mask a rectangle (area a share in [0.1^2, 0.3^2) of the image, aspect in
    [0.5, 2) log-uniform) and a uniform colour (B, 3), as the reference's
    `random_masking` draws them, on the generator's device."""
    def u(*size, lo=0.0, hi=1.0):
        return torch.rand(size, generator=gen, device=gen.device) * (hi - lo) + lo

    area = (MASK_RATIO[0] ** 2, MASK_RATIO[1] ** 2)
    rects, colors = [], []
    for _ in range(num_masks):
        rects.append(_rect_draws(u, B, area, MASK_ASPECT))
        colors.append(u(B, 3))
    return rects, colors


def draw_augment(gen: torch.Generator, shape, cfg: AugmentConfig) -> AugmentDraws:
    """One batch's draws for images of `shape` (B, H, W, 3), on the
    generator's device: uniforms in [lo, hi), flags as uniform < prob."""
    B = shape[0]

    def u(*size, lo=0.0, hi=1.0):
        return torch.rand(size, generator=gen, device=gen.device) * (hi - lo) + lo

    area = (MASK_RATIO[0] ** 2, MASK_RATIO[1] ** 2)
    return AugmentDraws(
        brightness=u(B, lo=1 - cfg.brightness, hi=1 + cfg.brightness),
        contrast=u(B, lo=1 - cfg.contrast, hi=1 + cfg.contrast),
        saturation=u(B, lo=1 - cfg.saturation, hi=1 + cfg.saturation),
        hue=u(B, lo=-cfg.hue, hi=cfg.hue),
        blur_sigma=u(lo=BLUR_SIGMA[0], hi=BLUR_SIGMA[1]),
        blur_apply=u(B) < cfg.blur_prob,
        gray_apply=u(B) < cfg.grayscale_prob,
        erase=_rect_draws(u, B, ERASE_SCALE, ERASE_RATIO),
        erase_fill=u(*shape),
        erase_apply=u(B) < cfg.erasing_prob,
        mask_rects=[_rect_draws(u, B, area, MASK_ASPECT) for _ in range(cfg.masking_num)],
        mask_colors=[u(B, 3) for _ in range(cfg.masking_num)],
    )


def augment_batch(img: torch.Tensor, cfg: AugmentConfig = AugmentConfig(),
                  generator: torch.Generator | None = None,
                  draws: AugmentDraws | None = None) -> torch.Tensor:
    """The train-time pipeline on a [0, 1] float batch (B, H, W, 3): jitter,
    blur, grayscale, erasing, then masking if `cfg.masking_num`; with the
    given `draws`, else draws from `generator`."""
    if draws is None:
        draws = draw_augment(generator, img.shape, cfg)
    img = color_jitter(img, draws.brightness, draws.contrast, draws.saturation, draws.hue)
    img = gaussian_blur(img, draws.blur_sigma, draws.blur_apply, cfg.blur_kernel)
    img = random_grayscale(img, draws.gray_apply)
    img = random_erasing(img, draws.erase, draws.erase_fill, draws.erase_apply)
    if cfg.masking_num > 0:
        img = random_masking(img, draws.mask_rects, draws.mask_colors)
    return img
