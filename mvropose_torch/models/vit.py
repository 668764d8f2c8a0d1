"""Vision Transformer backbone (DINOv2/v3-compatible).

Port of `mvropose_tpu/models/vit.py::ViTBackbone`: patch embedding, CLS and
register tokens, LayerScale, bicubic position-embedding interpolation
reproducing torch's `F.interpolate`, DINOv3 axial RoPE, pre-norm blocks.
Images enter NCHW; module attribute names equal the flax module names, so
`utils/weights.load_jax_params` maps a JAX checkpoint onto them by name.

Precision follows the reference: parameters are held in f32 and cast to the
compute dtype at use (flax's `param_dtype`, `models/layers.py`), matmuls and
convs run in the compute dtype, LayerNorms in f32, the residual stream in the
compute dtype, the final norm's output in f32. The blocks' attention is
the reference's `FusedMHA`: `ops/attention.py::fused_self_attention`, a
plain matmul + softmax in the compute dtype (the reference's XLA branch,
`mvropose_tpu/ops/attention.py:102-114`) below T = 2048 tokens or on the
CPU, and the flash-attention kernels at T >= 2048 on the card, where the
reference runs its Pallas flash kernel on a TPU (`--model-size` >= 736 at
patch 16).

The serve variants of the reference run here too: `fused_ln` normalizes
through `ops/layernorm.py` (the reference's fused kernels' arithmetic: fast
variance, the residual LayerNorm of the unrounded f32 sum), `quant="int8"`
makes the blocks' q/k/v/out and fc1/fc2 `Int8Linear`s, and
`quant_attn="int8"` runs `ops/int8_attention.py::int8_prob_attention`.
With both `fused_ln` and int8 layers, the LayerNorms that feed q/k/v and
fc1 write their output quantized per token (`fused_layernorm_int8`,
`fused_residual_layernorm_int8`): the (x_q, s_x) pair the `Int8Linear`s
would compute from it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mvropose_torch.models.layers import Conv2d, Linear
from mvropose_torch.models.quantize import Int8Linear
from mvropose_torch.ops.attention import fused_self_attention, rounded
from mvropose_torch.ops.int8_attention import int8_prob_attention
from mvropose_torch.ops.layernorm import (
    fused_layernorm,
    fused_layernorm_int8,
    fused_residual_layernorm,
    fused_residual_layernorm_int8,
)


def _cubic_kernel(x: np.ndarray, a: float) -> np.ndarray:
    """Cubic convolution kernel (torch bicubic: a=-0.75; its antialiased,
    PIL-adapted path: a=-0.5)."""
    ax = np.abs(x)
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0,
        np.where(ax < 2.0, a * (ax**3 - 5.0 * ax**2 + 8.0 * ax - 4.0), 0.0),
    )


@functools.lru_cache(maxsize=64)
def _torch_bicubic_matrix(n_in: int, n_out: int, antialias: bool = False) -> np.ndarray:
    """(n_out, n_in) 1-D resize matrix reproducing torch
    `F.interpolate(mode="bicubic", align_corners=False, antialias=...)`.
    A copy of the reference's numpy helper, so both packages interpolate
    position embeddings with the same matrix."""
    scale = n_in / n_out
    M = np.zeros((n_out, n_in), np.float64)
    if antialias:
        ks = max(scale, 1.0)  # kernel stretch on downscale
        support = 2.0 * ks
        for i in range(n_out):
            center = (i + 0.5) * scale
            jmin = max(int(center - support + 0.5), 0)
            js = np.arange(jmin, min(int(center + support + 0.5), n_in))
            w = _cubic_kernel((js - center + 0.5) / ks, a=-0.5)
            M[i, js] = w / w.sum()
    else:
        for i in range(n_out):
            x = (i + 0.5) * scale - 0.5
            x0 = int(np.floor(x))
            js = np.arange(x0 - 1, x0 + 3)
            w = _cubic_kernel(x - js, a=-0.75)
            np.add.at(M[i], np.clip(js, 0, n_in - 1), w)  # border replication
    return M


def _resize_matrices(g0: int, gh: int, gw: int):
    return _torch_bicubic_matrix(g0, gh), _torch_bicubic_matrix(g0, gw)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Same fields as the reference's ViTConfig, so model_config.json files
    round-trip. `fused_ln` runs the LayerNorms through `ops/layernorm.py`
    (the CUDA kernel on the card), `quant="int8"` the blocks' Dense layers
    through `Int8Linear`, `quant_attn="int8"` the attention through
    `int8_prob_attention` (one fused CUDA kernel on the card in bf16)."""

    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_register_tokens: int = 0
    layerscale_init: Optional[float] = 1e-5  # None disables LayerScale
    dtype: str = "bfloat16"
    use_rope: bool = False
    rope_theta: float = 100.0
    layer_norm_eps: float = 1e-6
    quant: Optional[str] = None
    quant_attn: Optional[str] = None
    fused_ln: bool = False

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _rope_cos_sin(gh: int, gw: int, head_dim: int, theta: float):
    """(N, head_dim) f64 cos/sin tables for axial RoPE over a gh x gw patch
    grid (HF DINOv3ViTRopePositionEmbedding): patch-centre coords in [-1, 1],
    angles = 2*pi*coords x inv_freq over the (h, w) pair, tiled to head_dim."""
    inv_freq = 1.0 / theta ** np.arange(0, 1, 4 / head_dim, dtype=np.float64)
    ch = 2.0 * ((np.arange(gh, dtype=np.float64) + 0.5) / gh) - 1.0
    cw = 2.0 * ((np.arange(gw, dtype=np.float64) + 0.5) / gw) - 1.0
    coords = np.stack(np.meshgrid(ch, cw, indexing="ij"), axis=-1).reshape(-1, 2)
    angles = 2.0 * np.pi * coords[:, :, None] * inv_freq[None, None, :]
    angles = np.tile(angles.reshape(coords.shape[0], -1), (1, 2))
    return np.cos(angles), np.sin(angles)


@functools.lru_cache(maxsize=64)
def device_constant(fn, args: tuple, device: torch.device) -> tuple:
    """numpy tables `fn(*args)` as f32 tensors on `device`, built once.

    Copying a pageable numpy array to the card inside a step would
    synchronize the stream and stall the host each call; cached, the copy
    happens once. Built outside inference mode, so later autograd use is
    allowed."""
    out = fn(*args)
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(np.asarray(t)).float().to(device) for t in out)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, n_prefix: int):
    """Rotate the patch tokens of (B, H, T, dh) q or k; the n_prefix tokens
    (cls + registers) pass through unrotated."""
    prefix, patches = x[:, :, :n_prefix], x[:, :, n_prefix:]
    x1, x2 = patches.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    patches = patches * cos.to(x.dtype) + rotated * sin.to(x.dtype)
    return torch.cat([prefix, patches], dim=2)


def attention_dropout_multiplier(shape, rate: float, dtype: torch.dtype, device,
                                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's attention dropout (`broadcast_dropout=True`): one (Tq, Tk) keep
    mask of probability 1 - rate, shared by every batch element and head, as
    keep / (1 - rate) in the attention dtype."""
    keep_prob = 1.0 - rate
    keep = torch.rand(tuple(shape), generator=generator, device=device) < keep_prob
    return keep.to(dtype) / rounded(keep_prob, dtype)


def dot_product_attention(q, k, v, key_mask: Optional[torch.Tensor] = None,
                          dropout_rate: float = 0.0,
                          generator: Optional[torch.Generator] = None):
    """Softmax attention on (B, H, T, dh) tensors in their own dtype.

    flax semantics: q is divided by sqrt(dh) rounded to the dtype, masked
    logits (key_mask (B, Tk) False) are set to the dtype's lowest finite
    value, softmax runs in the compute dtype; with `dropout_rate` the
    attention weights are multiplied by `attention_dropout_multiplier`."""
    q = q / rounded(math.sqrt(q.shape[-1]), q.dtype)
    logits = q @ k.transpose(-2, -1)
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], torch.finfo(logits.dtype).min)
    weights = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0:
        weights = weights * attention_dropout_multiplier(
            weights.shape[-2:], dropout_rate, weights.dtype, weights.device, generator)
    return weights @ v


def _dense(din: int, dout: int, dtype: torch.dtype, quant: Optional[str], device=None):
    if quant == "int8":
        return Int8Linear(din, dout, dtype, device)
    return Linear(din, dout, dtype, device)


class MultiHeadAttention(nn.Module):
    """flax `MultiHeadDotProductAttention` (the decoder layers): q/k/v/out
    projections with bias in the compute dtype, `dot_product_attention`;
    `dropout_rate` drops attention weights (train mode of the decoder
    layers)."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype, device=None,
                 quant: Optional[str] = None):
        super().__init__()
        self.num_heads = num_heads
        self.query = _dense(dim, dim, dtype, quant, device)
        self.key = _dense(dim, dim, dtype, quant, device)
        self.value = _dense(dim, dim, dtype, quant, device)
        self.out = _dense(dim, dim, dtype, quant, device)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, D) -> (B, T, H, D / H), a view."""
        B, T, D = x.shape
        return x.view(B, T, self.num_heads, D // self.num_heads)

    def forward(self, x, kv=None, key_mask=None, dropout_rate: float = 0.0,
                generator: Optional[torch.Generator] = None):
        kv = x if kv is None else kv
        q, k, v = (self._heads(t).transpose(1, 2)
                   for t in (self.query(x), self.key(kv), self.value(kv)))
        o = dot_product_attention(q, k, v, key_mask, dropout_rate, generator).transpose(1, 2)
        B, T = o.shape[:2]
        return self.out(o.reshape(B, T, -1))


class FusedMHA(MultiHeadAttention):
    """The reference's `FusedMHA` (`mvropose_tpu/models/vit.py:199-257`),
    self-attention of the backbone blocks and `SelfAttentionFusion`: the
    same parameters as `MultiHeadAttention` (`Int8Linear`s with
    quant="int8"), RoPE on the patch tokens of q and k, then
    `fused_self_attention` (the flash kernels at T >= 2048 on the card), or
    `int8_prob_attention` with `int8_attention`. With `Int8Linear`s, x may
    be given as its (x_q, s_x) pair already."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype, device=None,
                 quant: Optional[str] = None, int8_attention: bool = False):
        super().__init__(dim, num_heads, dtype, device, quant)
        self.int8_attention = int8_attention

    def forward(self, x, key_mask=None, rope=None):
        # int8 layers share one quantization of x: the same (x_q, s_x) all three would compute.
        quantize = isinstance(self.query, Int8Linear) and not isinstance(x, tuple)
        xs = self.query.quantize(x) if quantize else x
        q, k, v = (self._heads(layer(xs)) for layer in (self.query, self.key, self.value))
        if rope is not None:
            cos, sin, n_prefix = rope
            q, k = (_apply_rope(t.transpose(1, 2), cos, sin, n_prefix).transpose(1, 2)
                    for t in (q, k))
        attend = int8_prob_attention if self.int8_attention else fused_self_attention
        o = attend(q, k, v, key_mask=key_mask)
        B, T = o.shape[:2]
        return self.out(o.reshape(B, T, -1))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype, device=None,
                 quant: Optional[str] = None):
        super().__init__()
        self.fc1 = _dense(dim, hidden, dtype, quant, device)
        self.fc2 = _dense(hidden, dim, dtype, quant, device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init, device=device))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    """Pre-norm block. With `fused_ln`, norm1 and norm2 run the reference's
    fused kernels' arithmetic (norm2 with the residual add folded in); the
    `nn.LayerNorm`s then only hold their parameters. With int8 layers too
    (`quant="int8"`, or after `int8ify`), both write their output quantized
    for q/k/v and fc1."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        D, dt, eps = cfg.hidden_size, cfg.compute_dtype, cfg.layer_norm_eps
        self.fused_ln = cfg.fused_ln
        self.norm1 = nn.LayerNorm(D, eps=eps, device=device)
        self.attn = FusedMHA(D, cfg.num_heads, dt, device, quant=cfg.quant,
                             int8_attention=cfg.quant_attn == "int8")
        self.norm2 = nn.LayerNorm(D, eps=eps, device=device)
        self.mlp = Mlp(D, int(D * cfg.mlp_ratio), dt, device, quant=cfg.quant)
        if cfg.layerscale_init is not None:
            self.ls1 = LayerScale(D, cfg.layerscale_init, device)
            self.ls2 = LayerScale(D, cfg.layerscale_init, device)
        else:
            self.ls1 = self.ls2 = nn.Identity()

    def forward(self, x, rope=None):
        dt = x.dtype
        n1, n2 = self.norm1, self.norm2
        if self.fused_ln and isinstance(self.mlp.fc1, Int8Linear):
            xs = fused_layernorm_int8(x, n1.weight, n1.bias, n1.eps, out_dtype=dt)
            h = self.ls1(self.attn(xs, rope=rope))
            x, xs = fused_residual_layernorm_int8(x, h, n2.weight, n2.bias, n2.eps, out_dtype=dt)
            return x + self.ls2(self.mlp(xs))
        if self.fused_ln:
            h = fused_layernorm(x, n1.weight, n1.bias, n1.eps, out_dtype=dt)
        else:
            h = n1(x.float()).to(dt)
        h = self.ls1(self.attn(h, rope=rope))
        if self.fused_ln:
            x, h = fused_residual_layernorm(x, h, n2.weight, n2.bias, n2.eps, out_dtype=dt)
        else:
            x = x + h
            h = n2(x.float()).to(dt)
        h = self.ls2(self.mlp(h))
        return x + h


class ViTBackbone(nn.Module):
    """images (B, 3, H, W) -> dict of normalized tokens (f32):
    patch_tokens (B, N, D), cls_token (B, D), register_tokens (B, R, D),
    grid_hw (gh, gw)."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.hidden_size, cfg.compute_dtype
        self.patch_embed = Conv2d(3, D, cfg.patch_size, dt, device, stride=cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D, device=device))
        if not cfg.use_rope:
            self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, D, device=device))
        if cfg.num_register_tokens > 0:
            self.register_tokens = nn.Parameter(
                torch.zeros(1, cfg.num_register_tokens, D, device=device)
            )
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", Block(cfg, device))
        self.norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps, device=device)

    def _patch_pos(self, gh: int, gw: int) -> torch.Tensor:
        """(1, gh*gw, D) f32 patch position embeddings for a gh x gw grid,
        bicubic-interpolated from the config grid when the grid differs
        (compared as a grid, not a count: 28x7 is not 14x14)."""
        c = self.cfg
        patch_pos = self.pos_embed[:, 1:, :]
        if (gh, gw) == (c.grid_size, c.grid_size):
            return patch_pos
        g0 = c.grid_size
        Mh, Mw = device_constant(_resize_matrices, (g0, gh, gw), patch_pos.device)
        grid = patch_pos.reshape(g0, g0, c.hidden_size)
        grid = torch.einsum("Hh,hwd->Hwd", Mh, grid)
        grid = torch.einsum("Ww,hwd->hWd", Mw, grid)
        return grid.reshape(1, gh * gw, c.hidden_size)

    def forward(self, images: torch.Tensor) -> dict:
        c = self.cfg
        dt, D = c.compute_dtype, c.hidden_size
        B = images.shape[0]
        x = self.patch_embed(images.to(dt))  # (B, D, gh, gw)
        gh, gw = x.shape[-2:]
        x = x.flatten(2).transpose(1, 2)  # (B, gh*gw, D), row-major over the grid
        rope = None
        if c.use_rope:
            cos, sin = device_constant(
                _rope_cos_sin, (gh, gw, D // c.num_heads, c.rope_theta), x.device
            )
            rope = (cos, sin, 1 + c.num_register_tokens)
            cls_tok = self.cls_token.to(dt)
        else:
            x = x + self._patch_pos(gh, gw).to(dt)
            cls_tok = (self.cls_token + self.pos_embed[:, :1, :]).to(dt)
        toks = [cls_tok.expand(B, 1, D)]
        if c.num_register_tokens > 0:
            toks.append(self.register_tokens.to(dt).expand(B, -1, -1))
        x = torch.cat(toks + [x], dim=1)
        for i in range(c.num_layers):
            x = getattr(self, f"block_{i}")(x, rope=rope)
        if c.fused_ln:
            x = fused_layernorm(x, self.norm.weight, self.norm.bias, self.norm.eps,
                                out_dtype=torch.float32)
        else:
            x = self.norm(x.float())
        n_prefix = 1 + c.num_register_tokens
        return {
            "cls_token": x[:, 0, :],
            "register_tokens": x[:, 1:n_prefix, :],
            "patch_tokens": x[:, n_prefix:, :],
            "grid_hw": (gh, gw),
        }
