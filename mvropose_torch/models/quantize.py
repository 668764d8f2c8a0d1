"""int8 quantization of the frozen ViT backbone's matmuls (serve path).

Port of `mvropose_tpu/models/quantize.py`. Weights are int8 with a
per-output-channel scale s_w[j] = max_i |W[i, j]| / 127; activations are
quantized per token on the fly, s_x[t] = max_d |x[t, d]| / 127; and
y = (x_q @ W_q).int32 * s_x * s_w + b. Only the blocks' q/k/v/out and
fc1/fc2 are quantized; everything else stays float. On CUDA `int8_matmul`
runs the kernels of `csrc/int8_gemm.cu` (`ops/int8_matmul.py`), bit-equal
to the plain version here; `quantize_rows`, the activations' plain
quantization, lives beside its kernel in `ops/int8_matmul.py`.

`quantize_kernel` and `quantize_backbone` are numpy copies of the
reference's `_quantize_kernel` and `quantize_backbone_params` (that module
imports jax), working on flat `save_params_npz` names.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from mvropose_torch.ops.int8_matmul import (
    int8_gemm_cuda,
    int8_mm_route,
    int8_quantize_rows_cuda,
    quantize_rows,
)

# The quantized Dense layers of one block, and how many leading axes of each
# float kernel are input axes (DenseGeneral: q/k/v (D, H, dh), out (H, dh, D)).
QUANTIZED = {"attn/query": 1, "attn/key": 1, "attn/value": 1, "attn/out": 2,
             "mlp/fc1": 1, "mlp/fc2": 1}


def quantize_kernel(kernel: np.ndarray, in_dims: int):
    """f32 kernel (*in_shape, *out_shape) -> int8 (Din, Dout) + f32 (Dout,)
    per-output-channel scales: scale floor 1e-12, round half to even, clip
    to +-127 (`_quantize_kernel`)."""
    k = np.asarray(kernel, np.float32)
    din = int(np.prod(k.shape[:in_dims]))
    k2 = k.reshape(din, -1)
    scale = np.maximum(np.abs(k2).max(axis=0), 1e-12) / 127.0
    kq = np.clip(np.round(k2 / scale), -127, 127).astype(np.int8)
    return kq, scale.astype(np.float32)


def quantize_backbone(flat: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """A float backbone's flat leaves (`block_0/attn/query/kernel`, ..., names
    relative to the backbone) -> the int8 layout: each quantized layer's
    `kernel` becomes `kernel_q` (int8 (Din, Dout)) and `scale` (f32 (Dout,)),
    its bias is flattened to f32 (Dout,); every other leaf is kept as is."""
    out = dict(flat)
    blocks = sorted({k.split("/")[0] for k in flat if k.startswith("block_")})
    for blk in blocks:
        for layer, in_dims in QUANTIZED.items():
            prefix = f"{blk}/{layer}/"
            kq, scale = quantize_kernel(out.pop(prefix + "kernel"), in_dims)
            out[prefix + "kernel_q"], out[prefix + "scale"] = kq, scale
            if prefix + "bias" in out:
                out[prefix + "bias"] = np.asarray(out[prefix + "bias"], np.float32).reshape(-1)
    return out


def int8_gemm_reference(xq, sx, kernel_q, scale, bias, out_dtype) -> torch.Tensor:
    """The product and the dequant of a quantized x: x_q (..., Din) int8,
    s_x (..., 1) f32, kernel_q (Din, Dout) int8, scale (Dout,) f32 and bias
    (Dout,) f32 or None -> (..., Dout) in out_dtype.

    The int32 product is `torch._int_mm`, exact on both devices. On CUDA it
    needs Din and Dout multiples of 8, mat2 column-major (as `Int8Linear`
    holds kernel_q) and more than 16 rows: fewer are padded with zero rows."""
    x2 = xq.reshape(-1, xq.shape[-1])
    rows = x2.shape[0]
    if x2.is_cuda and rows <= 16:
        x2 = torch.cat([x2, x2.new_zeros(17 - rows, x2.shape[1])])
    y = torch._int_mm(x2, kernel_q)[:rows]
    y = y.reshape(*xq.shape[:-1], -1).float() * sx * scale
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


def int8_matmul_reference(x, kernel_q, scale, bias, out_dtype) -> torch.Tensor:
    """The plain version of `int8_matmul`, step by step as the reference."""
    return int8_gemm_reference(*quantize_rows(x), kernel_q, scale, bias, out_dtype)


def int8_matmul(x, kernel_q, scale, bias, out_dtype) -> torch.Tensor:
    """Dynamically quantized matmul (`int8_matmul`): x (..., Din) f32/bf16,
    or its (x_q, s_x) pair from `Int8Linear.quantize`, kernel_q (Din, Dout)
    int8, scale (Dout,) f32 -> (..., Dout) in out_dtype. The route
    (`ops/int8_matmul.py::int8_mm_route`) is decided once: CPU operands take
    the plain version (`int8_matmul_reference`), CUDA ones the two kernels of
    `csrc/int8_gemm.cu`."""
    quantized = isinstance(x, tuple)
    lead = x[0] if quantized else x
    if int8_mm_route(lead.device.type, out_dtype, *kernel_q.shape) == "plain":
        xs = x if quantized else quantize_rows(x)
        return int8_gemm_reference(*xs, kernel_q, scale, bias, out_dtype)
    xs = x if quantized else int8_quantize_rows_cuda(x)
    return int8_gemm_cuda(*xs, kernel_q, scale, bias, out_dtype)


class Int8Linear(nn.Module):
    """Counterpart of the reference's `Int8Dense`: int8 `kernel_q` (Din, Dout),
    f32 per-channel `scale` and f32 `bias` under the flax names, output in
    the compute dtype. `kernel_q` is a buffer stored column-major (its
    transpose is contiguous): the K-major B operand of the GEMM kernel, and
    the layout `torch._int_mm` takes on CUDA. `forward` takes x, or the
    (x_q, s_x) pair that `quantize` gives, so that layers reading one x
    share its quantization."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.register_buffer(
            "kernel_q",
            torch.zeros((out_features, in_features), dtype=torch.int8, device=device).t(),
        )
        self.scale = nn.Parameter(torch.ones(out_features, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(out_features, device=device), requires_grad=False)

    def quantize(self, x):
        """x's per-token quantization (x_q, s_x) on this layer's route: the
        plain `quantize_rows` or the kernel."""
        if int8_mm_route(x.device.type, x.dtype, *self.kernel_q.shape) == "plain":
            return quantize_rows(x)
        return int8_quantize_rows_cuda(x)

    def forward(self, x):
        return int8_matmul(x, self.kernel_q, self.scale, self.bias, self.dtype)
