"""LayerNorm and residual-add + LayerNorm: the CUDA kernel and its plain-torch versions.

Port of `mvropose_tpu/ops/layernorm.py::fused_layernorm` and
`::fused_residual_layernorm`, with their arithmetic: f32 statistics with the
fast variance var = E[x^2] - mean^2 (no clamp), y = (x - mean) * rsqrt(var +
eps) * scale + bias written in `out_dtype`; the residual variant casts h to
x's dtype, writes x + h in x's dtype and normalizes the unrounded f32 sum.
Both kernels are `csrc/layernorm.cu`; its source note says what bounds them.

For the int8 serve path the same kernels write the output quantized per
token instead, the (x_q, s_x) pair that the int8 matmuls of q/k/v and fc1
read (`fused_layernorm_int8`, `fused_residual_layernorm_int8`): y rounded to
`out_dtype`, then `ops/int8_matmul.py::quantize_rows`'s arithmetic. They take
the int8 matmul's route (`int8_mm_route`): on CUDA the kernels' int8 output,
bit-equal to the LayerNorm kernel followed by the rows' quantization; on the
CPU, and on CUDA inside `int_mm_route()`, that chain itself (`fused_layernorm`
or `fused_residual_layernorm`, then `quantize_rows`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mvropose_torch.ops._build import current_stream, device_context, load_library
from mvropose_torch.ops.int8_matmul import check_din, int8_mm_route, quantize_rows

# Kernel launches made through `layernorm_cuda` / `residual_layernorm_cuda`,
# and through `layernorm_int8_cuda` / `residual_layernorm_int8_cuda`.
launches = 0
residual_launches = 0
int8_launches = 0
residual_int8_launches = 0

# The (input, output) dtype pairs the kernel is instantiated for.
_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PAIRS = {(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
          (torch.bfloat16, torch.float32)}


def _normalize(v: torch.Tensor, scale, bias, eps: float, out_dtype) -> torch.Tensor:
    """The reference kernels' normalization of f32 rows `v`."""
    D = v.shape[-1]
    mean = v.sum(-1, keepdim=True) / D
    var = (v * v).sum(-1, keepdim=True) / D - mean * mean
    y = (v - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(out_dtype)


def layernorm_reference(x, scale, bias, eps: float = 1e-6, out_dtype=None) -> torch.Tensor:
    """Plain torch version of `_ln_kernel`: LayerNorm over the last dim."""
    return _normalize(x.float(), scale, bias, eps, out_dtype or x.dtype)


def residual_layernorm_reference(x, h, scale, bias, eps: float = 1e-6, out_dtype=None):
    """Plain torch version of `_res_ln_kernel`: (x + h in x's dtype, LN of the f32 sum)."""
    v = x.float() + h.to(x.dtype).float()
    return v.to(x.dtype), _normalize(v, scale, bias, eps, out_dtype or x.dtype)


@functools.cache
def _kernels():
    lib = load_library()
    fwd, fwd_int8 = lib.layernorm_fwd, lib.layernorm_int8_fwd
    tail = [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fwd.argtypes = [ctypes.c_void_p] * 6 + tail + [ctypes.c_void_p]
    fwd_int8.argtypes = [ctypes.c_void_p] * 7 + tail + [ctypes.c_void_p]
    for fn in (fwd, fwd_int8):
        fn.restype = ctypes.c_int
    return fwd, fwd_int8


def _operands(x, h, scale, bias, out_dtype):
    """Check the operands -> (x, h in x's dtype or None, contiguous; scale,
    bias f32; out_dtype; M rows; D)."""
    for name, t in (("x", x), ("h", h), ("scale", scale), ("bias", bias)):
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"the LayerNorm kernel needs CUDA tensors, got {name} on {t.device}")
    out_dtype = out_dtype or x.dtype
    if (x.dtype, out_dtype) not in _PAIRS:
        raise ValueError(f"no LayerNorm kernel for {x.dtype} -> {out_dtype}")
    D = x.shape[-1]
    if scale.shape != (D,) or bias.shape != (D,):
        raise ValueError(f"scale {tuple(scale.shape)} and bias {tuple(bias.shape)} must be ({D},)")
    M = x.numel() // D if D else 0
    if D == 0 or x.numel() >= 2**31:
        raise ValueError(f"x of shape {tuple(x.shape)}: need D > 0 and fewer than 2**31 elements")
    rows = x.contiguous()
    hr = None if h is None else h.to(x.dtype).contiguous()
    if hr is not None and hr.shape != rows.shape:
        raise ValueError(f"h {tuple(h.shape)} does not match x {tuple(x.shape)}")
    return rows, hr, scale.float().contiguous(), bias.float().contiguous(), out_dtype, M, D


def _launch(x, h, scale, bias, eps, out_dtype):
    """Launch the kernel on the current stream (counted in `launches`, or
    `residual_launches` when h is given) -> (xnew, y)."""
    global launches, residual_launches
    rows, hr, g, b, out_dtype, M, D = _operands(x, h, scale, bias, out_dtype)
    y = torch.empty(rows.shape, dtype=out_dtype, device=rows.device)
    xnew = None if hr is None else torch.empty_like(rows)
    if M:
        dev = rows.get_device()
        with device_context(dev):
            err = _kernels()[0](
                rows.data_ptr(), 0 if hr is None else hr.data_ptr(), g.data_ptr(), b.data_ptr(),
                0 if xnew is None else xnew.data_ptr(), y.data_ptr(), M, D, float(eps),
                _TYPE_CODES[x.dtype], _TYPE_CODES[out_dtype], int(hr is not None),
                current_stream(dev),
            )
        if err != 0:
            raise RuntimeError(f"layernorm_fwd launch failed with CUDA error {err}")
        if hr is None:
            launches += 1
        else:
            residual_launches += 1
    return xnew, y


def _launch_int8(x, h, scale, bias, eps, out_dtype):
    """Launch the kernel with its int8 output (counted in `int8_launches`,
    or `residual_int8_launches` when h is given) -> (xnew, (x_q, s_x))."""
    global int8_launches, residual_int8_launches
    rows, hr, g, b, out_dtype, M, D = _operands(x, h, scale, bias, out_dtype)
    check_din(D)
    dev = rows.get_device()
    xq = torch.empty(rows.shape, dtype=torch.int8, device=dev)
    sx = torch.empty((*rows.shape[:-1], 1), dtype=torch.float32, device=dev)
    xnew = None if hr is None else torch.empty_like(rows)
    if M:
        with device_context(dev):
            err = _kernels()[1](
                rows.data_ptr(), 0 if hr is None else hr.data_ptr(), g.data_ptr(), b.data_ptr(),
                0 if xnew is None else xnew.data_ptr(), xq.data_ptr(), sx.data_ptr(), M, D,
                float(eps), _TYPE_CODES[x.dtype], _TYPE_CODES[out_dtype], int(hr is not None),
                current_stream(dev),
            )
        if err != 0:
            raise RuntimeError(f"layernorm_int8_fwd launch failed with CUDA error {err}")
        if hr is None:
            int8_launches += 1
        else:
            residual_int8_launches += 1
    return xnew, (xq, sx)


def layernorm_cuda(x, scale, bias, eps: float = 1e-6, out_dtype=None) -> torch.Tensor:
    """Launch the LayerNorm kernel on CUDA `x` (..., D) -> (..., D) in `out_dtype`."""
    return _launch(x, None, scale, bias, eps, out_dtype)[1]


def residual_layernorm_cuda(x, h, scale, bias, eps: float = 1e-6, out_dtype=None):
    """Launch the residual kernel on CUDA `x`, `h` -> (x + h, LN(x + h))."""
    return _launch(x, h, scale, bias, eps, out_dtype)


def fused_layernorm(x, scale, bias, eps: float = 1e-6, out_dtype=None) -> torch.Tensor:
    """LayerNorm over the last dim: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x.device.type == "cpu":
        return layernorm_reference(x, scale, bias, eps, out_dtype)
    return layernorm_cuda(x, scale, bias, eps, out_dtype)


def fused_residual_layernorm(x, h, scale, bias, eps: float = 1e-6, out_dtype=None):
    """(x + h, LayerNorm(x + h)): the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x.device.type == "cpu":
        return residual_layernorm_reference(x, h, scale, bias, eps, out_dtype)
    return residual_layernorm_cuda(x, h, scale, bias, eps, out_dtype)


def layernorm_int8_cuda(x, scale, bias, eps: float = 1e-6, out_dtype=None):
    """Launch the LayerNorm kernel with its int8 output on CUDA `x` (..., D),
    D a multiple of 16 up to 4096 -> (x_q (..., D) int8, s_x (..., 1) f32):
    `quantize_rows` of the LayerNorm in `out_dtype`."""
    return _launch_int8(x, None, scale, bias, eps, out_dtype)[1]


def residual_layernorm_int8_cuda(x, h, scale, bias, eps: float = 1e-6, out_dtype=None):
    """Launch the residual kernel with its int8 output on CUDA `x`, `h` ->
    (x + h, (x_q, s_x) of LN(x + h) in `out_dtype`)."""
    return _launch_int8(x, h, scale, bias, eps, out_dtype)


def fused_layernorm_int8(x, scale, bias, eps: float = 1e-6, out_dtype=None):
    """The LayerNorm over the last dim in `out_dtype`, quantized per token:
    (x_q, s_x) as `quantize_rows` gives them, on `int8_mm_route`'s route."""
    out_dtype = out_dtype or x.dtype
    if int8_mm_route(x.device.type, out_dtype, x.shape[-1]) == "plain":
        return quantize_rows(fused_layernorm(x, scale, bias, eps, out_dtype))
    return layernorm_int8_cuda(x, scale, bias, eps, out_dtype)


def fused_residual_layernorm_int8(x, h, scale, bias, eps: float = 1e-6, out_dtype=None):
    """(x + h, (x_q, s_x) of LayerNorm(x + h) in `out_dtype`), on
    `int8_mm_route`'s route."""
    out_dtype = out_dtype or x.dtype
    if int8_mm_route(x.device.type, out_dtype, x.shape[-1]) == "plain":
        xnew, y = fused_residual_layernorm(x, h, scale, bias, eps, out_dtype)
        return xnew, quantize_rows(y)
    return residual_layernorm_int8_cuda(x, h, scale, bias, eps, out_dtype)
