"""The int8 serve path's dynamically quantized matmul: the CUDA kernels'
bindings, their launch counters and the route rule.

Port of `mvropose_tpu/models/quantize.py::int8_matmul`, per token row r of x
(M, K) and column c of the int8 weight W_q (K, N): s_x[r] = max(max_k
|x[r, k]|, 1e-6) / 127, x_q = round(x / s_x) (int8, half to even), an exact
int32 product, then ((f32(acc) * s_x[r]) * s_w[c]) + b[c] in the output
dtype. `csrc/int8_gemm.cu` computes it in two kernels, bit-equal to the
plain version (`quantize_rows` here, `models/quantize.py::int8_gemm_reference`),
whose rounding points they repeat:
  * `int8_quantize_rows_cuda`: x (..., K) bf16 or f32 -> x_q (..., K) int8,
    s_x (..., 1) f32, 1 to 128 lanes a row (the LayerNorm kernels write the
    pair themselves for the layers that read a LayerNorm's output,
    `ops/layernorm.py::fused_layernorm_int8`);
  * `int8_gemm_cuda`: x_q, s_x and the layer's W_q, s_w and bias -> y
    (..., N) in bf16 or f32, wgmma s8 products on TMA tiles, the dequant and
    the bias in the epilogue.

Routes (`int8_mm_route`), one rule for the quantization and the product
(and for the LayerNorm kernels' int8 output):
  * CPU operands: "plain" (`models/quantize.py`'s plain versions);
  * CUDA bf16 or f32 activations at the kernels' widths: "kernel". They take
    K (Din) a multiple of 16 from 16 to 4096 and N (Dout) a multiple of 8:
    the ViT-B/16 serve widths 768 and 3072 and the small models' 128 and 512;
  * `int_mm_route()` sends those to "plain" too (the plain chain around
    `torch._int_mm`), for the comparisons on the card;
  * anything else on CUDA raises. No route falls back to another.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from mvropose_torch.ops._build import current_stream, device_context, load_library

# Kernel launches: the GEMM (`int8_gemm_cuda`) and the activations'
# quantization (`int8_quantize_rows_cuda`).
launches = 0
quantize_launches = 0

DIN_MULTIPLE, DIN_MAX = 16, 4096  # TMA's 16-byte row stride; a row held in a warp's registers
DOUT_MULTIPLE = 8  # the epilogue stores column pairs, 8 columns a thread group
_DTYPES = (torch.bfloat16, torch.float32)
_INT_MM_ROUTE = False  # `int_mm_route()`: CUDA operands take the plain chain


def int8_mm_route(device_type: str, dtype: torch.dtype, din: int, dout: int | None = None) -> str:
    """The route of an int8 matmul on this device type, of activations of this
    dtype (x's in `Int8Linear.quantize`, the output's in `int8_matmul`, the
    LayerNorm's output in `fused_layernorm_int8`) and a (din, dout) weight
    (dout None: the quantization alone): "plain" on the CPU; on CUDA
    "kernel" (or "plain" inside `int_mm_route()`) for bf16 or f32 at the
    kernels' widths; raises for any other."""
    if device_type == "cpu":
        return "plain"
    if device_type != "cuda":
        raise ValueError(f"int8_matmul runs on the CPU or on CUDA, got {device_type}")
    bad_dout = dout is not None and (dout % DOUT_MULTIPLE or dout < DOUT_MULTIPLE)
    if dtype not in _DTYPES or din % DIN_MULTIPLE or not DIN_MULTIPLE <= din <= DIN_MAX or bad_dout:
        raise ValueError(f"the int8 matmul kernels take bf16 or f32 activations, Din a multiple of "
                         f"{DIN_MULTIPLE} up to {DIN_MAX} and Dout a multiple of {DOUT_MULTIPLE}, "
                         f"got {dtype} at ({din}, {dout})")
    return "plain" if _INT_MM_ROUTE else "kernel"


@contextlib.contextmanager
def int_mm_route():
    """Within this block CUDA operands take the plain chain (the plain
    quantization, `torch._int_mm`, the plain dequant), for the comparisons
    on the card."""
    global _INT_MM_ROUTE
    saved, _INT_MM_ROUTE = _INT_MM_ROUTE, True
    try:
        yield
    finally:
        _INT_MM_ROUTE = saved


def quantize_rows(x: torch.Tensor):
    """x (..., Din) -> (int8 x_q, f32 per-token scale s_x (..., 1)), the
    scale taken over the contraction axis only, floor 1e-6: the plain
    version of `int8_quantize_rows_cuda`."""
    xf = x.float()
    m = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
    # A tensor divisor: torch divides a CUDA tensor by a Python number as a
    # product with its f32 reciprocal, one rounding away from the division.
    sx = m / torch.full_like(m, 127.0)
    return torch.round(xf / sx).to(torch.int8), sx


@functools.cache
def _kernels():
    lib = load_library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    quantize, gemm = lib.int8_quantize_rows, lib.int8_gemm_sm90
    quantize.argtypes = [ptr, ctypes.c_int64, i32, i32, i32, ptr, ptr, ptr]
    gemm.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    for fn in (quantize, gemm):
        fn.restype = ctypes.c_int
    return quantize, gemm


GEMM_TILE = (128, 192, 128)  # the GEMM's output tile (rows, columns) and its K-tile (bytes)


def gemm_l2_bytes(M: int, K: int, N: int) -> int:
    """The operand bytes the int8 GEMM's blocks take from L2 into shared
    memory for (M, K) x (K, N): each 128 x 192 output tile streams its A row
    panel and B column panel, counted in whole boxes as issued (rows or K past
    the end are zero-filled by TMA but counted). A design reading of the
    schedule of `csrc/int8_gemm.cu`."""
    tm, tn, tk = GEMM_TILE
    return -(-M // tm) * -(-N // tn) * (tm + tn) * -(-K // tk) * tk


def _raise_on(err: int, kernel: str) -> None:
    if err < 0:
        raise RuntimeError(f"{kernel}: a TMA tensor map could not be encoded (CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")


def check_din(din: int) -> None:
    if din % DIN_MULTIPLE or not DIN_MULTIPLE <= din <= DIN_MAX:
        raise ValueError(f"the int8 matmul kernels take Din a multiple of {DIN_MULTIPLE} from "
                         f"{DIN_MULTIPLE} to {DIN_MAX}, got {din}")


def _check_rows(M: int) -> None:
    if M >= 2**31:
        raise ValueError(f"the int8 matmul kernels take fewer than 2**31 rows (an int), got {M}")


def int8_quantize_rows_cuda(x: torch.Tensor):
    """Launch the activations' quantization on a CUDA bf16 or f32 x (..., K)
    -> (x_q (..., K) int8 contiguous, s_x (..., 1) f32), as
    `models/quantize.py::quantize_rows` computes them."""
    global quantize_launches
    if not x.is_cuda:
        raise ValueError(f"int8_quantize_rows_cuda needs a CUDA tensor, got x on {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the int8 quantization kernel takes bf16 or f32 x, got {x.dtype}")
    K = x.shape[-1]
    check_din(K)
    x2 = x.reshape(-1, K)
    M, ld = x2.shape[0], x2.stride(0)
    _check_rows(M)
    if M and (x2.stride(1) != 1 or (ld * x.element_size()) % 16 or x2.data_ptr() % 16):
        raise ValueError(f"x of shape {tuple(x.shape)} and strides {x.stride()}: the kernel reads "
                         f"unit-stride rows at 16-byte aligned addresses")
    dev = x.get_device()
    xq = torch.empty(x.shape, dtype=torch.int8, device=dev)
    sx = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=dev)
    if M:
        with device_context(dev):
            err = _kernels()[0](x2.data_ptr(), ld, M, K, int(x.dtype == torch.float32),
                                xq.data_ptr(), sx.data_ptr(), current_stream(dev))
        _raise_on(err, "int8_quantize_rows")
        quantize_launches += 1
    return xq, sx


def int8_gemm_cuda(xq, sx, kernel_q, scale, bias, out_dtype) -> torch.Tensor:
    """Launch the int8 GEMM: CUDA x_q (..., K) int8 contiguous, s_x (..., 1)
    f32, kernel_q (K, N) int8 stored column-major (its (N, K) transpose
    contiguous, as `Int8Linear` holds it), scale (N,) and bias (N,) or None
    f32 -> (..., N) in out_dtype (bf16 or f32), as
    `models/quantize.py::int8_gemm_reference` computes it."""
    global launches
    dev = xq.get_device()
    operands = {"xq": xq, "sx": sx, "kernel_q": kernel_q, "scale": scale, "bias": bias}
    if not xq.is_cuda or any(t is not None and t.get_device() != dev for t in operands.values()):
        raise ValueError("int8_gemm_cuda needs CUDA tensors on one device, got " + ", ".join(
            f"{name} on {t.device}" for name, t in operands.items() if t is not None))
    if xq.dtype != torch.int8 or kernel_q.dtype != torch.int8:
        raise ValueError(f"xq and kernel_q must be int8, got {xq.dtype} and {kernel_q.dtype}")
    if out_dtype not in _DTYPES:
        raise ValueError(f"the int8 GEMM writes bf16 or f32, not {out_dtype}")
    K, N = kernel_q.shape
    check_din(K)
    if N % DOUT_MULTIPLE or N < DOUT_MULTIPLE:
        raise ValueError(f"the int8 GEMM takes Dout a multiple of {DOUT_MULTIPLE}, got {N}")
    M = xq.numel() // K if K else 0
    if xq.shape[-1] != K or not xq.is_contiguous() or xq.data_ptr() % 16:
        raise ValueError(f"xq {tuple(xq.shape)} (strides {xq.stride()}) is not a contiguous, "
                         f"16-byte aligned (..., {K}) int8 tensor")
    if sx.shape != (*xq.shape[:-1], 1) or sx.dtype != torch.float32 or not sx.is_contiguous():
        raise ValueError(f"sx {tuple(sx.shape)} {sx.dtype} is not the (..., 1) f32 scale of xq "
                         f"{tuple(xq.shape)}")
    if kernel_q.stride() != (1, K) or kernel_q.data_ptr() % 16:
        raise ValueError(f"kernel_q {tuple(kernel_q.shape)} of strides {kernel_q.stride()}: the "
                         f"kernel reads it as (N, K) contiguous (K-major) at a 16-byte aligned "
                         f"address, as `Int8Linear` holds it")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.shape != (N,) or t.dtype != torch.float32
                              or not t.is_contiguous() or t.data_ptr() % 8):
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} is not a contiguous, 8-byte "
                             f"aligned ({N},) f32 tensor")
    _check_rows(M)
    out = torch.empty((*xq.shape[:-1], N), dtype=out_dtype, device=dev)
    if M:
        with device_context(dev):
            err = _kernels()[1](xq.data_ptr(), kernel_q.data_ptr(), sx.data_ptr(),
                                scale.data_ptr(), None if bias is None else bias.data_ptr(),
                                out.data_ptr(), M, N, K, int(out_dtype == torch.float32),
                                current_stream(dev))
        _raise_on(err, "int8_gemm")
        launches += 1
    return out
