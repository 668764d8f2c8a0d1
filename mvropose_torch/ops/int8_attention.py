"""int8-probability attention: the fused kernels and their plain-torch
versions.

Port of `mvropose_tpu/ops/attention.py::int8_prob_attention`: probabilities
stored int8 with a per-row scale that falls out of the softmax (the row max
of exp(l - rowmax) is 1, so pq = round(e * 127)), values int8 per (b, h, d)
channel, an exact integer P@V, and the softmax's 1/Z folded into the dequant.

Routes (`int8_route`), one rule:
  * CPU operands: the plain version (`int8_prob_attention_reference`);
  * CUDA bf16 at a head width of `HEAD_DIMS` (32, 48, 64, 96, 128; every
    int8 serve step): "fused", the two kernels of `csrc/int8_attention.cu`,
    instantiated per width: `int8_quantize_v_cuda` quantizes the values,
    `int8_attention_cuda` does the rest in one pass over the queries (the
    logits, exponents and probabilities never reach device memory);
  * CUDA f32 at those widths (an f32 backbone's int8 serve step):
    "fused_f32", the same two kernels instantiated for f32, the logits on
    split-TF32 wgmma after a pre-pass that splits q and k, and pass 2 at
    the reference's f32 rounding points;
  * anything else on CUDA raises. No route falls back to another.
The kernels scale q by 1/sqrt(d) rounded to q's dtype (`sm_scale`), in q's
dtype, before the product, as the reference does.
The sources' notes say what bounds each kernel.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from mvropose_torch.ops._build import current_stream, device_context, load_library
from mvropose_torch.ops.attention import HEAD_DIMS, mask_bytes
from mvropose_torch.ops.attention import _kernel_layout as _operand_layout

# Kernel launches: the fused attention kernel (`int8_attention_cuda`) by
# (route, head width), "fused" for bf16 and "fused_f32" for f32 (its pre-pass
# and kernel, one entry point); the values' quantization
# (`int8_quantize_v_cuda`, both types).
width_launches: collections.Counter = collections.Counter()
quantize_v_launches = 0

FUSED_KEY_TILE = 128  # the values' keys are padded to a multiple of 128 (Tp)
_FUSED_ROUTES = {torch.bfloat16: "fused", torch.float32: "fused_f32"}


def route_launches(route: str) -> int:
    """Launches of the fused kernel on `route` ("fused" or "fused_f32") over
    every head width."""
    return sum(n for (r, _), n in width_launches.items() if r == route)


def int8_route(device_type: str, dtype: torch.dtype, d: int) -> str:
    """The route of operands on this device type, of this dtype and head
    width: "plain" on the CPU; on CUDA "fused" for bf16 and "fused_f32" for
    f32 at every d of `HEAD_DIMS`; raises for any other."""
    if device_type == "cpu":
        return "plain"
    if device_type != "cuda":
        raise ValueError(f"int8_prob_attention runs on the CPU or on CUDA, got {device_type}")
    if d not in HEAD_DIMS or dtype not in _FUSED_ROUTES:
        raise ValueError(f"the int8 attention kernels take bf16 or f32 operands of a head width "
                         f"in {HEAD_DIMS}, got {dtype} at d = {d}")
    return _FUSED_ROUTES[dtype]


@functools.cache
def sm_scale(d: int, dtype: torch.dtype) -> float:
    """The reference's 1/sqrt(d) as it multiplies q: a weakly typed Python
    float, so rounded to q's dtype first (1/8 at d = 64 in every dtype)."""
    return torch.tensor(1.0 / d**0.5, dtype=dtype).item()


# ----------------------------------------------------------- plain versions


def quantize_v_reference(v):
    """The values quantized per (b, h, channel), as the reference: (B, T, H,
    d) v -> (vq (B H, T, d) int8, sv (B H, d) f32), sv = max(max_T |v|,
    1e-6) / 127 and vq = round(v / sv), half to even."""
    B, T, H, d = v.shape
    vh = v.transpose(1, 2).float()  # (B, H, T, d)
    m = vh.abs().amax(dim=2).clamp_min(1e-6)
    # A tensor divisor: torch divides a CUDA tensor by a Python number as a
    # product with its f32 reciprocal, one rounding away from the division.
    sv = m / torch.full_like(m, 127.0)
    vq = torch.round(vh / sv[:, :, None]).to(torch.int8)
    return vq.reshape(B * H, T, d), sv.reshape(B * H, d)


def key_positions(Tp: int, device=None) -> torch.Tensor:
    """The key at each position of a row of the fused kernel's values: each
    group of 16 keys in the order of `key_position` in
    `csrc/int8_attention.cu` (byte 4 t + 2 i + c of a group holds key
    8 i + 2 t + c), so that a thread's probabilities are its A fragment."""
    pos = torch.arange(Tp, device=device)
    j = pos & 15
    t, i, c = j >> 2, (j >> 1) & 1, j & 1
    return (pos & ~15) | (8 * i + 2 * t + c)


def fused_values_layout(vq: torch.Tensor, Tp: int) -> torch.Tensor:
    """(B H, T, d) int8 values -> the fused kernel's (B H, d, Tp): transposed,
    keys in `key_positions` order, zero past T."""
    BH, T, d = vq.shape
    vt = torch.zeros((BH, d, Tp), dtype=torch.int8, device=vq.device)
    vt[:, :, :T] = vq.transpose(1, 2)
    return vt[:, :, key_positions(Tp, vq.device)]


def quantize_v_plain(v, Tp: int):
    """What `int8_quantize_v_cuda` computes, in plain torch: (vt (B H, d,
    Tp) in `fused_values_layout`, sv (B H, d) f32)."""
    vq, sv = quantize_v_reference(v)
    return fused_values_layout(vq, Tp), sv


def int8_pv_reference(pq, vq, z, sv, out_dtype) -> torch.Tensor:
    """Plain torch version of the P@V: pq (BH, T, T) int8, vq (BH, T, d)
    int8, z (BH, T) f32, sv (BH, d) f32 -> (BH, T, d) in out_dtype.

    The integer sums go through f64, where they are exact (f32 is exact only
    while T * 127**2 < 2**24); then the reference's dequant, in its order."""
    acc = torch.bmm(pq.double(), vq.double()).float()
    return (acc * (1.0 / (127.0 * z))[..., None] * sv[:, None, :]).to(out_dtype)


def probability_bytes(ef: torch.Tensor) -> torch.Tensor:
    """The reference's int8 probabilities of f32 exponents in [0, 1]:
    rint(fl(127 e)), half to even. Two roundings: the f32 product, then the
    integer (e = 0.7440945: fl(127 e) = 94.5 -> 94, where rounding the exact
    product once gives 95). The f32 fused kernel rounds at the same points."""
    # Exact integers in [0, 127]: the cast does not round again.
    return torch.round(ef * 127.0).to(torch.int8)


def _probabilities(q, k, key_mask):
    """The reference's logits, exponent and probability quantization, step
    by step in q's dtype: -> (pq (B H, T, T) int8, z (B H, T) f32)."""
    B, T, H, d = q.shape
    qh, kh = q.transpose(1, 2), k.transpose(1, 2)  # (B, H, T, d) views
    # q * 1/sqrt(d) in q's dtype, the scale rounded to that dtype first.
    logits = (qh * sm_scale(d, q.dtype)) @ kh.transpose(-2, -1)  # (B, H, T, T) in q's dtype
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], torch.finfo(logits.dtype).min)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))  # in [0, 1], q's dtype
    ef = e.float()
    z = ef.sum(dim=-1)  # (B, H, T)
    return probability_bytes(ef).reshape(B * H, T, T), z.reshape(B * H, T)


def int8_attention_reference(q, k, vq, sv, key_mask=None) -> torch.Tensor:
    """What the fused kernel computes after the values' quantization, in
    plain torch: (B, T, H, d) q, k, quantized values vq (B H, T, d) and sv
    (B H, d) as `quantize_v_reference` gives them, an optional (B, T) bool
    key mask -> (B, T, H, d) in q's dtype."""
    B, T, H, d = q.shape
    pq, z = _probabilities(q, k, key_mask)
    out = int8_pv_reference(pq, vq, z, sv, q.dtype)
    return out.reshape(B, H, T, d).transpose(1, 2)


def int8_prob_attention_reference(q, k, v, key_mask=None) -> torch.Tensor:
    """The plain version, step by step as the reference: (B, T, H, d) q, k,
    v and an optional (B, T) bool key mask (False = not attended) -> (B, T,
    H, d) in q's dtype."""
    return int8_attention_reference(q, k, *quantize_v_reference(v), key_mask)


# ------------------------------------------------------------------ kernels


@functools.cache
def _kernels():
    lib = load_library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    quantize, fused = lib.int8_quantize_v, lib.int8_attention_sm90
    fused_f32 = lib.int8_attention_f32_sm90
    quantize.argtypes = [ptr] + [i32] * 4 + [ptr] * 3 + [i32, i32, ptr]
    fused.argtypes = [ptr] * 6 + [i32] * 5 + [ptr, ctypes.c_float, ptr]
    fused_f32.argtypes = [ptr] * 6 + [i32] * 5 + [ptr, ctypes.c_float, ptr, ptr]
    for fn in (quantize, fused, fused_f32):
        fn.restype = ctypes.c_int
    lib.int8_attention_f32_scratch.argtypes = [i32] * 4
    lib.int8_attention_f32_scratch.restype = ctypes.c_int64
    return quantize, fused, fused_f32, lib.int8_attention_f32_scratch


def _raise_on(err: int, kernel: str) -> None:
    if err < 0:
        raise RuntimeError(f"{kernel}: a TMA tensor map could not be encoded (CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")


def _fused_tp(T: int) -> int:
    return -(-T // FUSED_KEY_TILE) * FUSED_KEY_TILE


def _check_fused(name: str, t: torch.Tensor, like) -> None:
    """`t` an operand the kernels take, of `like`'s shape and dtype where given."""
    if t.dtype not in _FUSED_ROUTES:
        raise ValueError(f"the fused int8 attention takes bf16 or f32 operands, got {name} "
                         f"{t.dtype}")
    if t.dim() != 4 or t.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the fused int8 attention takes (B, T, H, d) operands with a head "
                         f"width d in {HEAD_DIMS}, got {name} of shape {tuple(t.shape)}")
    if like is not None and (t.shape != like.shape or t.dtype != like.dtype):
        raise ValueError(f"q, k, v must share one (B, T, H, d) shape and dtype, got {name} "
                         f"{tuple(t.shape)} {t.dtype} beside {tuple(like.shape)} {like.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"the fused int8 attention needs CUDA tensors, got {name} on {t.device}")
    B, _, H, _ = t.shape
    if B >= 65536 or H >= 65536:
        raise ValueError(f"the fused int8 attention takes fewer than 65536 batch elements and "
                         f"heads, got B = {B}, H = {H}")
    if not _operand_layout(t):  # the flash kernels' rule: TMA's and the 16-byte loads'
        raise ValueError(f"{name} of strides {t.stride()}: the kernels read unit-stride rows of "
                         f"d at 16-byte aligned addresses, with 16-byte multiples as strides")


def int8_quantize_v_cuda(v):
    """Launch the values' quantization on a CUDA bf16 or f32 (B, T, H, d) v
    (d in `HEAD_DIMS`), read through its strides -> (vt (B H, d, Tp) int8 in
    `fused_values_layout`, Tp = T rounded up to 128, sv (B H, d) f32)."""
    global quantize_v_launches
    _check_fused("v", v, None)
    B, T, H, d = v.shape
    Tp = _fused_tp(T)
    vt = torch.empty((B * H, d, Tp), dtype=torch.int8, device=v.device)
    sv = torch.empty((B * H, d), dtype=torch.float32, device=v.device)
    if B * T * H:
        dev = v.get_device()
        with device_context(dev):
            strides = (ctypes.c_int64 * 3)(*v.stride()[:3])
            err = _kernels()[0](v.data_ptr(), B, H, T, d, strides, vt.data_ptr(), sv.data_ptr(),
                                Tp, int(v.dtype == torch.float32), current_stream(dev))
        _raise_on(err, "int8_quantize_v")
        quantize_v_launches += 1
    return vt, sv


def int8_attention_cuda(q, k, vt, sv, key_mask=None) -> torch.Tensor:
    """Launch the fused kernel: CUDA bf16 or f32 (B, T, H, d) q, k (d in
    `HEAD_DIMS`) read through their strides, the values as
    `int8_quantize_v_cuda` gives them, an optional (B, T) bool key mask ->
    (B, T, H, d) in q's dtype, contiguous. f32 launches the pre-pass and the
    kernel, on a scratch buffer of q scaled and k split into TF32 parts."""
    _check_fused("q", q, None)
    _check_fused("k", k, q)
    B, T, H, d = q.shape
    Tp = _fused_tp(T)
    if (vt.shape != (B * H, d, Tp) or vt.dtype != torch.int8 or not vt.is_contiguous()
            or sv.shape != (B * H, d) or sv.dtype != torch.float32 or not sv.is_contiguous()
            or vt.device != q.device or sv.device != q.device):
        raise ValueError(f"vt {tuple(vt.shape)} {vt.dtype} and sv {tuple(sv.shape)} {sv.dtype} "
                         f"are not the quantized values of a {(B, T, H, d)} v on {q.device}")
    if key_mask is not None and (key_mask.shape != (B, T) or key_mask.dtype != torch.bool
                                 or key_mask.device != q.device):
        raise ValueError(f"key_mask must be (B, T) = {(B, T)} bool on {q.device}, got "
                         f"{tuple(key_mask.shape)} {key_mask.dtype} on {key_mask.device}")
    out = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device)
    if B * T * H:
        mask_u8 = mask_bytes(key_mask)
        dev = q.get_device()
        f32 = q.dtype == torch.float32
        _, fused, fused_f32, scratch_size = _kernels()
        with device_context(dev):
            strides = (ctypes.c_int64 * 6)(*q.stride()[:3], *k.stride()[:3])
            args = (q.data_ptr(), k.data_ptr(), None if mask_u8 is None else mask_u8.data_ptr(),
                    vt.data_ptr(), sv.data_ptr(), out.data_ptr(), B, H, T, d, Tp, strides,
                    sm_scale(d, q.dtype))
            if f32:
                scratch = torch.empty(scratch_size(B, H, Tp, d), dtype=torch.float32,
                                      device=q.device)
                err = fused_f32(*args, scratch.data_ptr(), current_stream(dev))
            else:
                err = fused(*args, current_stream(dev))
        _raise_on(err, "int8_attention_f32" if f32 else "int8_attention")
        width_launches[_FUSED_ROUTES[q.dtype], d] += 1
    return out


def int8_prob_attention(q, k, v, key_mask=None) -> torch.Tensor:
    """Self-attention with int8 probabilities: (B, T, H, d) q, k, v (the
    reference's layout) and an optional (B, T) bool key mask (False = not
    attended) -> (B, T, H, d) in q's dtype, on the route `int8_route` gives."""
    if int8_route(q.device.type, q.dtype, q.shape[-1]) == "plain":
        return int8_prob_attention_reference(q, k, v, key_mask)
    if v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, T, H, d) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return int8_attention_cuda(q, k, *int8_quantize_v_cuda(v), key_mask)
