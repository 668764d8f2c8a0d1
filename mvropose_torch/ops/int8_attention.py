"""int8-probability attention: the fused kernel, the P@V kernel, and their
plain-torch versions.

Port of `mvropose_tpu/ops/attention.py::int8_prob_attention`: probabilities
stored int8 with a per-row scale that falls out of the softmax (the row max
of exp(l - rowmax) is 1, so pq = round(e * 127)), values int8 per (b, h, d)
channel, an exact integer P@V, and the softmax's 1/Z folded into the dequant.

Routes (`int8_route`), one rule:
  * CPU operands: the plain version (`int8_prob_attention_reference`);
  * CUDA bf16 at d = 64 (every int8 serve step): "fused", the two kernels of
    `csrc/int8_attention.cu`: `int8_quantize_v_cuda` quantizes the values,
    `int8_attention_cuda` does the rest in one pass over the queries (the
    logits, exponents and probabilities never reach device memory);
  * CUDA f32 at d = 64: "pv", the plain logits, softmax and quantization,
    then the P@V kernel `csrc/int8_pv.cu` (`int8_pv_cuda`); f32 logits have
    no bf16 tensor-core counterpart. `pv_route()` sends bf16 there too, for
    comparisons on the card;
  * anything else on CUDA raises. No route falls back to another.
The sources' notes say what bounds each kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from mvropose_torch.ops._build import current_stream, device_context, load_library
from mvropose_torch.ops.attention import _kernel_layout as _operand_layout
from mvropose_torch.ops.attention import mask_bytes

# Kernel launches: the P@V kernel (`int8_pv_cuda`), the fused attention
# kernel (`int8_attention_cuda`) and the values' quantization (`int8_quantize_v_cuda`).
launches = 0
launches_fused = 0
quantize_v_launches = 0

HEAD_DIM = 64  # the kernels' one head width (every ViT the repo configures)
KEY_TILE = 64  # the P@V kernel walks the keys in tiles of 64
FUSED_KEY_TILE = 128  # the fused kernel streams tiles of 128 keys
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PV_ROUTE_BF16 = False  # `pv_route()`: bf16 takes the "pv" route too


def int8_route(device_type: str, dtype: torch.dtype, d: int) -> str:
    """The route of operands on this device type, of this dtype and head
    width: "plain" on the CPU; on CUDA "fused" for bf16 at d = 64 (or "pv"
    inside `pv_route()`) and "pv" for f32 at d = 64; raises for any other."""
    if device_type == "cpu":
        return "plain"
    if device_type != "cuda":
        raise ValueError(f"int8_prob_attention runs on the CPU or on CUDA, got {device_type}")
    if d != HEAD_DIM or dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the int8 attention kernels take bf16 or f32 operands of head width "
                         f"{HEAD_DIM}, got {dtype} at d = {d}")
    return "fused" if dtype == torch.bfloat16 and not _PV_ROUTE_BF16 else "pv"


@contextlib.contextmanager
def pv_route():
    """Within this block bf16 CUDA operands take the "pv" route (the plain
    chain, then the P@V kernel), for the comparisons on the card."""
    global _PV_ROUTE_BF16
    saved, _PV_ROUTE_BF16 = _PV_ROUTE_BF16, True
    try:
        yield
    finally:
        _PV_ROUTE_BF16 = saved


# ----------------------------------------------------------- plain versions


def padded_probs(BH: int, T: int, device) -> torch.Tensor:
    """An empty int8 (BH, T, T) view whose rows are KEY_TILE-padded in
    memory: the layout the P@V kernel reads with 16-byte copies, which the
    producer of pq writes into. The padding stays unwritten; the kernel
    multiplies it by zero values."""
    Tp = -(-T // KEY_TILE) * KEY_TILE
    return torch.empty((BH, T, Tp), dtype=torch.int8, device=device)[:, :, :T]


def _kernel_layout(pq: torch.Tensor, Tp: int) -> bool:
    """Whether the P@V kernel can read `pq` as it is: unit key stride,
    16-byte aligned rows and heads, and every row readable up to key Tp. An
    empty `pq` has nothing to read."""
    BH, T, _ = pq.shape
    if BH * T == 0:
        return True
    s0, s1, s2 = pq.stride()
    last = pq.storage_offset() + (BH - 1) * s0 + (T - 1) * s1 + Tp
    return (s2 == 1 and s1 >= Tp and s1 % 16 == 0 and s0 % 16 == 0 and s0 >= T * s1
            and pq.data_ptr() % 16 == 0 and last <= pq.untyped_storage().nbytes())


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


def _probabilities(q, k, key_mask):
    """The reference's logits, exponent and probability quantization, step
    by step in q's dtype: -> (pq (B H, T, T) int8 in `padded_probs`' rows, z
    (B H, T) f32)."""
    B, T, H, d = q.shape
    qh, kh = q.transpose(1, 2), k.transpose(1, 2)  # (B, H, T, d) views
    # q * 1/sqrt(d) in q's dtype: the reference's weakly typed scale is
    # rounded to that dtype first.
    sm_scale = torch.tensor(1.0 / d**0.5, dtype=q.dtype).item()
    logits = (qh * sm_scale) @ kh.transpose(-2, -1)  # (B, H, T, T) in q's dtype
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], torch.finfo(logits.dtype).min)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))  # in [0, 1], q's dtype
    ef = e.float()
    z = ef.sum(dim=-1)  # (B, H, T)
    # round(e * 127) as int8 (exact integers: the cast does not round again),
    # written into the P@V kernel's padded row layout.
    pq = padded_probs(B * H, T, q.device).copy_(torch.round(ef * 127.0).reshape(B * H, T, T))
    return pq, z.reshape(B * H, T)


def int8_attention_reference(q, k, vq, sv, key_mask=None, pv=int8_pv_reference) -> torch.Tensor:
    """What the fused kernel computes after the values' quantization, in
    plain torch: (B, T, H, d) q, k, quantized values vq (B H, T, d) and sv
    (B H, d) as `quantize_v_reference` gives them, an optional (B, T) bool
    key mask -> (B, T, H, d) in q's dtype. `pv` is the P@V."""
    B, T, H, d = q.shape
    pq, z = _probabilities(q, k, key_mask)
    out = pv(pq, vq, z, sv, q.dtype)
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
    pv, quantize, fused = lib.int8_pv, lib.int8_quantize_v, lib.int8_attention_sm90
    pv.argtypes = [ptr] * 5 + [i32] * 3 + [ctypes.c_int64] * 2 + [i32, ptr]
    quantize.argtypes = [ptr] + [i32] * 3 + [ptr] * 3 + [i32, ptr]
    fused.argtypes = [ptr] * 6 + [i32] * 4 + [ptr, ptr]
    for fn in (pv, quantize, fused):
        fn.restype = ctypes.c_int
    return pv, quantize, fused


def _raise_on(err: int, kernel: str) -> None:
    if err < 0:
        raise RuntimeError(f"{kernel}: a TMA tensor map could not be encoded (CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")


def int8_pv_cuda(pq, vq, z, sv, out_dtype) -> torch.Tensor:
    """Launch the P@V kernel on CUDA operands (shapes as `int8_pv_reference`)."""
    global launches
    for name, t in (("pq", pq), ("vq", vq), ("z", z), ("sv", sv)):
        if t.device.type != "cuda":
            raise ValueError(f"int8_pv_cuda needs CUDA tensors, got {name} on {t.device}")
    if pq.dtype != torch.int8 or vq.dtype != torch.int8:
        raise ValueError(f"pq and vq must be int8, got {pq.dtype} and {vq.dtype}")
    if out_dtype not in _OUT_CODES:
        raise ValueError(f"no int8_pv kernel writing {out_dtype}")
    BH, T, d = vq.shape
    if d != HEAD_DIM:
        raise ValueError(f"the int8_pv kernel takes head width {HEAD_DIM}, got {d}")
    if pq.shape != (BH, T, T) or z.shape != (BH, T) or sv.shape != (BH, d):
        raise ValueError(
            f"shapes pq {tuple(pq.shape)}, vq {tuple(vq.shape)}, z {tuple(z.shape)}, "
            f"sv {tuple(sv.shape)} do not agree"
        )
    if BH >= 65536:
        raise ValueError(f"pq of shape {tuple(pq.shape)}: the kernel takes fewer than 65536 heads")
    Tp = -(-T // KEY_TILE) * KEY_TILE
    if not _kernel_layout(pq, Tp):
        raise ValueError(
            f"pq of shape {tuple(pq.shape)} and strides {pq.stride()}: the kernel reads rows "
            f"padded to {KEY_TILE} keys; write pq into `padded_probs`"
        )
    vt = torch.zeros((BH, d, Tp), dtype=torch.int8, device=vq.device)
    vt[:, :, :T] = vq.transpose(1, 2)
    zf, s = z.float().contiguous(), sv.float().contiguous()
    out = torch.empty((BH, T, d), dtype=out_dtype, device=vq.device)
    if BH and T:
        dev = out.get_device()
        with device_context(dev):
            err = _kernels()[0](pq.data_ptr(), vt.data_ptr(), zf.data_ptr(), s.data_ptr(),
                                out.data_ptr(), BH, T, Tp, pq.stride(1), pq.stride(0),
                                _OUT_CODES[out_dtype], current_stream(dev))
        _raise_on(err, "int8_pv")
        launches += 1
    return out


def int8_pv(pq, vq, z, sv, out_dtype) -> torch.Tensor:
    """The P@V kernel for CUDA operands, the plain version for CPU operands."""
    if pq.device.type == "cpu":
        return int8_pv_reference(pq, vq, z, sv, out_dtype)
    return int8_pv_cuda(pq, vq, z, sv, out_dtype)


def _fused_tp(T: int) -> int:
    return -(-T // FUSED_KEY_TILE) * FUSED_KEY_TILE


def _check_fused(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.bfloat16:
        raise ValueError(f"the fused int8 attention takes bf16 operands, got {name} {t.dtype}")
    if t.dim() != 4 or t.shape[-1] != HEAD_DIM:
        raise ValueError(f"the fused int8 attention takes (B, T, H, {HEAD_DIM}) operands, got "
                         f"{name} of shape {tuple(t.shape)}")
    if shape is not None and t.shape != shape:
        raise ValueError(f"q, k, v must share one (B, T, H, d) shape, got {name} "
                         f"{tuple(t.shape)} beside {tuple(shape)}")
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
    """Launch the values' quantization on a CUDA bf16 (B, T, H, 64) v, read
    through its strides -> (vt (B H, 64, Tp) int8 in `fused_values_layout`,
    Tp = T rounded up to 128, sv (B H, 64) f32)."""
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
            err = _kernels()[1](v.data_ptr(), B, H, T, strides, vt.data_ptr(), sv.data_ptr(), Tp,
                                current_stream(dev))
        _raise_on(err, "int8_quantize_v")
        quantize_v_launches += 1
    return vt, sv


def int8_attention_cuda(q, k, vt, sv, key_mask=None) -> torch.Tensor:
    """Launch the fused kernel: CUDA bf16 (B, T, H, 64) q, k read through
    their strides, the values as `int8_quantize_v_cuda` gives them, an
    optional (B, T) bool key mask -> (B, T, H, 64) bf16, contiguous."""
    global launches_fused
    _check_fused("q", q, None)
    _check_fused("k", k, q.shape)
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
        with device_context(dev):
            strides = (ctypes.c_int64 * 6)(*q.stride()[:3], *k.stride()[:3])
            err = _kernels()[2](q.data_ptr(), k.data_ptr(),
                                None if mask_u8 is None else mask_u8.data_ptr(), vt.data_ptr(),
                                sv.data_ptr(), out.data_ptr(), B, H, T, Tp, strides,
                                current_stream(dev))
        _raise_on(err, "int8_attention")
        launches_fused += 1
    return out


def int8_prob_attention(q, k, v, key_mask=None) -> torch.Tensor:
    """Self-attention with int8 probabilities: (B, T, H, d) q, k, v (the
    reference's layout) and an optional (B, T) bool key mask (False = not
    attended) -> (B, T, H, d) in q's dtype, on the route `int8_route` gives."""
    route = int8_route(q.device.type, q.dtype, q.shape[-1])
    if route == "plain":
        return int8_prob_attention_reference(q, k, v, key_mask)
    if route == "pv":
        return int8_attention_reference(q, k, *quantize_v_reference(v), key_mask, pv=int8_pv_cuda)
    if v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, T, H, d) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return int8_attention_cuda(q, k, *int8_quantize_v_cuda(v), key_mask)
