"""int8-probability attention: the P@V kernel and its plain-torch version.

Port of `mvropose_tpu/ops/attention.py::int8_prob_attention`: probabilities
stored int8 with a per-row scale that falls out of the softmax (the row max
of exp(l - rowmax) is 1, so pq = round(e * 127)), values int8 per (b, h, d)
channel, an exact integer P@V, and the softmax's 1/Z folded into the dequant.
The P@V with its dequant is the kernel `csrc/int8_pv.cu`; its source note
says what bounds it. The logits, the exponent and the quantization stay
plain torch, as they are plain XLA in the reference.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mvropose_torch.ops._build import load_library

# Kernel launches made through `int8_pv_cuda`.
launches = 0

HEAD_DIM = 64  # the kernel's one head width (every ViT the repo configures)
KEY_TILE = 64  # the kernel walks the keys in tiles of 64
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def padded_probs(BH: int, T: int, device) -> torch.Tensor:
    """An empty int8 (BH, T, T) view whose rows are KEY_TILE-padded in
    memory: the layout the kernel reads with 16-byte copies, which the
    producer of pq writes into. The padding stays unwritten; the kernel
    multiplies it by zero values."""
    Tp = -(-T // KEY_TILE) * KEY_TILE
    return torch.empty((BH, T, Tp), dtype=torch.int8, device=device)[:, :, :T]


def _kernel_layout(pq: torch.Tensor, Tp: int) -> bool:
    """Whether the kernel can read `pq` as it is: unit key stride, 16-byte
    aligned rows and heads, and every row readable up to key Tp. An empty
    `pq` has nothing to read."""
    BH, T, _ = pq.shape
    if BH * T == 0:
        return True
    s0, s1, s2 = pq.stride()
    last = pq.storage_offset() + (BH - 1) * s0 + (T - 1) * s1 + Tp
    return (s2 == 1 and s1 >= Tp and s1 % 16 == 0 and s0 % 16 == 0 and s0 >= T * s1
            and pq.data_ptr() % 16 == 0 and last <= pq.untyped_storage().nbytes())


def int8_pv_reference(pq, vq, z, sv, out_dtype) -> torch.Tensor:
    """Plain torch version: pq (BH, T, T) int8, vq (BH, T, d) int8, z (BH, T)
    f32, sv (BH, d) f32 -> (BH, T, d) in out_dtype.

    The integer sums go through f64, where they are exact (f32 is exact only
    while T * 127**2 < 2**24); then the reference's dequant, in its order."""
    acc = torch.bmm(pq.double(), vq.double()).float()
    return (acc * (1.0 / (127.0 * z))[..., None] * sv[:, None, :]).to(out_dtype)


@functools.cache
def _kernel():
    fn = load_library().int8_pv
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_int64] * 2 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def int8_pv_cuda(pq, vq, z, sv, out_dtype) -> torch.Tensor:
    """Launch the kernel on CUDA operands (shapes as `int8_pv_reference`)."""
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
        with torch.cuda.device(out.device):
            stream = torch.cuda.current_stream(out.device).cuda_stream
            err = _kernel()(pq.data_ptr(), vt.data_ptr(), zf.data_ptr(), s.data_ptr(),
                            out.data_ptr(), BH, T, Tp, pq.stride(1), pq.stride(0),
                            _OUT_CODES[out_dtype], stream)
        if err != 0:
            raise RuntimeError(f"int8_pv launch failed with CUDA error {err}")
        launches += 1
    return out


def int8_pv(pq, vq, z, sv, out_dtype) -> torch.Tensor:
    """The kernel for CUDA operands, the plain version for CPU operands."""
    if pq.device.type == "cpu":
        return int8_pv_reference(pq, vq, z, sv, out_dtype)
    return int8_pv_cuda(pq, vq, z, sv, out_dtype)


def int8_prob_attention(q, k, v, key_mask=None) -> torch.Tensor:
    """Self-attention with int8 probabilities: (B, T, H, d) q, k, v (the
    reference's layout) and an optional (B, T) bool key mask (False = not
    attended) -> (B, T, H, d) in q's dtype, step by step as the reference."""
    B, T, H, d = q.shape
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, T, d) views
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
    # written into the kernel's padded row layout.
    pq = padded_probs(B * H, T, q.device).copy_(torch.round(ef * 127.0).reshape(B * H, T, T))
    sv = vh.float().abs().amax(dim=2).clamp_min(1e-6) / 127.0  # (B, H, d), over T
    vq = torch.round(vh.float() / sv[:, :, None]).to(torch.int8)  # (B, H, T, d)
    out = int8_pv(pq, vq.reshape(B * H, T, d), z.reshape(B * H, T), sv.reshape(B * H, d),
                  q.dtype)
    return out.reshape(B, H, T, d).transpose(1, 2)
