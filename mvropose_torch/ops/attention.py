"""Self-attention of the backbone blocks and `SelfAttentionFusion`: the
flash-attention kernels and their plain-torch version.

Port of `mvropose_tpu/ops/attention.py::fused_self_attention`. The reference
runs its plain branch (einsums and a softmax in the operand dtype) below
T = 2048 tokens or off the TPU, and JAX's stock Pallas flash attention
(forward, dK/dV and dQ kernels under a `custom_vjp`) at T >= 2048 on a TPU.
The port keeps that rule with "on the card" for "on a TPU" (`flash_rule`):
a CUDA q at T >= `FLASH_MIN_TOKENS` goes to the kernels, whatever its dtype
(a dtype without kernels raises); every CPU q, and every q below that T,
goes to `flash_attention_reference`, the plain branch, in q's own dtype.
With a key mask the port follows the plain branch where the two branches of
the reference disagree: a query with no valid key averages v over the T
real keys (the reference's flash branch averages over T padded to 512).

Layout: (B, T, H, d) q, k, v, the reference's public layout; the kernels
read them through their strides, so the projections' outputs go in as they
are, and write O and the gradients in the same layout.

Three routes (`kernel_route`, `ENTRY_POINTS`), one per dtype, each with a
forward, a dK/dV and a dQ kernel at every width of `HEAD_DIMS`. bf16 takes
the Hopper kernels of `csrc/flash_attention.cu` (wgmma, TMA and a
warp-specialised mbarrier ring; "wgmma"), f16 the same kernels instantiated
for f16 ("wgmma_f16": f16 x f16 products accumulate exactly in f32 on the
tensor cores, as bf16's do), f32 those of `csrc/flash_attention_tf32.cu`
("wgmma_tf32": the same design on TF32 wgmma, each f32 product as three
TF32 products of the operands' big and small parts, written by a pre-pass
into a scratch buffer, so they keep f32's accuracy; `tf32_scratch`). Each
backward reads its forward's m (base 2) and l. A width outside
`HEAD_DIMS`, or a dtype without kernels, raises on every route. The
sources' notes say what bounds each. `flash_forward_plain` and
`flash_backward_plain` compute what the kernels compute, from the same
saved statistics, in plain torch: the yardsticks of the kernels alone.
`flash_forward_tf32_model` and `flash_backward_tf32_model` are the f32
kernels' split-TF32 arithmetic in plain torch, and with one TF32 product in
place of three the negative control of their accuracy bound.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from mvropose_torch.ops._build import current_stream, device_context, load_library

# Launches of the forward, dK/dV and dQ kernels by route:
# {("fwd" | "dkv" | "dq", route): count}.
route_launches = collections.Counter()

FLASH_MIN_TOKENS = 2048  # the reference's crossover (ops/attention.py:99-100)
HEAD_DIMS = (32, 48, 64, 96, 128)  # the head widths the kernels are built for
FLASH_PARTS = ("fwd", "dkv", "dq")  # the forward, dK/dV and dQ kernels
# route: the C entry points of its forward, dK/dV and dQ kernels.
ENTRY_POINTS = {
    "wgmma": ("flash_attention_forward_sm90", "flash_attention_backward_dkv_sm90",
              "flash_attention_backward_dq_sm90"),
    "wgmma_f16": ("flash_attention_forward_sm90_f16", "flash_attention_backward_dkv_sm90_f16",
                  "flash_attention_backward_dq_sm90_f16"),
    "wgmma_tf32": ("flash_attention_forward_tf32", "flash_attention_backward_dkv_tf32",
                   "flash_attention_backward_dq_tf32"),
}
# dtype: the routes of its forward, dK/dV and dQ.
DTYPE_ROUTES = {torch.bfloat16: ("wgmma",) * 3, torch.float16: ("wgmma_f16",) * 3,
                torch.float32: ("wgmma_tf32",) * 3}
LOG2E = 1.4426950408889634
# The plain branch's masked logit, bf16's lowest finite value (exact in f32).
MASKED_LOGIT = torch.finfo(torch.bfloat16).min


def rounded(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as a Python float (no device copy): a
    weakly typed JAX scalar meets a tensor in the tensor's dtype."""
    return torch.tensor(value, dtype=dtype).item()


def flash_attention_reference(q, k, v, key_mask=None) -> torch.Tensor:
    """The reference's plain branch (`ops/attention.py:102-114`): (B, T, H, d)
    q, k, v and an optional (B, T) bool key mask (False = not attended) ->
    (B, T, H, d) in q's dtype. q times 1/sqrt(d) rounded to q's dtype (the
    reference's weakly typed scale), logits in q's dtype, masked logits set
    to the dtype's lowest finite value, softmax in q's dtype."""
    scale = rounded(1.0 / math.sqrt(q.shape[-1]), q.dtype)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, T, d) views
    logits = (qh * scale) @ kh.transpose(-2, -1)
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], torch.finfo(logits.dtype).min)
    return (torch.softmax(logits, dim=-1) @ vh).transpose(1, 2)


def flash_attention_reference_f32(q, k, v, key_mask=None) -> torch.Tensor:
    """The plain branch in f32 on the same values: the yardstick of the
    kernels' and the bf16 plain branch's errors on the card."""
    return flash_attention_reference(q.float(), k.float(), v.float(), key_mask)


@functools.cache
def _kernels() -> dict:
    """{route: (forward, dK/dV, dQ)} bound from the kernels' library."""
    lib = load_library()
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    forward = [ptr] * 7 + [i32] * 4 + [ptr, f32, ptr]
    argtypes = (forward, [ptr] * 10 + [i32] * 4 + [ptr, f32, ptr],  # forward, dK/dV
                [ptr] * 9 + [i32] * 4 + [ptr, f32, ptr])  # dQ
    bound = {}
    for route, names in ENTRY_POINTS.items():
        bound[route] = tuple(getattr(lib, name) for name in names)
        for fn, types in zip(bound[route], argtypes):
            # ... and the f32 kernels the split operands' scratch.
            fn.argtypes, fn.restype = types + [ptr] * (route == "wgmma_tf32"), ctypes.c_int
    return bound


@functools.cache
def forward_key_tile() -> int:
    """Keys per tile of the bf16 and f16 Hopper forward, read from the kernels' library."""
    return load_library().flash_attention_forward_key_tile()


@functools.cache
def _tf32_scratch_fn(part: str):
    lib = load_library()
    fn = (lib.flash_attention_forward_tf32_scratch if part == "fwd"
          else lib.flash_attention_backward_tf32_scratch)
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int64
    return fn


def tf32_scratch(B: int, H: int, T: int, d: int, part: str = "fwd") -> int:
    """f32 elements of the split operands that the pre-pass of an f32
    kernel ("fwd", "dkv" or "dq") writes at (B, H, T, d), read from the
    kernels' library."""
    return _tf32_scratch_fn("fwd" if part == "fwd" else "bwd")(B, H, T, d)


def _scratch(route: str, part: str, q) -> tuple:
    """The f32 kernels' scratch for their split operands as (the tensor,
    which the caller holds until the launch has been enqueued, and the
    trailing argument of its entry point); ((), ()) for the other routes.
    The stream orders the memory's reuse after the call returns it to the
    allocator."""
    if route != "wgmma_tf32":
        return (), ()
    B, T, H, d = q.shape
    scratch = torch.empty(tf32_scratch(B, H, T, d, part), dtype=torch.float32, device=q.device)
    return scratch, (scratch.data_ptr(),)


def kernel_route(d: int, dtype: torch.dtype = torch.bfloat16, part: str = "fwd") -> str:
    """The kernel that a head width, an operand dtype and a part ("fwd",
    "dkv" or "dq") take: "wgmma" for bf16, "wgmma_f16" for f16 (Hopper:
    wgmma, TMA, warp-specialised) and "wgmma_tf32" for f32 (the same on
    split-TF32 wgmma), every part; raises for a width or a dtype without
    kernels."""
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash-attention kernels take head widths {HEAD_DIMS}, got d = {d}")
    if dtype not in DTYPE_ROUTES:
        raise ValueError(f"the flash-attention kernels take bf16, f16 or f32 operands, got {dtype}")
    return DTYPE_ROUTES[dtype][FLASH_PARTS.index(part)]


def part_launches(part: str) -> int:
    """Launches of `part`'s kernels ("fwd", "dkv" or "dq") over every route."""
    return sum(n for (p, _), n in route_launches.items() if p == part)


def flash_rule(device_type: str, tokens: int) -> bool:
    """Whether `fused_self_attention(use_flash=None)` takes the kernels for
    a q on this device type with this token count: a CUDA q at T >=
    FLASH_MIN_TOKENS does, whatever its dtype; every other q takes the plain
    branch."""
    return device_type == "cuda" and tokens >= FLASH_MIN_TOKENS


def _kernel_layout(t: torch.Tensor) -> bool:
    """Whether the kernels read `t` as it is: unit stride along d, the other
    strides whole 16-byte rows, a 16-byte aligned base."""
    return (t.stride(-1) == 1 and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _check(q, k, v, key_mask) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, T, H, d) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, d = q.shape
    kernel_route(d, q.dtype)  # raises for a head width or a dtype without kernels
    if not k.dtype == v.dtype == q.dtype:
        raise ValueError(f"q, k, v must share one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {name} on {t.device}")
    if B >= 65536 or H >= 65536:
        raise ValueError(f"the flash-attention kernels take fewer than 65536 batch elements "
                         f"and heads, got B = {B}, H = {H}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _kernel_layout(t):
            raise ValueError(f"{name} of strides {t.stride()}: the kernels read unit-stride "
                             "rows of d at 16-byte aligned addresses")
    if key_mask is not None and (key_mask.shape != (B, T) or key_mask.dtype != torch.bool
                                 or key_mask.device != q.device):
        raise ValueError(f"key_mask must be (B, T) = {(B, T)} bool on {q.device}, got "
                         f"{tuple(key_mask.shape)} {key_mask.dtype} on {key_mask.device}")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _strides(*tensors) -> ctypes.Array:
    return (ctypes.c_int64 * 12)(*(s for t in tensors for s in t.stride()[:3]),
                                 *([0] * (12 - 3 * len(tensors))))


def mask_bytes(key_mask):
    """A (B, T) bool key mask as the kernels read it: (B, T) bytes, a view."""
    return None if key_mask is None else key_mask.contiguous().view(torch.uint8)


def _raise_on(err: int, kernel: str) -> None:
    if err < 0:
        raise RuntimeError(f"flash-attention {kernel}: a TMA tensor map could not be encoded "
                           f"(CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"flash-attention {kernel} launch failed with CUDA error {err}")


def flash_forward_cuda(q, k, v, mask_u8=None, save_stats: bool = True):
    """Launch the forward kernel of `kernel_route(d, q.dtype)` on operands
    that `flash_attention_cuda` takes (mask as `mask_bytes`) -> (O (B, T, H,
    d) in q's dtype, m, l), with the row statistics m (base 2) and l as (B,
    H, T) f32 when `save_stats`. The f32 forward also gets a scratch buffer
    for its split operands (`tf32_scratch`)."""
    B, T, H, d = q.shape
    route = kernel_route(d, q.dtype)
    o = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device)
    m = l = None
    if save_stats:
        m = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    if B * T * H:
        dev = q.get_device()
        scratch, extra = _scratch(route, "fwd", q)
        with device_context(dev):
            stream = current_stream(dev)
            err = _kernels()[route][0](q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask_u8),
                                       o.data_ptr(), _ptr(m), _ptr(l), B, H, T, d,
                                       _strides(q, k, v), 1.0 / math.sqrt(d), stream, *extra)
        _raise_on(err, f"forward ({route})")
        route_launches["fwd", route] += 1
    return o, m, l


def _logits_base2(q, k, mask_u8) -> torch.Tensor:
    """(B, H, T, T) f32 logits as the kernels form them: q k^T times
    sm_scale log2(e) in f32, masked keys at MASKED_LOGIT."""
    d = q.shape[-1]
    scale_log2 = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) * LOG2E
    x = (q.float().transpose(1, 2) @ k.float().permute(0, 2, 3, 1)) * scale_log2.to(q.device)
    if mask_u8 is not None:
        x = x.masked_fill(mask_u8[:, None, None, :] == 0, MASKED_LOGIT)
    return x


def flash_forward_plain(q, k, v, mask_u8=None):
    """What the forward kernel computes, in plain torch (f32 inside):
    (B, T, H, d) q, k, v and an optional (B, T) byte mask -> (O in q's dtype,
    m, l), m the row max in base-2 units and l the row sum, (B, H, T) f32,
    as `flash_forward_cuda` saves them. P = exp2(logits - m) is rounded to
    q's dtype before P V (a no-op for f32 operands), as the kernels and the
    reference's flash kernel round it (the kernels against the running max
    of the key tiles seen so far, this against the row's), and O = P V / l
    rounded once."""
    x = _logits_base2(q, k, mask_u8)
    m = x.amax(-1)
    p = torch.exp2(x - m[..., None])
    l = p.sum(-1)
    o = (p.to(q.dtype).float() @ v.float().transpose(1, 2)) * l.reciprocal()[..., None]
    return o.transpose(1, 2).to(q.dtype), m, l


def tf32_split(x: torch.Tensor) -> tuple:
    """f32 x -> (big, small) as the f32 kernels split their operands: big is
    x with its low 13 mantissa bits cleared, small = x - big (exact in f32)
    with its own cleared. Both are exact TF32 values."""
    def cleared(t):
        return (t.view(torch.int32) & -8192).view(torch.float32)  # & 0xffffe000

    big = cleared(x)
    return big, cleared(x - big)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, products: int = 3) -> torch.Tensor:
    """a @ b (f32) as the f32 kernels' tensor cores form it, in f32 sums:
    products = 3 is a_big b_big + a_big b_small + a_small b_big (split
    TF32, ~2^-20 of each product dropped); products = 1 is a_big b_big alone
    (one TF32 product, ~2^-10 dropped)."""
    (a_big, a_small), (b_big, b_small) = tf32_split(a), tf32_split(b)
    out = a_big @ b_big
    if products == 3:
        out = out + a_big @ b_small + a_small @ b_big
    return out


def flash_forward_tf32_model(q, k, v, mask_u8=None, products: int = 3):
    """`flash_forward_plain` for f32 operands with its two products formed
    as `tf32_matmul(.., products)`: the f32 forward kernel's arithmetic in
    plain torch (products = 3), or the same with one TF32 product each (1),
    which a kernel that drops the small terms would compute. -> (O, m, l)."""
    d = q.shape[-1]
    scale_log2 = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) * LOG2E
    x = tf32_matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1), products) * scale_log2.to(q.device)
    if mask_u8 is not None:
        x = x.masked_fill(mask_u8[:, None, None, :] == 0, MASKED_LOGIT)
    m = x.amax(-1)
    p = torch.exp2(x - m[..., None])
    l = p.sum(-1)
    o = tf32_matmul(p, v.transpose(1, 2), products) * l.reciprocal()[..., None]
    return o.transpose(1, 2), m, l


def flash_backward_plain(q, k, v, mask_u8, do, m, l, di):
    """What the dK/dV and dQ kernels compute, in plain torch (f32 inside),
    with their interface -> (dQ, dK, dV) (B, T, H, d) in q's dtype: P =
    exp2(logits - m) / l from the *saved* m (base 2) and l, so an all-masked
    row recomputes P = 1/T; dV = P^T dO, dS = P o (dO V^T - di), 0 at masked
    keys, dQ = sm_scale dS K, dK = sm_scale dS^T Q. The Hopper pair's
    rounding points: P and dS rounded to q's dtype before the products they
    enter (a no-op for f32 operands), sm_scale applied to the f32 sums, each
    output rounded once. (The reference rounds sm_scale dS, not dS: the
    same where sm_scale is a power of two, as at d = 64.)"""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp2(_logits_base2(q, k, mask_u8) - m[..., None]) * l.reciprocal()[..., None]
    qh, kh, vh, doh = (t.float().transpose(1, 2) for t in (q, k, v, do))
    dv = p.to(q.dtype).float().transpose(-2, -1) @ doh
    ds = p * (doh @ vh.transpose(-2, -1) - di[..., None])
    if mask_u8 is not None:
        ds = ds.masked_fill(mask_u8[:, None, None, :] == 0, 0.0)
    ds = ds.to(q.dtype).float()
    dq = (ds @ kh) * scale
    dk = (ds.transpose(-2, -1) @ qh) * scale
    return tuple(t.transpose(1, 2).to(q.dtype) for t in (dq, dk, dv))


def flash_backward_tf32_model(q, k, v, mask_u8, do, m, l, di, products: int = 3):
    """`flash_backward_plain` for f32 operands with its five products (S,
    dP, dV, dQ, dK) formed as `tf32_matmul(.., products)`: the f32 backward
    kernels' arithmetic in plain torch (products = 3), or the same with one
    TF32 product each (1), which a pair that dropped the small terms would
    compute. -> (dQ, dK, dV)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    qh, kh, vh, doh = (t.float().transpose(1, 2) for t in (q, k, v, do))
    x = tf32_matmul(qh, kh.transpose(-2, -1), products) * scale_log2.to(q.device)
    if mask_u8 is not None:
        x = x.masked_fill(mask_u8[:, None, None, :] == 0, MASKED_LOGIT)
    p = torch.exp2(x - m[..., None]) * l.reciprocal()[..., None]
    dv = tf32_matmul(p.transpose(-2, -1), doh, products)
    ds = p * (tf32_matmul(doh, vh.transpose(-2, -1), products) - di[..., None])
    if mask_u8 is not None:
        ds = ds.masked_fill(mask_u8[:, None, None, :] == 0, 0.0)
    dq = tf32_matmul(ds, kh, products) * scale
    dk = tf32_matmul(ds.transpose(-2, -1), qh, products) * scale
    return tuple(t.transpose(1, 2) for t in (dq, dk, dv))


def row_dot(do, o) -> torch.Tensor:
    """di = rowsum(dO o O) in f32, (B, H, T), as the reference computes it
    in jnp beside its backward kernels."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _backward_args(q, k, v, mask_u8, do, m, l, di):
    B, T, H, d = q.shape
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask_u8), do.data_ptr(),
            m.data_ptr(), l.data_ptr(), di.data_ptr())
    return ptrs, (B, H, T, d, _strides(q, k, v, do), 1.0 / math.sqrt(d))


def flash_backward_dkv_cuda(q, k, v, mask_u8, do, m, l, di):
    """Launch the dK/dV kernel of `kernel_route(d, q.dtype, "dkv")`: the
    forward's operands and statistics (m in base 2 and l, as every route's
    forward saves them), dO in their layout and dtype and di =
    `row_dot(dO, O)` -> (dK, dV) (B, T, H, d) in q's dtype. The f32 kernel
    also gets a scratch buffer for its split operands (`tf32_scratch`)."""
    route = kernel_route(q.shape[-1], q.dtype, "dkv")
    dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(2))
    if q.numel():
        ptrs, dims = _backward_args(q, k, v, mask_u8, do, m, l, di)
        dev = q.get_device()
        scratch, extra = _scratch(route, "dkv", q)
        with device_context(dev):
            stream = current_stream(dev)
            err = _kernels()[route][1](*ptrs, dk.data_ptr(), dv.data_ptr(), *dims, stream, *extra)
        _raise_on(err, f"dK/dV ({route})")
        route_launches["dkv", route] += 1
    return dk, dv


def flash_backward_dq_cuda(q, k, v, mask_u8, do, m, l, di):
    """Launch the dQ kernel of `kernel_route(d, q.dtype, "dq")` (arguments
    as `flash_backward_dkv_cuda`) -> dQ."""
    route = kernel_route(q.shape[-1], q.dtype, "dq")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.numel():
        ptrs, dims = _backward_args(q, k, v, mask_u8, do, m, l, di)
        dev = q.get_device()
        scratch, extra = _scratch(route, "dq", q)
        with device_context(dev):
            stream = current_stream(dev)
            err = _kernels()[route][2](*ptrs, dq.data_ptr(), *dims, stream, *extra)
        _raise_on(err, f"dQ ({route})")
        route_launches["dq", route] += 1
    return dq


class _FlashAttention(torch.autograd.Function):
    """Forward kernel; backward: di in plain torch, the dK/dV kernel, then
    the dQ kernel."""

    @staticmethod
    def forward(ctx, q, k, v, mask_u8):
        o, m, l = flash_forward_cuda(q, k, v, mask_u8)
        ctx.save_for_backward(q, k, v, mask_u8, o, m, l)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask_u8, o, m, l = ctx.saved_tensors
        if not _kernel_layout(do):
            do = do.contiguous()
        args = (q, k, v, mask_u8, do, m, l, row_dot(do, o))
        dk, dv = flash_backward_dkv_cuda(*args)
        return flash_backward_dq_cuda(*args), dk, dv, None


def flash_attention_cuda(q, k, v, key_mask=None) -> torch.Tensor:
    """The kernels on CUDA bf16, f16 or f32 (B, T, H, d) q, k, v with d in
    HEAD_DIMS and an optional (B, T) bool key mask -> (B, T, H, d) in q's
    dtype; differentiable
    through the dK/dV and dQ kernels. Raises on any other input: it never
    runs the plain version."""
    _check(q, k, v, key_mask)
    mask_u8 = mask_bytes(key_mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, mask_u8)
    return flash_forward_cuda(q, k, v, mask_u8, save_stats=False)[0]


def fused_self_attention(q, k, v, use_flash: bool | None = None, key_mask=None) -> torch.Tensor:
    """Self-attention on (B, T, H, d) q, k, v with an optional (B, T) bool
    key mask (False = not attended) -> (B, T, H, d) in q's dtype.

    use_flash=None decides by `flash_rule`: the kernels for a CUDA q at T >=
    FLASH_MIN_TOKENS, the plain branch in q's dtype for every other q; True
    takes the kernels (raising for a CPU tensor), False the plain branch."""
    if use_flash is None:
        use_flash = flash_rule(q.device.type, q.shape[1])
    if use_flash:
        return flash_attention_cuda(q, k, v, key_mask)
    return flash_attention_reference(q, k, v, key_mask)
