"""Batched SVD of small f32 matrices: the CUDA kernel and its plain version.

The pose path's one SVD entry (`geometry/pnp.py`, `rotations.kabsch`), in
place of `jnp.linalg.svd` in the reference (an XLA call there, not a Pallas
kernel). `torch.linalg.svd` on a CUDA tensor waits for the device (it checks
convergence on the host), and the serve tick must not, so a CUDA tensor goes
to `csrc/small_svd.cu` (one-sided Jacobi in rounds of disjoint column pairs,
a lane a row, 32 / W matrices a warp; its source note says what bounds it)
and a CPU tensor to `torch.linalg.svd`. A shape the kernel does not take
raises on the card; it never falls back.

Singular vectors are defined up to sign, so the kernel and the plain version
agree on the singular values, on |<v, v'>| of each right singular vector
(where its singular value is simple) and on anything sign-free built from
them (A = U S Vh, the rotation U D Vh of a 3 x 3 matrix).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mvropose_torch.ops._build import current_stream, device_context, load_library

MAX_ROWS, MAX_COLS = 32, 16  # at most a warp a matrix: a lane a row

# Kernel launches made through `small_svd_cuda`.
launches = 0


def small_svd_reference(a: torch.Tensor, compute_u: bool = False):
    """Plain version: (U or None, S, Vh) of (..., m, n) matrices, S (..., min(m, n))
    descending, Vh (..., n, n) (the full right basis, as `jnp.linalg.svd(a,
    full_matrices=True)` gives it), U (..., m, m) where asked for."""
    U, S, Vh = torch.linalg.svd(a, full_matrices=True)
    return (U if compute_u else None), S, Vh


@functools.cache
def _kernel():
    fn = load_library().small_svd_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def small_svd_cuda(a: torch.Tensor, compute_u: bool = False):
    """Launch the kernel on (..., m, n) f32 CUDA matrices, m <= 32, n <= 16 ->
    (U or None, S, Vh) as `small_svd_reference`; U only for 3 x 3 input.
    One launch for the whole batch, on the current stream."""
    global launches
    if a.device.type != "cuda":
        raise ValueError(f"small_svd_cuda needs a CUDA tensor, got {a.device}")
    if a.dtype != torch.float32 or a.dim() < 2:
        raise ValueError(f"expected (..., m, n) f32 matrices, got {tuple(a.shape)} {a.dtype}")
    *lead, m, n = a.shape
    if not (1 <= m <= MAX_ROWS and 1 <= n <= MAX_COLS):
        raise ValueError(f"small_svd_cuda takes m <= {MAX_ROWS} rows and n <= {MAX_COLS} "
                         f"columns, got ({m}, {n})")
    if compute_u and (m, n) != (3, 3):
        raise ValueError(f"small_svd_cuda computes U for 3 x 3 input only, got ({m}, {n})")
    rows = a.contiguous().reshape(-1, m, n)
    batch = rows.shape[0]
    S = torch.empty((batch, min(m, n)), dtype=torch.float32, device=a.device)
    Vh = torch.empty((batch, n, n), dtype=torch.float32, device=a.device)
    U = torch.empty((batch, 3, 3), dtype=torch.float32, device=a.device) if compute_u else None
    if batch:
        dev = rows.get_device()
        with device_context(dev):
            err = _kernel()(rows.data_ptr(), S.data_ptr(), Vh.data_ptr(),
                            U.data_ptr() if compute_u else None, batch, m, n, current_stream(dev))
        if err != 0:
            raise RuntimeError(f"small_svd_f32 launch failed with CUDA error {err}")
        launches += 1
    return ((U.reshape(*lead, 3, 3) if compute_u else None), S.reshape(*lead, min(m, n)),
            Vh.reshape(*lead, n, n))


def small_svd(a: torch.Tensor, compute_u: bool = False):
    """(U or None, S, Vh) of small matrices (..., m, n): the kernel for a CUDA
    tensor, `torch.linalg.svd` for a CPU tensor."""
    if a.device.type == "cpu":
        return small_svd_reference(a, compute_u)
    return small_svd_cuda(a, compute_u)
