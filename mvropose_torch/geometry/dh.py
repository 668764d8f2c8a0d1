"""Denavit-Hartenberg transforms (standard and Craig's modified).

Port of `mvropose_tpu/geometry/dh.py`. Both take (a, d, alpha, theta) with
alpha and theta in radians, as tensors that broadcast together, and return
(..., 4, 4) homogeneous transforms.
"""

from __future__ import annotations

import torch


def _matrix(rows) -> torch.Tensor:
    entries = torch.broadcast_tensors(*(e for row in rows for e in row))
    return torch.stack(entries, -1).unflatten(-1, (4, 4))


def standard_dh_matrix(a, d, alpha, theta) -> torch.Tensor:
    """Standard DH: Rz(theta) Tz(d) Tx(a) Rx(alpha)."""
    ct, st, ca, sa = torch.cos(theta), torch.sin(theta), torch.cos(alpha), torch.sin(alpha)
    zero, one = torch.zeros_like(ct), torch.ones_like(ct)
    return _matrix([
        [ct, -st * ca, st * sa, a * ct],
        [st, ct * ca, -ct * sa, a * st],
        [zero, sa, ca, d * one],
        [zero, zero, zero, one],
    ])


def modified_dh_matrix(a, d, alpha, theta) -> torch.Tensor:
    """Craig's modified DH: Rx(alpha) Tx(a) Rz(theta) Tz(d)."""
    ct, st, ca, sa = torch.cos(theta), torch.sin(theta), torch.cos(alpha), torch.sin(alpha)
    zero, one = torch.zeros_like(ct), torch.ones_like(ct)
    return _matrix([
        [ct, -st, zero, a * one],
        [st * ca, ct * ca, -sa, -d * sa],
        [st * sa, ct * sa, ca, d * ca],
        [zero, zero, zero, one],
    ])
