"""Matrix products of the filter's covariance algebra over a batch of
sequences.

On the CPU, MKL's gemm result depends on where an operand sits in memory
(its alignment picks the kernel's peel loop), so a sequence's product
would change with its place in the batch. There `mm` multiplies each
sequence's slab on its own freshly allocated (aligned) copy, and a
sequence of a batch gets the bits it gets alone. On the card it is one
cuBLAS call for the whole batch. `eigvalsh3` is the localization weight's
3x3 eigen-solve.
"""
from __future__ import annotations

import math

import torch


def mm(a, b):
    """a @ b with leading batch axes, the first of them the sequence."""
    if a.device.type != "cpu" or (a.dim() < 3 and b.dim() < 3):
        return a @ b
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a = a.expand(*lead, *a.shape[-2:])
    b = b.expand(*lead, *b.shape[-2:])
    return torch.stack([x.clone() @ y.clone() for x, y in zip(a, b)])


def eigvalsh3(A):
    """Eigenvalues, ascending, of symmetric 3x3 matrices (..., 3, 3) read
    from the lower triangle, as torch.linalg.eigvalsh reads them: the
    trigonometric solution of the characteristic cubic, in f64, returned
    in A's dtype. It runs as elementwise device work; torch.linalg.eigvalsh
    reads its solver's status on the host on the card, which stalls the
    round and cannot be captured in a CUDA graph."""
    a = A.to(torch.float64)
    a00, a11, a22 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    a01, a02, a12 = a[..., 1, 0], a[..., 2, 0], a[..., 2, 1]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p = torch.sqrt((b00 * b00 + b11 * b11 + b22 * b22
                    + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0)
    safe = torch.where(p > 0.0, p, torch.ones_like(p))
    det = (b00 * (b11 * b22 - a12 * a12) - a01 * (a01 * b22 - a12 * a02)
           + a02 * (a01 * a12 - b11 * a02))
    phi = torch.acos(torch.clamp(det / (2.0 * safe * safe * safe), -1.0, 1.0)) / 3.0
    hi = q + 2.0 * p * torch.cos(phi)
    lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    out = torch.stack([lo, torch.clamp(3.0 * q - hi - lo, lo, hi), hi], dim=-1)
    return out.to(A.dtype)
