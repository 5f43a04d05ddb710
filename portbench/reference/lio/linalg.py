"""Matrix products of the filter's covariance algebra over a batch of
sequences.

On the CPU, MKL's gemm result depends on where an operand sits in memory
(its alignment picks the kernel's peel loop), so a sequence's product
would change with its place in the batch. There `mm` multiplies each
sequence's slab on its own freshly allocated (aligned) copy, and a
sequence of a batch gets the bits it gets alone. On the card it is one
cuBLAS call for the whole batch. `eigvalsh3` is the localization weight's
3x3 eigen-solve; `eigh3` adds the eigenvector of the smallest eigenvalue
(the back end's plane normals).
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
    return _eigvalsh3_f64(A.to(torch.float64))[0].to(A.dtype)


def _eigvalsh3_f64(a):
    """eigvalsh3 in f64, with the shift q and scale p of its normalised
    matrix (a - q I) / p (p = 1 where a = q I) and the angle phi whose
    2 cos(phi + 2 pi / 3) is that matrix's smallest eigenvalue."""
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
    return out, q, safe, phi


def _largest(vs):
    """Of the vectors vs (..., k, 3), the one of the largest norm, and its
    squared norm."""
    n2 = torch.sum(vs * vs, dim=-1)
    i = torch.argmax(n2, dim=-1, keepdim=True)
    return (torch.take_along_dim(vs, i[..., None], dim=-2)[..., 0, :],
            torch.take_along_dim(n2, i, dim=-1)[..., 0])


def _unit(x):
    return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def _quad(u, a, v):
    """u^T a v over the leading axes."""
    return torch.sum(u * torch.sum(a * v[..., None, :], dim=-1), dim=-1)


def eigh3(A):
    """Eigenvalues, ascending, of symmetric 3x3 matrices (..., 3, 3) read
    from the lower triangle, and the unit eigenvector of the smallest, in
    closed form, in f64, returned in A's dtype: device work only, as
    eigvalsh3 (torch.linalg.eigh reads its solver's status on the host on
    the card). The vector's sign is arbitrary (LAPACK's may differ).

    The vector v: the largest cross product of two rows of M = B - b0 I,
    with B = (A - q I) / p eigvalsh3's normalised matrix and b0 its
    smallest eigenvalue; for a simple eigenvalue the rows span the other
    two eigenvectors. Where b0 is double, M is of rank one (up to b0's
    round-off) and every unit vector orthogonal to its largest row is an
    eigenvector; where it is triple (A a multiple of I, or 0) M is -b0 I
    and the first case holds again. M is never 0 (B is traceless and
    b0 <= -1), so every finite input gives a finite unit vector.

    The eigenvalues: v^T A v, and the two of A on the plane orthogonal to
    v (a 2x2 problem, solved stably). They hold to round-off of A's scale
    also on double spectra, where the trigonometric solution loses half
    its digits (the cosine's argument comes from an acos near +-1), and
    so decide the planarity gates as LAPACK does."""
    a = A.to(torch.float64)
    a = torch.tril(a) + torch.tril(a, -1).transpose(-1, -2)
    _, q, p, phi = _eigvalsh3_f64(a)
    b0 = 2.0 * torch.cos(phi + 2.0 * math.pi / 3.0)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    m = (a - q[..., None, None] * eye) / p[..., None, None] - b0[..., None, None] * eye
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    v, v2 = _largest(torch.stack([torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                                 torch.linalg.cross(r1, r2)], dim=-2))
    row, _ = _largest(m)
    # M's entries are O(1); under 1e-10 a cross product is round-off of a
    # rank-one M: take the largest row crossed with the axis it leans on least
    v = _unit(torch.where((v2 > 1e-20)[..., None], v, torch.linalg.cross(row, _least_axis(row))))
    e1 = _unit(torch.linalg.cross(v, _least_axis(v)))
    e2 = torch.linalg.cross(v, e1)
    m11, m22, m12 = _quad(e1, a, e1), _quad(e2, a, e2), _quad(e1, a, e2)
    mean = 0.5 * (m11 + m22)
    rad = torch.sqrt(0.25 * (m11 - m22) * (m11 - m22) + m12 * m12)
    w, _ = torch.sort(torch.stack([_quad(v, a, v), mean - rad, mean + rad], dim=-1), dim=-1)
    return w.to(A.dtype), v.to(A.dtype)


def _least_axis(x):
    """The unit axis along which x (..., 3) has its smallest component."""
    return (torch.arange(3, device=x.device)
            == torch.argmin(x.abs(), dim=-1, keepdim=True)).to(x.dtype)
