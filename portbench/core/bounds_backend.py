"""The back end's roofline arithmetic: the bytes and f64 operations of one
block-tridiagonal solve of the relaxation's odometry chain (K diagonal
6x6 blocks, K - 1 off-diagonal ones, r right-hand-side columns), counted
from the work whatever implements it, and the least time they take at
the card's peaks (core/bounds.PEAKS for the bytes; f64 outside the tensor
cores at NVIDIA's H100 SXM data sheet rate).

Bytes: D, Boff and the right-hand sides read once, the solution written
once. Operations: block Thomas, the least a direct solve of the chain
does: a row's 6x6 work (the Schur block D_i - B^T C, 468; its inverse by
Cholesky, 432; C_i = S^-1 B_i, 432) and a column's at each row (the
forward step B^T W, the difference and S^-1, 150; the back substitution
W - C Y, 78). The extra operations of a parallel elimination (cyclic
reduction's) are the implementation's, not the work's, and are not
counted. The solve counted is the program's fixed-shape one: K is the
back end's capacity and r its loop capacity's columns, live or not (the
loop cell's 40 s drive fills ~78 of 2,048 nodes), so the roofline rates
the solve the program runs, not the least work of the live graph."""
from __future__ import annotations

from .bounds import peak

F64_OPS_PER_S = 34e12
ROW_OPS = 468 + 432 + 432
COLUMN_OPS = 150 + 78


def tridiag_bytes(K, r):
    return 8 * (36 * K + 36 * (K - 1) + 2 * 6 * K * r)


def tridiag_ops(K, r):
    return K * (ROW_OPS + COLUMN_OPS * r)


def columns(loop_capacity):
    """The relaxation's right-hand sides: b and the 6 L columns of U."""
    return 1 + 6 * loop_capacity


def tridiag_ms(K, r, kind):
    """The least time (ms) of one solve, and which of bytes and operations
    sets it."""
    t_bytes = tridiag_bytes(K, r) / peak(kind)["bytes_per_s"] * 1e3
    t_ops = tridiag_ops(K, r) / F64_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
