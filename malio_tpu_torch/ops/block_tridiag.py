"""Block-tridiagonal SPD solve: the CUDA kernel `csrc/block_tridiag.cu`
(block cyclic reduction) and its plain PyTorch version (block Thomas).
Not a port of a TPU kernel: it stands for the two lax.scans of the JAX
package's posegraph._block_tridiag_solve (malio_tpu/posegraph.py:243,
:251), the odometry chain's exact solve inside `posegraph.optimize_sparse`.

`block_tridiag_solve(D, Boff, RHS)` gives Y with T Y = RHS: D (K, 6, 6)
the diagonal blocks, Boff (K-1, 6, 6) with T[i, i+1] = Boff[i], RHS
(K, 6, r). CPU tensors run the plain version; f64 CUDA tensors launch the
kernel; any other CUDA dtype raises. There is no other fallback. The two
compute the same Y in different orders of elimination, so they agree to
round-off, not bit for bit: the plain version is the reference's K-step
recursion, the kernel eliminates odd rows level by level (ceil(log2 K)
levels down, one row solved, the levels back up: `device_launches`
launches a call). tests/test_torch_block_tridiag.py rehearses the
kernel's order on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, count_launch


def _chol6(A):
    """Inverse of a 6x6 SPD block by an unrolled Cholesky (rank-1
    downdates, pivot floored at 1e-30) and forward substitution, as the
    JAX package keeps it unrolled."""
    n = 6
    idx = torch.arange(n, device=A.device)
    L = torch.zeros_like(A)
    M = A
    for j in range(n):
        piv = torch.sqrt(torch.clamp(M[j, j], min=1e-30))
        col = torch.where(idx >= j, M[:, j] / piv, torch.zeros_like(piv))
        L[:, j] = col
        M = M - col[:, None] * col[None, :]
    I = torch.eye(n, dtype=A.dtype, device=A.device)
    V = torch.zeros_like(L)
    for i in range(n):
        V[i] = (I[i] - L[i] @ V) / L[i, i]
    return V.T @ V


def block_tridiag_solve_plain(D, Boff, RHS):
    """Solve the block-tridiagonal SPD system T Y = RHS by block Thomas:
    D (K, 6, 6) diagonal blocks, Boff (K-1, 6, 6) with T[i, i+1] = Boff[i],
    RHS (K, 6, r). A forward elimination and a back substitution, each K
    sequential 6x6 steps (the reference's two lax.scans)."""
    K = D.shape[0]
    zero = torch.zeros_like(D[:1])
    B_prev = torch.cat([zero, Boff])  # row i's predecessor block
    B_cur = torch.cat([Boff, zero])
    C = torch.zeros_like(D[0])
    W = torch.zeros((6, RHS.shape[-1]), dtype=D.dtype, device=D.device)
    Cs, Ws = [], []
    for i in range(K):
        S = D[i] - B_prev[i].T @ C
        Sinv = _chol6(0.5 * (S + S.T))
        C = Sinv @ B_cur[i]
        W = Sinv @ (RHS[i] - B_prev[i].T @ W)
        Cs.append(C)
        Ws.append(W)
    Y = torch.zeros_like(W)
    Ys = [None] * K
    for i in range(K - 1, -1, -1):
        Y = Ws[i] - Cs[i] @ Y
        Ys[i] = Y
    return torch.stack(Ys)


_loaded = None


def _lib():
    global _loaded
    if _loaded is None:
        lib = _build.load("block_tridiag")
        lib.block_tridiag_launch.restype = ctypes.c_int
        lib.block_tridiag_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        lib.block_tridiag_scratch.restype = ctypes.c_int64
        lib.block_tridiag_scratch.argtypes = [ctypes.c_int]
        _loaded = lib
    return _loaded


def device_launches(K: int, r: int) -> int:
    """Device launches of one kernel call on K rows and r columns: a
    launch a level down and up, and one for the last row; none for r = 0."""
    return 2 * (K - 1).bit_length() + 1 if r > 0 else 0


def block_tridiag_solve(D, Boff, RHS):
    """Same contract as `block_tridiag_solve_plain`. CUDA tensors launch
    the kernel, which takes contiguous f64 D (K, 6, 6), Boff (K-1, 6, 6)
    and RHS (K, 6, r) on one card: `device_launches(K, r)` launches on the
    current stream, counted here as one call."""
    args = (D, Boff, RHS)
    if all(t.device.type == "cpu" for t in args):
        return block_tridiag_solve_plain(D, Boff, RHS)
    dev = D.device
    if dev.type != "cuda" or any(t.device != dev for t in args):
        raise ValueError(f"block_tridiag_solve: tensors must lie on one CUDA device, got "
                         f"{[str(t.device) for t in args]}")
    if any(t.dtype != torch.float64 for t in args):
        raise ValueError(f"block_tridiag_solve: the kernel takes f64, got "
                         f"{[t.dtype for t in args]}")
    K, r = D.shape[0], RHS.shape[-1]
    if (tuple(D.shape) != (K, 6, 6) or tuple(Boff.shape) != (K - 1, 6, 6)
            or tuple(RHS.shape) != (K, 6, r) or K < 1):
        raise ValueError(f"block_tridiag_solve: D (K, 6, 6), Boff (K-1, 6, 6), RHS (K, 6, r), "
                         f"got {tuple(D.shape)}, {tuple(Boff.shape)}, {tuple(RHS.shape)}")
    D, Boff, RHS = (t.contiguous() for t in args)
    lib = _lib()
    Y = torch.empty_like(RHS)
    scratch = torch.empty(int(lib.block_tridiag_scratch(K)), dtype=torch.float64, device=dev)
    err = lib.block_tridiag_launch(D.data_ptr(), Boff.data_ptr(), RHS.data_ptr(), Y.data_ptr(),
                                   scratch.data_ptr(), K, r,
                                   torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "block_tridiag_launch")
    count_launch(_counted, (K, r))
    return Y


block_tridiag_solve.launches = 0
block_tridiag_solve.launches_by_shape = {}  # (steps K, columns r) -> launches
block_tridiag_solve.captured = {}  # the same, recorded into CUDA graphs
# the counts stay on the wrapper when a caller rebinds the module's name (a
# recording wrapper around it)
_counted = block_tridiag_solve
