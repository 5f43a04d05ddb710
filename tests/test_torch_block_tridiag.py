"""The block cyclic reduction of `malio_tpu_torch/csrc/block_tridiag.cu`,
rehearsed on the CPU.

The kernel runs only on a card. This file keeps a plain PyTorch mirror of
its order of elimination (`cyclic_reduction`: a level at a time, each
level's odd rows eliminated into its even rows through the Cholesky
factors of the odd rows' blocks, the last row solved, then the up-sweep
over the levels in reverse), with the kernel's arithmetic: pivots floored
at 1e-30 with their reciprocal square roots on L's diagonal, every D^-1
applied as two triangular solves. It holds the mirror to the JAX
reference `malio_tpu.posegraph._block_tridiag_solve` and to the port's
plain block Thomas (`ops/block_tridiag.block_tridiag_solve_plain`):
column by column within 1e-9 of the reference column's largest entry,
and |T Y - RHS|max within 4x the plain version's. The systems are the
two seeded families the port's tests use, both with the 1e8 gauge prior
on row 0: `_tridiag` of tests/test_torch_backend_compiled.py and
`chip_smoke.tridiag_inputs` (a chain of edge Hessians J^T J, damping 0.1),
rebuilt here in numpy, each seeded with K.

The JAX reference refuses K = 1 (its scan meets a zero-length Boff), so
at K = 1 it solves the decoupled two-row system [[D, 0], [0, I]], whose
first row is the one-row solution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from malio_tpu import posegraph as jpg
from malio_tpu_torch.ops import block_tridiag as bt

KS = [1, 2, 3, 5, 8, 63, 64, 65, 127, 128]
RS = [1, 7, 385]
REL = 1e-9
RESIDUAL_X = 4.0


def backend_family(K, r, seed):
    """tests/test_torch_backend_compiled.py:80-87's system."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(K, 6, 6))
    D = np.einsum("kab,kcb->kac", G, G) + 6.0 * np.eye(6)
    D[0] += 1e8 * np.eye(6)
    Boff = -0.4 * rng.normal(size=(K - 1, 6, 6))
    return D, Boff, rng.normal(size=(K, 6, r))


def chain_family(K, r, seed, damping=0.1):
    """chip_smoke.tridiag_inputs's system: a chain of edge Hessians J^T J
    (random 6 x 12 Jacobians), damping on the diagonal, node 0 pinned."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(K - 1, 6, 12))
    H = np.einsum("eai,eaj->eij", J, J)
    D = np.zeros((K, 6, 6))
    D[:-1] += H[:, :6, :6]
    D[1:] += H[:, 6:, 6:]
    D += damping * np.eye(6)
    D[0] += 1e8 * np.eye(6)
    return D, np.ascontiguousarray(H[:, :6, 6:]), rng.normal(size=(K, 6, r))


FAMILIES = {"backend": backend_family, "chain": chain_family}


# ---- the kernel's order, in plain PyTorch ----


def _chol(A):
    """Cholesky factors of a batch of 6x6 SPD blocks by rank-1 downdates,
    as block_tridiag.cu's chol6_warp: L below the diagonal, the pivot's
    reciprocal square root (floored at 1e-30) on it, zeros above."""
    L = torch.zeros_like(A)
    M = A.clone()
    rows = torch.arange(6)
    for j in range(6):
        ipiv = torch.rsqrt(torch.clamp(M[:, j, j], min=1e-30))
        col = torch.where((rows >= j)[None, :], M[:, :, j] * ipiv[:, None], 0.0)
        M = M - col[:, :, None] * col[:, None, :]
        L[:, :, j] = torch.where((rows > j)[None, :], col, 0.0)
        L[:, j, j] = ipiv
    return L


def _lower(L, X):
    """L^-1 X for a batch (N, 6, c), forward substitution (the kernel's
    lower_solve: x_a = (x_a - sum_k<a L_ak x_k) / pivot)."""
    X = X.clone()
    for a in range(6):
        s = (L[:, a, :a, None] * X[:, :a]).sum(1)
        X[:, a] = (X[:, a] - s) * L[:, a, a, None]
    return X


def _upper(L, X):
    """L^-T X, back substitution (the kernel's upper_solve)."""
    X = X.clone()
    for a in range(5, -1, -1):
        s = (L[:, a + 1:, a, None] * X[:, a + 1:]).sum(1)
        X[:, a] = (X[:, a] - s) * L[:, a, a, None]
    return X


def _sym(A):
    return 0.5 * (A + A.transpose(-1, -2))


def _inverse(L):
    """D^-1 as an explicit matrix, V^T V with V = L^-1 (the plain
    version's _chol6)."""
    V = _lower(L, torch.eye(6, dtype=L.dtype).expand(L.shape[0], 6, 6))
    return V.transpose(-1, -2) @ V


def _solve(L, X, explicit):
    return _inverse(L) @ X if explicit else _upper(L, _lower(L, X))


def cyclic_reduction(D, Boff, RHS, explicit=False):
    """T Y = RHS by block cyclic reduction in the kernel's order. Returns
    (Y, levels): levels is the number of elimination levels, so a solve
    makes 2 levels + 1 device launches. `explicit` applies each D^-1 as
    an explicit inverse, as a first design of the kernel did (and the
    plain version's Sinv does), in place of the triangular solves:
    test_an_explicit_inverse_breaks_the_residual_rule and `sweep` show
    why the kernel does not."""
    Y = RHS.clone()
    saved = []
    Dl, Bl, s, n = D, Boff, 1, D.shape[0]
    T = lambda A: A.transpose(-1, -2)
    while n > 1:
        j = torch.arange(0, n, 2)
        L = _chol(_sym(Dl[1::2]))  # the eliminated rows' factors, row 2k + 1 at k
        left, right = j >= 1, j + 1 < n
        jl, jr = j[left], j[right]
        jb = j[j + 2 < n]
        Rl = torch.zeros(len(j), 6, Y.shape[-1], dtype=D.dtype)
        Rr = torch.zeros_like(Rl)
        Rl[left], Rr[right] = Y[(jl - 1) * s], Y[(jr + 1) * s]
        Wl = torch.zeros(len(j), 6, 6, dtype=D.dtype)
        Wr = torch.zeros_like(Wl)
        if explicit:  # E = B_{j-1}^T D^-1, F = B_j D^-1
            Bl_, Br_ = torch.zeros_like(Wl), torch.zeros_like(Wl)
            Bl_[left], Br_[right] = Bl[jl - 1], T(Bl[jr])
            Wl[left] = T(Bl[jl - 1]) @ _inverse(L[(jl - 1) // 2])
            Wr[right] = Bl[jr] @ _inverse(L[jr // 2])
            Dn = _sym(Dl[j] - Wl @ Bl_ - Wr @ Br_)
            Bn = -(Wr[jb // 2] @ Bl[jb + 1])
            Y[j * s] = (Y[j * s] - Wl @ Rl) - Wr @ Rr
        else:
            Wl[left] = _lower(L[(jl - 1) // 2], Bl[jl - 1])
            Wr[right] = _lower(L[jr // 2], T(Bl[jr]))
            Dn = _sym(Dl[j] - T(Wl) @ Wl - T(Wr) @ Wr)
            Bn = -(T(Wr[jb // 2]) @ _lower(L[jb // 2], Bl[jb + 1]))
            Rl[left] = _lower(L[(jl - 1) // 2], Rl[left])
            Rr[right] = _lower(L[jr // 2], Rr[right])
            Y[j * s] = (Y[j * s] - T(Wl) @ Rl) - T(Wr) @ Rr
        saved.append((Bl, L, s, n))
        Dl, Bl, s, n = Dn, Bn, 2 * s, len(j)
    Y[:1] = _solve(_chol(_sym(Dl)), Y[:1], explicit)
    for Bl, L, s, n in reversed(saved):
        o = torch.arange(1, n, 2)
        yl = Y[(o - 1) * s]
        yr = torch.zeros_like(yl)
        right = o + 1 < n
        yr[right] = Y[(o[right] + 1) * s]
        Br = torch.zeros(len(o), 6, 6, dtype=D.dtype)
        Br[right] = Bl[o[right]]
        v = (Y[o * s] - T(Bl[o - 1]) @ yl) - Br @ yr
        Y[o * s] = _solve(L, v, explicit)
    return Y, len(saved)


# ---- references and rules ----


_jax_solve = jax.jit(jpg._block_tridiag_solve)


def jax_reference(D, Boff, RHS):
    if D.shape[0] == 1:  # the two-row decoupled system (module docstring)
        D = np.concatenate([D, np.eye(6)[None]])
        Boff = np.zeros((1, 6, 6))
        Y = np.asarray(_jax_solve(jnp.asarray(D), jnp.asarray(Boff),
                                  jnp.asarray(np.concatenate([RHS, np.zeros_like(RHS)]))))
        return Y[:1]
    return np.asarray(_jax_solve(*(jnp.asarray(a) for a in (D, Boff, RHS))))


def residual(D, Boff, RHS, Y):
    """max |T Y - RHS|, T applied block by block."""
    TY = D @ Y
    TY[:-1] += Boff @ Y[1:]
    TY[1:] += Boff.transpose(-1, -2) @ Y[:-1]
    return float((TY - RHS).abs().max())


def colwise(Y, ref):
    """Largest column-wise difference over the reference column's largest
    entry."""
    scale = ref.abs().amax(dim=(0, 1)).clamp_min(torch.finfo(ref.dtype).tiny)
    return float(((Y - ref).abs().amax(dim=(0, 1)) / scale).max())


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("r", RS)
@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_cyclic_reduction_matches_thomas(family, K, r):
    D, Boff, RHS = FAMILIES[family](K, r, seed=K)
    args = [torch.as_tensor(a) for a in (D, Boff, RHS)]
    Y, levels = cyclic_reduction(*args)
    assert levels == (K - 1).bit_length()  # ceil(log2 K)
    assert torch.isfinite(Y).all()
    plain = bt.block_tridiag_solve_plain(*args)
    want = torch.as_tensor(np.array(jax_reference(D, Boff, RHS)))
    assert colwise(plain, want) <= REL  # the plain version is the JAX function's counterpart
    assert colwise(Y, want) <= REL, (colwise(Y, want), "against JAX")
    assert colwise(Y, plain) <= REL, (colwise(Y, plain), "against the plain version")
    res, res_plain = residual(*args, Y), residual(*args, plain)
    assert res <= RESIDUAL_X * res_plain, (res, res_plain)


@pytest.mark.parametrize("K,r", [(1, 1), (2, 7), (64, 0), (128, 385)])
def test_device_launches_follow_the_levels(K, r):
    """The wrapper's count of device launches a solve (chip_smoke.py checks
    the card's trace against it): a launch a level each way and the top,
    none for r = 0."""
    D, Boff, RHS = backend_family(K, r, seed=K)
    _, levels = cyclic_reduction(*(torch.as_tensor(a) for a in (D, Boff, RHS)))
    assert bt.device_launches(K, r) == (2 * levels + 1 if r else 0)


def residual_ratio(family, K, r, seed, explicit=False):
    """The mirror's |T Y - RHS|max over the plain version's."""
    args = [torch.as_tensor(a) for a in FAMILIES[family](K, r, seed=seed)]
    Y, _ = cyclic_reduction(*args, explicit=explicit)
    return residual(*args, Y) / residual(*args, bt.block_tridiag_solve_plain(*args))


def test_an_explicit_inverse_breaks_the_residual_rule():
    """Why the kernel applies D^-1 by triangular solves: over 16 seeded
    chain systems of 8 rows (the last row, eliminated at level 0, holds a
    single edge's block), the same reduction with explicit inverses
    leaves a residual past the 4x rule on some, the triangular solves
    stay within it on all."""
    tri = [residual_ratio("chain", 8, 64, seed) for seed in range(16)]
    inv = [residual_ratio("chain", 8, 64, seed, explicit=True) for seed in range(16)]
    assert max(tri) <= RESIDUAL_X, tri
    assert max(inv) > RESIDUAL_X, inv


SWEEP = [(K, 16) for K in (2, 3, 5, 8, 63, 64, 65, 127, 128)] + [(2047, 3), (2048, 3)]


def sweep(r=64):
    """Residual ratios over SWEEP's seeded systems (K with its number of
    seeds, 0, 1, ...) of both families, with triangular solves and with
    explicit inverses: python tests/test_torch_block_tridiag.py"""
    out = {}
    for explicit in (False, True):
        ratios = [residual_ratio(f, K, r, seed, explicit)
                  for f in FAMILIES for K, seeds in SWEEP for seed in range(seeds)]
        out["explicit" if explicit else "triangular"] = dict(
            systems=len(ratios), max=max(ratios), median=float(np.median(ratios)),
            over_1=sum(x > 1 for x in ratios), over_4=sum(x > RESIDUAL_X for x in ratios))
    return out


if __name__ == "__main__":  # from the repo root, with the JAX package importable
    print(sweep())
