"""The back end's programs as the port compiles them (posegraph's LM
solvers and ICP, ba.optimize_window: one CUDA graph each on the card),
checked on the CPU against the JAX package:

* linalg.eigh3, the closed-form 3x3 eigenpair that replaces
  torch.linalg.eigh in the plane models, against jnp.linalg.eigh in f64
  and f32 on random, planar, double, triple, null and rank-one spectra:
  eigenvalues within eigvalsh3's tolerances (1e-12 / 2e-6 of the largest),
  the smallest one's eigenvector up to sign (1e-10 / 1e-5) where the two
  smallest eigenvalues lie a hundredth of the largest apart, and a finite
  unit eigenvector everywhere;
* the block-tridiagonal solve's plain version (ops/block_tridiag.py, the
  kernel's reference) against the JAX posegraph._block_tridiag_solve at
  K = 64, r = 385 in f64 (atol 1e-12), and the wrapper on CPU tensors;
* each program's eager version (what the card captures) reads nothing on
  the host: the 48-node scene of test_torch_backend.py through the dense
  and the structured solver, its ICP scene through icp_point_to_plane and
  refine_loop_edge, and its BA window through optimize_window.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from malio_tpu import posegraph as jpg

from malio_tpu_torch import ba as tba
from malio_tpu_torch import ops
from malio_tpu_torch import posegraph as tpg
from malio_tpu_torch.linalg import eigh3
from malio_tpu_torch.ops import block_tridiag

import test_torch_backend as tbk
from test_posegraph import _loop_scenario
from test_torch_graph_round import HostReads

torch.set_num_threads(1)


def _spectra(dtype):
    rng = np.random.default_rng(6)
    X = rng.normal(size=(400, 30, 3)) * rng.uniform(0.01, 10, size=(400, 1, 3))
    A = np.einsum("bki,bkj->bij", X, X)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    A[0] = np.eye(3) * 2.0  # triple
    A[1] = np.diag([1e-6, 1.0, 1.0])  # double largest, near-null smallest
    A[2] = 0.0  # null
    A[3] = np.outer([1.0, 2.0, 3.0], [1.0, 2.0, 3.0])  # rank one: double smallest
    A[4] = R @ np.diag([2.0, 2.0, 5.0]) @ R.T  # double smallest, rotated
    A[5] = R @ np.diag([0.0, 1.0, 1.0]) @ R.T  # an isotropic plane
    A[6] = np.diag([1e-12, 1e-12, 1.0])  # a line, as a plane model regularises it
    P = rng.normal(size=(40, 3)) * [3.0, 1.0, 0.002]  # planar points with noise
    A[7] = (P - P.mean(0)).T @ (P - P.mean(0)) / 40
    return A.astype(dtype)


@pytest.mark.parametrize("dtype,tol,vec_tol", [(np.float64, 1e-12, 1e-10),
                                               (np.float32, 2e-6, 1e-5)])
def test_eigh3_matches_jax(dtype, tol, vec_tol):
    A = _spectra(dtype)
    w, v = (t.numpy() for t in eigh3(torch.as_tensor(A)))
    jw, jv = (np.asarray(t) for t in jnp.linalg.eigh(jnp.asarray(A)))
    assert w.dtype == v.dtype == A.dtype
    scale = np.abs(jw).max(-1, keepdims=True) + 1e-30
    np.testing.assert_array_less(np.abs(w - jw) / scale, tol)
    assert (np.diff(w, axis=-1) >= 0).all()
    assert np.isfinite(v).all()
    np.testing.assert_allclose(np.linalg.norm(v.astype(np.float64), axis=-1), 1.0,
                               atol=10 * np.finfo(dtype).eps)
    # an eigenvector of the smallest eigenvalue everywhere, degenerate or not
    A64, v64 = A.astype(np.float64), v.astype(np.float64)
    res = np.einsum("bij,bj->bi", A64, v64) - jw[:, :1].astype(np.float64) * v64
    np.testing.assert_array_less(np.abs(res).max(-1) / scale[:, 0], 10 * vec_tol)
    apart = (jw[:, 1] - jw[:, 0]) / scale[:, 0] > 1e-2
    assert apart.sum() > 300 and apart[[1, 5, 7]].all()
    d = np.minimum(np.abs(v - jv[:, :, 0]).max(-1), np.abs(v + jv[:, :, 0]).max(-1))
    np.testing.assert_array_less(d[apart], vec_tol)


def _tridiag(K, r, seed=4):
    """An SPD block-tridiagonal system of the shape optimize_sparse builds:
    diagonal blocks of the chain's Hessians plus damping, one node pinned
    by the 1e8 gauge prior."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(K, 6, 6))
    D = np.einsum("kab,kcb->kac", G, G) + 6.0 * np.eye(6)
    D[0] += 1e8 * np.eye(6)
    Boff = -0.4 * rng.normal(size=(K - 1, 6, 6))
    return D, Boff, rng.normal(size=(K, 6, r))


def _dense(D, Boff):
    K = D.shape[0]
    T = np.zeros((K, 6, K, 6))
    for i in range(K):
        T[i, :, i] = D[i]
    for i in range(K - 1):
        T[i, :, i + 1] = Boff[i]
        T[i + 1, :, i] = Boff[i].T
    return T.reshape(6 * K, 6 * K)


def test_block_tridiag_plain_matches_jax():
    D, Boff, RHS = _tridiag(64, 385)
    want = np.asarray(jpg._block_tridiag_solve(*(jnp.asarray(a) for a in (D, Boff, RHS))))
    got = block_tridiag.block_tridiag_solve_plain(*(torch.as_tensor(a) for a in (D, Boff, RHS)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    T = _dense(D, Boff)
    res = T @ got.numpy().reshape(6 * 64, 385) - RHS.reshape(6 * 64, 385)
    assert np.abs(res).max() < 1e-8 * np.abs(RHS).max()
    # the wrapper and the solver's call take the plain version on the CPU,
    # and count no launch
    ops.reset_launches()
    args = [torch.as_tensor(a) for a in (D[:48], Boff[:47], RHS[:48, :, :7])]
    assert torch.equal(block_tridiag.block_tridiag_solve(*args),
                       block_tridiag.block_tridiag_solve_plain(*args))
    assert torch.equal(tpg._block_tridiag_solve(*args),
                       block_tridiag.block_tridiag_solve_plain(*args))
    assert ops.wrappers()["block_tridiag"].launches == 0


def _no_host_read(fn, *args, **kw):
    with HostReads() as h:
        out = fn(*args, **kw)
    assert h.seen == [], h.seen
    return out


@pytest.mark.parametrize("solver", ["dense", "sparse"])
def test_lm_solvers_read_nothing_on_the_host(solver):
    K, n, q, t, odo, loops = tbk._scene48()
    q, t = tbk._t(q), tbk._t(t)
    if solver == "dense":
        edges = tbk._edges(odo + loops, K + 8)[1]
        got = _no_host_read(tpg.optimize_eager, q, t, edges, iters=4)
        want = tpg.optimize(q, t, edges, iters=4)
    else:
        odo_e, loop_e = tbk._edges(odo, K - 1)[1], tbk._edges(loops, 8)[1]
        got = _no_host_read(tpg.optimize_sparse_eager, q, t, odo_e, loop_e, iters=4)
        want = tpg.optimize_sparse(q, t, odo_e, loop_e, iters=4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float(got[2]) < float(got[3])


def test_icp_and_refine_loop_edge_read_nothing_on_the_host():
    sc = _loop_scenario(K=4)
    P = sc["clouds"].shape[1]
    m = np.ones(P, bool)
    m[::11] = False
    ci, cj = (tbk._t(np.array(c)) for c in (sc["clouds"][0], sc["clouds"][2]))
    mt = tbk._t(m)
    qi, ti, qj, tj = (tbk._t(np.array(a)) for a in (sc["gt_q"][0], sc["gt_t"][0], sc["gt_q"][2],
                                                    sc["gt_t"][2] + [0.15, -0.1, 0.05]))
    zq0, zt0 = tpg.relative_pose(qi, ti, qj, tj)
    got = _no_host_read(tpg.icp_point_to_plane_eager, ci, mt, cj, mt, zq0, zt0, cell_size=1.5,
                        iters=4)
    for a, b in zip(got, tpg.icp_point_to_plane(ci, mt, cj, mt, zq0, zt0, cell_size=1.5,
                                                iters=4)):
        assert torch.equal(a, b)
    got = _no_host_read(tpg.refine_loop_edge_eager, qi, ti, ci, mt, qj, tj, cj, mt,
                        cell_size=1.5, iters=4)
    for a, b in zip(got, tpg.refine_loop_edge(qi, ti, ci, mt, qj, tj, cj, mt, cell_size=1.5,
                                              iters=4)):
        assert torch.equal(a, b)
    assert float(got[2]) > 0.3


def test_optimize_window_reads_nothing_on_the_host():
    _, twin = tbk._perturbed_window(seed=12)
    got = _no_host_read(tba.optimize_window_eager, twin, cell_size=2.0, num_cells=8192,
                        min_pts=8, iters=2)
    want = tba.optimize_window(twin, cell_size=2.0, num_cells=8192, min_pts=8, iters=2)
    for a, b in zip(got[0] + got[1:], want[0] + want[1:]):
        assert torch.equal(a, b)
    assert float(got[1]) < float(got[2])
