"""Parity of the port's back end with the JAX package at f64 on the CPU:
the pose graph's edge system, the dense and the structured solver on the
48-node scene of tests/test_posegraph.py (atol 1e-9), point-to-plane ICP
and the coarse-to-fine loop edge on its loop scenario (atol 1e-8), the
plane-BA window cost and its gradient (rtol 1e-10) and the BA solve (poses
atol 1e-8), PoseGraphBackend fed the same stub StepOutputs (same edges,
loop and feedback counts, trajectory atol 1e-8, the second half from a
store carried across by interop), its decimation (the loop edge on
adjacent kept nodes included), and WindowSmoother's trajectory."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from malio_tpu import ba as jba
from malio_tpu import posegraph as jpg
from malio_tpu import smoother as jsm
from malio_tpu.geometry import so3 as jso3

from malio_tpu_torch import ba as tba
from malio_tpu_torch import interop
from malio_tpu_torch import posegraph as tpg
from malio_tpu_torch import smoother as tsm
from malio_tpu_torch.segment import segment_sum

from test_ba import make_window
from test_posegraph import _loop_scenario, _yaw_quat

torch.set_num_threads(1)
F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _edges(items, cap):
    """(i, j, zq, zt, w) items padded to cap, as JAX and port EdgeSets."""
    i = np.zeros(cap, np.int32)
    j = np.zeros(cap, np.int32)
    zq = np.tile([1.0, 0, 0, 0], (cap, 1))
    zt = np.zeros((cap, 3))
    w = np.zeros(cap)
    m = np.zeros(cap, bool)
    for e, (ei, ej, q_, t_, we) in enumerate(items):
        i[e], j[e], zq[e], zt[e], w[e], m[e] = ei, ej, q_, t_, we, True
    d = dict(i=i, j=j, zq=zq, zt=zt, w=w, mask=m)
    return jpg.EdgeSet(**{k: jnp.asarray(v) for k, v in d.items()}), interop.edges_from_numpy(d, "cpu")


def test_segment_sum_is_the_sequential_scatter_add():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(500, 3, 3))
    ids = rng.integers(0, 40, 500)
    want = np.asarray(jnp.zeros((45, 3, 3)).at[jnp.asarray(ids)].add(jnp.asarray(v)))
    np.testing.assert_array_equal(segment_sum(_t(v), _t(ids), 45).numpy(), want)


def test_edge_system_matches_jax():
    rng = np.random.default_rng(17)
    K, E = 6, 8
    q = np.stack([_yaw_quat(0.3 * k) for k in range(K)])
    q[2] = np.array([0.9, 0.2, -0.3, 0.1]) / np.linalg.norm([0.9, 0.2, -0.3, 0.1])
    t = rng.normal(size=(K, 3))
    i = [0, 1, 2, 3, 4, 0, 1, 0]
    j = [1, 2, 3, 4, 5, 2, 3, 5]
    items = [(i[e], j[e], _yaw_quat(rng.uniform(-1, 1)), rng.normal(size=3), rng.uniform(0.5, 2))
             for e in range(E - 1)]
    je, te = _edges(items, E)
    H, b, c = jpg.edge_system(jnp.asarray(q), jnp.asarray(t), je)
    Ht, bt, ct = tpg.edge_system(_t(q), _t(t), te)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(H), rtol=0, atol=1e-9)
    np.testing.assert_allclose(bt.numpy(), np.asarray(b), rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(ct), float(c), rtol=1e-12)


def _scene48():
    """tests/test_posegraph.py::test_optimize_sparse_matches_dense_small."""
    rng = np.random.default_rng(0)
    K, n = 48, 32
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    t_gt = np.stack([5 * np.cos(th), 5 * np.sin(th), 0.1 * np.sin(3 * th)], -1)
    q_gt = np.stack([np.cos(th / 2), np.zeros(n), np.zeros(n), np.sin(th / 2)], -1)
    t_est = np.zeros((K, 3))
    q_est = np.tile([1.0, 0, 0, 0], (K, 1))
    t_est[:n] = t_gt + np.cumsum(rng.normal(size=(n, 3)) * 0.02, axis=0)
    q_est[:n] = q_gt

    def rel(i, j):
        zq, zt = jpg.relative_pose(*(jnp.asarray(a) for a in (q_gt[i], t_gt[i], q_gt[j], t_gt[j])))
        return np.asarray(zq), np.asarray(zt)

    odo = [(i, i + 1, *rel(i, i + 1), 1.0) for i in range(n - 1)]
    loops = [(i, j, *rel(i, j), 3.0) for (i, j) in [(0, n // 2), (3, n - 2), (1, n // 3)]]
    return K, n, q_est, t_est, odo, loops


@pytest.mark.parametrize("solver", ["dense", "sparse"])
def test_solvers_match_jax_on_the_48_node_scene(solver):
    K, n, q, t, odo, loops = _scene48()
    if solver == "dense":
        je, te = _edges(odo + loops, K + 8)
        want = jpg.optimize(jnp.asarray(q), jnp.asarray(t), je, iters=10)
        got = tpg.optimize(_t(q), _t(t), te, iters=10)
    else:
        (jo, to), (jl, tl) = _edges(odo, K - 1), _edges(loops, 8)
        want = jpg.optimize_sparse(jnp.asarray(q), jnp.asarray(t), jo, jl, iters=10)
        got = tpg.optimize_sparse(_t(q), _t(t), to, tl, iters=10)
        dense = tpg.optimize(_t(q), _t(t), _edges(odo + loops, K + 8)[1], iters=10)
        np.testing.assert_allclose(got[1][:n].numpy(), dense[1][:n].numpy(), atol=1e-6)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-12)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6, atol=1e-12)
    assert float(got[2]) < 1e-3 * float(got[3])


def test_icp_and_refine_loop_edge_match_jax():
    sc = _loop_scenario(K=4)
    qi, ti = sc["gt_q"][0], sc["gt_t"][0]
    qj, tj = sc["gt_q"][2], sc["gt_t"][2]
    qj_bad = np.asarray(jso3.boxplus(jnp.asarray(qj), jnp.asarray([0.0, 0.0, 0.03])))
    tj_bad = tj + np.array([0.15, -0.1, 0.05])
    P = sc["clouds"].shape[1]
    m = np.ones(P, bool)
    m[::11] = False
    ci, cj = sc["clouds"][0], sc["clouds"][2]
    zq0, zt0 = (np.asarray(a) for a in jpg.relative_pose(*(jnp.asarray(a) for a in
                                                          (qi, ti, qj_bad, tj_bad))))
    want = jpg.icp_point_to_plane(jnp.asarray(ci), jnp.asarray(m), jnp.asarray(cj),
                                  jnp.asarray(m), jnp.asarray(zq0), jnp.asarray(zt0),
                                  cell_size=1.5, iters=6)
    got = tpg.icp_point_to_plane(_t(ci), _t(m), _t(cj), _t(m), _t(zq0), _t(zt0),
                                 cell_size=1.5, iters=6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-8)
    args = (qi, ti, ci, m, qj_bad, tj_bad, cj, m)
    want = jpg.refine_loop_edge(*(jnp.asarray(a) for a in args), cell_size=1.5, iters=6)
    got = tpg.refine_loop_edge(*(_t(a) for a in args), cell_size=1.5, iters=6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-8)
    assert float(got[2]) > 0.3


def _perturbed_window(seed=11):
    (win,) = make_window(W=4, P=400, noise=0.002)
    r = np.random.default_rng(seed)
    d = np.concatenate([r.normal(size=(4, 3)) * 0.02, r.normal(size=(4, 3)) * 0.05], -1)
    d[0] = 0
    jwin = win._replace(q=jax.vmap(jso3.boxplus)(win.q, jnp.asarray(d[:, :3])),
                        t=win.t + jnp.asarray(d[:, 3:]))
    return jwin, interop.window_from_numpy({f: np.asarray(v) for f, v in jwin._asdict().items()},
                                          "cpu")


def test_window_cost_value_and_gradient_match_jax():
    jwin, twin = _perturbed_window()
    dx = np.random.default_rng(2).normal(size=(4, 6)) * 0.01
    dx[0] = 0
    cs = 2.0
    jf = lambda d: jba._window_cost(d, jwin, jnp.asarray(cs), 8192, 8)
    tf = lambda d: tba._window_cost(d, twin, torch.tensor(cs, dtype=F64), 8192, 8)
    np.testing.assert_allclose(float(tf(_t(dx))), float(jf(jnp.asarray(dx))), rtol=1e-10)
    np.testing.assert_allclose(torch.func.grad(tf)(_t(dx)).numpy(),
                               np.asarray(jax.grad(jf)(jnp.asarray(dx))), rtol=1e-10, atol=1e-12)
    assert float(tf(_t(dx))) > 0


def test_optimize_window_matches_jax():
    jwin, twin = _perturbed_window(seed=12)
    jw, jc1, jc0 = jba.optimize_window(jwin, cell_size=2.0, num_cells=8192, min_pts=8, iters=3)
    tw, tc1, tc0 = tba.optimize_window(twin, cell_size=2.0, num_cells=8192, min_pts=8, iters=3)
    np.testing.assert_allclose(tw.q.numpy(), np.asarray(jw.q), rtol=0, atol=1e-8)
    np.testing.assert_allclose(tw.t.numpy(), np.asarray(jw.t), rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(tc0), float(jc0), rtol=1e-10)
    np.testing.assert_allclose(float(tc1), float(jc1), rtol=1e-8)
    assert float(tc1) < float(tc0)


def _stub_outs(sc, k0=0, k1=None):
    P = sc["clouds"].shape[1]
    for k in range(k0, sc["od_q"].shape[0] if k1 is None else k1):
        yield types.SimpleNamespace(pos=sc["od_t"][k], quat=sc["od_q"][k], kf_pts=sc["clouds"][k],
                                    kf_mask=np.ones(P, bool), end_time=float(k))


def _same_graph(t, j):
    assert (t.count, t.n_loop_edges, t.n_feedback, t.keyframe_every) == (
        j.count, j.n_loop_edges, j.n_feedback, j.keyframe_every)
    assert [(e[0], e[1], e[5]) for e in t.edges] == [(e[0], e[1], e[5]) for e in j.edges]
    for a, b in zip(t.edges, j.edges):
        np.testing.assert_allclose(a[2], b[2], atol=1e-8)
        np.testing.assert_allclose(a[3], b[3], atol=1e-8)
        np.testing.assert_allclose(a[4], b[4], rtol=1e-6)
    for a, b in zip(t.trajectory(), j.trajectory()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)


def test_backend_matches_jax_on_stub_outputs():
    """The drifted loop of tests/test_posegraph.py with feedback on: the
    JAX backend takes the first 16 keyframes, its store is carried into
    the port's by interop, and both take the rest."""
    sc = _loop_scenario(K=24, P=1200, drift_rot=0.008, drift_trans=0.07)
    kw = dict(capacity=32, loop_capacity=16, keyframe_every=1, cloud_points=1200,
              loop_radius=3.0, min_time_gap=5.0, cell_size=1.5, feedback=True, relax_iters=6)
    jb = jpg.PoseGraphBackend(**kw)
    tb = tpg.PoseGraphBackend(**kw, device="cpu")
    for o in _stub_outs(sc, 0, 16):
        jb.observe(o)
    interop.store_from_numpy(tb, {f: getattr(jb, f) for f in interop._STORES["PoseGraphBackend"]},
                             "cpu")
    _same_graph(tb, jb)
    corr = {}
    for o in _stub_outs(sc, 16):
        for name, b in (("jax", jb), ("port", tb)):
            b.observe(o)
            c = b.take_correction()
            if c is not None:
                corr.setdefault(name, []).append(c)
    assert tb.n_loop_edges >= 1 and tb.n_feedback >= 1
    _same_graph(tb, jb)
    assert len(corr["port"]) == len(corr["jax"])
    for (a, b), (c, d) in zip(corr["port"], corr["jax"]):
        np.testing.assert_allclose(a, c, atol=1e-8)
        np.testing.assert_allclose(b, d, atol=1e-8)


def test_decimation_matches_jax():
    """Capacity decimation, then the hand-placed loop edge that lands on
    adjacent kept nodes (tests/test_posegraph.py:828) through two more."""
    kw = dict(capacity=16, loop_capacity=8, keyframe_every=1, cloud_points=8, feedback=False)
    jb, tb = jpg.PoseGraphBackend(**kw), tpg.PoseGraphBackend(**kw, device="cpu")
    rng = np.random.default_rng(0)
    for k in range(22):
        o = types.SimpleNamespace(quat=_yaw_quat(0.05 * k), pos=np.array([0.5 * k, 0.1 * k, 0.0]),
                                  kf_pts=rng.normal(size=(8, 3)), kf_mask=np.ones(8, bool),
                                  end_time=float(k))
        jb.observe(o)
        tb.observe(o)
    assert tb.keyframe_every == 2
    _same_graph(tb, jb)
    for b in (jb, tb):
        b.edges.append((2, 4, np.array([1.0, 0, 0, 0]), np.array([1.02, 0.0, 0.0]), 0.7, "loop"))
        b._decimate()
        b._decimate()
    loops = [e for e in tb.edges if e[5] == "loop"]
    assert len(loops) == 1 and (loops[0][0], loops[0][1]) == (0, 1)
    _same_graph(tb, jb)


def test_window_smoother_matches_jax():
    sc = _loop_scenario(K=10, P=300, drift_rot=0.004, drift_trans=0.03, seed=9)
    kw = dict(window_size=4, keyframe_every=1, optimize_every=2, max_points=320, cell_size=1.5,
              num_cells=4096, iters=2)
    js = jsm.WindowSmoother(**kw, dtype=jnp.float64)
    ts = tsm.WindowSmoother(**kw, dtype=F64, device="cpu")
    for o in _stub_outs(sc):
        js.observe(o)
        ts.observe(o)
    want, got = js.trajectory(), ts.trajectory()
    assert len(got[0]) >= 6
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)
