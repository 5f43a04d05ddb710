"""Parity of the port's spline, point-uncertainty algebra, spline deskew and
IMU undistortion with the JAX package.

* spline.feed_trajectory / get_pose_batch and the uncertainty compounding
  in f64 at atol 1e-12;
* the plain deskew (ops/deskew.py) in f32 at N = 777 points per LiDAR
  against the Pallas kernel run in interpret mode (atol 2e-5: rotation
  matrices there, quaternions here, as tests/test_pallas_deskew.py) and
  against the JAX jnp path (atol 1e-5: the same quaternion arithmetic in
  another f32 operation order); ok flags equal in both;
* propagate.undistort from a carried-across carry in f64 at atol 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from malio_tpu import pipeline as jpipe
from malio_tpu import propagate as jprop
from malio_tpu import runner as jrunner
from malio_tpu import spline as jspl
from malio_tpu import uncertainty as junc
from malio_tpu.geometry import se3 as jse3, so3 as jso3
from malio_tpu.ops.deskew_pallas import deskew_points as jdeskew_pallas

from malio_tpu_torch import interop, tree
from malio_tpu_torch import propagate as tprop
from malio_tpu_torch import spline as tspl
from malio_tpu_torch import uncertainty as tunc
from malio_tpu_torch.ops import deskew as tdeskew

import test_torch_pipeline as tp

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _trajectory(rng, T, dtype):
    """Timestamped poses along a smooth screw motion, jittered times, the
    last few entries invalid (the history's padding)."""
    xi = np.array([0.2, -0.1, 0.3, 1.0, 0.5, -0.2])
    ts = np.sort(rng.uniform(0.0, 0.004 * T, T)) + np.arange(T) * 0.004
    Ts = jse3.exp_se3(jnp.asarray(ts[:, None] * xi[None]))
    q = np.asarray(jso3.mat_to_quat(Ts[:, :3, :3]))
    p = np.asarray(Ts[:, :3, 3])
    valid = np.ones(T, bool)
    valid[-3:] = False
    return ts.astype(dtype), q.astype(dtype), p.astype(dtype), valid


def test_spline_matches_jax():
    rng = np.random.default_rng(11)
    ts, q, p, valid = _trajectory(rng, 40, np.float64)
    jsp = jspl.feed_trajectory(*map(jnp.asarray, (ts, q, p, valid)), cap=32)
    tsp = tspl.feed_trajectory(*map(_t, (ts, q, p, valid)), cap=32)
    for f in jspl.Spline._fields:
        np.testing.assert_allclose(getattr(tsp, f).numpy(), np.asarray(getattr(jsp, f)),
                                   atol=1e-12, rtol=0, err_msg=f)
    # query times inside, outside and exactly on the control grid
    tq = np.concatenate([rng.uniform(ts[0] - 0.02, ts[-1] + 0.02, 200),
                         ts[0] + 0.01 * np.arange(35)])
    for a, b, name in zip(tspl.get_pose_batch(tsp, _t(tq)),
                          jspl.get_pose_batch(jsp, jnp.asarray(tq)), ("q", "p", "ok")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12, rtol=0, err_msg=name)


def _pose_pair(rng, shape):
    q = rng.normal(size=shape + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(size=shape + (3,))
    A = rng.normal(size=shape + (6, 6)) * 0.1
    cov = A @ np.swapaxes(A, -1, -2)
    return (junc.Pose(jnp.asarray(q), jnp.asarray(t), jnp.asarray(cov)),
            tunc.Pose(_t(q), _t(t), _t(cov)))


def test_uncertainty_compounding_matches_jax():
    rng = np.random.default_rng(12)
    j1, t1 = _pose_pair(rng, (3, 5))
    j2, t2 = _pose_pair(rng, (3, 5))
    for jf, tf in ((junc.compound_pose, tunc.compound_pose),
                   (junc.compound_inv_pose, tunc.compound_inv_pose)):
        want = jax.vmap(jax.vmap(jf))(j1, j2)
        got = tf(t1, t2)
        for f in ("q", "t", "cov"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       atol=1e-12, rtol=0, err_msg=f"{jf.__name__}.{f}")
    pts = rng.normal(size=(15, 3)) * 10
    jtr = jax.vmap(junc.point_uncertainty_trace)(
        jnp.asarray(pts), jax.tree_util.tree_map(lambda a: a.reshape((15,) + a.shape[2:]), j1))
    ttr = tunc.point_uncertainty_trace(
        _t(pts), tunc.Pose(*(a.reshape((15,) + a.shape[2:]) for a in t1)))
    np.testing.assert_allclose(ttr.numpy(), np.asarray(jtr), atol=1e-12, rtol=0)


def _deskew_case(L, N, seed):
    """The spline of tests/test_pallas_deskew.py in f32 and L LiDARs of N
    points with their own extrinsic and scan-end poses."""
    rng = np.random.default_rng(seed)
    xi = jnp.asarray([0.2, -0.1, 0.3, 1.0, 0.5, -0.2], jnp.float32)
    ts = jnp.arange(40, dtype=jnp.float32) * 0.01
    Ts = jse3.exp_se3(ts[:, None] * xi[None])
    jsp = jspl.feed_trajectory(ts, jso3.mat_to_quat(Ts[:, :3, :3]), Ts[:, :3, 3],
                               jnp.ones(40, bool), cap=64)
    pts = np.concatenate([rng.normal(size=(L, N, 3)) * 5,
                          rng.uniform(-0.05, 0.45, size=(L, N, 1))], -1).astype(np.float32)
    small = lambda s: (rng.normal(size=(L, 3)) * s).astype(np.float32)
    ext_q = np.asarray(jso3.exp_so3(jnp.asarray(small(0.2))))
    lt_q = np.asarray(jso3.exp_so3(jnp.asarray(small(0.1))))
    return jsp, pts, ext_q, small(0.3), lt_q, small(0.5)


def test_plain_deskew_matches_pallas_interpret_and_jnp():
    L, N = 3, 777  # N off the Pallas block size exercises its padding
    jsp, pts, ext_q, ext_t, lt_q, lt_t = _deskew_case(L, N, seed=5)
    tsp = tspl.Spline(*(_t(a) for a in jsp))
    got = tdeskew.deskew_points_plain(_t(pts), tsp, _t(ext_q), _t(ext_t), _t(lt_q), _t(lt_t))
    got = got.numpy()
    assert 0 < got[..., 3].sum() < L * N  # points inside and outside the window
    for l in range(L):
        pk = np.asarray(jdeskew_pallas(
            jnp.asarray(pts[l]), jsp.cps[:, :3, :3], jsp.cps[:, :3, 3], jsp.logs, jsp.t0,
            jsp.num_valid, jspl.CONTROL_DT, jso3.quat_to_mat(jnp.asarray(ext_q[l])),
            jnp.asarray(ext_t[l]), jso3.quat_to_mat(jnp.asarray(lt_q[l])), jnp.asarray(lt_t[l]),
            interpret=True,
        ))
        np.testing.assert_array_equal(got[l, :, 3], pk[:, 3])
        np.testing.assert_allclose(got[l, :, :3], pk[:, :3], atol=2e-5, rtol=0)

        # the JAX eager path (propagate.py:378-394) for one LiDAR
        pq, pp, pok = jspl.get_pose_batch(jsp, jnp.asarray(pts[l, :, 3]))
        eq, lq = jnp.asarray(ext_q[l]), jnp.asarray(lt_q[l])
        pw = jso3.quat_rotate(pq, jso3.quat_rotate(eq[None], jnp.asarray(pts[l, :, :3]))
                              + ext_t[l][None])
        in_lt = jso3.quat_rotate_inv(jnp.broadcast_to(lq[None], pq.shape), pw + (pp - lt_t[l]))
        ref = jso3.quat_rotate_inv(jnp.broadcast_to(eq[None], pq.shape), in_lt - ext_t[l])
        ref = np.where(np.asarray(pok)[:, None], np.asarray(ref), pts[l, :, :3])
        np.testing.assert_array_equal(got[l, :, 3] > 0.5, np.asarray(pok))
        np.testing.assert_allclose(got[l, :, :3], ref, atol=1e-5, rtol=0)


def test_deskew_wrapper_runs_plain_version_on_cpu_tensors():
    jsp, pts, ext_q, ext_t, lt_q, lt_t = _deskew_case(2, 64, seed=6)
    tsp = tspl.Spline(*(_t(a) for a in jsp))
    args = (_t(pts), tsp, _t(ext_q), _t(ext_t), _t(lt_q), _t(lt_t))
    before = tdeskew.deskew_points.launches
    assert torch.equal(tdeskew.deskew_points(*args), tdeskew.deskew_points_plain(*args))
    assert tdeskew.deskew_points.launches == before


def _close_tree(t, j, path=""):
    """Nested dicts of arrays, key for key."""
    if isinstance(j, dict):
        assert set(t) == set(j), path
        for f in j:
            _close_tree(t[f], j[f], f"{path}.{f}")
        return
    np.testing.assert_allclose(t, j, atol=1e-9, rtol=0, err_msg=path)


def test_undistort_matches_jax():
    """Two JAX rounds fill the pose history; the third round's undistort
    then runs on both sides from the carried-across carry."""
    cfg = tp._city_small()
    tcfg = tp.port_config(cfg)
    groups = tp._groups(cfg)
    jc, start = tp._jax_init(cfg, groups)
    gdev, _ = jrunner._stack_chunk(groups[start : start + 3], np.float64,
                                   jrunner.group_base(groups[start]))
    for k in range(2):
        jc, _ = jpipe.step(cfg, jc, jax.tree_util.tree_map(lambda a: a[k], gdev))
    jg = jax.tree_util.tree_map(lambda a: a[2], gdev)
    args = ("x", "P", "hist")
    rest = ("Q", "last_in", "last_imu", "last_end_t", "mean_acc_norm")
    want = jax.jit(jprop.undistort, static_argnums=0)(
        cfg, *(getattr(jc, f) for f in args), jg, *(getattr(jc, f) for f in rest))
    tc = interop.carry_from_numpy(tp.flat(jc), "cpu")
    tg = interop.group_from_numpy(tp.flat(jg), "cpu")
    one = tree.unsqueeze((*(getattr(tc, f) for f in args), tg, *(getattr(tc, f) for f in rest)))
    got = tree.squeeze(tprop.undistort(tcfg, *one))  # a batch of one
    assert int(np.asarray(want.hist.n)) > 8  # a real history behind the spline
    _close_tree(interop.to_numpy(got), tp.flat(want))
