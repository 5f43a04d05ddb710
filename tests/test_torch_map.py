"""Parity of the rest of the port's voxel-hash map with the JAX package:
the rigid re-hash `transform` (tables equal, points within 1e-12 at f64),
`lookup`, `flatten` / `extract_points`, `_masked_take` and the box and
radius searches (exact, overflow past max_results included), and `knn`
with its budgeted wide escalation against the jitted and the op-by-op JAX
function (equal selections; nn_d2 within the 2 ulp that XLA:CPU's fused
multiply-adds move it under jit, ROADMAP §4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from malio_tpu.map import voxel_hash as jvh

from malio_tpu_torch.map import voxel_hash as tvh

torch.set_num_threads(1)


def _maps(dtype, capacity=1 << 12, n=900, seed=0, spread=8.0):
    """The same inserts into a JAX and a port map: two batches, the second
    re-offering some voxels, a few rows overflowing at small capacity."""
    rng = np.random.default_rng(seed)
    np_dt = np.float32 if dtype == "f32" else np.float64
    jm = jvh.create(capacity, 0.5, jnp.float32 if dtype == "f32" else jnp.float64)
    tm = tvh.create(capacity, 0.5, torch.float32 if dtype == "f32" else torch.float64, "cpu")
    for b in range(2):
        pts = rng.uniform(-spread, spread, size=(n, 3)).astype(np_dt)
        if b:
            pts[:60] = pts_prev[:60] + 0.01
        covs = rng.uniform(0.001, 0.2, size=n).astype(np_dt)
        mask = rng.uniform(size=n) < 0.92
        jm = jvh.insert(jm, jnp.asarray(pts), jnp.asarray(covs), jnp.asarray(mask))
        tm = tvh.insert(tm, torch.as_tensor(pts), torch.as_tensor(covs), torch.as_tensor(mask))
        pts_prev = pts
    np.testing.assert_array_equal(tm.tab.numpy(), np.asarray(jm.tab))
    return jm, tm


def _yaw(a):
    return np.array([np.cos(a / 2), 0.0, 0.0, np.sin(a / 2)])


@pytest.mark.parametrize("dq,dt,capacity", [
    (_yaw(0.0), [4.0, -2.5, 1.0], 1 << 12),  # voxel-aligned translation
    (_yaw(0.7), [3.0, -2.0, 1.3], 1 << 12),  # rotation: voxels regroup
    (np.array([0.9, 0.1, -0.3, 0.2]) / np.linalg.norm([0.9, 0.1, -0.3, 0.2]),
     [0.3, 0.1, -0.2], 1 << 9),  # a small table: full rows, drops counted
])
def test_transform_tables_equal_f64(dq, dt, capacity):
    jm, tm = _maps("f64", capacity=capacity, seed=capacity)
    jm = jvh.evict_outside(jm, jnp.asarray([-6.0, -7.0, -8.0]), jnp.asarray([7.0, 6.0, 8.0]))
    tm = tvh.evict_outside(tm, torch.tensor([-6.0, -7.0, -8.0], dtype=torch.float64),
                           torch.tensor([7.0, 6.0, 8.0], dtype=torch.float64))
    j2 = jvh.transform(jm, jnp.asarray(dq), jnp.asarray(dt, jnp.float64))
    t2 = tvh.transform(tm, torch.as_tensor(dq), torch.as_tensor(dt, dtype=torch.float64))
    jt, tt = np.asarray(j2.tab), t2.tab.numpy()
    np.testing.assert_array_equal(tt[..., 0], jt[..., 0])
    np.testing.assert_array_equal(tt[..., 4], jt[..., 4])
    np.testing.assert_allclose(tt[..., 1:4], jt[..., 1:4], rtol=0, atol=1e-12)
    assert int(t2.n_dropped) == int(j2.n_dropped) and int(t2.n_evicted) == int(j2.n_evicted)
    assert int(tvh.size(t2)) == int(jvh.size(j2)) > 0


def test_lookup_exact():
    jm, tm = _maps("f32", seed=1)
    rng = np.random.default_rng(1)
    pts = np.concatenate([np.asarray(jvh.extract_points(jm)[0][:300]),
                          rng.uniform(-9, 9, size=(300, 3)).astype(np.float32)])
    keys = np.floor(pts / np.float32(0.5)).astype(np.int64)
    js, jf = jvh.lookup(jm, jnp.asarray(keys, jnp.int32))
    ts, tf = tvh.lookup(tm, torch.as_tensor(keys))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.asarray(jf)[:300].all() and not np.asarray(jf).all()


def test_flatten_and_extract_points_exact():
    jm, tm = _maps("f32", seed=2)
    for a, b in zip(tvh.flatten(tm), jvh.flatten(jm)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tvh.extract_points(tm), jvh.extract_points(jm)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_results", [16, 512, 4096])
def test_box_radius_and_masked_take_exact(max_results):
    """Below, near and above the match count: overflow returns the first
    matches in slot order and the true total."""
    jm, tm = _maps("f32", seed=3)
    lo, hi = np.array([-3.0, -2.0, -4.0], np.float32), np.array([2.5, 3.0, 1.0], np.float32)
    center, radius = np.array([0.5, -1.0, 0.25], np.float32), np.float32(3.5)
    j_box = jvh.box_search(jm, jnp.asarray(lo), jnp.asarray(hi), max_results=max_results)
    t_box = tvh.box_search(tm, torch.as_tensor(lo), torch.as_tensor(hi), max_results=max_results)
    j_rad = jvh.radius_search(jm, jnp.asarray(center), jnp.asarray(radius), max_results=max_results)
    t_rad = tvh.radius_search(tm, torch.as_tensor(center), torch.as_tensor(radius),
                              max_results=max_results)
    occ = np.asarray(jm.occupied)
    mask = occ & (np.arange(occ.size) % 3 == 0)
    j_take = jvh._masked_take(jm, jnp.asarray(mask), max_results)
    t_take = tvh._masked_take(tm, torch.as_tensor(mask), max_results)
    for t, j in ((t_box, j_box), (t_rad, j_rad), (t_take, j_take)):
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    totals = [int(j_box[3]), int(j_rad[3]), int(j_take[3])]
    if max_results == 16:
        assert min(totals) > 16  # overflow
    if max_results == 4096:
        assert max(totals) < 4096 and not np.asarray(j_box[2]).all()  # padding


@pytest.mark.parametrize("budget,wide_radius,qmask", [(0, 0, False), (8, 3, True),
                                                      (64, 5, False)])
def test_knn_matches_both_jax_paths(budget, wide_radius, qmask):
    """vh.knn at K = 5 with the budgeted wide escalation: bit-equal to the
    op-by-op JAX function; against the jitted one equal selections and
    nn_d2 within 2 ulp."""
    jm, tm = _maps("f32", seed=4)
    rng = np.random.default_rng(4)
    near = np.asarray(jvh.extract_points(jm)[0][:120]) + 0.07
    far = rng.uniform(9, 14, size=(40, 3)).astype(np.float32)  # sparse: they escalate
    qs = np.concatenate([near, far]).astype(np.float32)
    qm = np.ones(qs.shape[0], bool)
    if qmask:
        qm[::7] = False
    kw = dict(k=5, radius=1, wide_radius=wide_radius, wide_budget=budget)
    got = tvh.knn(tm, torch.as_tensor(qs), qmask=torch.as_tensor(qm) if qmask else None, **kw)
    jkw = dict(kw, qmask=jnp.asarray(qm) if qmask else None)
    with jax.disable_jit():
        eager = jvh.knn(jm, jnp.asarray(qs), **jkw)
    jitted = jvh.knn(jm, jnp.asarray(qs), **jkw)
    names = ("nn_pts", "nn_covs", "nn_d2", "nn_cnt", "n_miss")
    for nm, a, b, c in zip(names, got, eager, jitted):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=nm)
        if nm == "nn_d2":
            np.testing.assert_array_max_ulp(a.numpy(), np.asarray(c), maxulp=2)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(c), err_msg=nm)
    if budget:
        assert int(got[4]) < int(tvh.knn(tm, torch.as_tensor(qs), k=5)[4])  # escalation helped
