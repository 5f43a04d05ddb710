"""The round with no host read inside it, which the compiled round (a CUDA
graph on the card, malio_tpu_torch/graph.py) captures, against the JAX
package on the CPU:

* a steady round of a batch that mixes sequences with and without a map
  makes no operation that reads a device value on the host or makes a
  tensor from host data, and matches jax.vmap(step) (pos/quat 1e-8, P
  1e-10, counts equal);
* the voxel downsample's and segment_sum's segment counts by a scatter of
  ones (no bincount) match JAX (f64, 1e-12);
* knn_cached searching every escalation at the budget gives the
  selections of JAX's two-tier search, with escalation counts below, at
  and above its 256 tier (eager JAX bit for bit, jitted nn_d2 to 2 ulp);
* update_iterated at max_iter + 1 iterations with done sequences frozen
  matches jax.vmap of the JAX while_loop for a batch whose sequences stop
  after different iteration counts, one of them on the direct inverse
  (1e-9); the all-false re-search tensor gives the bits of `False`;
* the closed-form 3x3 eigenvalues against jnp.linalg.eigvalsh;
* run_sequence's output with one host copy a chunk equals the
  round-by-round path's, and launch counts added for graph replays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from malio_tpu import pipeline as jpipe
from malio_tpu import preprocess as jpre
from malio_tpu import state as jst
from malio_tpu.config import Config as JConfig
from malio_tpu.filter import esekf as jesekf
from malio_tpu.map import voxel_hash as jvh

from malio_tpu_torch import interop, ops, tree
from malio_tpu_torch import measurement as tmeas
from malio_tpu_torch import pipeline as tpipe
from malio_tpu_torch import preprocess as tpre
from malio_tpu_torch import runner as trunner
from malio_tpu_torch import state as tst
from malio_tpu_torch.filter import esekf as tesekf
from malio_tpu_torch.io.assemble import assemble_groups
from malio_tpu_torch.io.synthetic import SyntheticSequence
from malio_tpu_torch.linalg import eigvalsh3
from malio_tpu_torch.map import voxel_hash as tvh
from malio_tpu_torch.segment import segment_sum

import test_torch_batched as tb
import test_torch_filter as tf
import test_torch_knn as tkn
import test_torch_pipeline as tp
from host_reads import HostReads

torch.set_num_threads(1)


def test_host_reads_sees_what_it_looks_for():
    x = torch.arange(5.0)
    with HostReads() as h:
        bool(x.any())
        x[x > 2]
        torch.tensor(1.0)
        torch.bincount(x.long())
        torch.where(x > 1, x, 0.5)
    assert [n for n, _ in h.seen] == ["aten::_local_scalar_dense", "aten::index",
                                      "aten::lift_fresh", "aten::bincount"]


def test_steady_mixed_round_reads_nothing_on_the_host_and_matches_jax_vmap():
    """Sequence 0 starts (no map), sequence 1 has taken a round: the
    update runs for both and is kept for 1 only, with no host read."""
    cfg = tp._city_small()
    tcfg = tp.port_config(cfg)
    carries, chunks = tb._sequences(cfg, 2)
    c1, _ = jpipe.step(cfg, carries[1], jax.tree_util.tree_map(lambda a: a[0], chunks[1]))
    jc = tb._jstack([carries[0], c1])
    jg = tb._jstack([jax.tree_util.tree_map(lambda a: a[i], g)
                     for i, g in zip((0, 1), chunks[:2])])
    assert np.asarray(jc.map_init).tolist() == [False, True]
    tc = interop.carry_from_numpy(tp.flat(jc), "cpu")
    tg = interop.group_from_numpy(tp.flat(jg), "cpu")
    tpipe.step_eager(tcfg, tc, tg, device="cpu")  # the first round makes cached constants
    with HostReads() as h:
        tc2, to = tpipe.step(tcfg, tc, tg, device="cpu")
    assert h.seen == []
    jc2, jo = jax.jit(jax.vmap(lambda c, g: jpipe.step(cfg, c, g)))(jc, jg)
    for b in range(2):
        np.testing.assert_allclose(to.pos[b].numpy(), np.asarray(jo.pos[b]), atol=1e-8)
        np.testing.assert_allclose(to.quat[b].numpy(), np.asarray(jo.quat[b]), atol=1e-8)
        np.testing.assert_allclose(tc2.P[b].numpy(), np.asarray(jc2.P[b]), atol=1e-10)
    for f in ("map_size", "n_effective", "iterations", "nn_miss"):
        np.testing.assert_array_equal(getattr(to, f).numpy(), np.asarray(getattr(jo, f)), err_msg=f)
    assert to.iterations.tolist()[0] == 0 < to.iterations.tolist()[1]


def test_voxel_downsample_counts_without_bincount_match_jax():
    """Two sequences of three LiDARs in one call, caps that overflow into
    the dump segment and groups with no valid point; then valid points
    planted in the cell whose hash is the JAX package's masked key
    (0xFFFFFFFF), so there they share the masked slots' segment: in a
    group with masked slots, in one with no valid point besides them and
    in one with no masked slot."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-4, 4, size=(2, 3, 300, 3))
    aux = rng.uniform(0, 5, size=(2, 3, 300, 1))
    mask = rng.uniform(size=(2, 3, 300)) < 0.8
    mask[1, 2] = False
    planted = pts.copy(), mask.copy()
    cell = np.asarray([1195, 544, 0])  # spatial hash 0xFFFFFFFF
    for (b, lid, slot, n) in ((0, 0, 7, 3), (1, 2, 290, 2), (0, 2, 100, 4)):
        planted[0][b, lid, slot:slot + n] = (cell + np.linspace(0.1, 0.8, n)[:, None]) * 0.9
        planted[1][b, lid, slot:slot + n] = True
    planted[1][0, 2] = True
    assert int(tpre.spatial_hash(torch.as_tensor(cell))) == tpre.MASK32
    for pts, mask in ((pts, mask), planted):
        args = [torch.as_tensor(a) for a in (pts, aux, mask)]
        for cap in (40, 300):
            with HostReads() as h:
                got = tpre.voxel_downsample(*args, 0.9, cap)
            assert h.seen == []
            for b in range(2):
                for lid in range(3):
                    want = jpre.voxel_downsample(jnp.asarray(pts[b, lid]),
                                                 jnp.asarray(aux[b, lid]),
                                                 jnp.asarray(mask[b, lid]), 0.9, cap)
                    for g, w in zip(got, want):
                        np.testing.assert_allclose(g[b, lid].numpy(), np.asarray(w), atol=1e-12)


def test_segment_sum_counts_without_bincount_match_jax():
    """Ids that leave segments empty, the last ones included."""
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 30, size=500)
    ids[ids == 7] = 8
    vals = rng.normal(size=(500, 3))
    tv, ti = torch.as_tensor(vals), torch.as_tensor(ids)
    with HostReads() as h:
        got = segment_sum(tv, ti, 41)
    assert h.seen == []
    want = jnp.zeros((41, 3)).at[jnp.asarray(ids)].add(jnp.asarray(vals))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)
    assert (got[30:].numpy() == 0).all() and (got[7].numpy() == 0).all()


def _escalations(n_far):
    """Queries of tkn._map_and_queries(7, n_far) that miss the base window."""
    _, tm, qs, qmask = tkn._map_and_queries(7, n_far)
    return int(tvh.knn_cached(tm, torch.as_tensor(qs), qmask=torch.as_tensor(qmask),
                              radius=1, cache_k=16)[4])


@pytest.mark.parametrize("escalations", [100, 256, 290])
def test_knn_cached_at_the_budget_matches_jax_tiers(escalations):
    """wide_budget 300: JAX searches 100 and 256 escalations in its 256
    tier and 290 at the budget; the port searches every one at the
    budget and selects what JAX selects."""
    n_far = escalations - _escalations(3) + 3  # the last 3 queries are masked off
    assert _escalations(n_far) == escalations
    jm, tm, qs, qmask = tkn._map_and_queries(7, n_far)
    kw = dict(radius=1, wide_radius=3, wide_budget=300, cache_k=16)
    names = ["nn_pts", "nn_covs", "nn_d2", "nn_cnt", "n_miss", "cache_pts", "cache_covs",
             "cache_valid"]
    got = tvh.knn_cached(tm, torch.as_tensor(qs), qmask=torch.as_tensor(qmask), **kw)
    with jax.disable_jit():
        eager = jvh.knn_cached(jm, jnp.asarray(qs), qmask=jnp.asarray(qmask), **kw)
    jitted = jvh.knn_cached(jm, jnp.asarray(qs), qmask=jnp.asarray(qmask), **kw)
    for nm, a, b, c in zip(names, got, eager, jitted):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=nm)
        if nm == "nn_d2":
            np.testing.assert_array_max_ulp(a.numpy(), np.asarray(c), maxulp=2)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(c), err_msg=nm)


@pytest.fixture(scope="module")
def scenario():
    import test_oracle_parity as top

    return top._h_share_scenario(M=72, seed=13, spread=2.0)


def test_update_iterated_fixed_iterations_matches_jax_while_loop(scenario):
    """Sequence 0 starts at a converged posterior with its inverse (the
    Newton-Schulz path, done early); sequence 1 starts perturbed with no
    inverse (the direct inverse, more iterations)."""
    sc = scenario
    cfg = sc["cfg"]
    tcfg, tmap, tsd, tx = tf._port_scenario(sc)
    L = tf.L
    n = jst.dof(L)
    dx0 = np.zeros(n)
    dx0[:3] = [0.04, -0.03, 0.02]
    dx0[3:6] = [2e-4, -1.5e-4, 1e-4]
    rng = np.random.default_rng(29)
    A = rng.normal(size=(n, n)) * 0.01
    P0 = A @ A.T + np.eye(n) * 5e-3
    kw = dict(max_iter=cfg.max_iteration, limit=cfg.converge_limit)
    first = jesekf.update_iterated(jst.boxplus(sc["x"], jnp.asarray(dx0)), jnp.asarray(P0),
                                   sc["h_share"], sc["cache0"], **kw)
    xs = tb._jstack([first.x, jst.boxplus(sc["x"], jnp.asarray(dx0))])
    Ps = jnp.stack([first.P, jnp.asarray(P0)])
    Pis = jnp.stack([first.Pi, jnp.zeros((n, n))])
    want = jax.vmap(lambda x, P, Pi: jesekf.update_iterated(
        x, P, sc["h_share"], sc["cache0"], Pi0=Pi, **kw))(xs, Ps, Pis)

    t_h, t_cache0 = tmeas.make_h_share(tcfg, *(tree.stack([tree.squeeze(a)] * 2)
                                             for a in (tmap, tsd, tx)))
    tx2 = interop.state_from_numpy(tp.flat(xs), "cpu")
    got = tesekf.update_iterated(tx2, torch.as_tensor(np.asarray(Ps)), t_h, t_cache0,
                                 Pi0=torch.as_tensor(np.asarray(Pis)), **kw)
    its = got.iterations.tolist()
    assert its == np.asarray(want.iterations).tolist()
    assert its[0] < its[1] <= cfg.max_iteration
    assert got.valid.tolist() == [True, True]
    for f, a in zip(tst.State._fields, got.x):
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(want.x, f)), atol=1e-9, err_msg=f)
    np.testing.assert_allclose(got.P.numpy(), np.asarray(want.P), atol=1e-9)
    np.testing.assert_allclose(got.Pi.numpy(), np.asarray(want.Pi), atol=1e-9)


def test_all_false_search_tensor_gives_the_bits_of_false(scenario):
    tcfg, tmap, tsd, tx = tf._port_scenario(scenario)
    t_h, cache0 = tmeas.make_h_share(tcfg, tmap, tsd, tx)
    moved = tst.boxplus(tx, torch.full((1, tst.dof(tf.L)), 1e-3, dtype=torch.float64))
    a = t_h(moved, False, cache0)
    b = t_h(moved, torch.zeros(1, dtype=torch.bool), cache0)
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert torch.equal(x, y) or torch.equal(torch.isnan(x), torch.isnan(y))
    c = t_h(moved, torch.ones(1, dtype=torch.bool), cache0)  # a re-search that moves the fit
    assert not torch.equal(a[1].searched, c[1].searched) or not torch.equal(a[0].h, c[0].h)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 2e-6)])
def test_eigvalsh3_matches_jax(dtype, tol):
    rng = np.random.default_rng(6)
    X = rng.normal(size=(400, 30, 3)) * rng.uniform(0.01, 10, size=(400, 1, 3))
    A = np.einsum("bki,bkj->bij", X, X)
    A[0] = np.eye(3) * 2.0  # a triple eigenvalue
    A[1] = np.diag([1e-6, 1.0, 1.0])  # a double one and a near-null one
    A[2] = 0.0
    A[3] = np.outer([1.0, 2.0, 3.0], [1.0, 2.0, 3.0])  # rank one
    A = A.astype(dtype)
    got = eigvalsh3(torch.as_tensor(A)).numpy()
    want = np.asarray(jnp.linalg.eigvalsh(jnp.asarray(A)))
    scale = np.abs(want).max(-1, keepdims=True) + 1e-30
    assert got.dtype == A.dtype
    np.testing.assert_array_less(np.abs(got - want) / scale, tol)
    assert (np.diff(got, axis=-1) >= 0).all()


def test_run_sequence_copies_a_chunk_to_the_host_once():
    """The scan path (chunks of 3, one host copy a field a chunk) gives
    the round-by-round path's arrays (a callback forces it)."""
    kw = tp._golden_cfg()
    kw.update(max_raw_points=256, max_points_per_scan=256)
    cfg = tp.port_config(JConfig(**kw))
    seq = SyntheticSequence(duration=1.4, num_lidars=1, points_per_scan=256,
                            ext_t=np.array([[0.2, 0.0, 0.0]]), seed=42)
    imu, rounds, _ = seq.generate()
    groups = assemble_groups(cfg, imu, rounds)
    chunked = trunner.run_sequence(cfg, groups, dtype=torch.float64, device="cpu",
                                   prefetch_chunk=3)
    rounds_ = trunner.run_sequence(cfg, groups, dtype=torch.float64, device="cpu",
                                   prefetch_chunk=3, callback=lambda *a: None)
    assert len(chunked["t"]) >= 6
    for k in ("t", "pos", "quat", "pose_cov", "iterations", "n_effective", "map_size",
              "map_dropped", "nn_miss", "n_meas_dropped"):
        np.testing.assert_array_equal(chunked[k], rounds_[k], err_msg=k)
        assert chunked[k].dtype == rounds_[k].dtype, k


def test_replays_add_the_captured_launches():
    ops.reset_launches()
    ops.add_launches({"knn_window": {(9984, 8, 16): 1, (1024, 208, 16): 4},
                      "merge_rows": {(1 << 16, 9984): 1},
                      "imu_propagate": {(1, 127): 1, (1, 64): 1, (1, 15): 1}}, 3)
    w = ops.wrappers()
    assert w["knn_window"].launches == 15
    assert w["knn_window"].launches_by_shape == {(9984, 8, 16): 3, (1024, 208, 16): 12}
    assert w["merge_rows"].launches == 3 and w["deskew"].launches == 0
    assert w["imu_propagate"].launches == 9
    assert w["imu_propagate"].launches_by_shape == {(1, 127): 3, (1, 64): 3, (1, 15): 3}
    ops.reset_launches()
    assert w["imu_propagate"].launches == 0 and w["imu_propagate"].launches_by_shape == {}
