"""Parity of the port's batched lockstep round (a leading batch axis B on
every field, malio_tpu_torch.batched) with jax.vmap of the JAX package's
step, and of each sequence of a batch with its own run.

* three f64 rounds of B = 3 City-shaped sequences against
  jax.jit(jax.vmap(malio_tpu.pipeline.step)), per sequence at the
  tolerances of test_three_city_rounds_match_jax (pos/quat 1e-8, P 1e-10,
  map size, effective points, iterations and k-NN misses equal);
* each sequence of a batched run equals its own unbatched run for five
  rounds, map tables bit for bit;
* a batch that mixes sequences with and without a map;
* knn_cached where one sequence escalates past the 256 tier and another
  not; the plain deskew and the map insert over a batch;
* the batched benchmark entry point on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from malio_tpu import pipeline as jpipe
from malio_tpu import runner as jrunner
from malio_tpu import spline as jspl
from malio_tpu.geometry import so3 as jso3
from malio_tpu.map import voxel_hash as jvh

from malio_tpu_torch import batched as tbatched
from malio_tpu_torch import interop, tree
from malio_tpu_torch import pipeline as tpipe
from malio_tpu_torch import spline as tspl
from malio_tpu_torch.map import voxel_hash as tvh
from malio_tpu_torch.ops import deskew as tdeskew

import test_torch_deskew as tdk
import test_torch_knn as tkn
import test_torch_pipeline as tp

torch.set_num_threads(1)
SEEDS = (3, 4, 5)


def _jstack(trees, axis=0):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, axis), *trees)


def _sequences(cfg, rounds):
    """B JAX carries at their first fused round and their next `rounds`
    groups (stacked (rounds, ...) each)."""
    carries, chunks = [], []
    for seed in SEEDS:
        groups = tp._groups(cfg, seed=seed)
        jc, start = tp._jax_init(cfg, groups)
        g, _ = jrunner._stack_chunk(groups[start : start + rounds], np.float64,
                                    jrunner.group_base(groups[start]))
        carries.append(jc)
        chunks.append(g)
    return carries, chunks


def _jvstep(cfg):
    return jax.jit(jax.vmap(lambda c, g: jpipe.step(cfg, c, g)))


def _check_round(k, tc, to, jc, jo):
    for b in range(len(SEEDS)):
        msg = f"round {k} sequence {b}"
        np.testing.assert_allclose(to.pos[b].numpy(), np.asarray(jo.pos[b]), atol=1e-8, err_msg=msg)
        np.testing.assert_allclose(to.quat[b].numpy(), np.asarray(jo.quat[b]), atol=1e-8, err_msg=msg)
        np.testing.assert_allclose(tc.P[b].numpy(), np.asarray(jc.P[b]), atol=1e-10, err_msg=msg)
    for f in ("map_size", "n_effective", "iterations", "nn_miss"):
        np.testing.assert_array_equal(getattr(to, f).numpy(), np.asarray(getattr(jo, f)),
                                      err_msg=f"round {k} {f}")


def test_batched_rounds_match_jax_vmap():
    cfg = tp._city_small()
    tcfg = tp.port_config(cfg)
    carries, chunks = _sequences(cfg, 3)
    jc = _jstack(carries)
    gdev = _jstack(chunks, axis=1)  # (K, B, ...)
    tc = interop.carry_from_numpy(tp.flat(jc), "cpu")
    vstep = _jvstep(cfg)
    for k in range(3):
        jg = jax.tree_util.tree_map(lambda a: a[k], gdev)
        jc, jo = vstep(jc, jg)
        tc, to = tpipe.step(tcfg, tc, interop.group_from_numpy(tp.flat(jg), "cpu"), device="cpu")
        _check_round(k, tc, to, jc, jo)
    assert int(np.asarray(jo.iterations).min()) > 0


def test_each_sequence_equals_its_own_run():
    cfg = tp._city_small()
    tcfg = tp.port_config(cfg)
    carries, chunks = _sequences(cfg, 5)
    tcs = [interop.carry_from_numpy(tp.flat(c), "cpu") for c in carries]
    tgs = [interop.group_from_numpy(tp.flat(g), "cpu") for g in chunks]
    batch_c = tree.stack(tcs)
    batch_g = tree.stack(tgs, 1)
    batch_c, outs = tpipe.scan_steps(tcfg, batch_c, batch_g, device="cpu")
    for b in range(len(SEEDS)):
        c, o = tpipe.scan_steps(tcfg, tcs[b], tgs[b], device="cpu")
        np.testing.assert_allclose(outs.pos[:, b].numpy(), o.pos.numpy(), atol=1e-12, rtol=0)
        np.testing.assert_array_equal(batch_c.map.tab[b].numpy(), c.map.tab.numpy())
        np.testing.assert_array_equal(outs.iterations[:, b].numpy(), o.iterations.numpy())
        np.testing.assert_array_equal(outs.map_size[:, b].numpy(), o.map_size.numpy())


def test_mixed_map_init_matches_jax_vmap():
    """Sequence 0 has taken a round (its map exists), sequences 1 and 2
    start: the update runs for 0 only, the others seed their maps."""
    cfg = tp._city_small()
    tcfg = tp.port_config(cfg)
    carries, chunks = _sequences(cfg, 2)
    c0, _ = jpipe.step(cfg, carries[0], jax.tree_util.tree_map(lambda a: a[0], chunks[0]))
    jc = _jstack([c0, carries[1], carries[2]])
    jg = _jstack([jax.tree_util.tree_map(lambda a: a[i], g)
                  for i, g in zip((1, 0, 0), chunks)])
    assert np.asarray(jc.map_init).tolist() == [True, False, False]
    tc = interop.carry_from_numpy(tp.flat(jc), "cpu")
    jc, jo = _jvstep(cfg)(jc, jg)
    tc, to = tpipe.step(tcfg, tc, interop.group_from_numpy(tp.flat(jg), "cpu"), device="cpu")
    _check_round(0, tc, to, jc, jo)
    assert np.asarray(jo.iterations).tolist()[1:] == [0, 0] and int(jo.iterations[0]) > 0
    np.testing.assert_array_equal(tc.map.tab[1:, ..., 0].numpy(), np.asarray(jc.map.tab[1:, ..., 0]))


def test_knn_cached_batch_mixing_tiers():
    """Sequence 0 escalates 280 queries (the full budget), sequence 1 a
    few (the 256 tier alone would do): each equals its own call, and the
    reference under jax.vmap (nn_d2 within 2 ulp of the jitted reference,
    as in test_torch_knn.py)."""
    kw = dict(radius=1, wide_radius=3, wide_budget=300, cache_k=16)
    cases = [tkn._map_and_queries(7, 280), tkn._map_and_queries(8, 280)]
    qmask1 = cases[1][3].copy()
    qmask1[60:] = False  # sequence 1: 40 near queries and 20 far ones searched
    cases[1] = cases[1][:3] + (qmask1,)
    tm = tree.stack([c[1] for c in cases])
    qs = np.stack([c[2] for c in cases])
    qm = np.stack([c[3] for c in cases])
    jm = _jstack([c[0] for c in cases])
    got = tvh.knn_cached(tm, torch.as_tensor(qs), qmask=torch.as_tensor(qm), **kw)
    want = jax.jit(jax.vmap(lambda m, q, k: jvh.knn_cached(m, q, qmask=k, **kw)))(
        jm, jnp.asarray(qs), jnp.asarray(qm))
    names = ["nn_pts", "nn_covs", "nn_d2", "nn_cnt", "n_miss", "cache_pts", "cache_covs",
             "cache_valid"]
    assert got[4].tolist()[0] > 256 > got[4].tolist()[1]  # n_miss after the wide pass
    for b, (_, m1, q1, k1) in enumerate(cases):
        one = tvh.knn_cached(m1, torch.as_tensor(q1), qmask=torch.as_tensor(k1), **kw)
        for nm, a, c in zip(names, got, one):
            np.testing.assert_array_equal(a[b].numpy(), c.numpy(), err_msg=f"{nm} seq {b}")
    for nm, a, w in zip(names, got, want):
        if nm == "nn_d2":
            np.testing.assert_array_max_ulp(a.numpy(), np.asarray(w), maxulp=2)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(w), err_msg=nm)


def test_plain_deskew_batched():
    cases = [tdk._deskew_case(3, 257, seed=s) for s in (5, 6, 7)]
    # each sequence its own spline: shift the trajectory's time origin
    sps = []
    for b, c in enumerate(cases):
        sps.append(c[0]._replace(t0=c[0].t0 + 0.013 * b))
    args = [(tdk._t(c[1]), tspl.Spline(*(tdk._t(a) for a in sp)), *(tdk._t(a) for a in c[2:]))
            for c, sp in zip(cases, sps)]
    got = tdeskew.deskew_points_plain(*tree.stack(args))
    for b, a in enumerate(args):
        np.testing.assert_array_equal(got[b].numpy(), tdeskew.deskew_points_plain(*a).numpy())
    assert 0 < got[..., 3].sum() < got[..., 3].numel()

    def ref(sp, pts, ext_q, ext_t, lt_q, lt_t):  # the JAX eager path (propagate.py:378-394)
        pq, pp, pok = jspl.get_pose_batch(sp, pts[..., 3].reshape(-1))
        pq, pp, pok = pq.reshape(pts.shape[:2] + (4,)), pp.reshape(pts.shape[:2] + (3,)), \
            pok.reshape(pts.shape[:2])
        pw = jso3.quat_rotate(pq, jso3.quat_rotate(ext_q[:, None], pts[..., :3]) + ext_t[:, None])
        in_lt = jso3.quat_rotate_inv(jnp.broadcast_to(lt_q[:, None], pq.shape),
                                     pw + (pp - lt_t[:, None]))
        out = jso3.quat_rotate_inv(jnp.broadcast_to(ext_q[:, None], pq.shape), in_lt - ext_t[:, None])
        return jnp.where(pok[..., None], out, pts[..., :3]), pok

    jsp = _jstack(sps)
    stacked = [np.stack([c[i] for c in cases]) for i in range(1, 6)]
    want, ok = jax.vmap(ref)(jsp, *map(jnp.asarray, stacked))
    np.testing.assert_array_equal(got[..., 3].numpy() > 0.5, np.asarray(ok))
    np.testing.assert_allclose(got[..., :3].numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_insert_batched_equals_each_insert():
    """Colliding voxels inside every sequence, and a table small enough to
    drop and evict: the batched insert gives each sequence its own insert's
    table and counts bit for bit."""
    maps, firsts, seconds = [], [], []
    for seed in (1, 2, 3):
        rng = np.random.default_rng(seed)
        m = tvh.create(1 << 8, 0.5, torch.float32, "cpu")
        firsts.append([torch.as_tensor(a) for a in tkn._batch(rng, 300, 3.0, 0.01, 0.5)])
        seconds.append([torch.as_tensor(a) for a in tkn._batch(rng, 300, 3.0, 0.01, 0.5)])
        maps.append(m)
    bm = tree.stack(maps)
    for batch in (firsts, seconds):
        bm = tvh.insert(bm, *tree.stack([tuple(x) for x in batch]))
        maps = [tvh.insert(m, *x) for m, x in zip(maps, batch)]
        for b, m in enumerate(maps):
            np.testing.assert_array_equal(bm.tab[b].numpy(), m.tab.numpy())
            assert int(bm.n_dropped[b]) == int(m.n_dropped)
            assert int(bm.n_evicted[b]) == int(m.n_evicted)
    assert int(bm.n_dropped.sum()) > 0 and int(bm.n_evicted.sum()) > 0
    np.testing.assert_array_equal(tvh.size(bm).numpy(), [int(tvh.size(m)) for m in maps])


def test_synthetic_batched_benchmark_on_cpu():
    res = tbatched.synthetic_batched_benchmark(batch=2, duration=3.0, points=512, warmup=2,
                                               chunk=4, device="cpu")
    assert set(res) == {"aggregate_scans_per_sec", "per_seq", "ates", "rounds"}
    assert res["rounds"] > 10
    assert np.isfinite(res["aggregate_scans_per_sec"])
    assert len(res["ates"]) == 2
    assert all(np.isfinite(a) for a in res["ates"])
