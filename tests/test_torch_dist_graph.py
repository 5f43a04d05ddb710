"""The mp rank's round with static shapes and no host read: what lets it be
one CUDA graph over NCCL (pipeline.step with a capturable shard), checked
on the CPU in real gloo worlds of OS processes (tests/dist_worlds.py, one
thread a process, a deadline on each world):

* an mp rank's steady round (dp1xmp2, dp2xmp2) makes no operation that
  reads a device value on the host (tests/host_reads.py): the only
  operations outside the round's own are the c10d collectives, by name;
* `voxel_hash.whole_map` on a row-sharded batch of maps (mp = 2 and 4)
  gives every rank the unsharded tables bit for bit, so the window rows
  are the unsharded ones; knn_cached over a rank's share of the queries
  on its rows gives the unsharded search's results on those queries bit
  for bit, with the escalation budget counted over every rank;
* `esekf.update_iterated` on an mp rank (its h_share over sharded lanes
  and rows) runs the unsharded loop, max_iter + 1 iterations masked per
  sequence, and gives the unsharded result bit for bit (the scenario of
  test_update_iterated_fixed_iterations_matches_jax_while_loop: one
  sequence on the Newton-Schulz inverse, done early; one on the direct
  inverse);
* the worker's backend rule (sharding.worker_backend).
"""
import numpy as np
import pytest
import torch

from malio_tpu_torch import interop, tree
from malio_tpu_torch import measurement as tmeas
from malio_tpu_torch.distributed import sharding
from malio_tpu_torch.filter import esekf as tesekf
from malio_tpu_torch.map import voxel_hash as tvh

import dist_worlds

torch.set_num_threads(1)
DEADLINE_S = 180
STEADY_ROUNDS = 3  # two rounds make the map and the cached constants, the third is read
MESHES = {"dp1_mp2": (1, 2), "dp2_mp2": (2, 2)}


def _bits(t):
    t = t.contiguous()
    if t.dtype in (torch.float32, torch.float64):
        t = t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)
    return t


def _same_bits(got, want, what):
    for i, (g, w) in enumerate(zip(tree.leaves(got), tree.leaves(want))):
        assert g.shape == w.shape and torch.equal(_bits(g), _bits(w)), f"{what} leaf {i}"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_graph")
    path = d / "in.npz"
    dist_worlds.make_inputs(path, seeds=(0, 1), rounds=STEADY_ROUNDS)
    return d, path


@pytest.mark.parametrize("mesh", list(MESHES))
def test_steady_mp_round_reads_nothing_on_the_host(inputs, mesh):
    d, path = inputs
    dp, mp = MESHES[mesh]
    payload = dict(dir=str(d / mesh), inputs=str(path), mp=mp, device="cpu")
    (d / mesh).mkdir()
    runs, res, _ = dist_worlds.spawn("steady_round", dp * mp, payload, deadline_s=DEADLINE_S)
    dist_worlds.check(runs)
    for r in res:
        assert r["seen"] == [], (mesh, r["mp_index"], r["seen"])
        assert r["calls"] > 0 and len(r["collectives"]) == r["calls"], r
        assert set(r["collectives"]) <= {"c10d::allgather_into_tensor_coalesced_",
                                         "c10d::_allgather_base_", "c10d::allreduce_"}, r
    for r in res:  # the mp ranks of a dp row hold the same outputs
        peer = next(q for q in res if q["dp_index"] == r["dp_index"] and q["mp_index"] == 0)
        _same_bits((r["pos"], r["map_size"]), (peer["pos"], peer["map_size"]), mesh)
    assert all(int(r["map_size"].min()) > 0 for r in res)


def _maps(seed=5, B=2, N=3000, Q=64):
    """B maps of random points (voxel_hash.insert), queries near and far
    from them with a few masked off, and knn_cached's arguments with an
    escalation budget under the demand."""
    rng = np.random.default_rng(seed)
    m = tree.stack([tvh.create(1 << 15, 0.5, torch.float32, "cpu")] * B)
    pts = torch.as_tensor(rng.uniform(-12, 12, size=(B, N, 3)), dtype=torch.float32)
    covs = torch.as_tensor(rng.uniform(1e-4, 1e-2, size=(B, N)), dtype=torch.float32)
    m = tvh.insert(m, pts, covs, torch.ones((B, N), dtype=torch.bool))
    near = pts[:, :Q] + torch.as_tensor(rng.normal(size=(B, Q, 3)) * 0.3, dtype=torch.float32)
    near[:, ::3] += 40.0  # far from the map: they escalate
    qmask = torch.as_tensor(rng.uniform(size=(B, Q)) < 0.9)
    kw = dict(radius=1, wide_radius=3, wide_budget=8, accept_d2=5.0, accept_k=5, cache_k=16)
    return m, near, qmask, kw


@pytest.mark.parametrize("mp", [2, 4])
def test_whole_map_of_a_row_sharded_map_is_the_unsharded_map(tmp_path, mp):
    m, q, qmask, kw = _maps()
    torch.save(dict(map=m, queries=q, qmask=qmask, kw=kw), tmp_path / "maps.pt")
    payload = dict(dir=str(tmp_path), maps=str(tmp_path / "maps.pt"), mp=mp)
    runs, res, _ = dist_worlds.spawn("whole_table", mp, payload, deadline_s=DEADLINE_S)
    dist_worlds.check(runs)
    want = tvh.knn_cached(m, q, qmask=qmask, **kw)
    assert int(want[4].sum()) > kw["wide_budget"] * 2  # the budget cuts the escalations
    b_all, alive = tvh._window_rows(m, q, kw["radius"], qmask)
    for r in res:
        assert r["local_rows"] * mp == m.tab.shape[1]
        _same_bits(r["tab"], m.tab, f"mp={mp} whole table")
        whole = m._replace(tab=r["tab"])
        got_rows = tvh._window_rows(whole, q, kw["radius"], qmask)
        _same_bits(got_rows, (b_all, alive), "window rows")
        lo, hi = r["lanes"]
        for i, (g, w) in enumerate(zip(r["knn"], want)):
            _same_bits(g, w if i == 4 else w[:, lo:hi], f"mp={mp} knn_cached output {i}")


@pytest.fixture(scope="module")
def iekf_scenario():
    """test_update_iterated_fixed_iterations_matches_jax_while_loop's batch
    of two, as port objects."""
    import jax.numpy as jnp
    import test_oracle_parity as top
    import test_torch_batched as tb
    import test_torch_filter as tf
    import test_torch_pipeline as tp
    from malio_tpu import state as jst
    from malio_tpu.filter import esekf as jesekf

    sc = top._h_share_scenario(M=72, seed=13, spread=2.0)
    cfg = sc["cfg"]
    tcfg, tmap, tsd, tx = tf._port_scenario(sc)
    n = jst.dof(tf.L)
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
    two = [tree.stack([tree.squeeze(a)] * 2) for a in (tmap, tsd, tx)]
    return dict(cfg=tcfg, map=two[0], data=two[1], x=two[2],
                xs=interop.state_from_numpy(tp.flat(xs), "cpu"),
                P=torch.as_tensor(np.stack([np.asarray(first.P), P0])),
                Pi=torch.as_tensor(np.stack([np.asarray(first.Pi), np.zeros((n, n))])), kw=kw)


def test_mp_update_iterated_is_the_unsharded_one(tmp_path, iekf_scenario):
    sc = iekf_scenario
    torch.save(sc, tmp_path / "scenario.pt")
    payload = dict(dir=str(tmp_path), scenario=str(tmp_path / "scenario.pt"), mp=2)
    runs, res, _ = dist_worlds.spawn("iekf", 2, payload, deadline_s=DEADLINE_S)
    dist_worlds.check(runs)
    h, cache0 = tmeas.make_h_share(sc["cfg"], sc["map"], sc["data"], sc["x"])
    want = tesekf.update_iterated(sc["xs"], sc["P"], h, cache0, Pi0=sc["Pi"], **sc["kw"])
    its = want.iterations.tolist()
    assert its[0] < its[1] <= sc["kw"]["max_iter"] and want.valid.tolist() == [True, True]
    for r in res:
        # max_iter + 1 iterations, each one gather of the weighting laws'
        # extremes and one of the measurement rows
        assert r["calls"] == 2 * (sc["kw"]["max_iter"] + 1), r["calls"]
        _same_bits((r["x"], r["P"], r["Pi"], r["iterations"], r["valid"]),
                   (want.x, want.P, want.Pi, want.iterations, want.valid), "update_iterated")


@pytest.mark.parametrize("cpu,backend,nprocs,cards,want", [
    (True, None, 2, 0, "gloo"),  # the CPU
    (True, None, 2, 2, "gloo"),  # --cpu on a host with cards
    (False, None, 2, 1, "gloo"),  # two ranks share the one card: NCCL refuses that
    (False, None, 4, 2, "gloo"),
    (False, None, 2, 2, "nccl"),  # a card a rank
    (False, None, 4, 8, "nccl"),
    (False, "gloo", 2, 2, "gloo"),  # --backend forces either
    (False, "nccl", 2, 1, "nccl"),
])
def test_worker_backend_rule(cpu, backend, nprocs, cards, want):
    assert sharding.worker_backend(cpu, backend, nprocs, cards) == want
