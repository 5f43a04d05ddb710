"""Parity of the port's sharded fusion step (malio_tpu_torch.distributed)
with the JAX package's single-device pipeline.step and with the port's own
single process.

Real gloo process groups: each case writes its inputs to a temporary npz
and runs `python -m malio_tpu_torch.distributed.sharding` in dp * mp
processes on the CPU (`sharding.run_local`: one thread each, a deadline
on the whole world).
The children import no JAX; this process computes the references and
compares the children's gathered outputs and carry. Meshes: dp=2 x mp=1,
dp=1 x mp=2, dp=2 x mp=2. Cases:

* `dummy`: __graft_entry__._dummy_inputs at _tiny_cfg(L=2, pts=256), f64,
  one round of four sequences, two of them the same round and two
  perturbed each its own way (tests/test_distributed.py's two cases);
  the map does not exist yet, so only the insert runs sharded;
* `city`: three f64 rounds of two City-shaped sequences (seeds 3 and 4 of
  test_torch_pipeline's _city_small / _groups / _jax_init), so that the
  k-NN with its escalation tier, both weighting laws and the IEKF run
  sharded.

Tolerances: against JAX, those of test_three_city_rounds_match_jax (pos,
quat 1e-8, P 1e-10, map size, effective points, iterations and k-NN
misses equal); against the port's single process, dp bit for bit and mp
pos within 1e-9 (every exchange is exact and the measurement rows are
summed in one process's order, but a rank's per-lane products run on
half the lanes), the re-assembled table equal in its fingerprint and
covariance columns and within 1e-12 in its positions. Each map shard
holds ceil(R / mp) rows.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from malio_tpu import pipeline as jpipe
from malio_tpu import runner as jrunner

from malio_tpu_torch import interop, tree
from malio_tpu_torch import pipeline as tpipe
from malio_tpu_torch.distributed import multihost, sharding
from malio_tpu_torch.distributed.sharding import Mesh

import test_torch_pipeline as tp

torch.set_num_threads(1)
MESHES = {"dp2_mp1": (2, 1), "dp1_mp2": (1, 2), "dp2_mp2": (2, 2)}
CASES = ("dummy", "city")
CITY_SEEDS = (3, 4)
CITY_ROUNDS = 3
DEADLINE_S = 240


def run_world(inputs, out, dp, mp, cfg, B):
    """The sharding worker in dp * mp processes on the CPU, with a
    deadline (sharding.run_local): ((outputs, carry as numpy), every
    rank's stats)."""
    stats = sharding.run_local(inputs, out, dp * mp, mp, device="cpu", deadline_s=DEADLINE_S)
    outs, carry = sharding.load_outputs(out, sharding.carry_template(cfg, B, torch.float64))
    return (outs, interop.carry_to_numpy(carry)), stats


def _dummy_case():
    cfg = ge._tiny_cfg(L=2, pts=256)
    carry, group = ge._dummy_inputs(cfg, dtype=jnp.float64)
    rng = np.random.default_rng(42)
    groups = []
    for b in range(4):  # sequences 0 and 2 the same round, 1 and 3 each perturbed its own way
        pts = np.asarray(group.pts).copy()
        if b % 2:
            pts[..., :3] += rng.normal(size=pts[..., :3].shape) * (0.5 + 0.2 * b)
        groups.append(group._replace(pts=jnp.asarray(pts)))
    return cfg, [carry] * 4, [jax.tree_util.tree_map(lambda a: a[None], g) for g in groups]


def _city_case():
    cfg = tp._city_small()
    carries, chunks = [], []
    for seed in CITY_SEEDS:
        groups = tp._groups(cfg, seed=seed)
        jc, start = tp._jax_init(cfg, groups)
        g, _ = jrunner._stack_chunk(groups[start : start + CITY_ROUNDS], np.float64,
                                    jrunner.group_base(groups[start]))
        carries.append(jc)
        chunks.append(g)
    return cfg, carries, chunks


def _stack(trees, axis):
    return {k: (_stack([t[k] for t in trees], axis) if isinstance(trees[0][k], dict)
                else np.stack([t[k] for t in trees], axis)) for k in trees[0]}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Per case: the port's config, the JAX single-device references
    (per sequence, per round), the port's single-process run of the whole
    batch and the inputs file."""
    d = tmp_path_factory.mktemp("dist")
    out = {}
    for name, make in (("dummy", _dummy_case), ("city", _city_case)):
        jcfg, jcarries, jchunks = make()
        refs = []  # per sequence: [(carry, out)] per round
        for jc, g in zip(jcarries, jchunks):
            rounds = []
            for k in range(g.pts.shape[0]):
                jc, jo = jpipe.step(jcfg, jc, jax.tree_util.tree_map(lambda a: a[k], g))
                rounds.append((tp.flat(jc), tp.flat(jo)))
            refs.append(rounds)
        carry_np = _stack([tp.flat(c) for c in jcarries], 0)
        groups_np = _stack([tp.flat(g) for g in jchunks], 1)  # (K, B, ...)
        tcfg = tp.port_config(jcfg)
        path = d / f"{name}.npz"
        tc = interop.carry_from_numpy(carry_np, "cpu")
        sharding.save_inputs(path, tcfg, tc, groups_np)
        tg = interop.group_from_numpy(groups_np, "cpu")
        tc, touts = tpipe.scan_steps(tcfg, tc, tg, device="cpu")
        out[name] = dict(refs=refs, single=(interop.carry_to_numpy(tc), interop.to_numpy(touts)),
                         path=path, cfg=tcfg, B=len(jcarries))
    return out


@pytest.fixture(scope="module")
def worlds(cases, tmp_path_factory):
    """Every case on every mesh: {(mesh, case): ((outputs, carry), stats)}."""
    d = tmp_path_factory.mktemp("worlds")
    res = {}
    for mesh, (dp, mp) in MESHES.items():
        for case in CASES:
            c = cases[case]
            res[mesh, case] = run_world(c["path"], d / f"{mesh}_{case}.npz", dp, mp, c["cfg"], c["B"])
    return res


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_step_matches_jax(cases, worlds, mesh, case):
    (outs, carry), _ = worlds[mesh, case]
    refs = cases[case]["refs"]
    for b, rounds in enumerate(refs):
        for k, (jc, jo) in enumerate(rounds):
            msg = f"{mesh} {case} sequence {b} round {k}"
            np.testing.assert_allclose(outs["pos"][k, b], jo["pos"], atol=1e-8, err_msg=msg)
            np.testing.assert_allclose(outs["quat"][k, b], jo["quat"], atol=1e-8, err_msg=msg)
            for f in ("map_size", "n_effective", "iterations", "nn_miss"):
                assert int(outs[f][k, b]) == int(jo[f]), (msg, f)
        np.testing.assert_allclose(carry["P"][b], rounds[-1][0]["P"], atol=1e-10)
    if case == "city":  # the update ran with the map in place, and the wide tier searched
        assert outs["iterations"][1:].min() > 0 and outs["n_effective"][1:].min() > 0
        assert outs["nn_miss"].min() > 0


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_step_matches_single_process(cases, worlds, mesh, case):
    (outs, carry), stats = worlds[mesh, case]
    s_carry, s_outs = cases[case]["single"]
    mp = MESHES[mesh][1]
    if mp == 1:  # dp alone: each rank's round is the single process's, bit for bit
        for f, v in s_outs.items():
            np.testing.assert_array_equal(outs[f], v, err_msg=f)
        for f in ("P", "Pi"):
            np.testing.assert_array_equal(carry[f], s_carry[f], err_msg=f)
        np.testing.assert_array_equal(carry["map"]["tab"], s_carry["map"]["tab"])
        return
    np.testing.assert_allclose(outs["pos"], s_outs["pos"], atol=1e-9, rtol=0)
    for f in ("map_size", "n_effective", "iterations", "nn_miss", "n_insert", "map_dropped"):
        np.testing.assert_array_equal(outs[f], s_outs[f], err_msg=f)
    tab, s_tab = carry["map"]["tab"], s_carry["map"]["tab"]
    np.testing.assert_array_equal(tab[..., [0, 4]], s_tab[..., [0, 4]])
    np.testing.assert_allclose(tab[..., 1:4], s_tab[..., 1:4], atol=1e-12, rtol=0)
    assert all(s["collectives_per_round"] and min(s["collectives_per_round"]) > 0 for s in stats)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_map_shards_hold_their_rows(worlds, mesh):
    dp, mp = MESHES[mesh]
    for case in CASES:
        _, stats = worlds[mesh, case]
        assert sorted((s["dp_index"], s["mp_index"]) for s in stats) == [
            (i, j) for i in range(dp) for j in range(mp)]
        for s in stats:
            assert s["shard_rows"] <= -(-s["rows"] // mp), s
            assert s["shard_rows"] * mp == s["rows"], s
            if mp == 1:
                assert s["collectives_per_round"] == [0] * len(s["collectives_per_round"]), s


def test_port_dummy_inputs_equal_jax():
    cfg = ge._tiny_cfg(L=2, pts=256)
    jc, jg = ge._dummy_inputs(cfg, dtype=jnp.float64)
    tcfg = multihost._tiny_cfg(L=2, pts=256)
    assert tcfg == tp.port_config(cfg)
    tc, tg = multihost._dummy_inputs(tcfg, torch.float64, "cpu")

    def check(t, j):
        for f, v in t.items():
            if isinstance(v, dict):
                check(v, j[f])
            else:
                np.testing.assert_array_equal(v, j[f], err_msg=f)

    check(interop.to_numpy(tc), tp.flat(jc))
    check(interop.to_numpy(tg), tp.flat(jg))


def _mesh(dp, mp):
    """A mesh object for shape checks only: no process group behind it."""
    layout = tuple(tuple(range(i * mp, (i + 1) * mp)) for i in range(dp))
    return Mesh(layout=layout, dp_index=0, mp_index=0, device=torch.device("cpu"),
                mp_group=None, ranks=None)


@pytest.mark.parametrize("what", ["raw points", "lanes", "rows", "batch"])
def test_a_mesh_that_does_not_divide_raises(what):
    cfg = multihost._tiny_cfg(L=2, pts=256)
    carry, group = multihost._dummy_inputs(cfg, torch.float64, "cpu")
    batch = sharding.batch_carries([carry] * 2)
    if what == "raw points":
        cfg = multihost._tiny_cfg(L=2, pts=250)  # 250 raw points over mp = 4
        with pytest.raises(ValueError, match="raw points"):
            sharding.make_sharded_step(cfg, _mesh(1, 4))
    elif what == "lanes":
        import dataclasses

        cfg = dataclasses.replace(cfg, max_meas_points=300)  # 300 lanes over mp = 8
        with pytest.raises(ValueError, match="measurement lanes"):
            sharding.make_sharded_step(cfg, _mesh(1, 8))
    elif what == "rows":
        small = batch._replace(map=batch.map._replace(tab=batch.map.tab[:, :6]))
        with pytest.raises(ValueError, match="mp=4 does not divide axis 1"):
            sharding.make_sharded_step(cfg, _mesh(1, 4), carry_template=small)
    else:
        with pytest.raises(ValueError, match="dp=4 does not divide axis 0"):
            sharding.carry_sharding(_mesh(4, 1), batch)


def test_world_correction_of_a_sharded_carry_raises():
    """A world correction re-hashes the whole table: on mp rank 0's shard
    of a carry (half its rows) it raises; on the whole carry it runs."""
    cfg = multihost._tiny_cfg(L=2, pts=256)
    carry, _ = multihost._dummy_inputs(cfg, torch.float64, "cpu")
    local = sharding.carry_sharding(_mesh(1, 2), sharding.batch_carries([carry]))
    local = tree.index(local, 0)
    assert local.map.tab.shape[0] * 2 == carry.map.tab.shape[0]
    dq = torch.tensor([0.9998, 0.0, 0.0, 0.02], dtype=torch.float64)
    dt = torch.tensor([0.5, -0.2, 0.0], dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="sharded map"):
        tpipe.apply_world_correction(cfg, local, dq, dt)
    assert tpipe.apply_world_correction(cfg, carry, dq, dt).map.tab.shape == carry.map.tab.shape


def test_a_failing_process_fails_the_world(tmp_path):
    """Every process dies before its first round (no inputs file): the call
    raises with the process's log, within the deadline."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited"):
        sharding.run_local(tmp_path / "missing.npz", tmp_path / "out.npz", 2, 2, device="cpu",
                           deadline_s=60)
    assert time.monotonic() - t0 < 60
