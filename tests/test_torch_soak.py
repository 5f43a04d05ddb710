"""Parity of the port's soak (malio_tpu_torch/soak.py, the counterpart of
scripts/soak_tpu.py) with the JAX package.

* `soak.run` against the JAX soak loop (scripts/soak_tpu.py:81-120,
  written out below with malio_tpu.batched._init_seq, malio_tpu.runner.
  _stack_chunk and malio_tpu.pipeline.scan_steps) on the same numpy
  groups in f64, at the soak's config (3 LiDARs, no measurement cap) with
  256 points a LiDAR and 2^16 slots: positions within 1e-6 m; map size,
  map drops, evictions, measurement-lane drops and nn_miss equal every
  round (tests/test_torch_soak_evict.py does the same at
  tests/test_soak.py's `_soak_cfg`, whose small box slides and evicts).
  Two chunks: a round of the port at this size takes ~1.5 s on one CPU
  thread.
* the summary's keys and values from that run; the quartiles.
* the port twin of test_soak.py's 5k-round soak with its asserts (slow).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from malio_tpu import batched as jbatched
from malio_tpu import pipeline as jpipe
from malio_tpu import runner as jrunner

from malio_tpu_torch import soak
from malio_tpu_torch.io.assemble import assemble_groups
from malio_tpu_torch.io.synthetic import SyntheticSequence

import test_soak
import test_torch_pipeline as tp

torch.set_num_threads(1)
POS_ATOL = 1e-6
CHUNK = 8
EQUAL = ("map_size", "map_dropped", "meas_dropped", "nn_miss")


def _jax_soak(cfg, groups, chunk):
    """The loop of scripts/soak_tpu.py:81-120 in f64: per-round arrays and
    the final carry."""
    carry, stream, prev_base = jbatched._init_seq(cfg, groups, jnp.float64)
    n = len(stream) - len(stream) % chunk
    out = {k: [] for k in ("pos", "t", *EQUAL)}
    for c0 in range(0, n, chunk):
        gdev, bases = jrunner._stack_chunk(stream[c0 : c0 + chunk], np.float64, prev_base)
        prev_base = float(bases[-1])
        carry, st = jpipe.scan_steps(cfg, carry, gdev)
        out["pos"].append(np.asarray(st.pos))
        out["t"].append(np.asarray(st.end_time) + bases)
        out["map_size"].append(np.asarray(st.map_size))
        out["map_dropped"].append(np.asarray(st.map_dropped))
        out["meas_dropped"].append(np.asarray(st.n_meas_dropped))
        out["nn_miss"].append(np.asarray(st.nn_miss))
    return {k: np.concatenate(v) for k, v in out.items()}, carry


def _check(jcfg, groups, rounds):
    res = soak.run(tp.port_config(jcfg), groups, torch.float64, "cpu", CHUNK)
    want, jcarry = _jax_soak(jcfg, groups, CHUNK)
    assert res["rounds"] == len(want["pos"]) >= rounds
    np.testing.assert_allclose(res["pos"], want["pos"], atol=POS_ATOL, rtol=0)
    np.testing.assert_allclose(res["t"], want["t"], atol=1e-9, rtol=0)
    for k in EQUAL:
        np.testing.assert_array_equal(res[k], want[k], err_msg=k)
    assert int(res["carry"].map.n_evicted) == int(jcarry.map.n_evicted)
    np.testing.assert_allclose(res["carry"].P.numpy(), np.asarray(jcarry.P), atol=1e-10)
    return res


def _soak_config_case(duration, points=256, slots=1 << 16):
    """The soak's config and stream at `points` a LiDAR, as the JAX
    package builds them (its config with the port's stream: the streams are
    the same, tests/test_torch_io.py)."""
    cfg, groups, traj = soak.soak_sequence(duration, points, seed=0)
    jcfg = dataclasses.replace(jbatched._flagship_config(points, slots, False),
                               max_meas_points=None)
    assert tp.port_config(jcfg) == dataclasses.replace(cfg, map_capacity=slots)
    return jcfg, groups, traj


def test_soak_run_matches_jax_at_the_soak_config():
    jcfg, groups, traj = _soak_config_case(2.5)
    res = _check(jcfg, groups, 16)
    assert res["meas_dropped"].sum() == 0  # uncapped lanes drop nothing
    out = soak.summary(res, traj)
    assert set(out) == {"rounds", "wall_s", "scans_per_sec", "thr_first_quartile",
                        "thr_last_quartile", "finite", "n_nonfinite_rounds", "P_max", "ate_m",
                        "map_size_final", "map_dropped_final", "n_evicted_final",
                        "meas_dropped_total", "nn_miss_p50", "nn_miss_p99"}
    assert out["finite"] and out["n_nonfinite_rounds"] == 0
    assert out["rounds"] == res["rounds"] and out["map_size_final"] == res["map_size"][-1]
    assert np.isfinite(out["ate_m"]) and out["ate_m"] < 0.5
    assert out["nn_miss_p50"] == np.median(res["nn_miss"])
    assert len(res["chunk_s"]) == res["rounds"] // CHUNK
    assert res["memory"] == []  # no card
    assert all(c == {"knn_window": {}, "deskew": {}, "merge_rows": {}} for c in res["launches"])


def test_quartiles():
    assert [soak.quartile_chunks(10, k) for k in range(4)] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(8, 10)]
    assert [soak.quartile_chunks(2, k) for k in range(4)] == [
        slice(0, 1), slice(1, 2), slice(2, 3), slice(1, 2)]
    res = dict(chunk=4, launches=[{"deskew": {(1, 3, 8, 4): 4}}] * 6
               + [{"deskew": {(1, 3, 8, 4): 8}, "merge_rows": {(64, 24): 4}}] * 2)
    assert soak.launches_per_round(res, 0) == {"deskew": {"1,3,8,4": 1.0}}
    assert soak.launches_per_round(res, 3) == {"deskew": {"1,3,8,4": 2.0},
                                               "merge_rows": {"64,24": 1.0}}


def _run_port_soak(duration=510.0, seed=11):
    """test_soak._run_soak through the port's soak.run (chunks of 50)."""
    cfg = tp.port_config(test_soak._soak_cfg())
    seq = SyntheticSequence(duration=duration, num_lidars=1, points_per_scan=256,
                            ext_t=np.array([[0.2, 0.0, 0.0]]), seed=seed)
    imu, rounds, traj = seq.generate()
    res = soak.run(cfg, assemble_groups(cfg, imu, rounds), torch.float64, "cpu",
                   test_soak.CHUNK)
    res["slides"] = int((np.abs(np.diff(res["box_min"], axis=0)).sum(axis=1) > 1e-9).sum())
    gt = traj.pos(res["t"])
    from malio_tpu_torch.eval import ate

    res["ate_aligned"] = ate.ate_rmse(res["pos"], gt, align=True)
    res["ate_raw"] = ate.ate_rmse(res["pos"], gt, align=False)
    res["cfg"] = cfg
    return res


@pytest.mark.slow
def test_soak_5k_rounds_slide_evict_high_load():
    res = _run_port_soak()
    assert res["rounds"] >= 5000, res["rounds"]
    assert np.isfinite(res["pos"]).all()
    assert np.isfinite(res["carry"].P.numpy()).all()
    assert np.isfinite(res["carry"].x.pos.numpy()).all()
    assert res["slides"] >= 40, res["slides"]
    assert res["map_load"].max() >= 0.5, res["map_load"].max()
    total_offered = float(res["n_insert"].sum())
    total_dropped = float(res["map_dropped"][-1])
    assert total_dropped <= 0.15 * total_offered, (total_dropped, total_offered)
    half = res["rounds"] // 2
    d1 = res["map_dropped"][half] - res["map_dropped"][0]
    d2 = res["map_dropped"][-1] - res["map_dropped"][half]
    assert d2 <= 2.0 * max(d1, 500.0), (int(d1), int(d2))
    assert res["ate_aligned"] < 0.75, (res["ate_aligned"], res["ate_raw"])
    assert res["iters"][-1000:].mean() < res["cfg"].max_iteration + 1
