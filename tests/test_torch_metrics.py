"""The port's metrics.py against the JAX package's on the CPU: the JSONL
records of MetricsLogger equal the JAX logger's for the same round values
(all keys but compute_ms, a host time); the dashboard renders the same
lines (title, compute and RSS lines aside); ros_pose_covariance is equal."""
import collections
import json

import numpy as np
import torch

from malio_tpu import metrics as jmetrics

from malio_tpu_torch import metrics as tmetrics

torch.set_num_threads(1)

Out = collections.namedtuple("Out", "pos quat end_time iterations n_effective map_size map_load "
                                    "map_dropped n_insert")
X = collections.namedtuple("X", "vel ext_t ext_r")
Carry = collections.namedtuple("Carry", "x")


def _rounds(n=12, seed=0):
    rng = np.random.default_rng(seed)
    for k in range(n):
        q = rng.normal(size=4)
        yield dict(pos=rng.normal(size=3), quat=q / np.linalg.norm(q), end_time=0.1 * k + 0.013,
                   iterations=int(rng.integers(1, 5)), n_effective=int(rng.integers(0, 9000)),
                   map_size=1000 + 37 * k, map_load=(1000 + 37 * k) / 2**21, map_dropped=k // 5,
                   n_insert=int(rng.integers(0, 12000)))


def _as(d, torch_out):
    wrap = (lambda v: torch.as_tensor(np.asarray(v))) if torch_out else np.asarray
    return Out(**{k: wrap(v) for k, v in d.items()})


def _carry(torch_out, seed=1):
    rng = np.random.default_rng(seed)
    vals = dict(vel=rng.normal(size=3), ext_t=rng.normal(size=(3, 3)),
                ext_r=rng.normal(size=(3, 4)))
    wrap = torch.as_tensor if torch_out else np.asarray
    return Carry(X(**{k: wrap(v) for k, v in vals.items()}))


def _log(mod, path, torch_out, capsys):
    lg = mod.MetricsLogger(jsonl_path=path, dashboard=True, every=5)
    for k, d in enumerate(_rounds()):
        lg.update(_carry(torch_out), _as(d, torch_out), t_base=1.6e9 + k)
    lg.close()
    return capsys.readouterr().out


def test_jsonl_and_dashboard_match_the_jax_logger(tmp_path, capsys):
    j_out = _log(jmetrics, tmp_path / "j.jsonl", False, capsys)
    t_out = _log(tmetrics, tmp_path / "t.jsonl", True, capsys)
    jr = [json.loads(l) for l in (tmp_path / "j.jsonl").read_text().splitlines()]
    tr = [json.loads(l) for l in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert len(jr) == len(tr) == 12
    for a, b in zip(tr, jr):
        assert a.keys() == b.keys()
        a.pop("compute_ms"), b.pop("compute_ms")
        assert a == b
    keep = lambda s: [l for l in s.splitlines() if l.startswith("[") and
                      not l.startswith(("[Compute]", "[RSS]"))]
    assert keep(t_out) == keep(j_out) and len(keep(t_out)) == 2 * 10
    assert t_out.count("\x1b[2J") == j_out.count("\x1b[2J") == 2


def test_ros_pose_covariance_matches():
    P = np.random.default_rng(2).normal(size=(4, 6, 6))
    np.testing.assert_array_equal(tmetrics.ros_pose_covariance(P), jmetrics.ros_pose_covariance(P))
    np.testing.assert_array_equal(tmetrics.ros_pose_covariance(P[0]),
                                  jmetrics.ros_pose_covariance(P[0]))
