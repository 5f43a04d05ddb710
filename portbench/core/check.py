"""The comparison that decides `correct`: the program's per-round outputs
against the reference's on the same rounds, as a few numbers, each held
to a limit of its own (the workload file's `check`).

A number is the worst over every round compared:
  pos_gap_m          |pos - pos_ref| (m): propagation, deskew, the k-NN,
                     the plane fits and the IEKF all move it;
  rot_gap_rad        the angle between the two orientations (rad);
  cov_gap_rel        |pose_cov - ref|_F / |ref|_F: the IEKF's covariance;
  map_size_gap_rel   |map_size - ref| / ref: the map insert;
  n_effective_gap_rel |n_effective - ref| / ref: the plane fits' accepted
                     lanes;
  iter_gap           |iterations - ref|, the IEKF's iterations;
  map_dropped_gap    |map_dropped - ref|, the insert's drops.
A round the program did not produce, or whose pose is not finite, makes
every number infinite.

Beside them, a witness that owes nothing to the program's code nor to
the reference's, which is a frozen copy of the program's round:
  ate_m              the RMS over a pass's rounds of |pos - the
                     generator's position at the round's end| (m),
                     unaligned: the poses against the drive the inputs
                     were made from; the worst pass or sequence."""
from __future__ import annotations

import math

import numpy as np

# each number and the output fields it reads
FIELDS = dict(pos_gap_m=("pos",), rot_gap_rad=("quat",), cov_gap_rel=("pose_cov",),
              map_size_gap_rel=("map_size",), n_effective_gap_rel=("n_effective",),
              iter_gap=("iterations",), map_dropped_gap=("map_dropped",))


def gaps(prog, ref):
    """prog and ref: {field: array (S, R, ...)} of the same rounds (S
    sequences or passes). Returns {name: worst gap} for the numbers whose
    fields prog holds (the live path polls no drops)."""
    S, R = ref["pos"].shape[:2]
    names = [n for n, fs in FIELDS.items() if all(f in prog for f in fs)]
    if R == 0 or prog["pos"].shape[:2] != (S, R) or not np.all(np.isfinite(prog["pos"])) \
            or not np.all(np.isfinite(prog["quat"])):
        return {n: math.inf for n in names}
    pos = np.linalg.norm(prog["pos"].astype(np.float64) - ref["pos"], axis=-1)
    qa, qb = (q.astype(np.float64) / np.linalg.norm(q.astype(np.float64), axis=-1, keepdims=True)
              for q in (prog["quat"], ref["quat"]))
    qb = qb * np.where(np.sum(qa * qb, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    rot = 4.0 * np.arcsin(np.clip(np.linalg.norm(qa - qb, axis=-1) / 2.0, 0.0, 1.0))
    cref = np.linalg.norm(ref["pose_cov"].reshape(S, R, -1), axis=-1)
    cov = np.linalg.norm((prog["pose_cov"].astype(np.float64) - ref["pose_cov"]).reshape(S, R, -1),
                         axis=-1) / np.maximum(cref, 1e-300)

    def rel(f):
        a, b = prog[f].astype(np.float64), ref[f].astype(np.float64)
        return np.abs(a - b) / np.maximum(np.abs(b), 1.0)

    def absdiff(f):
        return np.abs(prog[f].astype(np.float64) - ref[f].astype(np.float64))

    vals = dict(pos_gap_m=lambda: pos, rot_gap_rad=lambda: rot, cov_gap_rel=lambda: cov,
                map_size_gap_rel=lambda: rel("map_size"),
                n_effective_gap_rel=lambda: rel("n_effective"),
                iter_gap=lambda: absdiff("iterations"),
                map_dropped_gap=lambda: absdiff("map_dropped"))
    return {n: float(np.nan_to_num(np.max(vals[n]()), nan=math.inf)) for n in names}


def ate(pos, end_time, traj):
    """One pass's ate_m: pos (R, 3) at end_time (R,) against traj, the
    generator's trajectory (infinite where a pose is not finite)."""
    if len(pos) == 0:
        return 0.0
    err = np.linalg.norm(np.asarray(pos, np.float64) - traj.pos(np.asarray(end_time)), axis=-1)
    v = float(np.sqrt(np.mean(err ** 2)))
    return v if math.isfinite(v) else math.inf


def worst(*gap_dicts):
    """The worst of each number over several comparisons."""
    return {n: max(g[n] for g in gap_dicts) for n in gap_dicts[0]} if gap_dicts else {}


def judge(values, limits):
    """(correct, [(name, value, limit)]) for the numbers the workload holds
    to a limit; a number not finite fails."""
    rows = [(n, values.get(n, math.inf), float(lim)) for n, lim in limits.items()]
    return all(math.isfinite(v) and v <= lim for _, v, lim in rows), rows
