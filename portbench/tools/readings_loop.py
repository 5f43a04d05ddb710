"""The readings that the loop cells' limits are set from (README.md's rule,
as tools/readings.py gives it for the replay cells): for each seed, one
run of the cell's timed path with a short window (whole passes) and its
numbers against the reference (the lower readings); on the first
`--control-seeds` seeds the two controls against the same reference on
the same recorded passes (the upper readings):

  tf32         the reference round corrected as each pass was, with its
               float32 matmuls in TF32 (reference/replay.CONTROLS): the
               filter's numbers;
  f32_backend  the plain back end (reference/backend.py) computed in
               float32 on each pass's recorded inputs: the back end's
               numbers.

Beside them, each pass's loop closures, and `ate_still_m`: the ate_m of a
pose that never leaves the start. The drives are made in parallel
processes first; one process runs every seed, so the set-up is paid once.
`--backend-only` drives one pass a seed and reads the back end's numbers
alone (no corrected replay of the filter), for the program and f32_backend.

    python3 portbench/tools/readings_loop.py --workload city3loop.replay --seconds 1 \\
        --seeds 11 12 13 [--control-seeds 3] [--backend-only]

Each seed's numbers go to standard output as one JSON line."""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent.parent))
from portbench.core import env  # noqa: E402

env.prepare()

import numpy as np  # noqa: E402

from portbench.core import bench, check  # noqa: E402


def control_gaps(cell, res):
    """Both controls' numbers on the passes the run compared."""
    mode = bench.load_module("modes", cell.workload["mode"])
    bk = mode.backend_params(cell.config)
    groups = res["reference_inputs"][0]
    out = {}
    ctl, _ = mode.replays(cell.reference_config(), groups, res["records"], cell.device,
                          control=cell.workload["control"])
    for o, ref, c in zip(res["outs"], res["references"], ctl):
        R = o["pos"].shape[1]
        g = check.gaps({f: v[:, :R] for f, v in c.items()}, {f: v[:, :R] for f, v in ref.items()})
        out = check.worst(out, g) if out else g
    answers, dtype = {}, mode.BACKEND_CONTROLS[cell.workload["backend_control"]]
    for p in res["records"]:
        key = mode.inputs_key(p)
        if key not in answers:
            want = mode.reference_backend(p, bk)
            got = mode.reference_backend(p, bk, dtype)
            answers[key] = mode.compare_backend(p, got, want, bk)
        out.update({k: max(v, out.get(k, 0.0)) for k, v in answers[key].items()})
    return out


def backend_only(cell, mode, control):
    """One pass of the cell's timed path, recorded, and its back-end numbers
    against the plain back end: (program, control or None, closures)."""
    from malio_tpu_torch import posegraph, runner

    bk = mode.backend_params(cell.config)
    imu, rounds, _ = cell.sequence(cell.seed, cell.params["sequence_s"])
    rec = mode.Recorder().install()
    try:
        mode._pass(runner, posegraph, cell.program_config(), cell.groups(imu, rounds), cell, rec,
                   bk)
    finally:
        rec.uninstall()
    p = mode.to_host(rec.passes[0])
    want = mode.reference_backend(p, bk)
    prog = mode.compare_backend(p, mode.program_backend(p), want, bk)
    dtype = mode.BACKEND_CONTROLS[cell.workload["backend_control"]]
    ctl = (mode.compare_backend(p, mode.reference_backend(p, bk, dtype), want, bk)
           if control else None)
    return prog, ctl, len(p["pairs"])


def still_ate(res):
    """ate_m of poses held at the drive's first compared position."""
    ref = res["references"][0]
    traj = res["trajectories"][0]
    return check.ate(ref["pos"][0, :1].repeat(ref["pos"].shape[1], 0), ref["end_time"][0], traj)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--backend-only", action="store_true")
    a = ap.parse_args(argv)
    first = bench.Cell.load(a.workload, a.seeds[0], a.seconds, False, time.perf_counter())
    t = time.perf_counter()
    made = dict(zip(a.seeds, first.sequences(a.seeds, first.params["sequence_s"])))
    print(json.dumps(dict(workload=a.workload, drives=len(made),
                          seconds=time.perf_counter() - t)), flush=True)
    for i, seed in enumerate(a.seeds):
        t = time.perf_counter()
        cell = bench.Cell.load(a.workload, seed, a.seconds, False, t)
        cell.sequence = lambda s, d, seq=made.pop(seed): seq
        mode = bench.load_module("modes", cell.workload["mode"])
        if a.backend_only:
            prog, ctl, closures = backend_only(cell, mode, i < a.control_seeds)
            print(json.dumps(dict(workload=a.workload, seed=seed, program=prog, control=ctl,
                                  closures=closures, seconds=time.perf_counter() - t)),
                  flush=True)
            continue
        res = mode.run(cell)
        line = dict(workload=a.workload, seed=seed, program=res["gaps"], failed=res["failed"],
                    attempted=res["attempted"], e2e=res["e2e"], setup_s=res["setup_s"],
                    passes=len(res["records"]), closures=res["closures"],
                    corrections=[len(p["corrections"]) for p in res["records"]],
                    rounds=int(res["references"][0]["pos"].shape[1]),
                    ate_still_m=still_ate(res))
        if i < a.control_seeds:
            t1 = time.perf_counter()
            line["control"] = control_gaps(cell, res)
            line["control_s"] = time.perf_counter() - t1
        line["seconds"] = time.perf_counter() - t
        print(json.dumps({k: (float(v) if isinstance(v, np.floating) else v)
                          for k, v in line.items()}), flush=True)
        del res
    return 0


if __name__ == "__main__":
    sys.exit(main())
