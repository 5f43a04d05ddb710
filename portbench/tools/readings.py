"""The readings that a cell's limits are set from (README.md, "How
correct is decided"): for each seed, one run of the cell's timed path
with a short window and its numbers against the reference (the lower
readings), and the cell's control (the workload's `control`: the
reference put in the program's place and computed in a lower precision
than the configurations state, reference/replay.CONTROLS) against the
same reference on the same rounds (the upper readings). Beside them,
`ate_still_m`: the ate_m of a pose that never leaves the start, as a
step that returns its state unchanged would give it. One process for all
seeds, so the set-up is paid once.

    python3 portbench/tools/readings.py --workload city3.replay --seconds 5 \
        --seeds 11 12 13 [--control-seeds 3]

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

from portbench.core import bench, check  # noqa: E402
from portbench.reference import replay as reference  # noqa: E402


def control_gaps(cell, res):
    """The control's numbers on the rounds the run compared."""
    ref = res["reference"]
    ctl = reference.replay(cell.reference_config(), res["reference_inputs"], ref["pos"].shape[1],
                           device=cell.device, control=cell.workload["control"])
    return check.gaps(ctl, ref)


def still_ate(res):
    """ate_m of poses held at each sequence's first compared position."""
    ref = res["reference"]
    return max(check.ate(ref["pos"][s, :1].repeat(ref["pos"].shape[1], 0), ref["end_time"][s], traj)
               for s, traj in enumerate(res["trajectories"]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    a = ap.parse_args(argv)
    for i, seed in enumerate(a.seeds):
        t = time.perf_counter()
        cell = bench.Cell.load(a.workload, seed, a.seconds, False, t)
        mode = bench.load_module("modes", cell.workload["mode"])
        res = mode.run(cell)
        line = dict(workload=a.workload, seed=seed, program=res["gaps"], failed=res["failed"],
                    attempted=res["attempted"], e2e=res["e2e"], setup_s=res["setup_s"],
                    rounds=int(res["reference"]["pos"].shape[1]), ate_still_m=still_ate(res))
        if i < a.control_seeds:
            t1 = time.perf_counter()
            line["control"] = control_gaps(cell, res)
            line["control_s"] = time.perf_counter() - t1
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
