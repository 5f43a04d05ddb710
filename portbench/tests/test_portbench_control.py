"""The control: the reference put in the program's place and computed in
the nearest precision below the one the configuration states (the
workload's `control`, reference/replay.CONTROLS) comes out not correct by
the cell's own limits, on each cell's own inputs and sizes. TF32 exists
only on the card, so this is a card test:

    python3 -m pytest --noconftest -m cuda portbench/tests/test_portbench_control.py -q
"""
from __future__ import annotations

import pathlib
import time

import pytest

from portbench.core import env

env.prepare()

from portbench.core import bench, check  # noqa: E402
from portbench.reference import replay as reference  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
CELLS = sorted(p.stem for p in (ROOT / "portbench" / "workloads").glob("*.json"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_is_not_correct(cell_name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the control's precisions (TF32) exist only on a card")
    cell = bench.Cell.load(cell_name, 4_000_000_321, 30.0, False, time.perf_counter())
    p = cell.params
    seeds = [cell.seed + b for b in range(p.get("check_sequences", 1))]
    duration = p.get("sequence_s", cell.seconds + p.get("tail_s", 0.0))
    seqs = [cell.groups(imu, rounds) for imu, rounds, _ in cell.sequences(seeds, duration)]
    cfg = cell.reference_config()
    rounds = p.get("check_rounds", max(len(s) for s in seqs))  # the replays: the whole drive
    ref = reference.replay(cfg, seqs, rounds, device="cuda")
    ctl = reference.replay(cfg, seqs, rounds, device="cuda", control=cell.workload["control"])
    gaps = check.gaps(ctl, ref)
    # the numbers held against the reference (ate_m is held against the drive)
    limits = {k: v for k, v in cell.workload["check"].items() if k in gaps}
    correct, rows = check.judge(gaps, limits)
    assert not correct, rows
