"""The loop cell's limits on a card: the back end's control (`f32_backend`:
the plain back end computed in float32 on the run's own recorded passes,
reference/backend.py) comes out not correct by the cell's limits, and the
program is correct on two seeds, every whole pass closing a loop and
feeding a correction back. The window is cut to one whole pass, so a
test takes a few minutes:

    python3 -m pytest --noconftest -m cuda portbench/tests/test_portbench_loop_control.py -q
"""
from __future__ import annotations

import pathlib
import time

import pytest

from portbench.core import env

env.prepare()

from portbench.core import bench, check  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
CELLS = sorted(p.stem for p in (ROOT / "portbench" / "workloads").glob("*.json")
               if bench.load_json(p).get("mode") == "loop")


def _run(cell_name, seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the loop cell measures on a card")
    cell = bench.Cell.load(cell_name, seed, 1.0, False, time.perf_counter())
    mode = bench.load_module("modes", cell.workload["mode"])
    return cell, mode, mode.run(cell)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_the_backend_control_is_not_correct(cell_name):
    cell, mode, res = _run(cell_name, 4_000_000_417)
    dtype = mode.BACKEND_CONTROLS[cell.workload["backend_control"]]
    bk = mode.backend_params(cell.config)
    gaps = {}
    for p in res["records"]:
        g = mode.compare_backend(p, mode.reference_backend(p, bk, dtype),
                                 mode.reference_backend(p, bk), bk)
        gaps = check.worst(gaps, g) if gaps else g
    limits = {k: v for k, v in cell.workload["check"].items() if k in gaps}
    correct, rows = check.judge(gaps, limits)
    assert not correct, rows


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("seed", [4_000_000_501, 4_000_000_502])
def test_the_program_is_correct(cell_name, seed):
    cell, _, res = _run(cell_name, seed)
    correct, rows = check.judge(res["gaps"], cell.workload["check"])
    assert correct and res["failed"] == 0, rows
    for p in res["records"]:
        assert p["pairs"] and p["corrections"], (len(p["pairs"]), len(p["corrections"]))
