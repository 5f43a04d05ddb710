"""The per-layer metrics that read the program's own records
(core/program_trace.py over malio_tpu_torch/trace.py): each tiny cell run
with --trace 1 on the CPU reads every such metric its BENCHMARK.json
entry lists for the cell as a finite number (the profiler's segments,
which need a card, stubbed out: their metrics read nothing here); and
with the program's tracer missing, as in a tree before it, every reader
returns None and raises nothing."""
from __future__ import annotations

import contextlib
import io
import json
import math
import pathlib
import sys

import pytest
import torch

from portbench import run as bench_run  # noqa: F401  (sets the environment first)
from portbench.core import bench, program_trace
from portbench.tests import tiny

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 4_000_000_321


def _reads_program_trace(name):
    return "program_trace" in (ROOT / "portbench" / "metrics" / f"{name}.py").read_text()


NEW = [m for m in BENCH["per_layer"] if _reads_program_trace(m["name"])]
CELLS = sorted({c for m in NEW for c in m["workloads"]})


class _NoSegment:
    """A profiler segment that records nothing (a trace needs a card)."""

    def __init__(self, host=True):
        pass

    def start(self):
        pass

    def end(self):
        pass

    def reduce(self, rounds):
        return None

    def stop(self, rounds):
        return None


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_every_reader_of_the_program_trace_is_listed():
    assert {m["name"] for m in NEW} >= {
        "round_graph_ms.window", "off_graph_pct.window", "runner.marshal_ms",
        "runner.host_copies", "live.round_graph_ms_p50", "live.fuse_ms_p50",
        *(f"stage_{s}_ms.window" for s in program_trace.ROUND_STAGES)}
    assert all("workloads" in m for m in NEW)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_tiny_run_reads_every_new_metric(cell, monkeypatch):
    from portbench.core import trace

    monkeypatch.setattr(trace, "Segment", _NoSegment)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "3",
                             "--trace", "1"], require_card=False, adjust=tiny.adjust)
    assert rc == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is True
    want = {m["name"] for m in NEW if cell in m["workloads"]}
    got = result["metrics"]
    assert want <= set(got), want - set(got)
    for name in want:
        v = got[name]["value"]
        assert isinstance(v, float) and math.isfinite(v), (name, v)
    if "off_graph_pct.window" in want:
        assert 0.0 <= got["off_graph_pct.window"]["value"] < 100.0
    if "round_graph_ms.window" in want:
        stages = sum(got[f"stage_{s}_ms.window"]["value"] for s in program_trace.ROUND_STAGES)
        assert stages == pytest.approx(got["round_graph_ms.window"]["value"], rel=0.2)


def test_without_the_program_tracer_every_reader_returns_none(monkeypatch):
    import malio_tpu_torch

    monkeypatch.delattr(malio_tpu_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "malio_tpu_torch.trace", None)
    cell = bench.Cell.load("city3.live", SEED, 3.0, True, 0.0, device="cpu")
    cell.window_t0 = 1.0
    for m in NEW:
        run = dict(window_s=3.0, attempted=10, spans={})
        assert bench.load_module("metrics", m["name"]).read(run, cell) is None, m["name"]
