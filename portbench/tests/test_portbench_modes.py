"""Each mode's driver runs a few rounds at a tiny size on the CPU with
the plain kernels, through the whole of a run (set-up, window, the check
against the reference, the result line), and the entry point refuses to
measure without a card. A run of the timed path broken underneath comes
out not correct: a step that returns its state unchanged, half of a
batch left out (its outputs the mean of the rest), a pose altered where
the round produces it."""
from __future__ import annotations

import contextlib
import io
import json
import pathlib

import numpy as np
import pytest
import torch

from portbench import run as bench_run  # noqa: F401  (sets the environment first)
from portbench.tests import tiny

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
CELLS = sorted(p.stem for p in (ROOT / "portbench" / "workloads").glob("*.json"))
SEED = 4_000_000_123  # more than 31 bits, as the driver's seeds are


def _run(cell, seed=SEED, seconds=3.0, require_card=False):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                             "--trace", "0"], require_card=require_card, adjust=tiny.adjust)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 else None), lines


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    rc, result, lines = _run("city3.replay", require_card=True)
    assert rc == 2 and result is None and not any(line.startswith("{") for line in lines)


@pytest.mark.parametrize("cell", CELLS)
def test_mode_runs_a_tiny_cell(cell):
    rc, result, _ = _run(cell)
    assert rc == 0
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert "setup_s" in result["metrics"] and len(result["metrics"]) == 2
    assert list(result)[-1] == "check"
    assert all(c["value"] <= c["limit"] for c in result["check"].values())


def _broken(monkeypatch, fault):
    from malio_tpu_torch import pipeline

    eager = pipeline.step_eager

    def step(cfg, carry, group, device="cuda", shard=None):
        new, out = eager(cfg, carry, group, device=device, shard=shard)
        if fault == "state_unchanged":
            return carry, out
        if fault == "answer_altered":
            return new, out._replace(pos=out.pos + 0.02)
        if fault == "half_batch":
            B = out.pos.shape[0] if out.pos.dim() == 2 else 1
            if B > 1:
                h = B // 2
                out = out._replace(**{f: torch.cat([getattr(out, f)[:h], getattr(out, f)[:h].mean(
                    0, keepdim=True).expand_as(getattr(out, f)[h:])]) for f in ("pos", "quat")})
            return new, out
        raise AssertionError(fault)

    monkeypatch.setattr(pipeline, "step_eager", step)


FAULTS = [(c, "state_unchanged") for c in CELLS] + [(c, "answer_altered") for c in CELLS] + [
    (c, "half_batch") for c in CELLS if "fleet" in c]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    _broken(monkeypatch, fault)
    rc, result, _ = _run(cell)
    assert rc == 0 and result["correct"] is False


def test_ate_is_the_rms_of_the_position_error():
    from portbench.core import check, generator

    traj = generator.Trajectory()
    t = np.linspace(1.0, 5.0, 9)
    off = np.zeros((9, 3))
    off[::2, 0], off[1::2, 1] = 0.03, -0.04
    assert check.ate(traj.pos(t) + off, t, traj) == pytest.approx(
        np.sqrt((5 * 0.03 ** 2 + 4 * 0.04 ** 2) / 9), rel=1e-12)
    off[4, 2] = np.nan
    assert check.ate(traj.pos(t) + off, t, traj) == float("inf")


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_off_its_drive_is_not_correct(cell):
    """ate_m is held too: a limit under what the tiny run reads fails it."""
    def adjust(c):
        tiny.adjust(c)
        c.workload["check"]["ate_m"] = 1e-6

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "3",
                             "--trace", "0"], require_card=False, adjust=adjust)
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and result["correct"] is False
    assert result["check"]["ate_m"]["value"] > 1e-6
