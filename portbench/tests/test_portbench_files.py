"""The benchmark's data files: every configuration and workload parses,
its names and units keep the allowed characters, BENCHMARK.json names
only what exists, and a file added beside the others is found by name
with no code edited."""
from __future__ import annotations

import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
HERE = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = sorted(p.stem for p in (HERE / "configs").glob("*.json"))
WORKLOADS = sorted(p.stem for p in (HERE / "workloads").glob("*.json"))


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


@pytest.mark.parametrize("name", CONFIGS)
def test_config_parses(name):
    c = json.loads((HERE / "configs" / f"{name}.json").read_text())
    assert c["name"] == name and NAME.match(name)
    assert _line(c["source"])
    assert all(NAME.match(k) for k in c["reduced"])
    assert len(c["sensors"]["points"]) == c["config"]["num_lidars"]
    assert len(c["sensors"]["phase"]) == c["config"]["num_lidars"]
    from malio_tpu_torch.config import Config

    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in c["config"].items()}
    Config(**kw)  # every key is the program's


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_parses(name):
    w = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    assert w["name"] == name and NAME.match(name)
    assert w["config"] in CONFIGS
    assert (HERE / "modes" / f"{w['mode']}.py").exists()
    assert _line(w["why"])
    assert w["chips"] in (1, 4)
    assert w["check"] and all(NAME.match(k) and v > 0 for k, v in w["check"].items())


def test_benchmark_names_what_exists():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists() and c["name"] in CONFIGS
    for w in BENCH["workloads"]:
        data = json.loads((HERE / "workloads" / f"{w['name']}.json").read_text())
        assert data["config"] == w["config"] and data["chips"] == w["chips"] and _line(w["why"])
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
        assert _line(m["layer"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and all(m["moves"] in e2e for m in BENCH["per_layer"])


def test_a_new_workload_is_found_by_name(tmp_path):
    """A workload file copied in under a new name is a cell, with no code
    edited: the copy's harness loads it and its metrics by name."""
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    w = json.loads((HERE / "workloads" / "city3.replay.json").read_text())
    w.update(name="city3.replay_short", params=dict(w["params"], sequence_s=10.0))
    (tmp_path / "portbench" / "workloads" / "city3.replay_short.json").write_text(json.dumps(w))
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["workloads"].append(dict(name="city3.replay_short", config="city3", traffic="replay_short",
                               chips=1, why="a shorter drive"))
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m and "city3.replay" in m["workloads"]:
            m["workloads"].append("city3.replay_short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = ("import json, sys, time; sys.path.insert(0, '.');"
            "from portbench.core import bench;"
            "c = bench.Cell.load('city3.replay_short', 1, 1, False, time.perf_counter());"
            "e, p = bench.metrics_of(c.name, json.load(open('BENCHMARK.json')));"
            "[bench.load_module('metrics', m['name']) for m in p];"
            "print(c.params['sequence_s'], c.workload['mode'], len(e), len(p))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["10.0", "replay", "2", "6"]
