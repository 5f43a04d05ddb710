"""The benchmark of malio_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's workload file (portbench/workloads/<cell>.json) names its
deployment (portbench/configs/<config>.json) and its mode, the driver
portbench/modes/<mode>.py. The run makes its inputs from the seed, warms
up every shape the cell uses, measures for --seconds, then holds what the
timed path produced against the plain reference (portbench/reference/).
With --trace 0 the result line carries the cell's end-to-end metrics of
BENCHMARK.json; with --trace 1 its per-layer metrics, each read by
portbench/metrics/<metric>.py from a torch.profiler trace or the
benchmark's own spans. The last line of standard output is the result
as one JSON object; earlier lines say more. A run needs a CUDA card and
exits with 2 without one, printing no result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from portbench.core import env  # noqa: E402

env.prepare()

from portbench.core import bench, check, trace  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_info():
    """The card's name, power limit and clocks as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out


def measure(cell, benchmark, device_kind, chips):
    """Drive the cell and reduce its run to the result line's fields."""
    e2e, per_layer = bench.metrics_of(cell.name, benchmark)
    mode = bench.load_module("modes", cell.workload["mode"])
    run = mode.run(cell)
    run["device_kind"] = device_kind
    metrics, units = {}, {m["name"]: m["unit"] for m in e2e + per_layer}
    if cell.trace:
        for m in per_layer:
            v = bench.load_module("metrics", m["name"]).read(run, cell)
            if v is not None:
                metrics[m["name"]] = v
    else:
        for m in e2e:
            v = run["setup_s"] if m["name"] == "setup_s" else run["e2e"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = v
    correct, rows = check.judge(run["gaps"], cell.workload["check"])
    correct = correct and run["failed"] == 0
    device = dict(platform="gpu", kind=device_kind, count=chips,
                  memory_peak_bytes=run["memory_peak_bytes"])
    result = dict(correct=bool(correct), attempted=int(run["attempted"]), failed=int(run["failed"]),
                  metrics={k: dict(value=v, unit=units[k]) for k, v in metrics.items()},
                  device=device)
    if cell.trace and run.get("trace"):
        device.update(busy_s=run["trace"]["busy_s"], window_s=run["trace"]["window_s"])
        result["breakdown"] = trace.breakdown(run["trace"])
    bench.log("counters: " + json.dumps(run.get("counters", {})))
    bench.log("gaps: " + json.dumps({k: v for k, v in run["gaps"].items()}))
    result["check"] = {n: dict(value=v, limit=lim) for n, v, lim in rows}
    result["check"]["failed_rounds"] = dict(value=run["failed"], limit=0)
    return result


def _finite(x):
    """The result with every number that is not finite written as a string
    ("inf", "nan"): the line stays JSON."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    return x


def main(argv=None, require_card=True, adjust=None):
    """A run; `require_card=False` and `adjust` (a function that edits the
    loaded cell) serve the CPU tests, which drive a run at a tiny size."""
    args = parse(argv)
    import torch

    if require_card and (not torch.cuda.is_available() or torch.cuda.device_count() < 1):
        bench.note("portbench: no CUDA card; a run measures only on a card")
        return 2
    cell = bench.Cell.load(args.workload, args.seed, args.seconds, bool(args.trace), T0,
                           device="cuda" if require_card else "cpu")
    if adjust is not None:
        adjust(cell)
    chips = int(cell.workload.get("chips", 1))
    if require_card and torch.cuda.device_count() < chips:
        bench.note(f"portbench: {cell.name} needs {chips} cards, this host has "
                   f"{torch.cuda.device_count()}")
        return 2
    benchmark = json.loads((env.ROOT / "BENCHMARK.json").read_text())
    kind = torch.cuda.get_device_name(0) if require_card else "cpu"
    bench.log(f"portbench {cell.name} seed {cell.seed} seconds {cell.seconds} trace "
              f"{int(cell.trace)}; torch {torch.__version__} cuda {torch.version.cuda}; "
              f"card {card_info() if require_card else 'none'}")
    if cell.trace and require_card:
        trace.warm()
    try:
        result = measure(cell, benchmark, kind, chips)
    finally:
        if cell.sampler is not None:  # a window that raised: stop nvidia-smi
            cell.sampler.stop()
    bad = env.forbidden_modules()
    if bad:
        bench.note(f"portbench: the run loaded {bad}; the benchmark may not load JAX or malio_tpu")
        return 3
    for n, c in result["check"].items():
        bench.note(f"check {n}: {c['value']!r} (limit {c['limit']!r})")
    bench.note(f"correct: {result['correct']}")
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
