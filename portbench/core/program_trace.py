"""The program's own records, for the per-layer metrics that read them:
the stamps, host spans and counters of malio_tpu_torch/trace.py, taken
once a run by its `snapshot()` after the run (the only reader of the
tracer, which records all the time).

Every reading is of the run's untraced window: entries whose times, on
the host clock (time.perf_counter in ns), lie from `cell.window_t0` for
`run["window_s"]` seconds; a live run's window ends where its first traced
stretch begins (`cell.seconds - 2 * trace_s` into it). So no profiler
session overlaps what these metrics read.

A program without the tracer (a tree before it) gives nothing to read:
each function then returns None and raises nothing."""
from __future__ import annotations

import numpy as np

ROUND_STAGES = ("undistort", "downsample", "compact_evict", "uncertainty", "update", "insert")
_KEY = "program_trace"


def snapshot(run):
    """The tracer's snapshot, taken at the first call of a run and kept in
    `run`, each span's self time added (`spans["self"]`, ns); None where
    the program has no tracer."""
    if _KEY not in run:
        try:
            from malio_tpu_torch import trace
        except ImportError:
            run[_KEY] = None
        else:
            snap = trace.snapshot()
            snap["spans"]["self"] = trace.self_ns(snap["spans"])
            run[_KEY] = snap
    return run[_KEY]


def window_ns(run, cell):
    """(start, end) of the untraced window on the host clock, in ns."""
    t0 = cell.window_t0
    if cell.workload["mode"] == "live" and cell.trace:
        t1 = t0 + cell.seconds - 2 * cell.params["trace_s"]
    else:
        t1 = t0 + run["window_s"]
    return int(t0 * 1e9), int(t1 * 1e9)


def rounds(run, cell):
    """The round replays whose 7 stamps lie inside the window: (n, 7) host
    ns, or None."""
    snap = snapshot(run)
    if snap is None:
        return None
    lo, hi = window_ns(run, cell)
    pid = {v: k for k, v in snap["programs"].items()}.get("round")
    rows = []
    for s in snap["stamps"].values():
        t = s["t"][s["program"] == pid][:, :7]
        rows.append(t[(t > 0).all(axis=1) & (t[:, 0] >= lo) & (t[:, 6] <= hi)])
    t = np.concatenate(rows) if rows else np.zeros((0, 7), np.int64)
    return t if len(t) else None


def round_ms(run, cell):
    """The median round replay, first to last stamp, in ms."""
    t = rounds(run, cell)
    return None if t is None else float(np.median(t[:, 6] - t[:, 0])) / 1e6


def stage_ms(run, cell, stage):
    """The median of one stage's intervals over the window's rounds, ms."""
    t = rounds(run, cell)
    if t is None:
        return None
    k = ROUND_STAGES.index(stage)
    return float(np.median(t[:, k + 1] - t[:, k])) / 1e6


def off_graph_pct(run, cell):
    """100 (1 - the summed round replays / the window)."""
    t = rounds(run, cell)
    if t is None:
        return None
    lo, hi = window_ns(run, cell)
    return 100.0 * (1.0 - float(np.sum(t[:, 6] - t[:, 0])) / (hi - lo))


def spans(run, cell, name):
    """The closed spans named `name` inside the window, with the self time
    of each (`self`, ns), or None."""
    snap = snapshot(run)
    if snap is None:
        return None
    sp = snap["spans"]
    lo, hi = window_ns(run, cell)
    keep = (sp["name"] == name) & (sp["start"] >= lo) & (sp["end"] <= hi)
    return {k: v[keep] for k, v in sp.items()} if keep.any() else None


def counted(run, cell, name):
    """The change of counter `name` over the window, or None."""
    snap = snapshot(run)
    if snap is None:
        return None
    lo, hi = window_ns(run, cell)
    c = snap["counts"]
    keep = (c["name"] == name) & (c["t"] >= lo) & (c["t"] <= hi)
    return int(np.sum(c["n"][keep])) if keep.any() else None


def span_table(run, cell, prefix):
    """Median ms, median self ms and count of each span whose name starts
    with `prefix`, over the window, for the run's log."""
    snap = snapshot(run)
    if snap is None:
        return None
    names = sorted({n for n in snap["spans"]["name"] if n.startswith(prefix)})
    out = {}
    for n in names:
        sp = spans(run, cell, n)
        if sp is not None:
            out[n] = dict(ms=float(np.median(sp["end"] - sp["start"])) / 1e6,
                          self_ms=float(np.median(sp["self"])) / 1e6, n=int(len(sp["id"])))
    return out


def stage_table(run, cell):
    """Each stage's median ms, its share of the summed stage medians and
    the graph nodes the capture counted between its stamps
    (graph_nodes.round.<stage>), for the run's log."""
    t = rounds(run, cell)
    snap = snapshot(run)
    if t is None:
        return None
    med = np.median(np.diff(t, axis=1), axis=0) / 1e6
    nodes = snap["counters"]
    return [dict(stage=s, ms=float(m), share_pct=float(100.0 * m / med.sum()),
                 nodes=nodes.get(f"graph_nodes.round.{s}"))
            for s, m in zip(ROUND_STAGES, med)]
