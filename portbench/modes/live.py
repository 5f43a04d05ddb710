"""Live: online.OnlineEstimator fed in an open loop at the rig's own rates,
paced by the wall clock and never slowed by the system: each IMU sample
at its time, each scan at its end time. After every push that fuses a
round the benchmark calls poll(). A round's latency runs from the
scheduled time of the push that made it ready to poll() returning its
pose, so the lateness of the pushes that a slow round causes counts in
the rounds after it; pose_latency_p50_ms is the median over every round
of the window. The sequence is the window plus `tail_s` long.

A round is due when all of its data has arrived `ready_margin_s` before
the window closes; a due round without a finite pose, and a dropped
scan, count as failed.

After the window the first `check_rounds` polled rounds are held
against the reference, and every polled round against the drive the
inputs were made from (check.ate). A traced run traces the window's
end: `trace_s` seconds with the device's activities alone, for the
numbers, then `trace_s` seconds with the host's operations too, for the
labels of the idle gaps (core/trace.py); closing the first session holds
the feed up for seconds, so the second stretch shows the catch-up. The
host-clock spans (live.push_ms, live.poll_ms) cover the window up to the
first traced stretch, and so do the latencies of `live.latency_ms`,
which the per-layer live.pose_latency_p95_ms reads: in a traced run the
catch-up after the traced stretches would set that tail.

Workload parameters: tail_s, warmup_s (the set-up's unpaced feed, which
captures the round), ready_margin_s, check_rounds, trace_s."""
from __future__ import annotations

import math
import time

import numpy as np

from portbench.core import check, trace
from portbench.core.bench import log
from portbench.modes.replay import counters, init_groups
from portbench.reference import replay as reference

POLLED = ("pos", "quat", "pose_cov", "end_time", "iterations", "n_effective", "map_size")


def _events(imu, rounds, until):
    """The feed in arrival order up to `until` (s): (t, kind, payload)."""
    ev = [(float(r[0]), 0, ("imu", r)) for r in imu if r[0] <= until]
    for rnd in rounds:
        for l, s in enumerate(rnd):
            if s["end_t"] <= until:
                rel = s["pts"].copy()
                rel[:, 3] -= s["beg_t"]
                ev.append((float(s["end_t"]), 1, ("scan", (l, s["beg_t"], rel,
                                                           s["end_t"] - s["beg_t"]))))
    ev.sort(key=lambda e: (e[0], e[1]))
    return ev


def _push(est, payload):
    kind, x = payload
    if kind == "imu":
        est.push_imu(x[0], x[1:4], x[4:7])
    else:
        est.push_scan(x[0], x[1], x[2], duration=x[3])


def run(cell):
    import torch
    from malio_tpu_torch import graph
    from malio_tpu_torch.online import OnlineEstimator

    p = cell.params
    cfg = cell.program_config()
    T = cell.seconds
    imu, rounds, traj = cell.sequence(cell.seed, T + p["tail_s"])
    groups = cell.groups(imu, rounds)
    n_init = init_groups(groups)
    feed = _events(imu, rounds, T)
    # set-up: an unpaced feed of the start captures the round and polls it
    warm = OnlineEstimator(cfg, dtype=torch.float32, device=cell.device)
    for t, _, payload in feed:
        if t > p["warmup_s"]:
            break
        _push(warm, payload)
    warm.poll()
    del warm
    lookahead = cell.config["config"]["sync_lookahead"]
    imu_t = imu[:, 0]
    due = 0
    for g in groups[n_init:]:
        end = float(np.max(g["end_t"]))
        nxt = imu_t[np.searchsorted(imu_t, end + lookahead - 1e-9)] if imu_t[-1] >= end + lookahead \
            else np.inf
        due += bool(max(end, nxt) <= T - p["ready_margin_s"])

    est = OnlineEstimator(cfg, dtype=torch.float32, device=cell.device)
    push_ms, poll_ms, late, latency, polled, untraced = [], [], [], [], [], []
    # the traced stretches: (start, end, host) in the window's seconds
    stretches = [(T - 2 * p["trace_s"], T - p["trace_s"], False),
                 (T - p["trace_s"], math.inf, True)] if cell.trace else []
    segs, marks = [], []
    setup_s = cell.start_window()
    w0 = cell.window_t0
    for t, _, payload in feed:
        if segs and len(marks) % 2 == 1 and t >= stretches[len(segs) - 1][1]:
            segs[-1].end()
            marks.append(len(polled))
        if len(segs) < len(stretches) and t >= stretches[len(segs)][0]:
            marks.append(len(polled))
            segs.append(trace.Segment(host=stretches[len(segs)][2]))
            segs[-1].start()
        wait = w0 + t - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        a = time.perf_counter()
        late.append(a - (w0 + t))
        n0 = est.n_rounds
        _push(est, payload)
        b = time.perf_counter()
        if not segs:
            push_ms.append((b - a) * 1e3)
        if est.n_rounds > n0:
            out = est.poll()
            c = time.perf_counter()
            if not segs:
                poll_ms.append((c - b) * 1e3)
            for r in out:
                latency.append((c - (w0 + t)) * 1e3)
                polled.append(r)
                if not segs:
                    untraced.append(latency[-1])
    window_s = cell.end_window()
    summary = None
    if len(segs) == 2:
        segs[1].end()
        marks.append(len(polled))
        numbers, labels = (sg.reduce(rounds=marks[2 * i + 1] - marks[2 * i])
                           for i, sg in enumerate(segs))
        summary = trace.labelled(numbers, labels)
    peak = cell.memory_peak()
    got = {f: np.asarray([r["t" if f == "end_time" else f] for r in polled])[None] for f in POLLED}
    ok = np.all(np.isfinite(got["pos"][0]), axis=-1) if polled else np.zeros(0, bool)
    failed = max(0, due - int(np.sum(ok[:due]))) + est.n_dropped_scans
    lat = np.asarray(latency)
    result = dict(setup_s=setup_s, window_s=window_s, memory_peak_bytes=peak,
                  e2e=dict(pose_latency_p50_ms=float(np.median(lat)) if lat.size else None),
                  attempted=due, failed=failed, batch=1,
                  spans={"live.push_ms": push_ms, "live.poll_ms": poll_ms,
                         "live.latency_ms": untraced},
                  trace=summary)
    lt = np.asarray(late) * 1e3
    log(f"live: {len(polled)} rounds polled ({due} due), {est.n_dropped_scans} scans dropped, "
        f"{len(feed)} pushes in {window_s:.3f} s; latency p50 {np.median(lat):.3f} ms, p95 "
        f"{np.percentile(lat, 95):.3f} ms, max {lat.max():.3f} ms over {lat.size} rounds; pushes "
        f"late p50 {np.median(lt):.3f} ms, p95 {np.percentile(lt, 95):.3f} ms, max {lt.max():.3f} "
        f"ms; poll p50 {np.median(poll_ms):.3f} ms; set-up {setup_s:.3f} s")
    result["counters"] = counters(graph)
    del est
    cell.release(graph)

    want = min(p["check_rounds"], len(polled))
    t_ref = time.perf_counter()
    ref = reference.replay(cell.reference_config(), [groups], want, device=cell.device)
    log(f"reference: {ref['pos'].shape[1]} rounds of {ref['pos'].shape[0]} sequences in "
        f"{time.perf_counter() - t_ref:.3f} s")
    result["gaps"] = check.gaps(
        {f: v[:, :want] for f, v in got.items()},
        {f: ref[f][:, :want] for f in POLLED})
    result["gaps"]["ate_m"] = (check.ate(got["pos"][0], got["end_time"][0], traj) if polled
                               else math.inf)
    result.update(reference=ref, reference_inputs=[groups], trajectories=[traj])
    return result
