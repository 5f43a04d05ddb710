#!/usr/bin/env python3
"""Smoke run of malio_tpu_torch on one NVIDIA card.

Builds the CUDA kernels from malio_tpu_torch/csrc/, drives the City 3-LiDAR
flagship through runner.run_sequence with both kernels on (launch counters
set to 0 just before and read just after), checks the trajectory against
the synthetic ground truth, then holds each kernel against its plain
PyTorch version on the card at the main path's shapes: the fused k-NN
window kernel on the map that run built and on one of its rounds' queries
(bit-equal, also with ties, exhausted rows, all-invalid windows, masked
queries and duplicate rows planted), the deskew kernel within atol 2e-5
(for coordinates under 64 m) with equal ok flags, compared with the world
origin at the scan-end position: on that run's last-round points, spline and frames, and on
seeded inputs at the path's shape (3 x 4096 points, 64 control points),
at the Config default (1 x 65,536, 96) and at 3 x 65,536, in both of its
layouts, whose crossover a sweep of point counts measures. Each kernel is timed on the device alone (the CUPTI kernel
events of torch.profiler, median of >= 30 launches) and per wrapper call
(CUDA events around 100 back-to-back calls). It times the whole k-NN stage
(`voxel_hash.knn_cached`), re-runs the first rounds with the plain
versions, and traces a few steady rounds with torch.profiler to show where
a round's time goes. Any failure exits non-zero; the last line is the
device summary.

    python3 chip_smoke.py                               # the smoke run
    python3 chip_smoke.py --save-stage-inputs FILE      # ... keeping the map, the
                                                        # queries and the deskew inputs
    python3 chip_smoke.py --knn-stage TREE --inputs FILE  # time knn_cached of the
                                                        # package in TREE on them
    python3 chip_smoke.py --deskew-kernel TREE [--inputs FILE] [--outputs FILE]
                                                        # time the deskew kernel of the
                                                        # package in TREE
    python3 chip_smoke.py --trace-check SECONDS [--lead-in S]  # count profiler
                                                        # traces that lose device events

Writes per-round and build details to chiprun_out/chip_smoke.json.
"""
import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
ATE_GATE_M = 0.05
PLAIN_ROUNDS = 20
PLAIN_TOL_M = 0.01
ROW_BYTES = 32 * 5 * 4  # one hash-table row: 32 slots of [fp, x, y, z, cov] f32
# f32 operations per point of csrc/deskew.cu, counted from its source:
# inside the spline window 3 SE(3) exps (~80 each), 3 pose compositions
# (~60 each), 2 quaternion-to-matrix conversions (~25 each), 4 frame maps
# (~15 each) and the basis weights; outside it only the interval test
DESKEW_OPS_PER_POINT = 560
DESKEW_OPS_OUTSIDE = 10
# f32 operations per live lane of csrc/knn_window.cu: 3 sub, 3 mul, 2 add
KNN_OPS_PER_LANE = 8
TRACE_LEAD_IN_S = 0.02  # host time between a profiler session's start and its first call
TRACE_ATTEMPTS = 5
TRACES = []  # one entry per profiler trace: calls (or rounds), events, markers found
# max |deskew kernel - plain| for coordinates under 64 m (about 5 ulp of
# them); it doubles with the ulp past that (deskew_atol)
DESKEW_ATOL = 2e-5


def log(*a):
    print(*a, flush=True)


def call_ms(fn, n=100, warm=3):
    """Time of one wrapper call, host work included: CUDA events around n
    back-to-back calls, divided by n."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def _trace(fn, n, warm):
    """Device activities of one torch.profiler session, in start order:
    warm-up calls, then n calls with a marker kernel before each and
    after the last."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_LEAD_IN_S)
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        for _ in range(n):
            torch.cuda._sleep(1000)
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    return sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: e.time_range.start)


def device_events(fn, n, warm=3):
    """For each of n calls of fn, the (name, microseconds) of its device
    activities (kernels, copies, memsets) from torch.profiler's CUPTI
    trace: those between two marker kernels, on the one stream the calls
    use.

    Now and then a session places its device events a few ms before
    their host launches and drops those that then fall before the trace
    start, up to all of them (`--trace-check` counts how often). The
    lead-in keeps the calls away from the start, and a trace is taken
    again, up to TRACE_ATTEMPTS times, unless it holds all n + 1 markers
    and the same number of activities in every call; each retake is
    logged and counted."""
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        ev = _trace(fn, n, warm)
        marks = [i for i, e in enumerate(ev) if "spin_kernel" in e.name]
        calls = [[(e.name, e.time_range.elapsed_us()) for e in ev[a + 1 : b]]
                 for a, b in zip(marks, marks[1:])]
        sizes = sorted({len(c) for c in calls})
        ok = len(marks) == n + 1 and len(sizes) == 1
        TRACES.append(dict(calls=n, device_events=len(ev), markers=len(marks),
                           events_per_call=sizes, ok=ok))
        if ok:
            return calls
        log(f"torch.profiler trace {attempt} of {TRACE_ATTEMPTS} lost device events "
            f"({len(ev)} recorded, {len(marks)} of {n + 1} markers, {sizes} per call); "
            f"taking it again")
    raise AssertionError(f"torch.profiler lost device events in {TRACE_ATTEMPTS} traces in a row")


def kernel_ms(fn, name, n=50):
    """The device duration of one launch of the kernel whose name holds
    `name`: median over n calls of fn, each of which launches it once."""
    ds = [us for call in device_events(fn, n) for nm, us in call if name in nm]
    if len(ds) != n:
        raise AssertionError(f"{name}: {len(ds)} device events for {n} calls")
    return statistics.median(ds) / 1e3


def device_ms(fn, n=10):
    """Device time of one call of fn (the sum of its kernels' and copies'
    durations, mean over n calls) and its device activities per call."""
    calls = device_events(fn, n)
    return sum(us for c in calls for _, us in c) / n / 1e3, len(calls[0])


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def launch_floor_ms():
    """Device duration of the smallest kernel: a one-element add."""
    import torch

    x = torch.zeros(1, device="cuda")
    return kernel_ms(lambda: x.add_(1.0), "elementwise", n=50)


def edge_windows(tab, qs, rows, alive):
    """The path's inputs with the selection's edge cases planted: twin
    points (distance ties) in every third row, queries on stored points,
    all-invalid windows, masked-off queries (row 0, nothing alive),
    windows with fewer valid lanes than K where lane 0 is valid, invalid
    or dead, and duplicate rows left alive (every point ties its twin)."""
    tab, qs, rows, alive = tab.clone(), qs.clone(), rows.clone(), alive.clone()
    V = rows.shape[1]
    occ = tab[..., 0] != 0
    twin = occ[:, 2] & occ[:, 7]
    twin[1::3] = False
    twin[2::3] = False
    tab[twin, 7, 1:4] = tab[twin, 2, 1:4]
    ra, rb = 11, 12  # two sparse rows: slot 0 occupied / empty
    tab[ra, :, 0] = 0
    tab[ra, [0, 3, 9], 0] = 1.0
    tab[ra, [0, 3, 9], 4] = 0.05
    tab[rb, :, 0] = 0
    tab[rb, [4, 11], 0] = 1.0
    tab[rb, [4, 11], 4] = 0.07
    alive[::97] = False
    rows[1::89] = 0
    alive[1::89] = False
    rows[2::61, 0] = ra
    alive[2::61, 1:] = False
    rows[3::67, 0] = rb
    alive[3::67, 1:] = False
    alive[4::71, 0] = False
    if V > 2:
        rows[5::53, 1] = rows[5::53, 0]
        alive[5::53, :2] = True
    qs[6::59] = tab[rows[6::59, 0], 2, 1:4]
    return tab, qs, rows, alive


def check_window(name, args, K):
    """The fused kernel against knn_window_plain on the same inputs, bit
    for bit. Returns the largest |difference| (0) and what the case
    exercised."""
    import torch
    from malio_tpu_torch.ops import knn

    got = knn.knn_window(*args, K)
    want = knn.knn_window_plain(*args, K)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("pts", "covs", "d2")):
        if not torch.equal(g, w):
            bad = int((g != w).sum())
            raise AssertionError(f"{name}: kernel {what} differs from plain at {bad} entries")
    d2 = want[2]
    big = torch.finfo(d2.dtype).max
    live = d2 < big
    stats = dict(
        exhausted_slots=int((~live).sum()), empty_windows=int((~live[:, 0]).sum()),
        ties=int(((d2[:, 1:] == d2[:, :-1]) & live[:, 1:]).sum()),
    )
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return err, stats


def knn_phase(m, queries, qmask, cfg, K):
    """The fused k-NN window kernel at the path's shapes, on the map the
    main path built and one of its rounds' queries: the base window over
    every measurement lane, and the wide window over the first live
    queries at the path's tier (256) and at the full budget."""
    import torch
    from malio_tpu_torch.map import voxel_hash as vh
    from malio_tpu_torch.ops import knn

    live = queries[qmask].contiguous()
    shapes = [
        ("knn_window", queries, cfg.knn_radius, qmask),
        ("knn_window_wide", live[:256], cfg.knn_wide_radius, None),
        ("knn_window_wide_budget", live[: cfg.knn_wide_budget], cfg.knn_wide_radius, None),
    ]
    big = torch.finfo(torch.float32).max
    rows_out = []
    for name, q, radius, mask in shapes:
        q = q.contiguous()
        b, alive = vh._window_rows(m, q, radius, mask)
        args = (m.tab, q, b, alive)
        Q, V = b.shape
        err, stats = check_window(name, args, K)
        err_e, stats_e = check_window(name + " (edge cases)", edge_windows(*args), K)
        for key in ("exhausted_slots", "empty_windows", "ties"):
            if stats_e[key] == 0:
                raise AssertionError(f"{name}: the edge inputs exercised no {key}")
        ms = kernel_ms(lambda: knn.knn_window(*args, K), "knn_window_")
        c_ms = call_ms(lambda: knn.knn_window(*args, K))
        p_ms, p_ops = device_ms(lambda: knn.knn_window_plain(*args, K))
        p_call = call_ms(lambda: knn.knn_window_plain(*args, K), n=10)

        # library yardstick: torch.topk + gather on the precomputed masked d2
        win = m.tab[b]
        occ = ((win[..., 0] != 0) & alive[..., None]).reshape(Q, V * 32)
        cpts = win[..., 1:4].reshape(Q, V * 32, 3).contiguous()
        ccov = torch.where(occ, win[..., 4].reshape(Q, V * 32), 0.0)
        d2 = torch.where(occ, vh._sqdist(cpts, q[:, None, :]), big)
        del win

        def library():
            v, i = torch.topk(d2, K, dim=-1, largest=False, sorted=True)
            return torch.gather(cpts, 1, i[..., None].expand(Q, K, 3)), torch.gather(ccov, 1, i), v

        l_ms, _ = device_ms(library)
        l_call = call_ms(library, n=30)
        del d2, cpts, ccov
        touched = int(torch.unique(torch.cat([b[alive], b[:, 0]])).numel())
        n_lanes = int((m.tab[..., 0] != 0).sum(1)[b][alive].sum())
        nbytes = touched * ROW_BYTES + Q * 12 + Q * V * 9 + Q * K * 20
        b_ms, b_by = bound(nbytes, n_lanes * KNN_OPS_PER_LANE)
        rows_out.append(dict(
            name=name, route="cuda", source="malio_tpu_torch/csrc/knn_window.cu",
            replaces="malio_tpu/ops/knn_pallas.py:88", shape=f"Q={Q} V={V} K={K}", Q=Q, V=V,
            max_abs_err=max(err, err_e), ms=ms, call_ms=c_ms, plain_ms=p_ms, plain_call_ms=p_call,
            plain_device_ops=p_ops, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
            touched_rows=touched, live_lanes=n_lanes, library_ms=l_ms, library_call_ms=l_call,
            cases=stats, edge_cases=stats_e,
        ))
        log(f"kernel {name} Q={Q} V={V} K={K}: bit-equal to plain (path inputs {stats}, "
            f"edge inputs {stats_e}); device {ms:.4f} ms, call {c_ms:.4f} ms (plain device "
            f"{p_ms:.4f} ms in {p_ops:.0f} device ops, call {p_call:.4f} ms; torch.topk+gather "
            f"device {l_ms:.4f} ms, call {l_call:.4f} ms); bound {b_ms:.5f} ms by {b_by} "
            f"({touched} distinct rows, {nbytes} B)")
    return rows_out


def deskew_inputs(L, N, C, seed):
    import numpy as np
    import torch
    from malio_tpu_torch import spline as spl
    from malio_tpu_torch.geometry import se3, so3

    rng = np.random.default_rng(seed)
    dev = "cuda"
    xi = torch.tensor([0.2, -0.1, 0.3, 1.0, 0.5, -0.2], dtype=torch.float32, device=dev)
    ts = torch.arange(C, dtype=torch.float32, device=dev) * 0.01
    Ts = se3.exp_se3(ts[:, None] * xi[None])
    sp = spl.feed_trajectory(ts, so3.mat_to_quat(Ts[:, :3, :3]), Ts[:, :3, 3].contiguous(),
                             torch.ones(C, dtype=torch.bool, device=dev), cap=C)
    pts = np.concatenate(
        [rng.normal(size=(L, N, 3)) * 10, rng.uniform(-0.05, 0.7, size=(L, N, 1))], -1
    ).astype(np.float32)
    small = lambda s: torch.as_tensor(rng.normal(size=(L, 3)) * s, dtype=torch.float32, device=dev)
    return (torch.as_tensor(pts, device=dev), sp, so3.exp_so3(small(0.2)), small(0.5),
            so3.exp_so3(small(0.1)), small(1.0))


def recentred(args):
    """deskew_points arguments with the world origin moved to LiDAR 0's
    scan-end position. The deskew sees world positions only relative to
    one another, so its result is the same; f32 then rounds at the scale
    of the points and the trajectory's excursion, not of where the map
    happens to sit (the plain version composes the spline in world
    coordinates, the kernel relative to the scan-end position)."""
    pts, sp, ext_q, ext_t, lt_q, lt_t = args
    o = lt_t[0].clone()
    cps = sp.cps.clone()
    cps[:, :3, 3] -= o
    return (pts, sp._replace(cps=cps), ext_q, ext_t, lt_q, (lt_t - o).contiguous())


def deskew_atol(args):
    """DESKEW_ATOL scaled to the ulp of the largest coordinate the deskew
    of recentred args can hold (the points' range, plus the spline's
    excursion from the scan-end position and the extrinsic's offset): f32
    round-off grows with it."""
    import math

    pts, sp, _, ext_t = args[:4]
    scale = float(pts[..., :3].abs().max() + sp.cps[:, :3, 3].abs().max() + ext_t.abs().max())
    return DESKEW_ATOL * 2.0 ** max(0, math.floor(math.log2(max(scale, 1.0))) - 5)


def deskew_err(deskew, args, fn):
    """fn (a deskew kernel launch) against deskew_points_plain on args
    recentred: whether the ok flags are equal, max |kernel - plain|, its
    limit (deskew_atol) and the plain result."""
    import torch

    args = recentred(args)
    got, want = fn(*args), deskew.deskew_points_plain(*args)
    torch.cuda.synchronize()
    return (bool(torch.equal(got[..., 3], want[..., 3])),
            float((got[..., :3] - want[..., :3]).abs().max()), deskew_atol(args), want)


def deskew_check(args, lanes=None):
    """The deskew kernel (the wrapper's layout, or `lanes` per point)
    against deskew_points_plain on args: equal ok flags, max |kernel -
    plain| <= deskew_atol. Returns that max, its limit and the plain
    result."""
    from malio_tpu_torch.ops import deskew

    fn = deskew.deskew_points if lanes is None else (
        lambda *a: deskew._launch(*a, lanes=lanes))
    same_ok, err, atol, want = deskew_err(deskew, args, fn)
    what = "default layout" if lanes is None else f"lanes={lanes}"
    if not same_ok:
        raise AssertionError(f"deskew ({what}): ok flags differ from plain")
    if not err <= atol:
        raise AssertionError(f"deskew ({what}): max |kernel - plain| = {err} > {atol}")
    return err, atol, want


def deskew_phase(name, args, floor):
    """The deskew kernel on args (L, N points, C control points): checked
    against its plain version and timed alone on the device, per wrapper
    call, and in both of its layouts (three lanes a point with the spline
    read through the read-only cache, one lane with it staged in shared
    memory); the bound is computed from these inputs."""
    import torch
    from malio_tpu_torch.ops import deskew

    pts, sp = args[0], args[1]
    L, N, C = pts.shape[0], pts.shape[1], sp.cps.shape[0]
    err, atol, want = deskew_check(args)
    ms = kernel_ms(lambda: deskew.deskew_points(*args), "deskew_kernel")
    c_ms = call_ms(lambda: deskew.deskew_points(*args))
    p_ms, p_ops = device_ms(lambda: deskew.deskew_points_plain(*args))
    p_call = call_ms(lambda: deskew.deskew_points_plain(*args), n=10)
    layouts = {}
    for lanes in (1, 3):
        e, _, _ = deskew_check(args, lanes=lanes)
        layouts[f"lanes={lanes}"] = dict(
            ms=kernel_ms(lambda: deskew._launch(*args, lanes=lanes), "deskew_kernel"),
            max_abs_err=e)
    # the same points with no valid interval: loads, the interval test and
    # stores only, what a launch costs before any spline arithmetic
    none_ok = (pts, sp._replace(num_valid=torch.full_like(sp.num_valid, 3))) + tuple(args[2:])
    empty_ms = kernel_ms(lambda: deskew.deskew_points(*none_ok), "deskew_kernel")
    n_ok = int(want[..., 3].sum())
    nbytes = L * N * 32 + C * (16 + 6) * 4 + L * 14 * 4 + 8  # points in+out, spline, frames
    nops = n_ok * DESKEW_OPS_PER_POINT + (L * N - n_ok) * DESKEW_OPS_OUTSIDE
    b_ms, b_by = bound(nbytes, nops)
    lanes = deskew.lanes_for(L * N)
    log(f"kernel {name} L={L} N={N} C={C} (lanes={lanes}): max |kernel - plain| {err:.3g} "
        f"(atol {atol:.3g}), ok flags equal ({n_ok}/{L * N} inside); device {ms:.5f} ms, "
        f"call {c_ms:.4f} ms (plain device {p_ms:.4f} ms in {p_ops:.0f} device ops, call "
        f"{p_call:.4f} ms); bound {b_ms:.6f} ms by {b_by}, {b_ms + floor:.6f} ms with the launch "
        f"floor; no point inside the window {empty_ms:.5f} ms; layouts "
        + ", ".join(f"{k} {v['ms']:.5f} ms" for k, v in layouts.items()))
    return dict(
        name=name, route="cuda", source="malio_tpu_torch/csrc/deskew.cu",
        replaces="malio_tpu/ops/deskew_pallas.py:197", shape=f"L={L} N={N} C={C}",
        shape_key=(L, N, C), lanes=lanes,
        max_abs_err=max([err] + [v["max_abs_err"] for v in layouts.values()]), atol=atol, ms=ms,
        call_ms=c_ms, plain_ms=p_ms, plain_call_ms=p_call, plain_device_ops=p_ops,
        bound_ms=b_ms, bound_by=b_by, bound_with_floor_ms=b_ms + floor, bytes=nbytes, ops=nops,
        points_inside=n_ok, library_ms=None, library_call_ms=None, layouts=layouts,
        empty_window_ms=empty_ms,
    )


# one LiDAR, the Config default's 96-entry spline: point counts on both
# sides of the layouts' crossover (65,536 is the Config default)
SWEEP_POINTS = (12288, 24576, 36864, 49152, 65536, 81920, 98304, 131072, 196608)


def deskew_layout_sweep():
    """Device time of each kernel layout over SWEEP_POINTS, on seeded
    inputs with the times in random order (as `deskew_inputs` draws them)
    and sorted (as a scan delivers them, so a warp's points share their
    interval): where three lanes a point stop paying."""
    import torch
    from malio_tpu_torch.config import Config
    from malio_tpu_torch.ops import deskew

    out = []
    for n in SWEEP_POINTS:
        for order in ("random", "sorted"):
            args = deskew_inputs(1, n, Config.spline_capacity, seed=1)
            if order == "sorted":
                pts = args[0]
                args = (pts[:, torch.argsort(pts[0, :, 3])].contiguous(),) + args[1:]
            row = dict(points=n, times=order, default_lanes=deskew.lanes_for(n))
            for lanes in (1, 3):
                deskew_check(args, lanes=lanes)
                row[f"lanes={lanes}"] = kernel_ms(
                    lambda: deskew._launch(*args, lanes=lanes), "deskew_kernel")
            out.append(row)
            log(f"deskew layouts, {n} points, {order} times: one lane {row['lanes=1']:.5f} ms, "
                f"three lanes {row['lanes=3']:.5f} ms (wrapper: {row['default_lanes']})")
    return out


def saved_deskew_args(d):
    """deskew_points arguments from the dict that --save-stage-inputs wrote."""
    from malio_tpu_torch import spline as spl

    sp = spl.Spline(t0=d["t0"], cps=d["cps"], logs=d["logs"], num_valid=d["num_valid"])
    return (d["pts"], sp, d["ext_q"], d["ext_t"], d["lt_q"], d["lt_t"])


def stage_ms(vh, meas, m, queries, qmask, cfg, use_kernel):
    """The whole k-NN stage, `knn_cached` as make_h_share calls it, on the
    card: CUDA events around 20 calls (host work and the escalation
    tier's host read included), the device time of one call, and its
    device activities per call."""
    kw = dict(radius=cfg.knn_radius, wide_radius=cfg.knn_wide_radius,
              wide_budget=cfg.knn_wide_budget, qmask=qmask, accept_d2=meas.NN_REJECT_D2,
              accept_k=meas.NUM_MATCH, cache_k=meas.CAND_K, use_kernel=use_kernel)
    fn = lambda: vh.knn_cached(m, queries, **kw)
    dev_ms, ops = device_ms(fn, n=10)
    return dict(stage_ms=call_ms(fn, n=20), stage_device_ms=dev_ms, stage_device_ops=ops)


def knn_stage_main(tree, inputs):
    """Time knn_cached of the package in `tree` on saved inputs (the map
    and one round's queries of a flagship run), so two trees can be
    compared on one card, one after the other."""
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    import torch
    from malio_tpu_torch import measurement as meas
    from malio_tpu_torch.config import flagship_config
    from malio_tpu_torch.map import voxel_hash as vh

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    d = torch.load(inputs, map_location="cuda")
    m = vh.VoxelHashMap(tab=d["tab"], voxel_size=d["voxel_size"], n_dropped=d["n_dropped"],
                        n_evicted=d["n_evicted"])
    out = stage_ms(vh, meas, m, d["queries"], d["qmask"], flagship_config(), use_kernel=True)
    out["tree"] = str(tree)
    out["package"] = str(pathlib.Path(vh.__file__).resolve().parent.parent)
    print(json.dumps(out))
    return 0


def deskew_kernel_main(tree, inputs, outputs):
    """Time the deskew kernel of the package in `tree`, on its default
    layout: at the flagship path's shape, at 3 x 65,536 points and at
    the sweep's one-LiDAR point counts (the smoke run's seeded inputs)
    and, with `inputs`, on the
    last-round points, spline and frames a flagship run saved. Reports
    each case's max |kernel - plain| and ok-flag agreement with that
    package's plain version. With `outputs`, the first tree's results are
    kept in that file and each later tree's are compared with them. Two
    trees can so be compared on one card, one after the other."""
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from malio_tpu_torch.config import Config, flagship_config
    from malio_tpu_torch.ops import deskew

    cfg = flagship_config()
    cases = {
        "deskew": deskew_inputs(cfg.num_lidars, cfg.max_raw_points, cfg.spline_capacity, seed=1),
        "deskew_capacity": deskew_inputs(cfg.num_lidars, Config.max_raw_points,
                                         Config.spline_capacity, seed=1),
    }
    for n in SWEEP_POINTS[1:-1]:
        cases[f"deskew_1x{n}"] = deskew_inputs(1, n, Config.spline_capacity, seed=1)
    if inputs:
        cases["deskew_path"] = saved_deskew_args(torch.load(inputs, map_location="cuda")["deskew"])
    out = dict(tree=str(tree), package=str(pathlib.Path(deskew.__file__).resolve().parent.parent),
               gpu=gpu_name_and_limit())
    first = pathlib.Path(outputs) if outputs else None
    kept = torch.load(first, map_location="cuda") if first and first.exists() else None
    results = {}
    for name, args in cases.items():
        fn = lambda a=args: deskew.deskew_points(*a)
        results[name] = got = fn()
        same_ok, err, atol, _ = deskew_err(deskew, args, deskew.deskew_points)
        row = dict(shape=f"L={args[0].shape[0]} N={args[0].shape[1]} C={args[1].cps.shape[0]}",
                   ms=kernel_ms(fn, "deskew_kernel"), call_ms=call_ms(fn),
                   max_abs_err=err, atol=atol, ok_flags_equal=same_ok)
        if kept is not None:
            row["max_abs_diff_first_tree"] = float((got - kept[name]).abs().max())
            row["equal_to_first_tree"] = bool(torch.equal(got, kept[name]))
        out[name] = row
    if first and kept is None:
        torch.save(results, first)
    out["traces"], out["trace_retakes"] = len(TRACES), [t for t in TRACES if not t["ok"]]
    print(json.dumps(out))
    return 0


def trace_check_main(seconds, lead_in_s):
    """How often a profiler trace of device_events loses device events:
    the kernel phase's timings (launch floor, fused kernel, plain version,
    torch.topk) in a loop for `seconds` on seeded random inputs at the
    base window's shape (65,536 table rows half full, Q=9984, V=8), with
    `lead_in_s` of host time before each trace's first call."""
    global TRACE_LEAD_IN_S
    import torch
    from malio_tpu_torch.ops import _build, knn

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    TRACE_LEAD_IN_S = lead_in_s
    _build.build_all(["knn_window"])
    g = torch.Generator(device="cuda").manual_seed(0)
    R, Q, V, K = 65536, 9984, 8, 16
    tab = torch.zeros(R, 32, 5, device="cuda")
    tab[..., 0] = (torch.rand(R, 32, device="cuda", generator=g) < 0.5).float()
    tab[..., 1:4] = torch.rand(R, 32, 3, device="cuda", generator=g) * 10
    tab[..., 4] = 0.01
    args = (tab, torch.rand(Q, 3, device="cuda", generator=g) * 10,
            torch.randint(0, R, (Q, V), device="cuda", generator=g),
            torch.rand(Q, V, device="cuda", generator=g) < 0.9)
    d2 = torch.rand(Q, V * 32, device="cuda", generator=g)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        launch_floor_ms()
        kernel_ms(lambda: knn.knn_window(*args, K), "knn_window_")
        device_ms(lambda: knn.knn_window_plain(*args, K))
        device_ms(lambda: torch.topk(d2, K, dim=-1, largest=False, sorted=True))
    lost = [t for t in TRACES if not t["ok"]]
    print(json.dumps(dict(lead_in_s=lead_in_s, seconds=time.perf_counter() - t0,
                          traces=len(TRACES), lost=len(lost), lost_traces=lost)))
    return 0


def _profile_rounds(cfg, groups, n_init, skip, active):
    """One traced replay: rounds `skip` .. `skip + active - 1` inside a
    torch.profiler session that starts TRACE_LEAD_IN_S and one untraced
    round before them, with a marker kernel at the start of each traced
    round and after the last.
    Returns the session's events, the device activities between the first
    and the last marker (markers left out), the markers' positions and the
    host time per traced round."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from malio_tpu_torch import runner

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    done, stamps = [], {}

    def tick(carry, out, base):
        k = len(done)  # the round that just ended
        done.append(k)
        torch.cuda.synchronize()
        if k == skip - 2:
            # a session loses some of its first device activities even
            # after the lead-in: round skip - 1 runs inside it untraced,
            # as device_events' warm-up calls do
            prof.start()
            time.sleep(TRACE_LEAD_IN_S)
        elif k == skip - 1:
            stamps["start"] = time.perf_counter()
            torch.cuda._sleep(1000)
        elif skip <= k < skip + active:
            torch.cuda._sleep(1000)
            if k == skip + active - 1:
                torch.cuda.synchronize()
                stamps["end"] = time.perf_counter()
                time.sleep(TRACE_LEAD_IN_S)  # the same margin at the end
                prof.stop()

    runner.run_sequence(cfg, groups[: n_init + skip + active], dtype=torch.float32,
                        device="cuda", callback=tick)
    events = prof.events()
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(dev) if "spin_kernel" in e.name]
    inside = [e for e in dev[marks[0] + 1 : marks[-1]] if "spin_kernel" not in e.name] if marks else []
    edges = (marks[0], len(dev) - marks[-1] - 1) if marks else (len(dev), 0)
    per_round = [b - a - 1 for a, b in zip(marks, marks[1:])]
    return (events, inside, marks, per_round, (stamps["end"] - stamps["start"]) * 1e3 / active,
            len(dev), edges)


def profile_phase(cfg, groups, n_init, round_ms, skip=8, active=5):
    """Where a steady round's time goes: `active` rounds after `skip`
    traced with torch.profiler (kernels on). Returns the device busy time
    per round (the sum of the kernels' and copies' device intervals, one
    stream), the device's idle share against `round_ms` (the steady round
    time measured without the profiler, which slows the host), launches
    per round and the kernels that take the most device time.

    Guarded as device_events is: the session starts TRACE_LEAD_IN_S and
    one untraced round before the first traced round, a marker kernel
    stands at the start of each traced round and after the last, and the
    replay is traced again, up to TRACE_ATTEMPTS times, unless every
    marker is in the trace and every round holds device activities; each
    retake is logged and counted."""
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        events, dev, marks, per_round, traced_ms, n_all, edges = _profile_rounds(
            cfg, groups, n_init, skip, active)
        ok = len(marks) == active + 1 and min(per_round) > 0
        TRACES.append(dict(kind="profile", calls=active, device_events=n_all,
                           markers=len(marks), events_per_call=per_round,
                           before_first_marker=edges[0], after_last_marker=edges[1], ok=ok))
        if ok:
            break
        log(f"profile trace {attempt} of {TRACE_ATTEMPTS} lost device events ({len(marks)} of "
            f"{active + 1} markers, {per_round} device activities per round, {edges[0]} before "
            f"the first marker and {edges[1]} after the last); taking it again")
    else:
        raise AssertionError(f"torch.profiler lost device events in {TRACE_ATTEMPTS} profile "
                             f"traces in a row")
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / active
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / active
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # the session's launches but the markers', over its active + 1 rounds
    launches = (sum(1 for e in events if e.name == "cudaLaunchKernel") - len(marks)) / (active + 1)
    knn_ms = sum(ms for name, ms in by_name.items() if "knn_window_" in name)
    desk_ms = sum(ms for name, ms in by_name.items() if "deskew_kernel" in name)
    out = dict(rounds=active, round_ms=round_ms, traced_round_ms=traced_ms,
               device_busy_ms_per_round=busy_ms, device_idle_share=1.0 - busy_ms / round_ms,
               launches_per_round=launches, device_ops_per_round=len(dev) / active,
               knn_window_ms_per_round=knn_ms, deskew_ms_per_round=desk_ms,
               retakes=attempt - 1, top_device_ms_per_round=top)
    log(f"profile, {active} steady rounds (trace {attempt}, all {len(marks)} markers): device "
        f"busy {busy_ms:.2f} ms/round of a {round_ms:.1f} ms round (idle share "
        f"{out['device_idle_share']:.3f}; {traced_ms:.1f} ms/round while traced), {launches:.0f} "
        f"kernel launches/round; fused k-NN kernel {knn_ms:.4f} ms/round, deskew "
        f"{desk_ms:.4f} ms/round")
    for name, ms in top:
        log(f"  {ms:8.3f} ms/round  {name[:100]}")
    return out


def flagship_groups(cfg, duration, seed):
    import numpy as np
    from malio_tpu_torch.config import FLAGSHIP_RANGE_MAX, FLAGSHIP_WORLD
    from malio_tpu_torch.io.synthetic import SyntheticSequence
    from malio_tpu_torch.io.assemble import assemble_groups

    seq = SyntheticSequence(
        duration=duration, num_lidars=3, points_per_scan=cfg.max_raw_points, seed=seed,
        ext_t=np.asarray(cfg.extrinsic_T, np.float64).reshape(3, 3),
        ext_q_wxyz=np.asarray(cfg.extrinsic_R, np.float64).reshape(3, 4),
        range_max=FLAGSHIP_RANGE_MAX, world_kwargs=FLAGSHIP_WORLD,
    )
    imu, rounds, traj = seq.generate()
    return assemble_groups(cfg, imu, rounds), traj


def sum_order_check():
    """Entries where PyTorch's (d*d).sum(-1) over x, y, z differs on the
    card from the explicit ((dx*dx + dy*dy) + dz*dz) of the port's
    sqdist (the JAX reference's op-by-op order), over 2e6 random pairs."""
    import torch
    from malio_tpu_torch.ops import knn

    g = torch.Generator(device="cuda").manual_seed(0)
    p = (torch.rand(2_000_000, 3, device="cuda", generator=g) * 12 - 6) * (
        torch.rand(2_000_000, 1, device="cuda", generator=g) * 30)
    q = torch.rand(1, 3, device="cuda", generator=g) * 10 - 5
    d = p - q
    return int(((d * d).sum(-1) != knn.sqdist(p, q)).sum()), p.shape[0]


def gpu_name_and_limit():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main(save_stage_inputs=None):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import types

    import numpy as np
    import malio_tpu_torch  # noqa: F401  (sets the matmul precision)
    from malio_tpu_torch import measurement as meas
    from malio_tpu_torch import propagate as prop
    from malio_tpu_torch import runner
    from malio_tpu_torch.config import Config, flagship_config
    from malio_tpu_torch.eval.ate import ate_rmse
    from malio_tpu_torch.map import voxel_hash as vh
    from malio_tpu_torch.ops import _build, deskew, knn

    smi = gpu_name_and_limit()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report = dict(gpu=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    names = ["knn_window", "deskew"]
    _build.build_all(names)
    build_s = time.perf_counter() - t0
    log(f"kernels built in {build_s:.1f} s (parallel nvcc, sm_90a)")
    report["build_s"] = build_s
    report["ptxas"] = {n: _build.ptxas_report(n) for n in names}
    floor = launch_floor_ms()
    n_diff, n_pairs = sum_order_check()
    report.update(launch_floor_ms=floor, sum_order_differs=[n_diff, n_pairs])
    log(f"launch floor (one-element add, device) {floor:.4f} ms; (d*d).sum(-1) differs from "
        f"the explicit x, y, z order at {n_diff} of {n_pairs} entries on this card")

    # ---- main path: City 3-LiDAR flagship, both kernels on ----
    cfg = flagship_config()
    K = meas.CAND_K
    v_base = len(vh._svx_ball_offsets(cfg.knn_radius))
    v_wide = len(vh._svx_ball_offsets(cfg.knn_wide_radius))
    t0 = time.perf_counter()
    groups, traj = flagship_groups(cfg, duration=8.0, seed=0)
    log(f"flagship world + {len(groups)} measure groups generated in {time.perf_counter() - t0:.1f} s")
    stamps = []

    def tick(carry, out, base):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    # keep the last round's k-NN queries and deskew arguments for the
    # kernel and stage phases
    last_search, last_deskew = {}, {}
    knn_cached = vh.knn_cached

    def recording_knn_cached(m, queries, **kw):
        last_search.update(queries=queries, qmask=kw.get("qmask"))
        return knn_cached(m, queries, **kw)

    def recording_deskew(*args):
        last_deskew["args"] = args
        return deskew.deskew_points(*args)

    vh.knn_cached = recording_knn_cached
    prop.deskew_ops = types.SimpleNamespace(deskew_points=recording_deskew,
                                            deskew_points_plain=deskew.deskew_points_plain)
    knn.knn_window.launches = 0
    knn.knn_window.launches_by_shape = {}
    deskew.deskew_points.launches = 0
    deskew.deskew_points.launches_by_shape = {}
    t0 = time.perf_counter()
    try:
        res = runner.run_sequence(cfg, groups, dtype=torch.float32, device="cuda", callback=tick)
        torch.cuda.synchronize()
    finally:
        vh.knn_cached = knn_cached
        prop.deskew_ops = deskew
    wall = time.perf_counter() - t0
    by_shape = dict(knn.knn_window.launches_by_shape)
    n_base = sum(n for (q, v), n in by_shape.items() if v == v_base)
    n_wide = sum(n for (q, v), n in by_shape.items() if v == v_wide)
    n_desk = deskew.deskew_points.launches
    desk_by_shape = dict(deskew.deskew_points.launches_by_shape)
    rounds = len(res["t"])
    if n_base == 0 or n_wide == 0 or n_desk == 0:
        raise AssertionError(f"main path skipped a kernel: knn_window {by_shape}, deskew {n_desk}")
    warm = 8
    steady = (rounds - warm) / (stamps[-1] - stamps[warm - 1])
    ate = ate_rmse(res["pos"], traj.pos(res["t"]))
    miss_p50 = float(np.median(res["nn_miss"]))
    log(f"main path: {rounds} rounds in {wall:.2f} s; steady {steady:.2f} scans/s "
        f"(rounds {warm}+), {smi}")
    log(f"ATE {ate:.6f} m (gate {ATE_GATE_M}), map_dropped {int(res['map_dropped'][-1])}, "
        f"meas_dropped max {int(res['n_meas_dropped'].max())}, nn_miss p50 {miss_p50}, "
        f"map_size {int(res['map_size'][-1])}, launches knn_window {by_shape} "
        f"(Q, V): n, deskew {desk_by_shape} (L, N, C): n")
    if not (np.isfinite(ate) and ate <= ATE_GATE_M):
        raise AssertionError(f"ATE {ate} is not finite or exceeds {ATE_GATE_M} m")
    if not np.all(np.isfinite(res["pos"])) or res["pos"].shape != (rounds, 3):
        raise AssertionError("trajectory has non-finite values or a wrong shape")

    # ---- kernels against their plain versions, timed, at the path's shapes ----
    m = res["carry"].map
    queries, qmask = last_search["queries"], last_search["qmask"]
    if save_stage_inputs:
        pts, sp, ext_q, ext_t, lt_q, lt_t = last_deskew["args"]
        desk = dict(pts=pts, t0=sp.t0, cps=sp.cps, logs=sp.logs, num_valid=sp.num_valid,
                    ext_q=ext_q, ext_t=ext_t, lt_q=lt_q, lt_t=lt_t)
        torch.save(dict(tab=m.tab, voxel_size=m.voxel_size, n_dropped=m.n_dropped,
                        n_evicted=m.n_evicted, queries=queries, qmask=qmask,
                        deskew={k: v.clone() for k, v in desk.items()}), save_stage_inputs)
    knn_rows = knn_phase(m, queries, qmask, cfg, K)
    knn_rows[0]["launches"] = n_base
    knn_rows[1]["launches"] = by_shape.get((256, v_wide), 0)
    knn_rows[2]["launches"] = by_shape.get((cfg.knn_wide_budget, v_wide), 0)
    L = cfg.num_lidars
    desk_rows = [
        deskew_phase("deskew", deskew_inputs(L, cfg.max_raw_points, cfg.spline_capacity, seed=1),
                     floor),
        deskew_phase("deskew_path", last_deskew["args"], floor),
        deskew_phase("deskew_config_default",
                     deskew_inputs(Config.num_lidars, Config.max_raw_points,
                                   Config.spline_capacity, seed=1), floor),
        deskew_phase("deskew_capacity",
                     deskew_inputs(L, Config.max_raw_points, Config.spline_capacity, seed=1), floor),
    ]
    # the main path's launches at each row's shape
    for r in desk_rows:
        r["launches"] = desk_by_shape.get(r.pop("shape_key"), 0)
    report["deskew_layout_sweep"] = deskew_layout_sweep()

    # ---- the whole k-NN stage, kernel and plain ----
    stage = {flag: stage_ms(vh, meas, m, queries, qmask, cfg, flag) for flag in (True, False)}
    report["knn_stage"] = {"kernel": stage[True], "plain": stage[False]}
    for flag, st in stage.items():
        log(f"k-NN stage (knn_cached, Q={queries.shape[0]}, {'kernel' if flag else 'plain'}): "
            f"{st['stage_ms']:.4f} ms per call by events, device {st['stage_device_ms']:.4f} ms "
            f"in {st['stage_device_ops']:.0f} device ops")
    # ---- the same rounds through the plain versions on the card ----
    import dataclasses

    plain_cfg = dataclasses.replace(cfg, knn_kernel=False, deskew_kernel=False)
    n_init = len(groups) - rounds  # groups consumed by the IMU initialisation
    res_p = runner.run_sequence(plain_cfg, groups[: n_init + PLAIN_ROUNDS], dtype=torch.float32,
                                device="cuda")
    k = len(res_p["t"])
    dpos = float(np.abs(res_p["pos"] - res["pos"][:k]).max())
    log(f"plain versions, first {k} rounds: max |pos(kernels) - pos(plain)| = {dpos:.3g} m "
        f"(limit {PLAIN_TOL_M})")
    if not dpos <= PLAIN_TOL_M:
        raise AssertionError(f"kernel and plain trajectories differ by {dpos} m")

    # ---- where a steady round's time goes ----
    report["profile"] = profile_phase(cfg, groups, n_init, round_ms=1e3 / steady)

    kernels = knn_rows + desk_rows
    for r in kernels:
        r["floor_ms"] = floor
    keys = ("name", "route", "source", "replaces", "shape", "launches", "max_abs_err", "ms",
            "call_ms", "plain_ms", "plain_call_ms", "bound_ms", "bound_by", "library_ms",
            "library_call_ms", "bound_with_floor_ms")
    report.update(
        kernels=kernels, rounds=rounds, wall_s=wall, steady_scans_per_s=steady, ate_m=ate,
        map_dropped=res["map_dropped"].tolist(), nn_miss=res["nn_miss"].tolist(),
        meas_dropped=res["n_meas_dropped"].tolist(), iterations=res["iterations"].tolist(),
        map_size=res["map_size"].tolist(), round_s=np.diff(stamps).tolist(),
        plain_max_dpos_m=dpos, knn_launches_by_shape={f"{q},{v}": n for (q, v), n in by_shape.items()},
        deskew_launches_by_shape={",".join(map(str, k)): n for k, n in desk_by_shape.items()},
        traces=len(TRACES), trace_retakes=[t for t in TRACES if not t["ok"]],
    )
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(smi)
    print(json.dumps({"kernels": [{k2: r[k2] for k2 in keys if k2 in r} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save-stage-inputs", metavar="FILE",
                    help="keep the map, the last round's k-NN queries and its deskew "
                         "inputs in FILE")
    ap.add_argument("--knn-stage", metavar="TREE",
                    help="only time knn_cached of the package in TREE on --inputs")
    ap.add_argument("--deskew-kernel", metavar="TREE",
                    help="only time the deskew kernel of the package in TREE (--inputs optional)")
    ap.add_argument("--inputs", metavar="FILE", help="inputs saved by --save-stage-inputs")
    ap.add_argument("--outputs", metavar="FILE",
                    help="with --deskew-kernel: keep the first tree's results in FILE, compare "
                         "later trees' with them")
    ap.add_argument("--trace-check", metavar="SECONDS", type=float,
                    help="only count profiler traces that lose device events, for SECONDS")
    ap.add_argument("--lead-in", metavar="S", type=float, default=TRACE_LEAD_IN_S,
                    help="host seconds before a trace's first call (with --trace-check)")
    a = ap.parse_args()
    if a.knn_stage:
        sys.exit(knn_stage_main(a.knn_stage, a.inputs))
    if a.deskew_kernel:
        sys.exit(deskew_kernel_main(a.deskew_kernel, a.inputs, a.outputs))
    if a.trace_check:
        sys.exit(trace_check_main(a.trace_check, a.lead_in))
    sys.exit(main(a.save_stage_inputs))
