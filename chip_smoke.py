#!/usr/bin/env python3
"""Smoke run of malio_tpu_torch on one NVIDIA card.

Builds the CUDA kernels from malio_tpu_torch/csrc/, captures the compiled
round (pipeline.step on the card: one CUDA graph of the fusion round, the
port's jax.jit) at the flagship's shape over its first rounds (capture
and warm-up seconds, graph nodes, pool bytes, each kernel's launches a
replay), drives the City 3-LiDAR flagship through runner.run_sequence
with all three kernels in that graph (launch counters set to 0 just
before and read just after; a replay counts the launches its capture
recorded), runs it again through the eager round (pipeline.step_eager,
op by op) and holds the two bit-equal, runs a steady round and a
scan_steps chunk under torch.cuda.set_sync_debug_mode("error") (no host
sync), checks the trajectory against
the synthetic ground truth, then holds each kernel against its plain
PyTorch version on the card at the main path's shapes: the fused k-NN
window kernel on the map that run built and on one of its rounds' queries
(bit-equal, also with ties, exhausted rows, all-invalid windows, masked
queries and duplicate rows planted), the deskew kernel within atol 2e-5
of the plain version run in f64, the exact deskew (for coordinates under
64 m), with the f32 plain version's ok flags, compared with the world
origin at the scan-end position: on that run's last-round points, spline and frames, and on
seeded inputs at the path's shape (3 x 4096 points, 64 control points),
at the Config default (1 x 65,536, 96) and at 3 x 65,536, in both of its
layouts, whose crossover a sweep of point counts measures. Each kernel is timed on the device alone (the CUPTI kernel
events of torch.profiler, median of >= 30 launches) and per wrapper call
(CUDA events around 100 back-to-back calls). It times the whole k-NN stage
(`voxel_hash.knn_cached`), re-runs the first rounds with the plain
versions, and traces a few steady rounds with torch.profiler to show where
a round's time goes, through the graph and through the eager round.

Then the slice's other paths, each with the launch counts set to 0 just
before it and read just after (a path that launches a kernel no time
fails): run_sequence with no hooks over two full chunks through
pipeline.scan_steps (bit-equal to the main path's first 32 rounds); the
live path, the same sequence pushed through OnlineEstimator in arrival
order (trajectory bit-equal to the main path's; push-to-pose latency and
poll() time), through the graph and through the eager round; a checkpoint after round 20 saved, loaded into a fresh
template and resumed for rounds 21-30 (bit-equal); the back end with
loop-closure feedback at full sensor width, a 20 s revisiting circle
through run_sequence with a WindowSmoother and a PoseGraphBackend
(feedback=True, capacity 2048): a loop closed, a correction fed back, graph
ATE within 1.1 x odometry ATE + 0.01 m, no drops, the times of every
relax(), optimize_window(), refine_loop_edge() and
apply_world_correction(), the rounds a second, and each back-end
program's capture (seconds, graph nodes, pool, replays); the first
relax's optimize_sparse, the first optimize_window and the first
refine_loop_edge replayed again on their own arguments, bit-equal to
their _eager versions, and once more under
torch.cuda.set_sync_debug_mode("error"); optimize_sparse at 2048
keyframes timed at its first call (with the capture), at a replay and
eagerly (all bit-equal); the block-tridiagonal kernel
(csrc/block_tridiag.cu) held to its plain version on the last systems of
the first relax (K = 2048, r = 385), of the solver (2048, 193) and on a
seeded one (64, 385): the residual within 4x the plain version's, the
column-wise difference within 1e-9 reported; timed beside the plain
version and torch.linalg.solve_ex on the dense 6K x 6K system; and
voxel_hash.knn at K = 5 through the
kernel bit-equal to its plain route, with the kernel's K = 5 shapes
checked and timed. Last the batched cell: batched.flagship_benchmark at
B = 16 (6 s, seeds 0-15) and at B = 1 (8 s), aggregate scans/s per pass,
every sequence's ATE and drops, three sequences against their own runs
(1e-3 m), a pass through the eager round at B = 16 (bit-equal to the
graph's, scans/s beside it), the B = 16 graph's capture, nodes and pool,
a profile of 5 steady batched rounds at B = 16 (its device operations
against the main path's profile, the same round at B = 1), and both
kernels checked and timed at the batched shapes (the k-NN over 16
maps as one flat table, the deskew at 16 x 3 x 4096). The map insert's
write, the merge kernel (one launch a call), is held bit-equal to its
plain version and to index_copy and timed beside index_copy and
tab.clone() at benchmarks/micro_r4b.py's shapes, on the insert's own
arguments (the main path's last round, the batch's, a world correction's
re-insert of the whole map) and at edge cases, and checked at the edges
of its copy's tiles; the plain rounds run once more with only the merge
plain, bit-equal to the main path. The dataset cell writes the flagship
sequence as a City file-player tree (io/export) and runs it through `python -m
malio_tpu_torch.run_dataset` (TUM, ATE / RPE, PCD map read back equal)
and DatasetPlayer (equal to the arrival-ordered feed within 1e-5 m);
bench_torch.py's kernel times; last the distributed cell: 24 flagship
rounds through distributed.sharding's worker in two processes sharing
the card over gloo, dp = 2 x mp = 1 (seeds 0 and 1, each bit-equal to
its own run) and dp = 1 x mp = 2 (within 1e-3 m of the main path, map
sizes equal), every rank's launches, collectives, their bytes and round
times, and the three kernels at an mp rank's shapes (also timed as
replays of a graph that holds the one call); with two or more cards the
same mp world over NCCL, a card a rank, through the captured round (its
collectives inside) and eagerly, bit-equal every round, against the main
path, with no host sync in a steady replay and each rank's capture, and
with four cards dp = 2 x mp = 2 through the graph (with one card a line
says that this part did not run, and why); last the soak cell: 20 s of
soak.py's stream (3 x 1024 points, a 2^19-slot map) through soak.run,
finite, within the ATE gate, no lane drop, map drops within the map
layout's contract, every kernel once a round in every chunk, the card's
memory at each quartile and the launches a round in the first and the
last, and the three kernels on its last round's arguments. Any failure
exits non-zero; the last line is the device summary.

    python3 chip_smoke.py                               # the smoke run
    python3 chip_smoke.py --save-stage-inputs FILE      # ... keeping the map, the
                                                        # queries and the deskew inputs
    python3 chip_smoke.py --knn-stage TREE --inputs FILE  # time knn_cached of the
                                                        # package in TREE on them
    python3 chip_smoke.py --deskew-kernel TREE [--inputs FILE] [--outputs FILE]
                                                        # time the deskew kernel of the
                                                        # package in TREE
    python3 chip_smoke.py --merge-kernel TREE           # time the merge kernel of
                                                        # the package in TREE beside
                                                        # this one's
    python3 chip_smoke.py --eigvalsh                    # the main path's ATE with
                                                        # torch.linalg.eigvalsh in
                                                        # place of linalg.eigvalsh3
    python3 chip_smoke.py --dist-mp TREE                # the mp = 2 world of the
                                                        # package in TREE beside this
                                                        # one's: round times by rank
    python3 chip_smoke.py --trace-check SECONDS [--lead-in S]  # count profiler
                                                        # traces that lose device events
    python3 chip_smoke.py --backend                     # only the back end, the
                                                        # solver and the block_tridiag
                                                        # kernel
    python3 chip_smoke.py --distributed                 # only the distributed cell
                                                        # (over NCCL too with two or
                                                        # four cards)
    python3 chip_smoke.py --batch-bits                  # the first operation whose
                                                        # bits differ between a B = 16
                                                        # round and a sequence's own

Writes per-round and build details to chiprun_out/chip_smoke.json.
"""
import argparse
import collections
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
F64_OPS_PER_S = 34e12  # H100 SXM, f64 outside the tensor cores (NVIDIA's data sheet)
ATE_GATE_M = 0.05
PLAIN_ROUNDS = 12
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
SCAN_ROUNDS = 32  # two full chunks of run_sequence's 16 through pipeline.scan_steps
GRAPH_GROUPS = 12  # the graph phase's groups: the IMU initialisation's and a few rounds
RESUME_AT, RESUME_TO = 20, 30  # checkpoint after round 20, resume rounds 21-30
# the back-end cell: the flagship on a revisiting circle (radius 4 m, closes
# after ~13.6 s); PoseGraphBackend at its default widths and capacity
BACKEND_SECONDS = 20.0
BACKEND_SEED = 0
BACKEND_CIRCLE = dict(yaw_rate=0.5, speed=2.0)
BACKEND_CAPACITY = 2048
# the ICP settings tests/test_posegraph.py:611-616 gives sparse keyframe
# clouds: at the defaults (1 m cells, 4 points a cell, quality 0.2) the
# 1024-point clouds of this rig fill too few cells, and no loop candidate
# passed the quality gate in a CPU rehearsal of this cell
BACKEND_ICP = dict(cell_size=2.0, icp_min_pts=3, min_quality=0.05)
SOLVER_K = 2048  # one optimize_sparse at the default capacity
# the block-tridiagonal kernel against its plain version: column by column
# within TRIDIAG_REL of the plain column's largest entry, and a residual
# |T Y - RHS| no more than TRIDIAG_RESIDUAL_X times the plain version's
# (T carries a 1e8 gauge prior: where its conditioning defeats the first,
# the residual decides); f64 operations a step of the 6x6 chain (S, the
# Cholesky, V, Sinv, C: five ~6^3 products) and a column a step (B^T w,
# Sinv r forward, C y back: 3 x 36 multiply-adds)
TRIDIAG_REL = 1e-9
TRIDIAG_RESIDUAL_X = 4.0
TRIDIAG_CHAIN_OPS = 2000
TRIDIAG_COLUMN_OPS = 216
TRIDIAG_SEEDED = (64, 385)  # the CPU test's shape, on seeded inputs
# the batched cell: B flagship sequences (seeds 0 .. B-1) in lockstep through
# batched.flagship_benchmark, and the same at B = 1 with bench.py's settings
BATCH = 16
BATCH_SECONDS = 6.0
BATCH_B1_SECONDS = 8.0
BATCH_PASSES = 2  # a third pass takes the whole run past 700 s (PERF.md §4)
BATCH_CHUNK = 8
BATCH_CHECK = (0, 7, 15)  # sequences of the B = 16 run held against their own runs,
BATCH_CHECK_ROUNDS = 24  # over their first 24 rounds (all 48 would take ~1 min more)
BATCH_TOL_M = 1e-3
BATCH_PROFILE_SECONDS = 2.0  # rounds enough for the profile's 8 + 5
TRACE_LEAD_IN_S = 0.1  # host time between a profiler session's start and its first call
# device work a session may drop before its first marker: on an H100 with
# torch 2.11 the first four device events of a session (three warm-up
# calls and the first marker) went missing in five traces in a row after a
# 20 ms lead-in
LEAD_IN_ADDS = 16
TRACE_ATTEMPTS = 5
TRACES = []  # one entry per profiler trace: calls (or rounds), events, markers found
# max |deskew kernel - exact| for coordinates under 64 m (about 5 ulp of
# them), exact being the plain version run in f64 on the same inputs; it
# doubles with the ulp past that (deskew_atol)
DESKEW_ATOL = 2e-5
# the merge kernel at benchmarks/micro_r4b.py's shapes: tables of 2^17,
# 2^19 and 2^21 rows of 5 f32, 12,288 sorted unique updates
MERGE_LOG_T = (17, 19, 21)
MERGE_N = 12288
# the insert's shapes on the paths, for --merge-kernel: (table rows T,
# updates N, valid updates) as PR 6's smoke run on an H100 met them (the
# main path's last insert, a world correction's re-insert of the whole map,
# the batched insert of 16 maps)
MERGE_PATH_SHAPES = {
    "merge_rows_path": (1 << 21, 9984, 551),
    "merge_rows_transform": (1 << 21, 1 << 21, 38600),
    "merge_rows_batched": (16 << 21, 16 * 9984, 30884),
}
# the dataset cell: the flagship sequence written as a City file-player tree
DATASET_SECONDS = 8.0
DATASET_SENSORS = ["ouster", "livox_avia", "livox_tele"]
PLAYER_TOL_M = 1e-5  # player against the arrival-ordered feed (tests/test_player.py:119)
BITS_ROUNDS = 3  # rounds of the --batch-bits search
# the distributed cell: the flagship config in two processes on one card over
# gloo, DIST_ROUNDS rounds through distributed.sharding's worker; dp = 2 x mp =
# 1 (seeds 0 and 1, each rank bit-equal to its sequence's own run) and dp = 1
# x mp = 2 (seed 0 against the main path within BATCH_TOL_M, map sizes equal);
# with more cards the same over NCCL, a card a rank
DIST_ROUNDS = 24
DIST_SEED1_SECONDS = 4.0  # seed 1's sequence: its IMU initialisation and DIST_ROUNDS rounds
DIST_MP = 2
DIST_DEADLINE_S = 300  # a world past it fails the phase; a collective waits as long
# the soak cell (malio_tpu_torch/soak.py, scripts/soak_tpu.py's config and
# stream): City01's length is 1309 s; the smoke run soaks 20 s of it (192
# rounds), a depth cut (PERF.md §4: 30 s took the run past 750 s)
SOAK_SECONDS = 20.0
SOAK_CAPTURE_GROUPS = 40  # a short soak run first captures the soak's round
SOAK_POINTS = 1024
SOAK_CHUNK = 8
MAP_DROP_SHARE = 0.002


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


def graph_ms(fn, n=100):
    """Time of one wrapper call as a captured round launches it: the call
    captured alone into a CUDA graph (after an eager call and a warm-up on
    the capture's stream), CUDA events around n replays, divided by n."""
    import torch

    fn()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=stream):
        fn()
    return call_ms(g.replay, n=n)


def _trace(fn, n, warm, lead_in_s):
    """Device activities of one torch.profiler session, in start order:
    LEAD_IN_ADDS one-element adds the session may drop, warm-up calls,
    then n calls with a marker kernel before each and after the last;
    `lead_in_s` of host time before the first launch and after the last."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(lead_in_s)
        for _ in range(LEAD_IN_ADDS):
            x.add_(1.0)
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        for _ in range(n):
            torch.cuda._sleep(1000)
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(lead_in_s)
    return sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: e.time_range.start)


def marked_calls(ev, n):
    """The calls of a marked trace of n calls: `ev` is its device
    activities in start order as (name, microseconds); a call's are those
    between two consecutive markers. Returns the calls that hold the most
    common number of activities, and whether the trace is whole (all
    n + 1 markers, every call the same number). A call that lost a marker
    or an activity holds another number and is left out."""
    marks = [i for i, (nm, _) in enumerate(ev) if "spin_kernel" in nm]
    calls = [ev[a + 1 : b] for a, b in zip(marks, marks[1:])]
    sizes = collections.Counter(len(c) for c in calls)
    whole = len(marks) == n + 1 and len(sizes) == 1
    if not calls:
        return [], whole
    common = sizes.most_common(1)[0][0]
    return [c for c in calls if len(c) == common], whole


def device_events(fn, n, warm=3):
    """For each of n calls of fn, the (name, microseconds) of its device
    activities (kernels, copies, memsets) from torch.profiler's CUPTI
    trace: those between two marker kernels, on the one stream the calls
    use.

    Now and then a session places its device events a few ms before
    their host launches and drops those that then fall before the trace
    start, up to all of them (`--trace-check` counts how often). The
    lead-in keeps the calls away from the start, and a trace is taken
    again, up to TRACE_ATTEMPTS times with the lead-in doubled each time,
    unless it holds all n + 1 markers and the same number of activities
    in every call; each retake is logged and counted. Late in a long run
    on an H100 with torch 2.11 a batched k-NN trace lost its first 35 or
    36 of 120 events in five traces in a row, whatever the lead-in: from
    the first retake on, a trace whose whole calls (marked_calls) number
    at least n / 2 is kept, with only those calls."""
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        ev = [(e.name, e.time_range.elapsed_us())
              for e in _trace(fn, n, warm, TRACE_LEAD_IN_S * 2 ** (attempt - 1))]
        calls, whole = marked_calls(ev, n)
        markers = sum("spin_kernel" in nm for nm, _ in ev)
        kept = whole or (attempt > 1 and len(calls) >= n / 2)
        TRACES.append(dict(calls=n, device_events=len(ev), markers=markers, ok=whole,
                           whole_calls=len(calls), kept=kept))
        if whole:
            return calls
        if kept:
            log(f"torch.profiler trace {attempt} lost device events ({len(ev)} recorded, "
                f"{markers} of {n + 1} markers); kept its {len(calls)} whole calls")
            return calls
        log(f"torch.profiler trace {attempt} of {TRACE_ATTEMPTS} lost device events "
            f"({len(ev)} recorded, {markers} of {n + 1} markers, {len(calls)} whole calls); "
            f"taking it again")
    raise AssertionError(f"torch.profiler lost device events in {TRACE_ATTEMPTS} traces in a row")


def kernel_ms(fn, name, n=50):
    """The device duration of one launch of the kernel whose name holds
    `name`: median over the n calls of fn (the whole calls of a trace that
    lost some), each of which launches it once."""
    calls = device_events(fn, n)
    ds = [us for call in calls for nm, us in call if name in nm]
    if len(ds) != len(calls):
        raise AssertionError(f"{name}: {len(ds)} device events for {len(calls)} calls")
    return statistics.median(ds) / 1e3


def device_ms(fn, n=10):
    """Device time of one call of fn (the sum of its kernels' and copies'
    durations, mean over n calls) and its device activities per call."""
    calls = device_events(fn, n)
    return sum(us for c in calls for _, us in c) / len(calls) / 1e3, len(calls[0])


def bound(nbytes, nops, ops_per_s=F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
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


def _live(queries, qmask):
    """The live queries of one sequence (n, 3), or of each sequence of a
    batch (B, n, 3) cut to the smallest live count."""
    import torch

    if queries.dim() == 2:
        return queries[qmask].contiguous()
    n = int(qmask.sum(-1).min())
    return torch.stack([q[k][:n] for q, k in zip(queries, qmask)])


def knn_phase(m, queries, qmask, cfg, K, suffix=""):
    """The fused k-NN window kernel at the path's shapes, on the map the
    path built and one of its rounds' queries: the base window over every
    measurement lane, and the wide window over the first live queries at
    the path's tier (256) and at the full budget. A batch of maps (B, R,
    32, 5) and queries (B, Q, 3) goes to the kernel as the batched path
    sends it (window_args)."""
    live = _live(queries, qmask)
    shapes = [
        ("knn_window", queries, cfg.knn_radius, qmask),
        ("knn_window_wide", live[..., :256, :], cfg.knn_wide_radius, None),
        ("knn_window_wide_budget", live[..., : cfg.knn_wide_budget, :], cfg.knn_wide_radius, None),
    ]
    return [knn_row(name + suffix, window_args(m, q, radius, mask), K)
            for name, q, radius, mask in shapes]


def knn_row(name, args, K):
    """The fused k-NN window kernel on args (tab, queries, rows, alive):
    bit-equal to its plain version on them and with edge cases planted,
    timed alone on the device, per wrapper call, against the plain version
    and torch.topk + gather; the bound from these inputs."""
    import torch
    from malio_tpu_torch.map import voxel_hash as vh
    from malio_tpu_torch.ops import knn

    tab, q, b, alive = args
    Q, V = b.shape
    big = torch.finfo(torch.float32).max
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
    win = tab[b]
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
    n_lanes = int((tab[..., 0] != 0).sum(1)[b][alive].sum())
    nbytes = touched * ROW_BYTES + Q * 12 + Q * V * 9 + Q * K * 20
    b_ms, b_by = bound(nbytes, n_lanes * KNN_OPS_PER_LANE)
    log(f"kernel {name} Q={Q} V={V} K={K}: bit-equal to plain (path inputs {stats}, "
        f"edge inputs {stats_e}); device {ms:.4f} ms, call {c_ms:.4f} ms (plain device "
        f"{p_ms:.4f} ms in {p_ops:.0f} device ops, call {p_call:.4f} ms; torch.topk+gather "
        f"device {l_ms:.4f} ms, call {l_call:.4f} ms); bound {b_ms:.5f} ms by {b_by} "
        f"({touched} distinct rows, {nbytes} B)")
    return dict(
        name=name, route="cuda", source="malio_tpu_torch/csrc/knn_window.cu",
        replaces="malio_tpu/ops/knn_pallas.py:88", shape=f"Q={Q} V={V} K={K}", Q=Q, V=V, K=K,
        max_abs_err=max(err, err_e), ms=ms, call_ms=c_ms, plain_ms=p_ms, plain_call_ms=p_call,
        plain_device_ops=p_ops, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
        touched_rows=touched, live_lanes=n_lanes, library_ms=l_ms, library_call_ms=l_call,
        cases=stats, edge_cases=stats_e,
    )


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


def batch_args(args):
    """deskew_points arguments with the leading batch axis (one sequence
    becomes a batch of one)."""
    from malio_tpu_torch import tree

    return args if args[0].dim() == 4 else tree.unsqueeze(tuple(args))


def deskew_inputs_batch(B, L, N, C, seed):
    """B sequences of deskew_inputs, each with its own points, frames and
    spline (its time origin moved by 3 ms a sequence), stacked."""
    import torch
    from malio_tpu_torch import tree

    seqs = []
    for b in range(B):
        pts, sp, *frames = deskew_inputs(L, N, C, seed + b)
        seqs.append((pts, sp._replace(t0=sp.t0 + 0.003 * b), *frames))
    return tuple(a.contiguous() if torch.is_tensor(a) else a for a in tree.stack(seqs))


def recentred(args):
    """deskew_points arguments with the world origin moved to LiDAR 0's
    scan-end position. The deskew sees world positions only relative to
    one another, so its result is the same; f32 then rounds at the scale
    of the points and the trajectory's excursion, not of where the map
    happens to sit (the plain version composes the spline in world
    coordinates, the kernel relative to the scan-end position)."""
    pts, sp, ext_q, ext_t, lt_q, lt_t = batch_args(args)
    o = lt_t[:, 0].clone()  # each sequence's own origin
    cps = sp.cps.clone()
    cps[..., :3, 3] -= o[:, None]
    return (pts, sp._replace(cps=cps), ext_q, ext_t, lt_q, (lt_t - o[:, None]).contiguous())


def deskew_atol(args):
    """DESKEW_ATOL scaled to the ulp of the largest coordinate the deskew
    of recentred args can hold (the points' range, plus the spline's
    excursion from the scan-end position and the extrinsic's offset): f32
    round-off grows with it."""
    import math

    pts, sp, _, ext_t = args[:4]
    scale = float(pts[..., :3].abs().max() + sp.cps[..., :3, 3].abs().max() + ext_t.abs().max())
    return DESKEW_ATOL * 2.0 ** max(0, math.floor(math.log2(max(scale, 1.0))) - 5)


def deskew_err(deskew, args, fn):
    """fn (a deskew kernel launch) against the plain version on args
    recentred: whether its ok flags equal deskew_points_plain's, max
    |kernel - exact| with exact deskew_points_plain run in f64 on the same
    inputs (over the points whose flag the f64 run keeps), its limit
    (deskew_atol), the f32 plain result and max |kernel - f32 plain|. Two
    f32 results of the deskew's chain lie up to ~5 ulp apart 35 m out (the
    f32 plain version 2.08e-5 from its f64 result on a soak's rounds), so
    the f32 plain version is no reference at DESKEW_ATOL: the kernel is held
    to the exact result."""
    import torch
    from malio_tpu_torch import tree

    args = recentred(args)
    got, want = fn(*args), deskew.deskew_points_plain(*args)
    exact = deskew.deskew_points_plain(*tree.map_tensors(
        lambda t: t.double() if t.is_floating_point() else t, args))
    torch.cuda.synchronize()
    same = want[..., 3] == exact[..., 3]
    err = float((got[..., :3].double() - exact[..., :3])[same].abs().max())
    return (bool(torch.equal(got[..., 3], want[..., 3])), err, deskew_atol(args), want,
            float((got[..., :3] - want[..., :3]).abs().max()))


def deskew_check(args, lanes=None):
    """The deskew kernel (the wrapper's layout, or `lanes` per point)
    against the plain version on args (deskew_err): ok flags equal to the
    f32 plain version's, max |kernel - exact| <= deskew_atol. Returns that
    max, its limit, the f32 plain result and max |kernel - f32 plain|."""
    from malio_tpu_torch.ops import deskew

    args = batch_args(args)
    fn = deskew.deskew_points if lanes is None else (
        lambda *a: deskew._launch(*a, lanes=lanes))
    same_ok, err, atol, want, err_plain = deskew_err(deskew, args, fn)
    what = "default layout" if lanes is None else f"lanes={lanes}"
    if not same_ok:
        raise AssertionError(f"deskew ({what}): ok flags differ from plain")
    if not err <= atol:
        raise AssertionError(f"deskew ({what}): max |kernel - exact| = {err} > {atol}")
    return err, atol, want, err_plain


def deskew_phase(name, args, floor):
    """The deskew kernel on args (B sequences of L LiDARs x N points, C
    control points; one sequence without B): checked
    against its plain version and timed alone on the device, per wrapper
    call, and in both of its layouts (three lanes a point with the spline
    read through the read-only cache, one lane with it staged in shared
    memory); the bound is computed from these inputs."""
    import torch
    from malio_tpu_torch.ops import deskew

    args = batch_args(args)
    pts, sp = args[0], args[1]
    B, L, N, C = *pts.shape[:3], sp.cps.shape[1]
    err, atol, want, err_plain = deskew_check(args)
    ms = kernel_ms(lambda: deskew.deskew_points(*args), "deskew_kernel")
    c_ms = call_ms(lambda: deskew.deskew_points(*args))
    p_ms, p_ops = device_ms(lambda: deskew.deskew_points_plain(*args))
    p_call = call_ms(lambda: deskew.deskew_points_plain(*args), n=10)
    layouts = {}
    for lanes in (1, 3):
        e = deskew_check(args, lanes=lanes)[0]
        layouts[f"lanes={lanes}"] = dict(
            ms=kernel_ms(lambda: deskew._launch(*args, lanes=lanes), "deskew_kernel"),
            max_abs_err=e)
    # the same points with no valid interval: loads, the interval test and
    # stores only, what a launch costs before any spline arithmetic
    none_ok = (pts, sp._replace(num_valid=torch.full_like(sp.num_valid, 3))) + tuple(args[2:])
    empty_ms = kernel_ms(lambda: deskew.deskew_points(*none_ok), "deskew_kernel")
    n_ok = int(want[..., 3].sum())
    # points in+out, splines, frames
    nbytes = B * (L * N * 32 + C * (16 + 6) * 4 + L * 14 * 4 + 8)
    nops = n_ok * DESKEW_OPS_PER_POINT + (B * L * N - n_ok) * DESKEW_OPS_OUTSIDE
    b_ms, b_by = bound(nbytes, nops)
    lanes = deskew.lanes_for(B * L * N)
    log(f"kernel {name} B={B} L={L} N={N} C={C} (lanes={lanes}): max |kernel - exact| {err:.3g} "
        f"(atol {atol:.3g}; |kernel - f32 plain| {err_plain:.3g}), ok flags equal ({n_ok}/{B * L * N} inside); device {ms:.5f} ms, "
        f"call {c_ms:.4f} ms (plain device {p_ms:.4f} ms in {p_ops:.0f} device ops, call "
        f"{p_call:.4f} ms); bound {b_ms:.6f} ms by {b_by}, {b_ms + floor:.6f} ms with the launch "
        f"floor; no point inside the window {empty_ms:.5f} ms; layouts "
        + ", ".join(f"{k} {v['ms']:.5f} ms" for k, v in layouts.items()))
    return dict(
        name=name, route="cuda", source="malio_tpu_torch/csrc/deskew.cu",
        replaces="malio_tpu/ops/deskew_pallas.py:197", shape=f"B={B} L={L} N={N} C={C}",
        shape_key=(B, L, N, C), lanes=lanes,
        max_abs_err=max([err] + [v["max_abs_err"] for v in layouts.values()]), atol=atol,
        f32_plain_abs_diff=err_plain, ms=ms,
        call_ms=c_ms, plain_ms=p_ms, plain_call_ms=p_call, plain_device_ops=p_ops,
        bound_ms=b_ms, bound_by=b_by, bound_with_floor_ms=b_ms + floor, bytes=nbytes, ops=nops,
        points_inside=n_ok, library_ms=None, library_call_ms=None, layouts=layouts,
        empty_window_ms=empty_ms,
    )


# one LiDAR, the Config default's 96-entry spline: point counts on both
# sides of the layouts' crossover (65,536 is the Config default)
SWEEP_POINTS = (12288, 24576, 36864, 49152, 65536, 196608)  # 196,608: 16 x 3 x 4096


def deskew_layout_sweep():
    """Device time of each kernel layout over SWEEP_POINTS, on seeded
    inputs with the times in random order (as `deskew_inputs` draws them):
    where three lanes a point stop paying."""
    from malio_tpu_torch.config import Config
    from malio_tpu_torch.ops import deskew

    out = []
    for n in SWEEP_POINTS:
        args = batch_args(deskew_inputs(1, n, Config.spline_capacity, seed=1))
        row = dict(points=n, times="random", default_lanes=deskew.lanes_for(n))
        for lanes in (1, 3):
            deskew_check(args, lanes=lanes)
            row[f"lanes={lanes}"] = kernel_ms(
                lambda: deskew._launch(*args, lanes=lanes), "deskew_kernel")
        out.append(row)
        log(f"deskew layouts, {n} points, random times: one lane {row['lanes=1']:.5f} ms, "
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
        args = batch_args(args)
        fn = lambda a=args: deskew.deskew_points(*a)
        results[name] = got = fn()
        same_ok, err, atol, _, _ = deskew_err(deskew, args, deskew.deskew_points)
        row = dict(shape="B={} L={} N={} C={}".format(*args[0].shape[:3], args[1].cps.shape[1]),
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


def _tree_module(tree, name):
    """Module `name` of the package malio_tpu_torch in checkout `tree`,
    imported under a name of its own beside this checkout's package (its
    kernels build into that checkout's _build/)."""
    import importlib
    import importlib.util

    pkg = pathlib.Path(tree).resolve() / "malio_tpu_torch"
    alias = "_tree_malio_tpu_torch"
    if alias not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        sys.modules[alias] = mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.{name}")


def merge_kernel_main(tree):
    """Time the merge kernel of the package in `tree` (for example the
    parent, unpacked by `git archive` into _local/parent) beside this
    checkout's, in turns (tree, this, this, tree), on seeded inputs at the
    paths' insert shapes (MERGE_PATH_SHAPES) and at micro_r4b's. Each
    result of either kernel is checked bit-equal to merge_rows_plain."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from malio_tpu_torch.ops import _build, merge

    other = _tree_module(tree, "ops.merge")
    t0 = time.perf_counter()
    _build.build_all(["merge_rows"])
    other._build.build_all(["merge_rows"])
    smi = gpu_name_and_limit()
    log(f"{smi}; both merge kernels built in {time.perf_counter() - t0:.1f} s")
    cases = {name: merge_path_inputs(*shape) for name, shape in MERGE_PATH_SHAPES.items()}
    cases.update({f"merge_rows_micro_T{lt}": merge_sorted_inputs(1 << lt) for lt in MERGE_LOG_T})
    out = dict(tree=str(tree), package=str(pathlib.Path(other.__file__).resolve().parents[1]),
               gpu=smi)
    for name, (tab, idx, rec) in cases.items():
        want = merge.merge_rows_plain(tab, idx, rec)
        valid = (idx >= 0) & (idx < tab.shape[0])
        n_valid = int(valid.sum())
        row = dict(shape=f"T={tab.shape[0]} N={idx.shape[0]} valid={n_valid}",
                   tree_ms=[], this_ms=[], tree_events=None, this_events=None)
        for who, mod in (("tree", other), ("this", merge), ("this", merge), ("tree", other)):
            fn = lambda m=mod: m.merge_rows(tab, idx, rec)
            if not torch.equal(_bits(fn()), _bits(want)):
                raise AssertionError(f"{name}: the {who} kernel differs from merge_rows_plain")
            ms, row[f"{who}_events"] = merge_device_ms(fn)
            row[f"{who}_ms"].append(ms)
        iv, rv = idx[valid].contiguous(), rec[valid].contiguous()
        row["library_ms"], _ = device_ms(lambda: tab.index_copy(0, iv, rv))
        row["clone_ms"], _ = device_ms(tab.clone)
        nbytes = merge_bytes(tab.shape[0], idx.shape[0], n_valid, 5 * tab.element_size())
        row["bound_ms"], _ = bound(nbytes, 0)
        log(f"{name} {row['shape']}: tree {row['tree_ms']} ms ({row['tree_events']} events a "
            f"call), this {row['this_ms']} ms ({row['this_events']}), index_copy "
            f"{row['library_ms']:.5f}, clone {row['clone_ms']:.5f}, bound {row['bound_ms']:.5f} ms")
        out[name] = row
    out["traces"], out["trace_retakes"] = len(TRACES), [t for t in TRACES if not t["ok"]]
    print(json.dumps(out))
    return 0


def dist_mp_main(tree):
    """The distributed cell's mp = 2 world (flagship seed 0, DIST_ROUNDS
    rounds, two processes sharing the card over gloo) through the
    sharding worker of the package in `tree` (for example the parent,
    unpacked by `git archive` into _local/parent) beside this checkout's,
    on the same inputs, in turns (tree, this, this, tree): every rank's
    median round time (host clock, synchronised) and collectives a
    round."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from malio_tpu_torch.config import flagship_config
    from malio_tpu_torch.distributed import sharding

    other = _tree_module(tree, "distributed.sharding")
    smi = gpu_name_and_limit()
    cfg = flagship_config()
    groups, _ = flagship_groups(cfg, 8.0, seed=0)
    d = ROOT / "chiprun_out" / "dist_mp_ab"
    d.mkdir(parents=True, exist_ok=True)
    dist_inputs(cfg, d / "mp.npz", [groups])
    out = dict(tree=str(tree), package=str(pathlib.Path(other.__file__).resolve().parents[2]),
               gpu=smi, tree_round_ms=[], this_round_ms=[])
    for who, mod in (("tree", other), ("this", sharding), ("this", sharding), ("tree", other)):
        stats = mod.run_local(d / "mp.npz", d / f"{who}_out.npz", DIST_MP, DIST_MP,
                              deadline_s=DIST_DEADLINE_S)
        ms = [statistics.median(st["round_ms"][1:]) for st in stats]
        out[f"{who}_round_ms"].append(ms)
        log(f"dist mp={DIST_MP} through {who}: round {ms} ms median by rank, collectives a round "
            f"{statistics.median(stats[0]['collectives_per_round'])}; {smi}")
    for f in d.glob("*.npz"):
        f.unlink()
    print(json.dumps(out))
    return 0


def eigvalsh_main():
    """The main path (flagship, seed 0, 8 s) through the eager round twice:
    with the localization weight's eigen-solve as the round has it
    (`linalg.eigvalsh3`, the closed form a graph can capture) and with
    `torch.linalg.eigvalsh` (cuSOLVER, which reads its status on the host)
    in its place; the ATE of each, unrounded."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from malio_tpu_torch import measurement, runner
    from malio_tpu_torch.config import flagship_config
    from malio_tpu_torch.eval.ate import ate_rmse

    cfg = flagship_config()
    groups, traj = flagship_groups(cfg, 8.0, seed=0)
    out = dict(gpu=gpu_name_and_limit())
    closed_form = measurement.eigvalsh3
    try:
        for name, fn in (("eigvalsh3", closed_form), ("torch.linalg.eigvalsh", torch.linalg.eigvalsh)):
            measurement.eigvalsh3 = fn
            with _Eager():
                r = runner.run_sequence(cfg, groups, dtype=torch.float32, device="cuda")
            out[name] = ate_rmse(r["pos"], traj.pos(r["t"]))
            log(f"main path, eager, eigen-solve {name}: ATE {out[name]!r} m")
    finally:
        measurement.eigvalsh3 = closed_form
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


def _profile_rounds(drive, skip, active):
    """One traced replay, `drive(tick, rounds)` running `rounds` rounds and
    calling tick(carry, out, base) after each: rounds `skip` .. `skip +
    active - 1` inside a
    torch.profiler session that starts TRACE_LEAD_IN_S and one untraced
    round before them, with a marker kernel at the start of each traced
    round and after the last.
    Returns the session's events, the device activities between the first
    and the last marker (markers left out), the markers' positions and the
    host time per traced round."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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

    drive(tick, skip + active)
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


def run_rounds(cfg, groups, n_init):
    """Rounds for profile_phase: the main path's replay (run_sequence)."""
    import torch
    from malio_tpu_torch import runner

    def drive(tick, rounds):
        runner.run_sequence(cfg, groups[: n_init + rounds], dtype=torch.float32, device="cuda",
                            callback=tick)

    return drive


def profile_phase(drive, round_ms, skip=8, active=5, label="profile"):
    """Where a steady round's time goes: `active` rounds after `skip` of
    `drive` (see _profile_rounds) traced with torch.profiler (kernels on).
    Returns the device busy time
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
            drive, skip, active)
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
    # the session's launches but the markers', over its active + 1 rounds:
    # kernels, graphs (a compiled round is one) and copies
    def per_round(api):
        return sum(1 for e in events if e.name == api) / (active + 1)

    launches = per_round("cudaLaunchKernel") - len(marks) / (active + 1)
    knn_ms = sum(ms for name, ms in by_name.items() if "knn_window_" in name)
    desk_ms = sum(ms for name, ms in by_name.items() if "deskew_kernel" in name)
    out = dict(rounds=active, round_ms=round_ms, traced_round_ms=traced_ms,
               device_busy_ms_per_round=busy_ms, device_idle_share=1.0 - busy_ms / round_ms,
               launches_per_round=launches, graph_launches_per_round=per_round("cudaGraphLaunch"),
               copies_per_round=per_round("cudaMemcpyAsync"), device_ops_per_round=len(dev) / active,
               knn_window_ms_per_round=knn_ms, deskew_ms_per_round=desk_ms,
               retakes=attempt - 1, top_device_ms_per_round=top)
    log(f"{label}, {active} steady rounds (trace {attempt}, all {len(marks)} markers): device "
        f"busy {busy_ms:.2f} ms/round of a {round_ms:.1f} ms round (idle share "
        f"{out['device_idle_share']:.3f}; {traced_ms:.1f} ms/round while traced), {launches:.0f} "
        f"kernel launches, {out['graph_launches_per_round']:.0f} graph launches, "
        f"{out['copies_per_round']:.0f} copies and {out['device_ops_per_round']:.0f} device "
        f"operations a round; fused k-NN kernel {knn_ms:.4f} ms/round, deskew "
        f"{desk_ms:.4f} ms/round")
    for name, ms in top:
        log(f"  {ms:8.3f} ms/round  {name[:100]}")
    return out


def flagship_sequence(cfg, duration, seed, traj_kwargs=None):
    """The flagship world seen by the City rig for `duration` seconds:
    (imu, rounds, trajectory)."""
    import numpy as np
    from malio_tpu_torch.config import FLAGSHIP_RANGE_MAX, FLAGSHIP_WORLD
    from malio_tpu_torch.io.synthetic import SyntheticSequence

    return SyntheticSequence(
        duration=duration, num_lidars=3, points_per_scan=cfg.max_raw_points, seed=seed,
        ext_t=np.asarray(cfg.extrinsic_T, np.float64).reshape(3, 3),
        ext_q_wxyz=np.asarray(cfg.extrinsic_R, np.float64).reshape(3, 4),
        range_max=FLAGSHIP_RANGE_MAX, world_kwargs=FLAGSHIP_WORLD, traj_kwargs=traj_kwargs,
    ).generate()


def flagship_groups(cfg, duration, seed, traj_kwargs=None):
    from malio_tpu_torch.io.assemble import assemble_groups

    imu, rounds, traj = flagship_sequence(cfg, duration, seed, traj_kwargs)
    return assemble_groups(cfg, imu, rounds), traj


def reset_launches():
    """Every kernel wrapper's launch count to 0."""
    from malio_tpu_torch import ops

    ops.reset_launches()


def read_launches(path, kernels=("knn_window", "deskew", "merge_rows")):
    """The launches of the run just driven, by kernel and shape; fails if
    a kernel of the path was launched no time."""
    from malio_tpu_torch import ops

    counts = {name: dict(fn.launches_by_shape) for name, fn in ops.wrappers().items()}
    for name in kernels:
        if not counts[name]:
            raise AssertionError(f"{path} path: kernel {name} was launched no time ({counts})")
    return counts


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _ms_since(t0):
    _sync()
    return (time.perf_counter() - t0) * 1e3


def _same(name, got, want):
    """Bit-equality of two host arrays, or a failure naming the largest
    difference."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        d = np.abs(got - want).max() if got.shape == want.shape else "shape"
        raise AssertionError(f"{name}: not bit-equal (shapes {got.shape} / {want.shape}, max "
                             f"|difference| {d})")


class _Eager:
    """Inside it `pipeline.step` and `pipeline.scan_steps` run the eager
    round (`pipeline.step_eager`, op by op, as on the CPU) wherever the
    runner, the live path, batched replay and the soak call them: the
    eager round beside the compiled one, and the runs whose swapped
    functions (a plain merge, a log of every operation) must act at every
    round, not only at a capture."""

    def __enter__(self):
        from malio_tpu_torch import pipeline, tree

        self._fns = pipeline.step, pipeline.scan_steps

        def scan_steps(cfg, carry, groups, device="cuda"):
            outs = []
            for k in range(groups.pts.shape[0]):
                carry, out = pipeline.step_eager(cfg, carry, tree.index(groups, k), device=device)
                outs.append(out)
            return carry, tree.stack(outs)

        pipeline.step, pipeline.scan_steps = pipeline.step_eager, scan_steps
        return self

    def __exit__(self, *exc):
        from malio_tpu_torch import pipeline

        pipeline.step, pipeline.scan_steps = self._fns


def compiled_report(cr):
    """A compiled round's capture: warm-up and capture (with instantiation)
    host seconds, graph nodes, the pool it reserved and each kernel's
    launches a replay by shape."""
    return dict(warmup_s=cr.warmup_s, capture_s=cr.capture_s, nodes=cr.nodes,
                pool_bytes=cr.pool_bytes, replays=cr.replays,
                launches_per_round={k: {",".join(map(str, sh)): n for sh, n in v.items()}
                                    for k, v in cr.launches.items()})


def graph_phase(cfg, groups, v_base, v_wide, smi, dev="cuda"):
    """The compiled round at the flagship's shape: run_sequence over the
    first GRAPH_GROUPS groups captures it at its first round (a warm-up
    round on a side stream, then the capture) and replays it for the
    rest. Fails unless exactly one round was captured and it launches the
    k-NN at the base window and at the wide budget, the deskew and the
    merge once each. Returns (report, the groups the IMU initialisation
    took, the rounds run)."""
    import torch
    from malio_tpu_torch import pipeline, runner

    before = len(pipeline.compiled_rounds())
    r = runner.run_sequence(cfg, groups[:GRAPH_GROUPS], dtype=torch.float32, device=dev)
    new = pipeline.compiled_rounds()[before:]
    if len(new) != 1:
        raise AssertionError(f"graph: {len(new)} rounds captured at the flagship's shape, not 1")
    cr = new[0]
    per = cr.launches
    knn_v = collections.Counter()
    for (q, v, k), n in per.get("knn_window", {}).items():
        knn_v[v] += n
    if (knn_v[v_base] != 1 or knn_v[v_wide] != 1 or sum(per.get("deskew", {}).values()) != 1
            or sum(per.get("merge_rows", {}).values()) != 1):
        raise AssertionError(f"graph: the captured round does not launch each kernel once: {per}")
    out = compiled_report(cr)
    log(f"graph: the round captured at B = 1 in {cr.capture_s:.3f} s (warm-up round "
        f"{cr.warmup_s:.3f} s), {cr.nodes} graph nodes, pool {cr.pool_bytes} B; launches a replay "
        f"{per}; {smi}")
    return out, GRAPH_GROUPS - len(r["t"]), r


def sync_check(cfg, carry, groups, n_init, at, dev="cuda"):
    """A steady compiled round (`pipeline.step` on `carry`, the carry after
    round `at`) and a scan_steps chunk of two rounds under
    torch.cuda.set_sync_debug_mode("error"): any host sync inside raises.
    The groups go to the card before."""
    import numpy as np
    import torch
    from malio_tpu_torch import pipeline, runner, tree

    gdev, _ = runner._stack_chunk(groups[n_init + at : n_init + at + 2], np.float32,
                                  runner.group_base(groups[n_init + at - 1]), dev)
    g0 = tree.index(gdev, 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipeline.step(cfg, carry, g0, device=dev)
        pipeline.scan_steps(cfg, carry, gdev, device=dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("graph: a steady round and a scan_steps chunk of two made no host sync "
        "(set_sync_debug_mode('error'))")
    return dict(step=True, scan_steps_rounds=2)


def scan_steps_phase(cfg, groups, n_init, res, dev="cuda"):
    """run_sequence with no hooks over the first SCAN_ROUNDS rounds: two
    full chunks through pipeline.scan_steps, which must give the main
    path's (per-round, callback) poses and map sizes bit for bit."""
    import torch
    from malio_tpu_torch import runner

    reset_launches()
    t0 = time.perf_counter()
    r = runner.run_sequence(cfg, groups[: n_init + SCAN_ROUNDS], dtype=torch.float32, device=dev)
    wall = _ms_since(t0)
    counts = read_launches("scan_steps")
    for f in ("t", "pos", "quat", "map_size"):
        _same(f"scan_steps {f}", r[f], res[f][:SCAN_ROUNDS])
    log(f"scan_steps: {len(r['t'])} rounds in two chunks bit-equal to the main path's first "
        f"{SCAN_ROUNDS} (pos, quat, map_size); {wall:.0f} ms")
    return dict(rounds=len(r["t"]), wall_ms=wall), counts


def online_phase(cfg, imu, rounds, res, ate_main, traj, dev="cuda"):
    """The live path: the flagship sequence pushed through OnlineEstimator
    in arrival order, polled after every push that fused a round, then
    flush() and a last poll(). Round count, times and poses must equal the
    main path's bit for bit. Push-to-pose latency: host clock from the
    push that completes a round to poll() returning its pose (poll
    synchronises)."""
    import numpy as np
    import torch
    from malio_tpu_torch import online, run_dataset
    from malio_tpu_torch.eval.ate import ate_rmse

    reset_launches()
    est = online.OnlineEstimator(cfg, dtype=torch.float32, device=dev)
    outs, latency, poll_ms = [], [], []
    t_all = time.perf_counter()
    for kind, _, p in run_dataset.arrival_events(imu, rounds):
        t0 = time.perf_counter()
        if kind == "imu":
            est.push_imu(p[0], p[1:4], p[4:7])
        else:
            est.push_scan(p[0], p[1], p[2], duration=p[3])
        if est._pending:
            t1 = time.perf_counter()
            got = est.poll()
            t2 = time.perf_counter()
            poll_ms.append((t2 - t1) * 1e3)
            latency.extend([(t2 - t0) * 1e3] * len(got))
            outs.extend(got)
    est.flush()
    t1 = time.perf_counter()
    got = est.poll()
    poll_ms.append((time.perf_counter() - t1) * 1e3)
    outs.extend(got)
    wall = _ms_since(t_all)
    counts = read_launches("online")
    t = np.asarray([o["t"] for o in outs])
    pos = np.stack([o["pos"] for o in outs])
    if len(outs) != len(res["t"]):
        raise AssertionError(f"online: {len(outs)} rounds, the main path {len(res['t'])}")
    _same("online t", t, res["t"])
    _same("online pos", pos, res["pos"])
    _same("online quat", np.stack([o["quat"] for o in outs]), res["quat"])
    ate = ate_rmse(pos, traj.pos(t))
    _same("online ATE", ate, ate_main)
    q = lambda a, p_: float(np.percentile(a, p_))
    out = dict(rounds=len(outs), ate_m=ate, wall_ms=wall, n_dropped_scans=est.n_dropped_scans,
               latency_ms=dict(p50=q(latency, 50), p90=q(latency, 90), max=max(latency)),
               poll_ms=dict(p50=q(poll_ms, 50), p90=q(poll_ms, 90), max=max(poll_ms),
                            calls=len(poll_ms)))
    log(f"online: {len(outs)} rounds, trajectory and ATE {ate:.6f} m bit-equal to the main path; "
        f"push-to-pose latency p50 {out['latency_ms']['p50']:.1f} ms, p90 "
        f"{out['latency_ms']['p90']:.1f} ms, max {out['latency_ms']['max']:.1f} ms; poll() p50 "
        f"{out['poll_ms']['p50']:.2f} ms over {len(poll_ms)} calls; dropped scans "
        f"{est.n_dropped_scans}")
    return out, counts


def resume_phase(cfg, groups, n_init, saved, res, out_dir, dev="cuda"):
    """Checkpoint/resume: the carry after round RESUME_AT saved, loaded into
    a fresh template, rounds RESUME_AT+1..RESUME_TO stepped from it; poses,
    times and map sizes must equal the uninterrupted main path's."""
    import numpy as np
    import torch
    from malio_tpu_torch import checkpoint, pipeline, runner, state
    from malio_tpu_torch import propagate as prop

    path = out_dir / "resume_carry.npz"
    _sync()
    t0 = time.perf_counter()
    checkpoint.save(path, saved)
    save_ms = _ms_since(t0)
    size = path.stat().st_size
    L = cfg.num_lidars
    n = state.dof(L)
    template = pipeline.init_carry(
        cfg, state.identity_state(L, device=dev), torch.eye(n, dtype=torch.float64, device=dev),
        torch.eye(12, device=dev), torch.float32, dev)
    t0 = time.perf_counter()
    loaded = checkpoint.load(path, template)
    load_ms = _ms_since(t0)
    path.unlink()
    for (k, a), (_, b) in zip(checkpoint._leaves(loaded), checkpoint._leaves(saved)):
        if not (a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)):
            raise AssertionError(f"checkpoint: {k} did not load back as saved")
    reset_launches()
    chunk = groups[n_init + RESUME_AT : n_init + RESUME_TO]
    gdev, bases = runner._stack_chunk(chunk, np.float32,
                                      runner.group_base(groups[n_init + RESUME_AT - 1]), dev)
    c, rows = loaded, []
    for k in range(len(chunk)):
        c, o = pipeline.step(cfg, c, prop.MeasureGroup(*(a[k] for a in gdev)), device=dev)
        rows.append((float(o.end_time) + bases[k], o.pos.cpu().numpy(), o.quat.cpu().numpy(),
                     int(o.map_size)))
    counts = read_launches("resume")
    for i, f in enumerate(("t", "pos", "quat", "map_size")):
        _same(f"resume {f}", np.asarray([r[i] for r in rows]), res[f][RESUME_AT:RESUME_TO])
    log(f"checkpoint: {size} B npz, save {save_ms:.0f} ms, load {load_ms:.0f} ms; rounds "
        f"{RESUME_AT + 1}-{RESUME_TO} resumed bit-equal to the uninterrupted run")
    return dict(file_bytes=size, save_ms=save_ms, load_ms=load_ms,
                rounds=RESUME_TO - RESUME_AT), counts


class _Timed:
    """Wraps a module's or object's function for one phase: each call is
    timed on the host clock between two synchronises; `first` keeps the
    first call's (args, kwargs)."""

    def __init__(self, owner, name):
        self.owner, self.name, self.ms, self.first = owner, name, [], None
        self.fn = getattr(owner, name)

    def __enter__(self):
        def timed(*a, **kw):
            if self.first is None:
                self.first = (a, kw)
            _sync()
            t0 = time.perf_counter()
            out = self.fn(*a, **kw)
            self.ms.append(_ms_since(t0))
            return out

        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


def capture_report(before, dev="cuda"):
    """The captures made since graph.captures() held `before`, by program:
    each one's warm-up and capture seconds, nodes, pool and replays."""
    from malio_tpu_torch import graph

    out = collections.defaultdict(list)
    for key, cr in graph.captures()[before:]:
        out[key[0]].append(compiled_report(cr))
    return dict(out)


def _bits_equal(name, got, want):
    """Bit-equality of two nests of card tensors, or a failure naming the
    first leaf that differs."""
    from malio_tpu_torch import tree

    for k, (a, b) in enumerate(zip(tree.leaves(got), tree.leaves(want))):
        _same(f"{name} leaf {k}", a.cpu().numpy(), b.cpu().numpy())


def program_checks(calls, dev="cuda"):
    """Each back-end program on the arguments it took on the path: the
    replay of its capture (the public function on the card) bit-equal to
    its _eager version, then one more replay under
    torch.cuda.set_sync_debug_mode("error") (any host sync raises).
    `calls` maps a name to (public, eager, (args, kwargs)). Returns the
    arguments of the last tridiagonal solve of the first eager program
    that ran one."""
    import torch
    from malio_tpu_torch.ops import block_tridiag

    tridiag = None
    for name, (fn, eager, (a, kw)) in calls.items():
        got = fn(*a, **kw)
        with _Recording(block_tridiag, "block_tridiag_solve") as rec:
            want = eager(*a, **kw)
        if rec.args is not None and tridiag is None:
            tridiag = tuple(t.clone() for t in rec.args)
        _bits_equal(f"{name}: graph against eager", got, want)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = fn(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        _bits_equal(f"{name}: a second replay", again, got)
        log(f"back end: {name} replayed bit-equal to its eager version on the path's arguments; "
            f"a replay made no host sync (set_sync_debug_mode('error'))")
    return tridiag


def backend_phase(cfg, seconds=BACKEND_SECONDS, dev="cuda"):
    """The back end with loop-closure feedback at full sensor width: the
    flagship config, world and capacities on a revisiting circle for
    BACKEND_SECONDS, through run_sequence with a WindowSmoother at its
    defaults and a PoseGraphBackend(feedback=True) at its default widths
    and capacity and the sparse-cloud ICP settings BACKEND_ICP. Requires a
    closed loop, a staged correction, graph ATE <= 1.1 x odometry ATE +
    0.01 m (both unaligned, as tests/test_posegraph.py:642 judges) and no
    drops. Reports the back-end programs' captures; the first relax's
    optimize_sparse, the first optimize_window and the first
    refine_loop_edge replayed again and run through their _eager versions
    (bit-equal), each replay once more with no host sync. Returns (report,
    launches, the arguments of the eager first relax's last tridiagonal
    solve)."""
    import numpy as np
    import torch
    from malio_tpu_torch import ba, graph, pipeline, posegraph, runner, smoother
    from malio_tpu_torch.eval.ate import ate_rmse
    from malio_tpu_torch.io.assemble import assemble_groups

    t0 = time.perf_counter()
    imu, rounds, traj = flagship_sequence(cfg, seconds, BACKEND_SEED, BACKEND_CIRCLE)
    groups = assemble_groups(cfg, imu, rounds)
    gen_s = time.perf_counter() - t0
    sm = smoother.WindowSmoother(device=dev)
    pg = posegraph.PoseGraphBackend(feedback=True, capacity=BACKEND_CAPACITY, device=dev,
                                    **BACKEND_ICP)
    before = len(graph.captures())
    reset_launches()
    t0 = time.perf_counter()
    with _Timed(pg, "relax") as relax, _Timed(posegraph, "optimize_sparse") as solve, \
            _Timed(ba, "optimize_window") as bundle, _Timed(posegraph, "refine_loop_edge") as icp, \
            _Timed(pipeline, "apply_world_correction") as corr:
        res = runner.run_sequence(cfg, groups, dtype=torch.float32, device=dev,
                                  smoother=sm, posegraph=pg)
    wall = _ms_since(t0)
    counts = read_launches("backend", ("knn_window", "deskew", "merge_rows", "block_tridiag"))
    captures = capture_report(before)
    ate_odo = ate_rmse(res["pos"], traj.pos(res["t"]), align=False)
    ts, ps, _ = res["smoothed"]
    ate_smooth = ate_rmse(ps, traj.pos(ts), align=False) if len(ts) else float("nan")
    tg, pgp, qg = res["graph"]
    ate_graph = ate_rmse(pgp, traj.pos(tg), align=False)
    drops = (int(res["map_dropped"][-1]), int(res["n_meas_dropped"].max()))
    out = dict(seconds=seconds, seed=BACKEND_SEED, capacity=BACKEND_CAPACITY,
               rounds=len(res["t"]), generate_s=gen_s, wall_ms=wall,
               rounds_per_s=len(res["t"]) / (wall / 1e3), ate_odometry_m=ate_odo,
               ate_smoothed_m=ate_smooth, ate_graph_m=ate_graph, keyframes=pg.count,
               smoothed_keyframes=len(ts), n_loop_edges=pg.n_loop_edges,
               n_feedback=pg.n_feedback, map_dropped=drops[0], meas_dropped=drops[1],
               relax_ms=relax.ms, optimize_sparse_ms=solve.ms, optimize_window_ms=bundle.ms,
               refine_loop_edge_ms=icp.ms, apply_world_correction_ms=corr.ms, icp=BACKEND_ICP,
               captures=captures,
               loop_edge_s=[float(pg.times[e[1]]) for e in pg.edges if e[5] == "loop"])
    r1 = lambda xs: [round(x, 1) for x in xs]
    log(f"back end ({seconds:.0f} s circle, seed {BACKEND_SEED}, capacity "
        f"{BACKEND_CAPACITY}): {len(res['t'])} rounds in {wall / 1e3:.1f} s "
        f"({out['rounds_per_s']:.2f} rounds/s), {pg.count} keyframes, "
        f"{pg.n_loop_edges} loop edges (keyframes at {[round(x, 1) for x in out['loop_edge_s']]} s), "
        f"{pg.n_feedback} corrections fed back; ATE odometry "
        f"{ate_odo:.4f} m, smoothed {ate_smooth:.4f} m, graph {ate_graph:.4f} m (unaligned); drops "
        f"{drops}; relax() ms {r1(relax.ms)} (optimize_sparse {r1(solve.ms)}); optimize_window "
        f"ms {r1(bundle.ms)}; refine_loop_edge ms {r1(icp.ms)}; apply_world_correction ms "
        f"{r1(corr.ms)}")
    for prog, reps in captures.items():
        for c in reps:
            log(f"back end: {prog} captured in {c['capture_s']:.3f} s (warm-up "
                f"{c['warmup_s']:.3f} s), {c['nodes']} graph nodes, pool {c['pool_bytes']} B, "
                f"{c['replays']} replays, launches a replay {c['launches_per_round']}")
    if not (np.isfinite(pgp).all() and np.isfinite(res["pos"]).all() and np.isfinite(ps).all()):
        raise AssertionError("back end: non-finite trajectory")
    if pg.n_loop_edges < 1 or pg.n_feedback < 1:
        raise AssertionError(f"back end: {pg.n_loop_edges} loop edges, {pg.n_feedback} corrections")
    if not ate_graph <= 1.1 * ate_odo + 0.01:
        raise AssertionError(f"back end: graph ATE {ate_graph} > 1.1 x {ate_odo} + 0.01")
    if drops != (0, 0):
        raise AssertionError(f"back end: map / measurement drops {drops}")
    for prog in ("optimize_sparse", "optimize_window", "icp"):
        if prog not in captures:
            raise AssertionError(f"back end: no {prog} capture ({list(captures)})")
    tridiag = program_checks({
        "optimize_sparse (the first relax)": (posegraph.optimize_sparse,
                                              posegraph.optimize_sparse_eager, solve.first),
        "optimize_window (the first)": (ba.optimize_window, ba.optimize_window_eager,
                                        bundle.first),
        "refine_loop_edge (the first)": (posegraph.refine_loop_edge,
                                         posegraph.refine_loop_edge_eager, icp.first),
    }, dev)
    out["graph_eager_bit_equal"] = out["replay_sync_free"] = True
    return out, counts, tridiag


def solver_scene(K=SOLVER_K, dev="cuda"):
    """The scene of tests/test_posegraph.py:703 built with the port's own
    code: K keyframes on two laps of a 60 m circle, noisy odometry, ~20
    loop edges one lap apart. Returns (q0, t0, odo, loops, t_gt, t_est)."""
    import numpy as np
    import torch
    from malio_tpu_torch import posegraph as pgm
    from malio_tpu_torch.geometry import so3

    rng = np.random.default_rng(1)
    th = np.linspace(0, 4 * np.pi, K)
    t_gt = np.stack([60 * np.cos(th), 60 * np.sin(th), 2.0 * np.sin(5 * th)], -1)
    q_gt = np.stack([np.cos(th / 2), np.zeros(K), np.zeros(K), np.sin(th / 2)], -1)
    h = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    zq, zt = (x.numpy() for x in pgm.relative_pose(h(q_gt[:-1]), h(t_gt[:-1]), h(q_gt[1:]),
                                                    h(t_gt[1:])))
    q_est, t_est = np.tile([1.0, 0, 0, 0], (K, 1)), np.zeros((K, 3))
    q_est[0], t_est[0] = q_gt[0], t_gt[0]
    odo = []
    for i in range(K - 1):
        zqn = zq[i] + rng.normal(size=4) * 2e-4
        zqn /= np.linalg.norm(zqn)
        ztn = zt[i] + rng.normal(size=3) * 5e-3
        odo.append((i, i + 1, zqn, ztn, 1.0))
        q_est[i + 1] = so3.quat_mul(h(q_est[i]), h(zqn)).numpy()
        t_est[i + 1] = t_est[i] + so3.quat_rotate(h(q_est[i]), h(ztn)).numpy()
    loops = []
    for k in range(20):
        i = 51 * k + 7
        j = i + K // 2  # the same bearing one lap later
        if j >= K:
            break
        a, b = pgm.relative_pose(h(q_gt[i]), h(t_gt[i]), h(q_gt[j]), h(t_gt[j]))
        loops.append((i, j, a.numpy(), b.numpy(), 3.0, "loop"))
    packer = pgm.PoseGraphBackend(capacity=K, loop_capacity=32, cloud_points=1, device=dev)
    odo_e = packer._pack_edges([e + ("odo",) for e in odo], K - 1)
    loop_e = packer._pack_edges(loops, 32)
    f64 = dict(dtype=torch.float64, device=dev)
    return (torch.as_tensor(q_est, **f64), torch.as_tensor(t_est, **f64), odo_e, loop_e, t_gt,
            t_est, len(loops))


def solver_phase(K=SOLVER_K, dev="cuda"):
    """optimize_sparse at SOLVER_K keyframes with ~20 loop edges
    (solver_scene), timed on the card: the first call (with its capture),
    a second (a replay, bit-equal to the first) and the eager version
    once (bit-equal). Requires the cost to fall 20-fold and the aligned
    ATE to fall 30 %, as that test does. Returns (report, launches, the
    last eager iteration's tridiagonal solve arguments)."""
    import torch
    from malio_tpu_torch import graph
    from malio_tpu_torch import posegraph as pgm
    from malio_tpu_torch.eval.ate import ate_rmse
    from malio_tpu_torch.ops import block_tridiag

    q0, t0_, odo_e, loop_e, t_gt, t_est, n_loops = solver_scene(K, dev)
    before = len(graph.captures())
    reset_launches()
    _sync()
    t0 = time.perf_counter()
    got = pgm.optimize_sparse(q0, t0_, odo_e, loop_e, iters=8)
    ms_first = _ms_since(t0)
    t0 = time.perf_counter()
    again = pgm.optimize_sparse(q0, t0_, odo_e, loop_e, iters=8)
    ms = _ms_since(t0)
    counts = read_launches("solver", ("block_tridiag",))
    captures = capture_report(before)
    t0 = time.perf_counter()
    with _Recording(block_tridiag, "block_tridiag_solve") as rec:
        want = pgm.optimize_sparse_eager(q0, t0_, odo_e, loop_e, iters=8)
    ms_eager = _ms_since(t0)
    _bits_equal("optimize_sparse: a second replay", again, got)
    _bits_equal("optimize_sparse: graph against eager", got, want)
    qs, ts, c1, c0 = got
    ts = ts.cpu().numpy()
    ate0, ate1 = ate_rmse(t_est, t_gt), ate_rmse(ts, t_gt)
    c0, c1 = float(c0), float(c1)
    cap = captures["optimize_sparse"][0]
    out = dict(K=K, loop_edges=n_loops, iters=8, ms=ms, first_call_ms=ms_first,
               eager_ms=ms_eager, cost0=c0, cost1=c1, ate0_m=ate0, ate1_m=ate1,
               capture=cap, graph_eager_bit_equal=True)
    log(f"optimize_sparse K={K}, {n_loops} loop edges, 8 iterations: {ms:.1f} ms a replayed call "
        f"(first call with its capture {ms_first:.1f} ms: capture {cap['capture_s']:.3f} s, "
        f"warm-up {cap['warmup_s']:.3f} s, {cap['nodes']} nodes, pool {cap['pool_bytes']} B); "
        f"eager {ms_eager:.1f} ms, bit-equal; cost {c0:.4g} -> {c1:.4g}; aligned ATE "
        f"{ate0:.3f} -> {ate1:.3f} m")
    if not (c1 < 0.05 * c0 and ate1 < 0.7 * ate0):
        raise AssertionError(f"optimize_sparse at K={K}: cost {c0} -> {c1}, ATE {ate0} -> {ate1}")
    return out, counts, tuple(t.clone() for t in rec.args)


def tridiag_inputs(K, r, seed=0, damping=0.1):
    """A seeded SPD block-tridiagonal system with optimize_sparse's
    structure, as numpy f64: a chain of edge Hessians J^T J (random 6 x 12
    Jacobians), `damping` on the diagonal, node 0 pinned by the 1e8 gauge
    prior; RHS (K, 6, r)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    J = rng.normal(size=(K - 1, 6, 12))
    H = np.einsum("eai,eaj->eij", J, J)
    D = np.zeros((K, 6, 6))
    D[:-1] += H[:, :6, :6]
    D[1:] += H[:, 6:, 6:]
    D += damping * np.eye(6)
    D[0] += 1e8 * np.eye(6)
    return D, np.ascontiguousarray(H[:, :6, 6:]), rng.normal(size=(K, 6, r))


def tridiag_residual(D, Boff, RHS, Y):
    """max |T Y - RHS| over all entries, T applied block by block."""
    TY = D @ Y
    TY[:-1] += Boff @ Y[1:]
    TY[1:] += Boff.transpose(-1, -2) @ Y[:-1]
    return float((TY - RHS).abs().max())


def tridiag_check(D, Boff, RHS):
    """The kernel against its plain version on (D, Boff, RHS): the largest
    column-wise difference relative to the plain column's largest entry,
    the largest absolute difference, and both residuals."""
    import torch
    from malio_tpu_torch.ops import block_tridiag as bt

    Y = bt.block_tridiag_solve(D, Boff, RHS)
    Yp = bt.block_tridiag_solve_plain(D, Boff, RHS)
    col = (Y - Yp).abs().amax(dim=(0, 1))
    rel = float((col / Yp.abs().amax(dim=(0, 1)).clamp_min(torch.finfo(Yp.dtype).tiny)).max())
    return dict(rel_colwise=rel, max_abs_err=float(col.max()),
                residual=tridiag_residual(D, Boff, RHS, Y),
                residual_plain=tridiag_residual(D, Boff, RHS, Yp),
                finite=bool(torch.isfinite(Y).all()))


def _dense_tridiag(D, Boff):
    import torch

    K = D.shape[0]
    T = torch.zeros((K, 6, K, 6), dtype=D.dtype, device=D.device)
    i = torch.arange(K, device=D.device)
    T[i, :, i, :] = D
    T[i[:-1], :, i[1:], :] = Boff
    T[i[1:], :, i[:-1], :] = Boff.transpose(-1, -2)
    return T.reshape(6 * K, 6 * K)


def tridiag_row(name, args, path=None):
    """The block-tridiagonal kernel on args (D, Boff, RHS): held to its
    plain version (tridiag_check: the residual within TRIDIAG_RESIDUAL_X
    of the plain one's; the column-wise TRIDIAG_REL reported and, where
    the conditioning defeats it, named), timed alone on the device
    (CUPTI, median of 50), per wrapper call, against the plain version (CUDA
    events around whole calls: ~90 launches a step) and against
    torch.linalg.solve_ex on the dense 6K x 6K T (assembly excluded; None
    where the card's memory refuses it); the bound from these inputs."""
    import torch
    from malio_tpu_torch.ops import block_tridiag as bt

    D, Boff, RHS = args
    K, r = D.shape[0], RHS.shape[-1]
    chk = tridiag_check(*args)
    if not (chk["finite"] and chk["residual"] <= TRIDIAG_RESIDUAL_X * chk["residual_plain"]):
        raise AssertionError(f"{name}: kernel residual {chk['residual']} against the plain "
                             f"version's {chk['residual_plain']} (limit x{TRIDIAG_RESIDUAL_X}), "
                             f"finite {chk['finite']}")
    within = chk["rel_colwise"] <= TRIDIAG_REL
    fn = lambda: bt.block_tridiag_solve(D, Boff, RHS)
    ms = kernel_ms(fn, "block_tridiag_kernel")
    c_ms = call_ms(fn, n=20)
    p_ms = call_ms(lambda: bt.block_tridiag_solve_plain(D, Boff, RHS), n=2 if K > 256 else 10,
                   warm=1)
    try:
        T = _dense_tridiag(D, Boff)
        rhs = RHS.reshape(6 * K, r)
        l_ms = call_ms(lambda: torch.linalg.solve_ex(T, rhs, check_errors=False), n=3, warm=1)
        del T, rhs
    except torch.cuda.OutOfMemoryError:
        l_ms = None
    torch.cuda.empty_cache()
    nbytes = 8 * (D.numel() + Boff.numel() + 2 * RHS.numel())
    nops = TRIDIAG_CHAIN_OPS * K + TRIDIAG_COLUMN_OPS * K * r
    b_ms, b_by = bound(nbytes, nops, F64_OPS_PER_S)
    lib = f"{l_ms:.3f} ms" if l_ms is not None else "not measured (out of memory)"
    log(f"kernel {name} K={K} r={r}: residual {chk['residual']:.3g} (plain "
        f"{chk['residual_plain']:.3g}); column-wise difference {chk['rel_colwise']:.3g} of the "
        f"plain column ({'within' if within else 'OUTSIDE'} {TRIDIAG_REL}"
        f"{'' if within else ': the residual decides'}), max |difference| "
        f"{chk['max_abs_err']:.3g}; device {ms:.4f} ms, call {c_ms:.4f} ms (plain call "
        f"{p_ms:.2f} ms; torch.linalg.solve_ex on the dense {6 * K}^2 T {lib}); bound "
        f"{b_ms:.5f} ms by {b_by}")
    row = dict(name=name, route="cuda", source="malio_tpu_torch/csrc/block_tridiag.cu",
               replaces="malio_tpu/posegraph.py:243,251 (_block_tridiag_solve's two lax.scans; "
                        "not a TPU kernel)",
               shape=f"K={K} r={r}", shape_key=(K, r), counter="block_tridiag", ms=ms,
               call_ms=c_ms, plain_ms=p_ms, plain_call_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
               bytes=nbytes, ops=nops, library_ms=l_ms, within_rel=within, **chk)
    if path:
        row["path"] = path
    return row


def tridiag_phase(backend_args, solver_args):
    """block_tridiag rows: the back-end cell's first relax (K = 2048, r =
    385), the solver cell's (2048, 193) and seeded inputs at the CPU
    test's shape."""
    import torch

    D, Boff, RHS = (torch.as_tensor(a, device="cuda") for a in tridiag_inputs(*TRIDIAG_SEEDED))
    return [tridiag_row("block_tridiag_backend", backend_args, "backend"),
            tridiag_row("block_tridiag_solver", solver_args, "solver"),
            tridiag_row("block_tridiag_seeded", (D, Boff, RHS))]


def batched_drive(cfg, seqs, record=None):
    """Rounds for profile_phase over len(seqs) sequences in lockstep: one
    batched round (pipeline.scan_steps over a (1, B) group) at a time.
    `record` receives the last carry and every round's IEKF iterations."""
    import torch
    from malio_tpu_torch import batched, pipeline

    carry0, chunks, _ = batched._prepare(cfg, seqs, torch.float32, 1, "cuda")

    def drive(tick, rounds):
        c, iters = carry0, []
        for k in range(rounds):
            c, out = pipeline.scan_steps(cfg, c, chunks[k][0], device="cuda")
            tick(c, out, None)
            iters.append(out.iterations[0])
        if record is not None:
            record.update(carry=c, iterations=torch.stack(iters).cpu().numpy())

    return drive


def batched_phase(floor, smi, main_profile):
    """The batched cell through the compiled round: batched.flagship_benchmark
    at B = BATCH (6 s) and at B = 1 (8 s, bench.py's settings), each with
    the launch counts set to 0 just before and read just after; ATE,
    drops and throughput per pass; the graph's capture at each B; three
    sequences of the batch against their own runs; a profile of 5 steady
    batched rounds at B = BATCH (device operations, busy time and idle
    share, kernel time per round, IEKF iterations), its device operations
    set against `main_profile`'s; one pass at B = BATCH through the eager
    round (bit-equal, scans/s beside the graph's); and the kernels checked
    and timed at the batched shapes. Returns (report, launch counts by
    path, kernel rows)."""
    from malio_tpu_torch import batched
    from malio_tpu_torch import measurement as meas
    from malio_tpu_torch.map import voxel_hash as vh
    from malio_tpu_torch.ops import merge

    cfg = batched._flagship_config(4096, 1 << 21, False)
    kw = dict(points_per_lidar=4096, passes=BATCH_PASSES, chunk=BATCH_CHUNK)
    # each batch's sequences built once: the eager pass replays the stream
    # of the graph's passes
    build, built = batched._build_sequences, {}

    def build_once(cfg_, B, secs, points, world):
        if (B, secs, points) not in built:
            built[B, secs, points] = build(cfg_, B, secs, points, world)
        return built[B, secs, points]

    # the last batched round's k-NN queries and insert arguments: the
    # recordings are on when the B = BATCH round is captured
    last = {}
    knn_cached = vh.knn_cached

    def recording_knn_cached(m, queries, **kw2):
        last.update(queries=queries, qmask=kw2.get("qmask"))
        return knn_cached(m, queries, **kw2)

    batched._build_sequences, vh.knn_cached = build_once, recording_knn_cached
    ins16 = _Recording(merge, "merge_rows").__enter__()
    try:
        out, paths, sinks, rec16 = _batched_runs(cfg, kw, smi, main_profile)
        last = {k: v.clone() for k, v in last.items()}
        ins16_args = tuple(a.clone() for a in ins16.args)
    finally:
        ins16.__exit__()
        vh.knn_cached = knn_cached
    try:
        sink_e = {}
        t0 = time.perf_counter()
        with _Eager():
            r_e = batched.flagship_benchmark(batch=BATCH, duration=BATCH_SECONDS, sink=sink_e,
                                             **dict(kw, passes=1))
        wall_e = _ms_since(t0) / 1e3
    finally:
        batched._build_sequences = build
    _same("batched eager pass, positions", sink_e["pos"], sinks["batched"]["pos"])
    out["batched_eager"] = dict(values=r_e["values"], median=r_e["median"], wall_s=wall_e)
    log(f"batched eager pass: B={BATCH}, aggregate {r_e['median']:.2f} scans/s against "
        f"{out['batched']['median']:.2f} median through the graph; positions bit-equal; {smi}")

    # both kernels at the batched shapes: the k-NN on the batch's maps and
    # last-round queries, the deskew on seeded batched inputs
    m = rec16["carry"].map
    rows = knn_phase(m, last["queries"], last["qmask"], cfg, meas.CAND_K, suffix="_batched")
    rows.append(deskew_phase("deskew_batched", deskew_inputs_batch(
        BATCH, cfg.num_lidars, cfg.max_raw_points, cfg.spline_capacity, seed=1), floor))
    rows.append(merge_phase("merge_rows_batched", *ins16_args, floor))
    del ins16_args
    for r in rows:
        r["path"] = "batched"
    return out, paths, rows


def _batched_runs(cfg, kw, smi, main_profile):
    """batched_phase's runs through the compiled round: the benchmark at
    B = 1 and B = BATCH, the sequences against their own runs, the
    profile. Returns (report, launches by path, sinks, the profile's last
    carry and iterations)."""
    import numpy as np
    import torch
    from malio_tpu_torch import batched, pipeline
    from malio_tpu_torch import measurement as meas
    from malio_tpu_torch.io.assemble import assemble_groups
    from malio_tpu_torch.map import voxel_hash as vh

    out, paths, sinks = {}, {}, {}
    for label, B, secs in (("batched_b1", 1, BATCH_B1_SECONDS), ("batched", BATCH, BATCH_SECONDS)):
        sinks[label] = {}
        captured = len(pipeline.compiled_rounds())
        reset_launches()
        t0 = time.perf_counter()
        r = batched.flagship_benchmark(batch=B, duration=secs, sink=sinks[label], **kw)
        _sync()
        paths[label] = read_launches(label)
        r["wall_s"] = time.perf_counter() - t0
        new = pipeline.compiled_rounds()[captured:]
        r["graph"] = compiled_report(new[-1]) if new else "the main path's"
        out[label] = r
        st = r["stats"]
        log(f"{label}: B={B}, {r['rounds']} rounds x {len(r['values'])} timed passes in "
            f"{r['wall_s']:.1f} s; aggregate {r['median']:.2f} scans/s median, {r['best']:.2f} best, "
            f"passes {[round(v, 3) for v in r['values']]}; ATE max {max(r['ates']):.6f} m; "
            f"map_dropped {st['map_dropped_final']}, meas_dropped {st['meas_dropped_max']}, "
            f"nn_miss p50 {st['nn_miss_p50']} p99 {st['nn_miss_p99']}; {smi}")
        bad = [a for a in r["ates"] if not (np.isfinite(a) and a <= ATE_GATE_M)]
        # lanes past the measurement cap: the JAX package's _flagship_config
        # sized its 13/16 cap on sequence 0, which stays under it; other
        # seeds' scans hold more live lanes in some rounds, so at B = BATCH
        # the drops are reported per sequence (sequence 0 must drop none)
        md = sinks[label]["n_meas_dropped"]
        r["meas_dropped_by_sequence"] = md.max(1).tolist()
        r["meas_dropped_rounds_by_sequence"] = (md > 0).sum(1).tolist()
        if bad or st["map_dropped_final"] or md[0].any():
            raise AssertionError(f"{label}: ATE over {ATE_GATE_M} m ({bad}) or drops ({st}, "
                                 f"lanes dropped by sequence {r['meas_dropped_by_sequence']})")
    log(f"batched: per-sequence ATE (m) {[round(a, 6) for a in out['batched']['ates']]}; "
        f"measurement lanes over the cap, most in a round by sequence "
        f"{out['batched']['meas_dropped_by_sequence']}, in "
        f"{out['batched']['meas_dropped_rounds_by_sequence']} rounds")
    v_base = len(vh._svx_ball_offsets(cfg.knn_radius))
    knn_key = (BATCH * cfg.max_meas_points, v_base, meas.CAND_K)
    desk_key = (BATCH, cfg.num_lidars, cfg.max_raw_points, cfg.spline_capacity)
    merge_key = (BATCH * cfg.map_capacity, BATCH * cfg.max_meas_points)
    pb = paths["batched"]
    if not (pb["knn_window"].get(knn_key) and pb["deskew"].get(desk_key)
            and pb["merge_rows"].get(merge_key)):
        raise AssertionError(f"batched path: no launch at {knn_key} / {desk_key} / {merge_key}: "
                             f"{pb}")

    # three sequences of the batch against their own B = 1 runs
    checks = {}
    pos16 = sinks["batched"]["pos"]
    for b in BATCH_CHECK:
        imu, rounds, traj = flagship_sequence(cfg, BATCH_SECONDS, seed=b)
        groups = assemble_groups(cfg, imu, rounds)[: BATCH_CHECK_ROUNDS + BATCH_CHUNK]
        one = {}
        batched._run_benchmark(cfg, [(groups, traj)], torch.float32, BATCH_CHUNK, 8, 1, sink=one)
        k = min(len(pos16[b]), len(one["pos"][0]))  # rounds both replayed
        a, w = pos16[b][:k], one["pos"][0][:k]
        checks[b] = dict(max_dpos_m=float(np.abs(a - w).max()), bit_equal=bool(np.array_equal(a, w)),
                         rounds=int(w.shape[0]))
        if not checks[b]["max_dpos_m"] <= BATCH_TOL_M:
            raise AssertionError(f"batched: sequence {b} differs from its own run: {checks[b]}")
    log(f"batched: sequences {list(BATCH_CHECK)} against their own runs (first "
        f"{checks[BATCH_CHECK[0]]['rounds']} rounds): max |dpos| "
        f"{[c['max_dpos_m'] for c in checks.values()]} m (limit {BATCH_TOL_M}), bit-equal "
        f"{sum(c['bit_equal'] for c in checks.values())} of {len(checks)}")
    out["single_checks"] = checks

    # where a steady batched round's time goes
    seqs = batched._build_sequences(cfg, BATCH, BATCH_PROFILE_SECONDS, 4096,
                                    batched._flagship_world(cfg))
    rec16 = {}
    prof16 = profile_phase(batched_drive(cfg, seqs, rec16), 1e3 * BATCH / out["batched"]["median"],
                           label=f"batched profile B={BATCH}")
    # each sequence of the batch runs its own iteration count; the loop runs
    # all max_iter + 1 with the done ones frozen
    it16 = rec16["iterations"][8:13]
    ratio = prof16["device_ops_per_round"] / main_profile["device_ops_per_round"]
    out["profile"] = {f"B={BATCH}": prof16, "device_ops_ratio_to_main_path": ratio,
                      "iekf_iterations_max": it16.max(1).tolist(),
                      "iekf_iterations_mean": it16.mean(1).tolist()}
    log(f"batched profile: {prof16['device_ops_per_round']:.0f} device operations a round at "
        f"B={BATCH} against {main_profile['device_ops_per_round']:.0f} on the main path (B=1, "
        f"{ratio:.3f}x); IEKF iterations per traced round, batch maximum "
        f"{it16.max(1).tolist()}, mean {[round(float(v), 2) for v in it16.mean(1)]}; {smi}")
    return out, paths, sinks, rec16


def knn_function_check(m, queries, qmask, cfg):
    """vh.knn at K = 5 (the base window and the budgeted wide escalation) on
    the main path's map and last queries: through the fused kernel, then
    with the wrapper's plain version in its place; bit-equal."""
    import torch
    from malio_tpu_torch import measurement as meas
    from malio_tpu_torch.map import voxel_hash as vh
    from malio_tpu_torch.ops import knn

    kw = dict(k=vh.NUM_MATCH_POINTS, radius=cfg.knn_radius, wide_radius=cfg.knn_wide_radius,
              wide_budget=cfg.knn_wide_budget, qmask=qmask, accept_d2=meas.NN_REJECT_D2)
    reset_launches()
    got = vh.knn(m, queries, **kw)
    _sync()
    counts = read_launches("knn_k5", kernels=("knn_window",))
    kernel = knn.knn_window
    knn.knn_window = knn.knn_window_plain
    try:
        want = vh.knn(m, queries, **kw)
    finally:
        knn.knn_window = kernel
    for name, a, b in zip(("nn_pts", "nn_covs", "nn_d2", "nn_cnt", "n_miss"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"vh.knn {name}: kernel route differs from the plain route")
    log(f"vh.knn K=5 on the main path's map and last queries: bit-equal to the plain route; "
        f"n_miss {int(got[4])}; launches {counts['knn_window']} (Q, V, K): n")
    return dict(n_miss=int(got[4])), counts


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


def _bits(t):
    """t's bits as integers of its width (NaNs compare equal to themselves)."""
    import torch

    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def merge_sorted_inputs(T, N=MERGE_N, seed=0):
    """benchmarks/micro_r4b.py's inputs at table size T: N sorted unique
    rows drawn from numpy's generator at `seed` and normal records; the
    table is normal too (micro_r4b's is zeros), so a lost row shows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    rec = torch.as_tensor(rng.normal(size=(N, 5)), dtype=torch.float32, device="cuda")
    idx = torch.as_tensor(np.sort(rng.choice(T, N, replace=False)), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(T, 5, generator=g, device="cuda"), idx, rec


def merge_bytes(T, N, n_valid, row_bytes):
    """The least bytes the merge moves: the table's rows that no update
    overwrites read once, the valid records read once, the table written
    once, idx (8 B an entry) read once."""
    return (T - n_valid) * row_bytes + n_valid * row_bytes + T * row_bytes + N * 8


def merge_path_inputs(T, N, n_valid, seed=0):
    """Seeded inputs of an insert's shape: N entries, n_valid of them
    unique rows in ascending order at random places among dead ones (-1),
    as the insert sends them; normal table and records."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    idx = np.full(N, -1, np.int64)
    idx[np.sort(rng.choice(N, n_valid, replace=False))] = np.sort(
        rng.choice(T, n_valid, replace=False))
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(T, 5, generator=g, device="cuda"), torch.as_tensor(idx, device="cuda"),
            torch.randn(N, 5, generator=g, device="cuda"))


def merge_device_ms(fn, n=50):
    """Device time of one merge call (the sum of its merge_rows kernels'
    CUPTI events, median over n calls) and its merge_rows events a call."""
    calls = device_events(fn, n)
    per = [sum(us for nm, us in c if "merge_rows" in nm) for c in calls]
    events = sorted({sum(1 for nm, _ in c if "merge_rows" in nm) for c in calls})
    return statistics.median(per) / 1e3, events


def merge_tile_edges(T, W, tw, rng, extra=200):
    """Rows at the copy's tile edges in a table of T rows of W words, tiles
    of tw words: for every tile boundary the row that holds its first word
    and the one that holds the word before (one row where a row straddles
    the boundary), the rows on either side of those, row 0 and row T - 1;
    and `extra` other rows at random."""
    import numpy as np

    cut = [[k * tw // W - 1, k * tw // W, -(-k * tw // W), (k * tw - 1) // W]
           for k in range(1, T * W // tw + 1)]
    rows = np.unique(np.clip(np.concatenate([[0, T - 1], *cut]), 0, T - 1))
    more = rng.choice(np.setdiff1d(np.arange(T), rows), extra, replace=False)
    return rng.permutation(np.concatenate([rows, more]))


def merge_tile_inputs(tw, seed=5):
    """Cases at the copy's tile edges, for tiles of `tw` words: the rows of
    merge_tile_edges in tables one row under, at and over 40 tiles, all
    updates inside one tile, every row updated, every entry dead (40.5
    tiles); rows of 4 f32 (a whole number a tile), 5 f32 and 5 f64 (rows
    that straddle)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    cases = {}
    for cols, dt in ((4, torch.float32), (5, torch.float32), (5, torch.float64)):
        W = cols * torch.finfo(dt).bits // 32  # words a row
        two, big = 40 * tw // W, 81 * tw // (2 * W)  # 40 tiles, 40.5
        tables = {
            "edges_under": (two - 1, merge_tile_edges(two - 1, W, tw, rng)),
            "edges_at": (two, merge_tile_edges(two, W, tw, rng)),
            "edges_over": (two + 1, merge_tile_edges(two + 1, W, tw, rng)),
            "one_tile": (big, rng.permutation(np.arange(tw // W + 1, 2 * tw // W - 1))[::2]),
            "every_row": (big, rng.permutation(big)),
            "every_dead": (big, np.where(rng.random(big) < 0.5, -1,
                                         big + rng.integers(0, big, big))),
        }
        for name, (T, rows) in tables.items():
            idx = torch.as_tensor(np.asarray(rows, np.int64), device="cuda")
            cases[f"merge_rows_tile_{name}_{cols}x{str(dt)[6:]}"] = (
                torch.randn(T, cols, generator=g, device="cuda", dtype=dt), idx,
                torch.randn(idx.shape[0], cols, generator=g, device="cuda", dtype=dt))
    return cases


def merge_edge_inputs(T, seed=3):
    """Edge cases of the merge at table size T: the first and the last row,
    unique rows in random order mixed with entries below 0 and at or past
    T, nothing valid, no update at all, and row counts whose size in words
    leaves a tail past the 16-byte copy (f32 and f64 rows)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def case(tab, rows):
        idx = torch.as_tensor(np.asarray(rows, np.int64), device="cuda")
        rec = torch.randn(idx.shape[0], tab.shape[1], generator=g, device="cuda",
                          dtype=torch.float64).to(tab.dtype)
        return tab, idx, rec

    tab = torch.randn(T, 5, generator=g, device="cuda")
    inner = rng.choice(np.arange(1, T - 1), 2046, replace=False)
    mixed = np.concatenate([rng.choice(T, 4096, replace=False), np.full(500, -1),
                            np.full(300, T), rng.integers(T, 2 * T, 200)])
    rng.shuffle(mixed)
    invalid = np.concatenate([np.full(1000, -1), rng.integers(T, 2 * T, 1000)])
    rng.shuffle(invalid)
    small = lambda n, dt: torch.randn(n, 5, generator=g, device="cuda", dtype=dt)
    return {
        "merge_rows_first_last_row": case(tab, np.concatenate([[T - 1], inner, [0]])),
        "merge_rows_unsorted_invalid": case(tab, mixed),
        "merge_rows_all_invalid": case(tab, invalid),
        "merge_rows_no_update": case(tab, []),
        "merge_rows_tail_f32": case(small(1001, torch.float32), np.concatenate(
            [[1000, 0], rng.choice(999, 300, replace=False) + 1])),
        "merge_rows_tail_f64": case(small(4099, torch.float64), np.concatenate(
            [[4098, 0, -1], rng.choice(4097, 900, replace=False) + 1])),
    }


def merge_check(name, tab, idx, rec):
    """The merge kernel against merge_rows_plain and against
    tab.index_copy on the valid entries, bit for bit. Returns the valid
    entries and their count."""
    import torch
    from malio_tpu_torch.ops import merge

    got = merge.merge_rows(tab, idx, rec)
    want = merge.merge_rows_plain(tab, idx, rec)
    valid = (idx >= 0) & (idx < tab.shape[0])
    iv, rv = idx[valid].contiguous(), rec[valid].contiguous()
    lib = tab.index_copy(0, iv, rv)
    _sync()
    for what, w in (("merge_rows_plain", want), ("index_copy", lib)):
        if not torch.equal(_bits(got), _bits(w)):
            bad = int((_bits(got) != _bits(w)).any(-1).sum())
            raise AssertionError(f"{name}: kernel differs from {what} in {bad} rows")
    return iv, rv, int(valid.sum())


def merge_phase(name, tab, idx, rec, floor):
    """The merge kernel on (tab, idx, rec): checked bit-equal to its plain
    version and to index_copy, timed alone on the device (its one launch,
    CUPTI), per wrapper call, and against the plain version, index_copy
    (on the valid entries) and tab.clone() (the copy alone); the bound is
    merge_bytes over the memory rate."""
    from malio_tpu_torch.ops import merge

    iv, rv, n_valid = merge_check(name, tab, idx, rec)
    T, W = tab.shape
    N = idx.shape[0]
    fn = lambda: merge.merge_rows(tab, idx, rec)
    ms, events = merge_device_ms(fn)
    if events != [1]:
        raise AssertionError(f"{name}: {events} merge_rows device events per call, not one")
    c_ms = call_ms(fn)
    p_ms, p_ops = device_ms(lambda: merge.merge_rows_plain(tab, idx, rec))
    p_call = call_ms(lambda: merge.merge_rows_plain(tab, idx, rec), n=10)
    l_ms, _ = device_ms(lambda: tab.index_copy(0, iv, rv))
    l_call = call_ms(lambda: tab.index_copy(0, iv, rv), n=30)
    clone_ms, _ = device_ms(tab.clone)
    nbytes = merge_bytes(T, N, n_valid, W * tab.element_size())
    b_ms, b_by = bound(nbytes, 0)
    log(f"kernel {name} T={T} N={N} ({n_valid} valid) {tab.dtype}: bit-equal to plain and to "
        f"index_copy; device {ms:.5f} ms (one launch), call {c_ms:.4f} ms (plain device "
        f"{p_ms:.4f} ms in {p_ops:.0f} device ops, call {p_call:.4f} ms; index_copy device "
        f"{l_ms:.4f} ms, call {l_call:.4f} ms; clone {clone_ms:.5f} ms); bound {b_ms:.5f} ms "
        f"by {b_by} ({b_ms / ms:.3f} of it), {b_ms + floor:.5f} ms with the launch floor")
    return dict(
        name=name, route="cuda", source="malio_tpu_torch/csrc/merge_rows.cu",
        replaces="benchmarks/micro_r4b.py:92", shape=f"T={T} N={N} W={W} {str(tab.dtype)[6:]}",
        shape_key=(T, N), counter="merge_rows", valid=n_valid, max_abs_err=0.0, ms=ms,
        call_ms=c_ms, plain_ms=p_ms, plain_call_ms=p_call, plain_device_ops=p_ops, bound_ms=b_ms,
        bound_by=b_by, bound_with_floor_ms=b_ms + floor, bytes=nbytes, library_ms=l_ms,
        library_call_ms=l_call, clone_ms=clone_ms,
    )


class _Recording:
    """Swaps a module's function for one that keeps the arguments of its
    last call (no copies) and calls it; the original comes back on exit."""

    def __init__(self, owner, name):
        self.owner, self.name, self.args = owner, name, None
        self.fn = getattr(owner, name)

    def __enter__(self):
        def recording(*a):
            self.args = a
            return self.fn(*a)

        setattr(self.owner, self.name, recording)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


class _PathRecording:
    """Inside it, the last call's arguments of the three kernels' callers on
    a path of one sequence: `search` (the k-NN queries and their mask),
    `deskew["args"]` (deskew_points' arguments) and `merge.args` (the
    insert's merge_rows arguments). Through the compiled round the last
    call is the capture: the tensors kept are the graph's own, which every
    replay rewrites, so after a run they hold its last round's arguments
    (`snapshot` copies them); the capture must happen inside it."""

    def __enter__(self):
        import types
        from malio_tpu_torch import propagate as prop, tree
        from malio_tpu_torch.map import voxel_hash as vh
        from malio_tpu_torch.ops import deskew, merge

        self.search, self.deskew = {}, {}
        knn_cached = self._knn_cached = vh.knn_cached

        def recording_knn_cached(m, queries, **kw):
            # the path's rounds are batches of one: keep its one sequence
            self.search.update(queries=queries[0], qmask=kw.get("qmask")[0])
            return knn_cached(m, queries, **kw)

        def recording_deskew(*args):
            self.deskew["args"] = tree.squeeze(args)
            return deskew.deskew_points(*args)

        vh.knn_cached = recording_knn_cached
        prop.deskew_ops = types.SimpleNamespace(deskew_points=recording_deskew,
                                                deskew_points_plain=deskew.deskew_points_plain)
        self.merge = _Recording(merge, "merge_rows").__enter__()
        return self

    def snapshot(self):
        """Copies of (search, deskew, merge arguments) as they are now."""
        import torch
        from malio_tpu_torch import tree

        copy = lambda t: tree.map_tensors(torch.clone, t)  # noqa: E731
        return ({k: v.clone() for k, v in self.search.items()},
                {"args": copy(self.deskew["args"])}, copy(self.merge.args))

    def __exit__(self, *exc):
        from malio_tpu_torch import propagate as prop
        from malio_tpu_torch.map import voxel_hash as vh
        from malio_tpu_torch.ops import deskew

        self.merge.__exit__(*exc)
        vh.knn_cached = self._knn_cached
        prop.deskew_ops = deskew


def window_args(m, queries, radius, qmask):
    """knn_window's arguments (tab, queries, rows, alive) for `queries` on
    map `m` at window `radius`, as voxel_hash sends them: a batch of maps
    (B, R, 32, 5) and queries (B, Q, 3) as one flat (B R) table, rows
    offset by b R, B Q queries."""
    from malio_tpu_torch.map import voxel_hash as vh

    q = queries.contiguous()
    b, alive = vh._window_rows(m, q, radius, qmask)
    tab, b = vh._batch_rows(m, b)
    V = b.shape[-1]
    return tab, q.reshape(-1, 3), b.reshape(-1, V), alive.reshape(-1, V)


def merge_kernel_phase(path_args, floor):
    """The merge kernel at micro_r4b's shapes (T = 2^17, 2^19, 2^21 rows, N
    = 12,288 sorted unique updates), on the insert's own arguments of the
    paths (`path_args`: name -> (tab, idx, rec)) and on the edge cases."""
    rows = [merge_phase(f"merge_rows_micro_T{lt}", *merge_sorted_inputs(1 << lt), floor)
            for lt in MERGE_LOG_T]
    rows += [merge_phase(name, *args, floor) for name, args in path_args.items()]
    rows += [merge_phase(name, *args, floor)
             for name, args in merge_edge_inputs(1 << MERGE_LOG_T[-1]).items()]
    from malio_tpu_torch.ops import merge

    tiles = merge_tile_inputs(merge.tile_words(1))
    for name, args in tiles.items():
        merge_check(name, *args)
    log(f"merge kernel bit-equal to plain and index_copy at {len(tiles)} tile-edge cases")
    return rows


def insert_plain_check(cfg, groups, n_init, res):
    """The main path's first PLAIN_ROUNDS rounds with both other kernels
    on but the insert's write through merge_rows_plain (the eager round, so
    that the swap acts): positions, times and map sizes bit-equal to the
    kernel run's (the write is a copy)."""
    import torch
    from malio_tpu_torch import runner
    from malio_tpu_torch.ops import merge

    kernel = merge.merge_rows
    merge.merge_rows = merge.merge_rows_plain
    try:
        with _Eager():
            r = runner.run_sequence(cfg, groups[: n_init + PLAIN_ROUNDS], dtype=torch.float32,
                                    device="cuda")
    finally:
        merge.merge_rows = kernel
    k = len(r["t"])
    for f in ("t", "pos", "quat", "map_size"):
        _same(f"insert through merge_rows_plain, {f}", r[f], res[f][:k])
    log(f"insert through merge_rows_plain, first {k} rounds: positions, times and map sizes "
        f"bit-equal to the kernel run")
    return k


def dataset_phase(out_dir, smi, dev="cuda"):
    """The dataset entry point: io/export.write_dataset writes the flagship
    3-LiDAR sequence (seed 0, DATASET_SECONDS) with its ground truth as a
    City file-player tree; `python -m malio_tpu_torch.run_dataset` replays
    it (decode, grouping, run_sequence, TUM, ATE / RPE against
    Groundtruth.txt, the live map as PCD, which read_pcd must read back
    equal to the map); DatasetPlayer(realtime=False) plays it into an
    OnlineEstimator, whose trajectory must equal the arrival-ordered feed
    of the loaded sequence within PLAYER_TOL_M. Launch counts per path."""
    import shutil

    import numpy as np
    import torch
    from malio_tpu_torch import online, run_dataset
    from malio_tpu_torch.config import city_config, flagship_config
    from malio_tpu_torch.eval import ate
    from malio_tpu_torch.io import dataset as ds, export, native, pcd
    from malio_tpu_torch.io.player import DatasetPlayer
    from malio_tpu_torch.map import voxel_hash as vh

    fcfg = flagship_config()
    root = out_dir / "dataset_city_synthetic"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    imu, rounds, traj = flagship_sequence(fcfg, DATASET_SECONDS, seed=0)
    export.write_dataset(root, imu, rounds, DATASET_SENSORS, traj=traj)
    write_s = time.perf_counter() - t0
    files = [p for p in root.rglob("*") if p.is_file()]
    tree = dict(files=len(files), bytes=sum(p.stat().st_size for p in files), write_s=write_s)
    # the City configuration at the flagship's widths: 4096 raw points a
    # LiDAR, a 2^21-slot map; the rest as run_dataset's `city` gives it
    overrides = dict(max_raw_points=fcfg.max_raw_points, max_points_per_scan=fcfg.max_raw_points,
                     map_capacity=fcfg.map_capacity)
    cfg = city_config(**overrides)
    argv = [str(root), "--config", "city", "--max-points", str(fcfg.max_raw_points),
            "--map-capacity", str(fcfg.map_capacity), "--out", str(root / "trajectory.txt"),
            "--save-map", str(root / "map.pcd")] + (["--cpu"] if dev == "cpu" else [])
    paths = {}
    reset_launches()
    t0 = time.perf_counter()
    s = run_dataset.main(argv)
    wall = _ms_since(t0) / 1e3
    paths["dataset"] = read_launches("dataset")
    res = s["res"]
    rows = np.loadtxt(root / "trajectory.txt")
    if rows.shape != (s["rounds"], 8) or not np.isfinite(rows).all():
        raise AssertionError(f"dataset: TUM file of shape {rows.shape} for {s['rounds']} rounds")
    if not (np.isfinite(s.get("ate_m", np.nan)) and s["ate_m"] <= ATE_GATE_M):
        raise AssertionError(f"dataset: ATE {s.get('ate_m')} over {ATE_GATE_M} m")
    back = pcd.read_pcd(root / "map.pcd")
    mpts, mcovs = vh.extract_points(res["carry"].map)
    _same("dataset map PCD read back", back, np.concatenate([mpts, mcovs[:, None]], 1))
    drops = int(res["map_dropped"][-1]), int(res["n_meas_dropped"].max())

    reset_launches()
    t0 = time.perf_counter()
    player = DatasetPlayer(root, cfg, DATASET_SENSORS, realtime=False, device=dev)
    try:
        pres = player.run()
    finally:
        player.close()
    player_s = _ms_since(t0) / 1e3
    paths["player"] = read_launches("player")
    imu2, rounds2 = ds.load_sequence(root, DATASET_SENSORS, list(cfg.lid_type),
                                     list(cfg.point_filter_num), list(cfg.n_scans), cfg.blind)
    # the player dispatches a scan at its file stamp, the scan's begin time
    # (tests/test_player.py:94-105): the feed pushes in that order
    events = [("imu", row[0], row) for row in imu2]
    for rnd in rounds2:
        for l, sc in enumerate(rnd):
            rel = sc["pts"].copy()
            rel[:, 3] -= sc["beg_t"]
            events.append(("scan", sc["beg_t"], (l, sc["beg_t"], rel, sc["end_t"] - sc["beg_t"])))
    events.sort(key=lambda e: e[1])
    reset_launches()
    est = online.OnlineEstimator(cfg, dtype=torch.float32, device=dev)
    recs = []
    for kind, _, p in events:
        if kind == "imu":
            est.push_imu(p[0], p[1:4], p[4:7])
        else:
            est.push_scan(p[0], p[1], p[2], duration=p[3])
        recs.extend(est.poll())
    est.flush()
    recs.extend(est.poll())
    paths["dataset_online"] = read_launches("dataset_online")
    fpos = np.asarray([r["pos"] for r in recs])
    if len(recs) != pres["n_rounds"] or pres["n_dropped_scans"]:
        raise AssertionError(f"player: {pres['n_rounds']} rounds ({pres['n_dropped_scans']} "
                             f"dropped scans), the online feed {len(recs)}")
    dpos = float(np.abs(pres["pos"] - fpos).max())
    dt = float(np.abs(pres["t"] - np.asarray([r["t"] for r in recs])).max())
    if not (dpos <= PLAYER_TOL_M and dt <= 1e-9):
        raise AssertionError(f"player vs online feed: max |dpos| {dpos} m, |dt| {dt} s")
    player_ate = ate.ate_rmse(pres["pos"], traj.pos(pres["t"]))
    # the decoders that ran are io/dataset's numpy ones; the C++ library
    # (native/libmalio_native.so) is checked against them where it loads
    nat = dict(available=native.available())
    if nat["available"]:
        fl = ds.list_scan_files(root, "ouster")[:8]
        out, counts, durs = native.batch_decode(fl, "ouster", cfg.point_filter_num[0],
                                                time_unit_scale=ds.TIME_UNIT_SCALE[0])
        for i, f in enumerate(fl):
            want, dur = ds.decode_ouster(f, cfg.point_filter_num[0], 0.0, ds.TIME_UNIT_SCALE[0])
            if counts[i] != len(want) or not np.allclose(out[i, : counts[i]], want, atol=1e-12,
                                                         rtol=0):
                raise AssertionError(f"native decoder differs from decode_ouster on {f.name}")
        nat["checked_files"] = len(fl)
    shutil.rmtree(root / "sensor_data")  # 18 MB of records; the TUM file and the map stay
    out = dict(seconds=DATASET_SECONDS, tree=tree, rounds=s["rounds"], wall_s=wall,
               scans_per_s=s["rounds"] / wall, ate_m=s["ate_m"], rot_ate_rad=s["rot_ate_rad"],
               rpe_m=s["rpe_m"], rpe_rad=s["rpe_rad"], map_points=s["map_points"],
               map_dropped=drops[0], meas_dropped=drops[1], player_rounds=pres["n_rounds"],
               player_s=player_s, player_scans_per_s=pres["n_rounds"] / player_s,
               player_vs_feed_max_dpos_m=dpos, player_ate_m=player_ate, native_decoder=nat,
               decoders="numpy (io/dataset.py)", gpu=smi)
    log(f"dataset ({DATASET_SECONDS:.0f} s, {tree['files']} files, {tree['bytes']} B): replay "
        f"{s['rounds']} rounds in {wall:.1f} s ({out['scans_per_s']:.2f} scans/s), ATE "
        f"{s['ate_m']:.6f} m / {np.degrees(s['rot_ate_rad']):.3f} deg, RPE {s['rpe_m']:.4f} m; "
        f"map PCD ({s['map_points']} voxels) read back equal; drops {drops}; player "
        f"{pres['n_rounds']} rounds in {player_s:.1f} s, max |dpos| {dpos:.3g} m against the "
        f"online feed (limit {PLAYER_TOL_M}); native decoder {nat}; {smi}")
    return out, paths


def dist_world(cfg, inputs, out, dp, mp, B, dev="cuda", backend=None, eager=False):
    """distributed.sharding's worker in dp x mp processes through
    sharding.run_local over B sequences, over `backend` (None: the
    worker's rule, NCCL with a card a process) and through the eager round
    where asked: a process that fails or a world past DIST_DEADLINE_S
    fails the phase, and its peers are killed. Returns (outputs, carry) of
    process 0 (gathered; the carry as numpy arrays) and every rank's stats
    (launches, collectives and their bytes a round, round ms, shard rows,
    its capture)."""
    import torch
    from malio_tpu_torch import interop
    from malio_tpu_torch.distributed import sharding

    stats = sharding.run_local(inputs, out, dp * mp, mp, device=dev, deadline_s=DIST_DEADLINE_S,
                               backend=backend, eager=eager)
    outs, carry = sharding.load_outputs(out, sharding.carry_template(cfg, B, torch.float32))
    return (outs, interop.carry_to_numpy(carry)), stats


def dist_inputs(cfg, path, seqs, dev="cuda", rounds=None):
    """The worker's inputs for sequences `seqs` (their measure groups):
    each IMU-initialised on `dev` as the replay seeds it
    (batched._init_seq) and its first `rounds` (DIST_ROUNDS) rounds stacked as
    run_sequence rebases them; the carries stacked on the batch axis."""
    import numpy as np
    import torch
    from malio_tpu_torch import batched, runner, tree
    from malio_tpu_torch.distributed import sharding

    rounds = DIST_ROUNDS if rounds is None else rounds
    carries, arrays = [], []
    for groups in seqs:
        c, stream, b0 = batched._init_seq(cfg, groups, torch.float32, dev)
        if len(stream) < rounds:
            raise AssertionError(f"distributed: {len(stream)} rounds, want {rounds}")
        carries.append(c)
        arrays.append(runner._chunk_arrays(stream[:rounds], np.float32, b0)[0])
    groups = {k: np.stack([a[k] for a in arrays], axis=1) for k in arrays[0]}
    sharding.save_inputs(path, cfg, tree.stack(carries), groups)


def _dist_launches(stats):
    """The ranks' launches summed, keyed as read_launches keys them."""
    total = {}
    for s in stats:
        for name, by_shape in s["launches"].items():
            d = total.setdefault(name, {})
            for key, n in by_shape.items():
                k = tuple(int(v) for v in key.split(","))
                d[k] = d.get(k, 0) + n
    return total


def check_dist_launches(label, stats):
    """Fails unless every rank launched each kernel of the path."""
    for s in stats:
        for name in ("knn_window", "deskew", "merge_rows"):
            if not s["launches"][name]:
                raise AssertionError(f"{label} rank {s['rank']}: kernel {name} was launched no "
                                     f"time ({s['launches']})")


def _rank_report(stats, main_round_ms):
    out = []
    for s in stats:
        calls = s["collectives_per_round"][1:]
        nbytes = s["collective_bytes_per_round"][1:]
        out.append(dict(
            rank=s["rank"], dp_index=s["dp_index"], mp_index=s["mp_index"], device=s["device"],
            backend=s["backend"], path=s["path"], compiled=s["compiled"],
            sync_check=s["sync_check"],
            launches={k: sum(v.values()) for k, v in s["launches"].items()},
            launches_by_shape=s["launches"], collectives_per_round=s["collectives_per_round"],
            collectives_per_round_median=statistics.median(calls) if calls else 0,
            collective_bytes_per_round=nbytes[-1] if nbytes else {},
            round_ms=s["round_ms"], round_ms_median=statistics.median(s["round_ms"][1:]),
            main_round_ms_median=main_round_ms, shard_rows=s["shard_rows"], rows=s["rows"]))
    return out


def distributed_phase(cfg, groups, res, round_s, out_dir, smi, dev="cuda"):
    """The distributed cell: DIST_ROUNDS flagship rounds through the
    sharding worker (make_mesh, carry_sharding, run_batched, gather_carry /
    gather_outputs).

    In two processes sharing card 0 over gloo (the eager round, as on any
    card count): dp = 2 x mp = 1, seeds 0 and 1, each rank's sequence
    bit-equal to its own single-process run (seed 0's is the main path);
    dp = 1 x mp = 2, seed 0, within BATCH_TOL_M of the main path with
    equal map sizes every round (every exchange is exact, but a rank's
    per-lane products run on half the lanes, which cuBLAS may serve with
    another kernel), and how many rounds are bit-equal.

    With two or more cards, over NCCL, a card a rank (`distributed_nccl`):
    dp = 1 x mp = 2 through the captured round and through the eager
    round, bit-equal every round on every rank, the graph's run against
    the main path as above, no host sync in a steady replay, each rank's
    capture; with four cards also dp = 2 x mp = 2 through the graph, each
    dp row against its own sequence's run. With one card it says why it
    did not run. Every rank must launch all three kernels; per rank its
    launches, collectives and their bytes a round, round wall time (host
    clock, synchronised) and its map rows. Returns (report, launches by
    path)."""
    import torch
    from malio_tpu_torch import runner

    groups1, _ = flagship_groups(cfg, DIST_SEED1_SECONDS, seed=1)
    res1 = runner.run_sequence(cfg, groups1, dtype=torch.float32, device=dev)
    main_ms = statistics.median(round_s[1:DIST_ROUNDS]) * 1e3
    d = out_dir / "distributed"
    d.mkdir(exist_ok=True)
    try:
        return _distributed_worlds(cfg, groups, groups1, res, res1, main_ms, d, smi, dev)
    finally:  # the worlds' npz files hold whole maps: keep only the stats and logs
        for f in d.glob("*.npz"):
            f.unlink()


def _mp_against(label, outs, ref, b=0):
    """Sequence b of a world's outputs against its own single-process run:
    (max |dpos| by round, bit-equal rounds); fails past BATCH_TOL_M or on a
    map size that differs."""
    import numpy as np

    K = DIST_ROUNDS
    pos, want = outs["pos"][:, b], ref["pos"][:K]
    if not np.all(np.isfinite(pos)) or pos.shape != want.shape:
        raise AssertionError(f"{label}: positions not finite or of shape {pos.shape}")
    dpos = np.abs(pos.astype(np.float64) - want).max(1)
    bits = [bool(np.array_equal(pos[k], want[k]) and np.array_equal(outs["quat"][k, b],
                                                                 ref["quat"][k])) for k in range(K)]
    sizes, want_sizes = outs["map_size"][:, b], ref["map_size"][:K]
    if not (dpos.max() <= BATCH_TOL_M and np.array_equal(sizes, want_sizes)):
        raise AssertionError(f"{label} against its own run: |dpos| by round {dpos.tolist()} m "
                             f"(limit {BATCH_TOL_M}), map sizes {sizes.tolist()} / "
                             f"{want_sizes.tolist()}, bit-equal rounds {bits}")
    return dpos, bits


def _check_shards(label, stats, carry, B, mp):
    rows = [s["shard_rows"] for s in stats]
    if max(rows) > -(-stats[0]["rows"] // mp) or tuple(carry["map"]["tab"].shape[:2]) != (
            B, stats[0]["rows"]):
        raise AssertionError(f"{label}: shard rows {rows} of {stats[0]['rows']}")


def _distributed_worlds(cfg, groups, groups1, res, res1, main_ms, d, smi, dev):
    import torch

    K = DIST_ROUNDS
    dist_inputs(cfg, d / "dp.npz", [groups, groups1], dev)
    dist_inputs(cfg, d / "mp.npz", [groups], dev)
    if dev == "cuda":
        torch.cuda.empty_cache()
    report, paths = {}, {}

    t0 = time.perf_counter()
    (outs, _), stats = dist_world(cfg, d / "dp.npz", d / "dp_out.npz", dp=2, mp=1, B=2, dev=dev,
                                  backend="gloo")
    wall = time.perf_counter() - t0
    check_dist_launches("dist_dp", stats)
    for b, ref in enumerate((res, res1)):
        for f in ("pos", "quat", "map_size"):
            _same(f"dist_dp sequence {b} {f}", outs[f][:, b], ref[f][:K])
    paths["dist_dp"] = _dist_launches(stats)
    report["dp2_mp1"] = dict(wall_s=wall, bit_equal_sequences=2, ranks=_rank_report(stats, main_ms))

    t0 = time.perf_counter()
    (outs, carry), stats = dist_world(cfg, d / "mp.npz", d / "mp_out.npz", dp=1, mp=DIST_MP, B=1,
                                      dev=dev, backend="gloo")
    wall = time.perf_counter() - t0
    check_dist_launches("dist_mp", stats)
    dpos, bits = _mp_against("dist_mp", outs, res)
    _check_shards("dist_mp", stats, carry, 1, DIST_MP)
    paths["dist_mp"] = _dist_launches(stats)
    report["dp1_mp2"] = dict(wall_s=wall, max_dpos_m=float(dpos.max()), dpos_m=dpos.tolist(),
                             bit_equal_rounds=int(sum(bits)), rounds=K,
                             ranks=_rank_report(stats, main_ms))
    cards = torch.cuda.device_count() if dev == "cuda" else 0
    if cards >= DIST_MP:
        report["nccl"] = _nccl_worlds(cfg, res, res1, main_ms, d, cards, paths, dev)
    else:
        report["nccl"] = dict(ran=False, cards=cards,
                              why="NCCL takes one rank a card: an mp = 2 world needs two cards")
        log("distributed_nccl: " + json.dumps(report["nccl"]))
    for label, r in report.items():
        for k in r.get("ranks", []):
            log(f"distributed {label} rank {k['rank']} (dp {k['dp_index']}, mp {k['mp_index']}, "
                f"{k['backend']}, {k['path']}): launches {k['launches']}, collectives a round "
                f"{k['collectives_per_round']} ({k['collective_bytes_per_round']} B), round "
                f"{k['round_ms_median']:.1f} ms median (main path {main_ms:.1f} ms), map rows "
                f"{k['shard_rows']}/{k['rows']}")
    mp = report["dp1_mp2"]
    log(f"distributed: dp=2 x mp=1 over gloo, {K} rounds of seeds 0 and 1 bit-equal to their own "
        f"runs ({report['dp2_mp1']['wall_s']:.1f} s); dp=1 x mp={DIST_MP} over gloo, seed 0: max "
        f"|dpos| {mp['max_dpos_m']:.3g} m against the main path (limit {BATCH_TOL_M}), map sizes "
        f"equal, {mp['bit_equal_rounds']} of {K} rounds bit-equal ({mp['wall_s']:.1f} s), "
        f"{mp['ranks'][0]['collectives_per_round_median']} collectives and "
        f"{mp['ranks'][0]['round_ms_median']:.1f} ms a round on rank 0; {smi}")
    return report, paths


def _nccl_worlds(cfg, res, res1, main_ms, d, cards, paths, dev):
    """The NCCL worlds, a card a rank: dp = 1 x mp = 2 through the graph
    and eagerly (bit-equal every round and in the final carry), the graph
    against the main path; with four cards dp = 2 x mp = 2 through the
    graph, each dp row against its own run."""
    import numpy as np

    K = DIST_ROUNDS
    out = dict(ran=True, cards=cards)
    runs = {}
    for label, eager in (("graph", False), ("eager", True)):
        t0 = time.perf_counter()
        runs[label] = dist_world(cfg, d / "mp.npz", d / f"mp_nccl_{label}.npz", dp=1, mp=DIST_MP,
                                 B=1, dev=dev, backend="nccl", eager=eager)
        runs[label] += (time.perf_counter() - t0,)
    (g_outs, g_carry), g_stats, g_wall = runs["graph"]
    (e_outs, e_carry), e_stats, e_wall = runs["eager"]
    check_dist_launches("dist_mp_nccl", g_stats)
    for s in g_stats:
        c = s["compiled"]
        if s["backend"] != "nccl" or s["path"] != "graph" or not s["sync_check"]:
            raise AssertionError(f"dist_mp_nccl rank {s['rank']}: {s['backend']} {s['path']}, "
                                 f"sync check {s['sync_check']}")
        per = {k: sum(v.values()) for k, v in c["launches"].items()}
        if not (per["knn_window"] >= 1 and per["deskew"] == 1 and per["merge_rows"] == 1):
            raise AssertionError(f"dist_mp_nccl rank {s['rank']}: launches a replay {per}")
    equal = [all(np.array_equal(g_outs[f][k], v[k], equal_nan=True) for f, v in e_outs.items())
             for k in range(K)]
    carry_equal = all(np.array_equal(a, b, equal_nan=True)
                      for a, b in zip(_leaves(g_carry), _leaves(e_carry)))
    if not (all(equal) and carry_equal):
        raise AssertionError(f"dist_mp_nccl: graph against eager, rounds bit-equal {equal}, "
                             f"final carry bit-equal {carry_equal}")
    dpos, bits = _mp_against("dist_mp_nccl", g_outs, res)
    _check_shards("dist_mp_nccl", g_stats, g_carry, 1, DIST_MP)
    paths["dist_mp_nccl"] = _dist_launches(g_stats)
    out["dp1_mp2_graph"] = dict(wall_s=g_wall, max_dpos_m=float(dpos.max()), dpos_m=dpos.tolist(),
                                bit_equal_rounds=int(sum(bits)), rounds=K,
                                graph_equals_eager_rounds=int(sum(equal)),
                                ranks=_rank_report(g_stats, main_ms))
    out["dp1_mp2_eager"] = dict(wall_s=e_wall, ranks=_rank_report(e_stats, main_ms))
    log(f"distributed_nccl: dp=1 x mp={DIST_MP}, {K} rounds through the graph bit-equal to the "
        f"eager NCCL round every round and in the final carry; max |dpos| {dpos.max():.3g} m "
        f"against the main path, map sizes equal, {sum(bits)} of {K} rounds bit-equal; no host "
        f"sync in a steady replay on any rank")
    for s in g_stats:
        c = s["compiled"]
        log(f"distributed_nccl rank {s['rank']}: capture {c['capture_s']:.3f} s, warm-up "
            f"{c['warmup_s']:.3f} s, {c['nodes']} nodes, pool {c['pool_bytes']} B, static "
            f"buffers {c['static_bytes']} B, launches a replay {c['launches']}, collectives a "
            f"replay {c['collectives']}")
    if cards >= 4:
        t0 = time.perf_counter()
        (outs, carry), stats = dist_world(cfg, d / "dp.npz", d / "dp2mp2_nccl.npz", dp=2,
                                          mp=DIST_MP, B=2, dev=dev, backend="nccl")
        wall = time.perf_counter() - t0
        check_dist_launches("dist_dp2_mp2_nccl", stats)
        rows = {}
        for b, ref in enumerate((res, res1)):
            dpos, bits = _mp_against(f"dist_dp2_mp2_nccl sequence {b}", outs, ref, b)
            rows[f"seed{b}"] = dict(max_dpos_m=float(dpos.max()), bit_equal_rounds=int(sum(bits)))
        _check_shards("dist_dp2_mp2_nccl", stats, carry, 2, DIST_MP)
        if not all(s["path"] == "graph" and s["sync_check"] for s in stats):
            raise AssertionError("dist_dp2_mp2_nccl: a rank did not run or check the graph")
        paths["dist_dp2_mp2_nccl"] = _dist_launches(stats)
        out["dp2_mp2_graph"] = dict(wall_s=wall, rounds=K, sequences=rows,
                                    ranks=_rank_report(stats, main_ms))
        log(f"distributed_nccl: dp=2 x mp={DIST_MP} through the graph, {K} rounds: {rows}")
    else:
        out["dp2_mp2_graph"] = dict(ran=False, why=f"{cards} cards: dp = 2 x mp = 2 needs four")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def dist_mp_kernel_inputs(m, queries, qmask, cfg, deskew_args, merge_args):
    """Each kernel's arguments as mp rank 0 of the distributed path (mp =
    DIST_MP) gets them from the main path's last round: the base window
    over its share of the lanes against the whole table (which the rank
    gathers from every rank's rows, voxel_hash.whole_map), the deskew over
    its slice of the raw points, and the insert's write into its rows of
    the table (targets past them are skipped)."""
    from malio_tpu_torch.map import voxel_hash as vh

    b, alive = vh._window_rows(m, queries, cfg.knn_radius, qmask)
    n = queries.shape[0] // DIST_MP
    knn_args = (m.tab, queries[:n].contiguous(), b[:n].contiguous(), alive[:n].contiguous())
    pts, *rest = deskew_args
    desk = (pts[:, : pts.shape[1] // DIST_MP].contiguous(), *rest)
    tab, idx, rec = merge_args
    return knn_args, desk, (tab[: tab.shape[0] // DIST_MP].contiguous(), idx, rec)


def bench_kernels_phase(smi):
    """bench_torch.py's insert_ms, nn_ms and iekf_ms through
    metrics.kernel_timer at its flagship shape."""
    import bench_torch

    reset_launches()
    times = bench_torch.kernel_times(bench_torch.bench_config())
    counts = read_launches("bench_kernels")
    log(f"bench_torch kernel times (kernel_timer): {times}; {smi}")
    return times, counts


class _OpLog:
    """A TorchFunctionMode that passes every torch operation's outputs to
    `store(key, tensor)` under key (caller file:line in the package,
    operation[.output], occurrence), keeping what it returns, in execution
    order. With `per_sequence` = B, each matrix product (f32 or f64) with
    an operand whose leading axis is B runs as B products, one per
    sequence on fresh copies of its operands (linalg.mm's rule on the
    CPU), and the products so split are counted."""

    PRODUCTS = ("matmul", "__matmul__", "__rmatmul__", "bmm")
    SKIP = ("empty", "empty_like", "empty_strided", "new_empty")

    def __init__(self, store, per_sequence=None):
        self.store, self.per_sequence = store, per_sequence
        self.ops, self.order, self.split, self._seen = {}, [], 0, {}

    def __enter__(self):
        from torch.overrides import TorchFunctionMode

        outer = self

        class Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                return outer._call(func, args, kwargs or {})

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)

    def _call(self, func, args, kwargs):
        import torch

        name = getattr(func, "__name__", str(func))
        B = self.per_sequence
        batched = lambda x: torch.is_tensor(x) and x.dim() >= 3 and x.shape[0] == B
        if (B and name in self.PRODUCTS and len(args) == 2 and not kwargs
                and all(torch.is_tensor(x) and x.is_floating_point() for x in args)
                and any(batched(x) for x in args)):
            part = lambda x, k: x[k : k + 1].clone() if batched(x) else x
            out = torch.cat([func(part(args[0], k), part(args[1], k)) for k in range(B)])
            self.split += 1
        else:
            out = func(*args, **kwargs)
        if name in self.SKIP:
            return out
        outs = [("", out)] if torch.is_tensor(out) else [
            (f".{i}", o) for i, o in enumerate(out) if torch.is_tensor(o)
        ] if isinstance(out, (tuple, list)) else []
        if not outs:
            return out
        f = sys._getframe(2)
        while f is not None and "malio_tpu_torch" not in f.f_code.co_filename:
            f = f.f_back
        if f is None:
            return out
        loc = f"{pathlib.Path(f.f_code.co_filename).relative_to(ROOT)}:{f.f_lineno}"
        for suffix, o in outs:
            n = self._seen.get((loc, name + suffix), 0)
            self._seen[loc, name + suffix] = n + 1
            key = (loc, name + suffix, n)
            kept = self.store(key, o.detach())
            if kept is not None:
                self.ops[key] = kept
                self.order.append(key)
        return out


def _sequence_slice(t16, shape1, b, B):
    """Sequence b's part of a B-sequence output whose one-sequence twin has
    `shape1`: the same tensor (no batch axis), row b of a leading batch
    axis, or the b-th of B equal parts of a sequence-major flat layout.
    None when the shapes do not say."""
    if tuple(t16.shape) == tuple(shape1):
        return t16
    if t16.dim() >= 1 and len(shape1) >= 1 and t16.shape[0] == B and shape1[0] == 1 \
            and tuple(t16.shape[1:]) == tuple(shape1[1:]):
        return t16[b : b + 1]
    n1 = 1
    for d in shape1:
        n1 *= d
    if n1 and t16.numel() == B * n1:
        return t16.reshape(-1)[b * n1 : (b + 1) * n1].reshape(shape1)
    return None


def _tensors(tree):
    import torch

    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def batch_bits_main(rounds=BITS_ROUNDS, dev="cuda", B=BATCH, check=BATCH_CHECK, points=4096,
                    map_slots=1 << 21):
    """Where a sequence of a B = 16 batched round leaves the bits of its own
    round (the batch of one): sequences BATCH_CHECK alone and the flagship
    batch (seeds 0-15) step the same rounds from their initial carries;
    every torch operation of each round is logged (_OpLog) and sequence b's
    part of each B = 16 output is held against its own round's output at
    the same call site and occurrence. Per round and sequence: the first
    differing operations in execution order, and whether the carry is
    still bit-equal. Then the same with every matrix product of the batch
    (f32 and f64) split into one product per sequence on fresh copies, with
    the products it split counted (each adds about 3 B launches). The
    insert's write goes through the merge kernel, checked against its
    plain version on each round's arguments. Writes
    chiprun_out/batch_bits.json."""
    import torch

    if dev == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import malio_tpu_torch  # noqa: F401  (sets the matmul precision)
    from malio_tpu_torch import batched
    from malio_tpu_torch.ops import _build

    smi = gpu_name_and_limit() if dev == "cuda" else "cpu"
    log(smi)
    if dev == "cuda":
        _build.build_all(["knn_window", "deskew", "merge_rows"])
    cfg = batched._flagship_config(points, map_slots, False)
    seqs = batched._build_sequences(cfg, B, BATCH_PROFILE_SECONDS, points,
                                    batched._flagship_world(cfg))
    report = dict(gpu=smi, rounds=rounds, sequences=list(check))
    with _Eager():  # every operation runs in Python to be logged
        _batch_bits_rounds(cfg, seqs, rounds, dev, B, check, report)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "batch_bits.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({v: [{b: (q["differing"], q["carry_bit_equal"])
                           for b, q in r["sequences"].items()} for r in report[v]]
                      for v in ("as_is", "per_sequence_products")}))
    return 0


def _batch_bits_rounds(cfg, seqs, rounds, dev, B, check, report):
    """batch_bits_main's rounds, both variants, into `report`."""
    import torch
    from malio_tpu_torch import batched, pipeline
    from malio_tpu_torch.ops import merge

    for variant, split in (("as_is", None), ("per_sequence_products", B)):
        c16, ch16, _ = batched._prepare(cfg, seqs, torch.float32, 1, dev)
        singles = {b: batched._prepare(cfg, [seqs[b]], torch.float32, 1, dev)[:2] for b in check}
        carries = {b: s[0] for b, s in singles.items()}
        out_rounds = []
        for k in range(rounds):
            logs1 = {}
            for b in check:
                with _OpLog(lambda key, t: t.clone()) as ol:
                    carries[b], _ = pipeline.scan_steps(cfg, carries[b], singles[b][1][k][0],
                                                        device=dev)
                logs1[b] = ol

            def store(key, t):
                kept = {}
                for b, o1 in logs1.items():
                    ref = o1.ops.get(key)
                    sl = None if ref is None else _sequence_slice(t, ref.shape, b, B)
                    if sl is not None and sl.dtype == ref.dtype:
                        kept[b] = sl.clone()
                return kept or None

            with _Recording(merge, "merge_rows") as ins, _OpLog(store, split) as ol16:
                c16, _ = pipeline.scan_steps(cfg, c16, ch16[k][0], device=dev)
            merge_check(f"batch_bits round {k}", *ins.args)
            del ins.args
            per_seq = {}
            for b, o1 in logs1.items():
                diffs, compared = [], 0
                for i, key in enumerate(o1.order):
                    s = ol16.ops.get(key, {}).get(b)
                    # integer outputs hold row offsets and sequence ids that
                    # differ by design for b > 0: floats only
                    if s is None or not s.is_floating_point():
                        continue
                    compared += 1
                    r = o1.ops[key]
                    if not torch.equal(_bits(s), _bits(r)):
                        d = (s.double() - r.double()).abs()
                        diffs.append(dict(order=i, at=key[0], op=key[1], occurrence=key[2],
                                          shape=list(r.shape), dtype=str(r.dtype)[6:],
                                          entries=int((_bits(s) != _bits(r)).sum()),
                                          max_abs=float(d.nan_to_num(0.0).max())))
                pairs = [(_sequence_slice(a, x.shape, b, B), x)
                         for a, x in zip(_tensors(c16), _tensors(carries[b]))]
                same = all(s is not None and torch.equal(_bits(s), _bits(x)) for s, x in pairs)
                per_seq[b] = dict(ops=len(o1.order), compared=compared, differing=len(diffs),
                                  first=diffs[:12], carry_bit_equal=same)
                first = diffs[0] if diffs else None
                log(f"batch_bits {variant} round {k} sequence {b}: {len(diffs)} of {compared} "
                    f"compared outputs differ, carry bit-equal {same}; first: "
                    + (f"{first['at']} {first['op']} {first['shape']} {first['dtype']} max "
                       f"|diff| {first['max_abs']}" if first else "none"))
            out_rounds.append(dict(split_products=ol16.split, sequences=per_seq))
            log(f"batch_bits {variant} round {k}: {ol16.split} products split per sequence")
            del logs1, ol, ol16
        report[variant] = out_rounds


def _clone(tree):
    """A copy of a nested NamedTuple of tensors."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_clone(v) for v in tree))
    return tree.clone()


def soak_phase(floor, dev="cuda"):
    """The soak cell: soak.run (scan_steps in chunks of SOAK_CHUNK, each
    fenced by a host copy; the compiled round captured by a short run
    before) over SOAK_SECONDS of the soak's stream at its
    full width (3 x 1024 raw points, 3072 measurement lanes uncapped, 2^19
    map slots, f32 points, f64 P), the launch counts set to 0 just before
    and read just after. Fails unless the trajectory and P are finite, the
    ATE is within ATE_GATE_M, no measurement lane dropped, map drops within
    the map layout's contract (MAP_DROP_SHARE of the insert candidates), and
    every chunk launched the base-window k-NN, the deskew and the merge
    once a round. Then each kernel on the last round's arguments
    (knn_window_soak, deskew_soak, merge_rows_soak), checked against its
    plain version and timed. Returns (report: soak.summary's keys, the
    card's memory at each quartile, launches a round in the first and the
    last quartile; launches; kernel rows)."""
    import torch
    from malio_tpu_torch import measurement as meas
    from malio_tpu_torch import soak
    from malio_tpu_torch.map import voxel_hash as vh

    from malio_tpu_torch import pipeline

    t0 = time.perf_counter()
    cfg, groups, traj = soak.soak_sequence(SOAK_SECONDS, SOAK_POINTS, seed=0)
    gen_s = time.perf_counter() - t0
    with _PathRecording() as rec:
        # a short run first captures the soak's round (its warm-up round
        # launches every kernel once more than the rounds it runs)
        captured = len(pipeline.compiled_rounds())
        soak.run(cfg, groups[:SOAK_CAPTURE_GROUPS], torch.float32, dev, SOAK_CHUNK)
        graph = [compiled_report(c) for c in pipeline.compiled_rounds()[captured:]]
        reset_launches()
        res = soak.run(cfg, groups, torch.float32, dev, SOAK_CHUNK)
        search, deskew_rec, merge_args = rec.snapshot()
    counts = read_launches("soak")
    out = soak.summary(res, traj)
    v_base = len(vh._svx_ball_offsets(cfg.knn_radius))
    for c, by_kernel in enumerate(res["launches"]):
        per = dict(knn_window=sum(n for (q, v, k), n in by_kernel["knn_window"].items()
                                  if v == v_base),
                   deskew=sum(by_kernel["deskew"].values()),
                   merge_rows=sum(by_kernel["merge_rows"].values()))
        if any(n != res["chunk"] for n in per.values()):
            raise AssertionError(f"soak: chunk {c} of {res['chunk']} rounds launched {per} "
                                 f"(base-window k-NN, deskew, merge), not one each a round")
    if not out["finite"]:
        raise AssertionError(f"soak: non-finite trajectory or P ({out['n_nonfinite_rounds']} "
                             f"rounds, P_max {out['P_max']})")
    if not out["ate_m"] <= ATE_GATE_M:
        raise AssertionError(f"soak: ATE {out['ate_m']} m exceeds {ATE_GATE_M} m")
    if out["meas_dropped_total"]:
        raise AssertionError(f"soak: dropped {out['meas_dropped_total']} measurement lanes")
    # the 2^19-slot table of the soak's config drops new voxels whose
    # supervoxel row is full, as the reference's insert does (a row tail,
    # re-offered and counted again each round; tests/test_torch_soak_evict.py
    # holds the port's drops to the JAX ones): hold the drops to the map
    # layout's contract, tests/test_map.py::test_surface_load_recall, at
    # most 0.2% of the insert candidates offered (tests/test_soak.py counts
    # its soak's drops against the same sum)
    offered = int(res["n_insert"].sum())
    if out["map_dropped_final"] > max(2, int(MAP_DROP_SHARE * offered)):
        raise AssertionError(f"soak: {out['map_dropped_final']} map drops for {offered} insert "
                             f"candidates (contract: {MAP_DROP_SHARE:.1%})")
    quartiles = {name: soak.launches_per_round(res, k) for k, name in ((0, "first"), (3, "last"))}
    log(f"soak: {out['rounds']} rounds ({SOAK_SECONDS} s of {cfg.num_lidars} x {SOAK_POINTS} "
        f"points, {cfg.map_capacity} slots; stream made in {gen_s:.1f} s): {json.dumps(out)}")
    for m in res["memory"]:
        log(f"soak: device memory at the end of quartile {m['quartile']}: allocated "
            f"{m['allocated']} B, reserved {m['reserved']} B")
    for name, q in quartiles.items():
        log(f"soak: launches a round, {name} quartile: {json.dumps(q)}")
    m = res["carry"].map
    K = meas.CAND_K
    rows = [knn_row("knn_window_soak", window_args(m, search["queries"], cfg.knn_radius,
                                                   search["qmask"]), K),
            deskew_phase("deskew_soak", deskew_rec["args"], floor),
            merge_phase("merge_rows_soak", *merge_args, floor)]
    for r in rows:
        r["path"] = "soak"
    report = dict(out, seconds=SOAK_SECONDS, stream_s=gen_s, memory=res["memory"], graph=graph,
                  insert_candidates=offered,
                  launches_per_round=quartiles,
                  chunk_s=res["chunk_s"].tolist(), p_tr=res["p_tr"].tolist())
    return report, counts, rows


def gpu_name_and_limit():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def backend_main():
    """Only the back end: the kernels built, the back-end cell, the solver
    cell and the block_tridiag rows, each kernel's launches by path; the
    kernels line and the device summary last."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import malio_tpu_torch  # noqa: F401  (sets the matmul precision)
    from malio_tpu_torch.config import flagship_config
    from malio_tpu_torch.ops import _build

    smi = gpu_name_and_limit()
    log(smi)
    t0 = time.perf_counter()
    _build.build_all(["knn_window", "deskew", "merge_rows", "block_tridiag"])
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    report, paths = dict(gpu=smi), {}
    report["backend"], paths["backend"], backend_tridiag = backend_phase(flagship_config())
    report["solver"], paths["solver"], solver_tridiag = solver_phase()
    rows = tridiag_phase(backend_tridiag, solver_tridiag)
    for r in rows:
        key, counts = r.pop("shape_key"), r.pop("counter")
        r["launches_by_path"] = {p: c.get(counts, {}).get(key, 0) for p, c in paths.items()}
        r["launches"] = r["launches_by_path"].get(r.get("path"), 0)
    report["kernels"] = rows
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_backend.json").write_text(json.dumps(report, indent=1, default=str))
    log(smi)
    print(json.dumps({"kernels": rows}, default=str))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def distributed_main():
    """Only the distributed cell: the kernels built, the flagship's main
    path (seed 0, run_sequence through the compiled round) that the worlds
    are held against, then the distributed phase; details in
    chip_smoke_distributed.json beside chip_smoke.json, the device summary
    last."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import malio_tpu_torch  # noqa: F401  (sets the matmul precision)
    from malio_tpu_torch import runner
    from malio_tpu_torch.config import flagship_config
    from malio_tpu_torch.ops import _build

    smi = gpu_name_and_limit()
    log(smi)
    t0 = time.perf_counter()
    _build.build_all(["knn_window", "deskew", "merge_rows"])
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    cfg = flagship_config()
    groups, _ = flagship_groups(cfg, 8.0, seed=0)
    stamps = []

    def tick(carry, out, base):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    res = runner.run_sequence(cfg, groups, dtype=torch.float32, device="cuda", callback=tick)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report, paths = distributed_phase(cfg, groups, res, np.diff(stamps), out_dir, smi)
    report.update(gpu=smi, cards=torch.cuda.device_count(),
                  launches_by_path={p: {k: {",".join(map(str, sh)): n for sh, n in c[k].items()}
                                        for k in c} for p, c in paths.items()})
    (out_dir / "chip_smoke_distributed.json").write_text(json.dumps(report, indent=1))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def main(save_stage_inputs=None):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import numpy as np
    import malio_tpu_torch  # noqa: F401  (sets the matmul precision)
    from malio_tpu_torch import measurement as meas
    from malio_tpu_torch import runner
    from malio_tpu_torch.config import Config, flagship_config
    from malio_tpu_torch.eval.ate import ate_rmse
    from malio_tpu_torch.io.assemble import assemble_groups
    from malio_tpu_torch.map import voxel_hash as vh
    from malio_tpu_torch.ops import _build, deskew, knn, merge

    t_start = time.perf_counter()
    elapsed = {}  # seconds since the start at the end of each phase

    def done(phase):
        elapsed[phase] = time.perf_counter() - t_start
        log(f"[{elapsed[phase]:.0f} s] {phase} done")

    smi = gpu_name_and_limit()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report = dict(gpu=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    names = ["knn_window", "deskew", "merge_rows", "block_tridiag"]
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
    imu, rounds_raw, traj = flagship_sequence(cfg, duration=8.0, seed=0)
    groups = assemble_groups(cfg, imu, rounds_raw)
    log(f"flagship world + {len(groups)} measure groups generated in {time.perf_counter() - t0:.1f} s")
    stamps = []
    saved = {}

    def tick(carry, out, base):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if len(stamps) == RESUME_AT:  # the carry after round RESUME_AT, for the resume phase
            saved["carry"] = _clone(carry)

    # keep the last round's kernel arguments for the kernel and stage
    # phases: the recording holds the graph's tensors from the capture on
    with _PathRecording() as rec:
        report["graph"], n_init, r_graph = graph_phase(cfg, groups, v_base, v_wide, smi)
        done("graph")
        reset_launches()
        t0 = time.perf_counter()
        res = runner.run_sequence(cfg, groups, dtype=torch.float32, device="cuda",
                                  callback=tick)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        last_search, last_deskew, main_merge_args = rec.snapshot()
    paths = {"main": read_launches("main")}
    by_shape = paths["main"]["knn_window"]
    n_base = sum(n for (q, v, k), n in by_shape.items() if v == v_base)
    n_wide = sum(n for (q, v, k), n in by_shape.items() if v == v_wide)
    n_desk = deskew.deskew_points.launches
    desk_by_shape = paths["main"]["deskew"]
    rounds = len(res["t"])
    # the replays of the round captured in the graph phase: each kernel once a round
    if not n_base == n_wide == n_desk == merge.merge_rows.launches == rounds:
        raise AssertionError(f"main path: not every kernel once a round: knn_window {by_shape}, "
                             f"deskew {n_desk}, merge_rows {paths['main']['merge_rows']} in "
                             f"{rounds} rounds")
    warm = 8
    steady = (rounds - warm) / (stamps[-1] - stamps[warm - 1])
    ate = ate_rmse(res["pos"], traj.pos(res["t"]))
    miss_p50 = float(np.median(res["nn_miss"]))
    log(f"main path: {rounds} rounds in {wall:.2f} s; steady {steady:.2f} scans/s "
        f"(rounds {warm}+), {smi}")
    log(f"ATE {ate:.6f} m (gate {ATE_GATE_M}), map_dropped {int(res['map_dropped'][-1])}, "
        f"meas_dropped max {int(res['n_meas_dropped'].max())}, nn_miss p50 {miss_p50}, "
        f"map_size {int(res['map_size'][-1])}, launches knn_window {by_shape} "
        f"(Q, V, K): n, deskew {desk_by_shape} (B, L, N, C): n, merge_rows "
        f"{paths['main']['merge_rows']} (T, N): n")
    if not (np.isfinite(ate) and ate <= ATE_GATE_M):
        raise AssertionError(f"ATE {ate} is not finite or exceeds {ATE_GATE_M} m")
    if not np.all(np.isfinite(res["pos"])) or res["pos"].shape != (rounds, 3):
        raise AssertionError("trajectory has non-finite values or a wrong shape")
    if n_init != len(groups) - rounds:
        raise AssertionError(f"graph phase: {n_init} initialisation groups, main path "
                             f"{len(groups) - rounds}")
    for f in ("t", "pos", "quat", "map_size"):
        _same(f"graph phase {f}", r_graph[f], res[f][: len(r_graph["t"])])
    report["graph"]["sync"] = sync_check(cfg, saved["carry"], groups, n_init, RESUME_AT)

    # ---- the same path through the eager round, held bit-equal ----
    main_stamps = list(stamps)
    stamps.clear()
    t0 = time.perf_counter()
    with _Eager():
        res_e = runner.run_sequence(cfg, groups, dtype=torch.float32, device="cuda",
                                    callback=tick)
    wall_e = _ms_since(t0) / 1e3
    steady_e = (rounds - warm) / (stamps[-1] - stamps[warm - 1])
    for f in ("t", "pos", "quat", "pose_cov", "map_size", "iterations", "n_effective",
              "nn_miss", "map_dropped"):
        _same(f"eager main path {f}", res_e[f], res[f])
    stamps[:] = main_stamps
    report["eager"] = dict(wall_s=wall_e, steady_scans_per_s=steady_e)
    log(f"eager round: {rounds} rounds in {wall_e:.2f} s, steady {steady_e:.2f} scans/s against "
        f"{steady:.2f} through the graph; every output bit-equal; {smi}")
    del res_e

    done("main path")
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
    # voxel_hash.knn's K = 5 (off the main path): the whole function, then
    # the kernel at its shapes
    report["knn_k5"], paths["knn_k5"] = knn_function_check(m, queries, qmask, cfg)
    knn_rows += knn_phase(m, queries, qmask, cfg, vh.NUM_MATCH_POINTS, suffix="_k5")
    # the three kernels at the shapes mp rank 0 of the distributed path gives them
    mp_knn, mp_desk, mp_merge = dist_mp_kernel_inputs(m, queries, qmask, cfg,
                                                      last_deskew["args"], main_merge_args)
    dist_rows = [knn_row("knn_window_dist_mp", mp_knn, K),
                 deskew_phase("deskew_dist_mp", mp_desk, floor)]
    dist_rows[0]["graph_ms"] = graph_ms(lambda: knn.knn_window(*mp_knn, K))
    dist_rows[1]["graph_ms"] = graph_ms(lambda: deskew.deskew_points(*batch_args(mp_desk)))
    del mp_knn, mp_desk
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
    report["deskew_layout_sweep"] = deskew_layout_sweep()
    # the merge kernel: micro_r4b's shapes, the main path's last insert, a
    # world correction's re-insert of the whole map (the back end's
    # transform), the edge cases
    dq = torch.tensor([np.cos(0.05), 0.0, 0.0, np.sin(0.05)], dtype=torch.float32, device="cuda")
    with _Recording(merge, "merge_rows") as corr:
        vh.transform(m, dq, torch.tensor([0.3, -0.2, 0.05], device="cuda"))
    merge_kernel_rows = merge_kernel_phase({"merge_rows_path": main_merge_args,
                                            "merge_rows_transform": corr.args}, floor)
    dist_rows.append(merge_phase("merge_rows_dist_mp", *mp_merge, floor))
    dist_rows[2]["graph_ms"] = graph_ms(lambda: merge.merge_rows(*mp_merge))
    for r in dist_rows:
        r["path"] = "dist_mp"
    del main_merge_args, corr.args, mp_merge

    # ---- the whole k-NN stage, kernel and plain ----
    stage = {flag: stage_ms(vh, meas, m, queries, qmask, cfg, flag) for flag in (True, False)}
    report["knn_stage"] = {"kernel": stage[True], "plain": stage[False]}
    for flag, st in stage.items():
        log(f"k-NN stage (knn_cached, Q={queries.shape[0]}, {'kernel' if flag else 'plain'}): "
            f"{st['stage_ms']:.4f} ms per call by events, device {st['stage_device_ms']:.4f} ms "
            f"in {st['stage_device_ops']:.0f} device ops")
    # ---- the same rounds through the plain versions on the card (eager:
    # the swapped merge acts at every round) ----
    import dataclasses

    plain_cfg = dataclasses.replace(cfg, knn_kernel=False, deskew_kernel=False)
    merge_rows_kernel = merge.merge_rows
    merge.merge_rows = merge.merge_rows_plain
    try:
        with _Eager():
            res_p = runner.run_sequence(plain_cfg, groups[: n_init + PLAIN_ROUNDS],
                                        dtype=torch.float32, device="cuda")
    finally:
        merge.merge_rows = merge_rows_kernel
    report["insert_plain_rounds"] = insert_plain_check(cfg, groups, n_init, res)
    k = len(res_p["t"])
    dpos = float(np.abs(res_p["pos"] - res["pos"][:k]).max())
    log(f"plain versions, first {k} rounds: max |pos(kernels) - pos(plain)| = {dpos:.3g} m "
        f"(limit {PLAIN_TOL_M})")
    if not dpos <= PLAIN_TOL_M:
        raise AssertionError(f"kernel and plain trajectories differ by {dpos} m")

    # ---- where a steady round's time goes, through the graph and eager ----
    report["profile"] = profile_phase(run_rounds(cfg, groups, n_init), round_ms=1e3 / steady)
    with _Eager():
        report["profile_eager"] = profile_phase(run_rounds(cfg, groups, n_init),
                                                round_ms=1e3 / steady_e, label="profile (eager)")

    done("kernel, stage, plain and profile phases")

    # ---- the slice's other paths, each with its own launch counts ----
    report["scan_steps"], paths["scan_steps"] = scan_steps_phase(cfg, groups, n_init, res)
    done("scan_steps")
    report["online"], paths["online"] = online_phase(cfg, imu, rounds_raw, res, ate, traj)
    with _Eager():
        report["online_eager"], _ = online_phase(cfg, imu, rounds_raw, res, ate, traj)
    done("online")
    report["resume"], paths["resume"] = resume_phase(cfg, groups, n_init, saved["carry"], res,
                                                     out_dir)
    del saved["carry"]
    done("resume")
    report["backend"], paths["backend"], backend_tridiag = backend_phase(cfg)
    done("back end")
    report["solver"], paths["solver"], solver_tridiag = solver_phase()
    tridiag_rows = tridiag_phase(backend_tridiag, solver_tridiag)
    del backend_tridiag, solver_tridiag
    done("solver and block_tridiag kernel")
    report["batched"], batch_paths, batch_rows = batched_phase(floor, smi, report["profile"])
    paths.update(batch_paths)
    done("batched")
    report["dataset"], dataset_paths = dataset_phase(out_dir, smi)
    paths.update(dataset_paths)
    done("dataset")
    report["bench_kernels"], paths["bench_kernels"] = bench_kernels_phase(smi)
    done("bench kernel times")
    report["distributed"], dist_paths = distributed_phase(cfg, groups, res, np.diff(stamps), out_dir,
                                                          smi)
    paths.update(dist_paths)
    done("distributed")
    report["soak"], paths["soak"], soak_rows = soak_phase(floor)
    done("soak")

    kernels = (knn_rows + desk_rows + merge_kernel_rows + batch_rows + dist_rows + soak_rows
               + tridiag_rows)
    for r in kernels:
        r["floor_ms"] = floor
        if "K" in r:
            key, counts = (r["Q"], r["V"], r["K"]), "knn_window"
        else:
            key, counts = r.pop("shape_key"), r.pop("counter", "deskew")
        r["launches_by_path"] = {p: c.get(counts, {}).get(key, 0) for p, c in paths.items()}
        # the launches of the row's own path (the main path, or the batched
        # path for the rows at the batched shapes) at the row's shape
        r["launches"] = r["launches_by_path"][r.get("path", "main")]
    keys = ("name", "route", "source", "replaces", "shape", "launches", "max_abs_err", "ms",
            "call_ms", "graph_ms", "plain_ms", "plain_call_ms", "bound_ms", "bound_by", "library_ms",
            "library_call_ms", "bound_with_floor_ms", "launches_by_path")
    report.update(
        kernels=kernels, rounds=rounds, wall_s=wall, steady_scans_per_s=steady, ate_m=ate,
        map_dropped=res["map_dropped"].tolist(), nn_miss=res["nn_miss"].tolist(),
        meas_dropped=res["n_meas_dropped"].tolist(), iterations=res["iterations"].tolist(),
        map_size=res["map_size"].tolist(), round_s=np.diff(stamps).tolist(),
        plain_max_dpos_m=dpos,
        launches_by_path={p: {k: {",".join(map(str, sh)): n for sh, n in c[k].items()} for k in c}
                          for p, c in paths.items()},
        traces=len(TRACES), trace_retakes=[t for t in TRACES if not t["ok"]], elapsed_s=elapsed,
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
    ap.add_argument("--merge-kernel", metavar="TREE",
                    help="only time the merge kernel of the package in TREE beside this one's")
    ap.add_argument("--eigvalsh", action="store_true",
                    help="only the main path's ATE through the eager round with the closed-form "
                         "eigen-solve and with torch.linalg.eigvalsh")
    ap.add_argument("--dist-mp", metavar="TREE",
                    help="only time the distributed mp world of the package in TREE beside "
                         "this one's")
    ap.add_argument("--backend", action="store_true",
                    help="only the back-end and solver cells and the block_tridiag kernel")
    ap.add_argument("--distributed", action="store_true",
                    help="only the distributed cell (its NCCL part with two or more cards)")
    ap.add_argument("--inputs", metavar="FILE", help="inputs saved by --save-stage-inputs")
    ap.add_argument("--outputs", metavar="FILE",
                    help="with --deskew-kernel: keep the first tree's results in FILE, compare "
                         "later trees' with them")
    ap.add_argument("--trace-check", metavar="SECONDS", type=float,
                    help="only count profiler traces that lose device events, for SECONDS")
    ap.add_argument("--lead-in", metavar="S", type=float, default=TRACE_LEAD_IN_S,
                    help="host seconds before a trace's first call (with --trace-check)")
    ap.add_argument("--batch-bits", action="store_true",
                    help="only find the first operation whose bits differ between a B = 16 "
                         "batched round and a sequence's own round")
    a = ap.parse_args()
    if a.batch_bits:
        sys.exit(batch_bits_main())
    if a.backend:
        sys.exit(backend_main())
    if a.distributed:
        sys.exit(distributed_main())
    if a.knn_stage:
        sys.exit(knn_stage_main(a.knn_stage, a.inputs))
    if a.deskew_kernel:
        sys.exit(deskew_kernel_main(a.deskew_kernel, a.inputs, a.outputs))
    if a.merge_kernel:
        sys.exit(merge_kernel_main(a.merge_kernel))
    if a.dist_mp:
        sys.exit(dist_mp_main(a.dist_mp))
    if a.eigvalsh:
        sys.exit(eigvalsh_main())
    if a.trace_check:
        sys.exit(trace_check_main(a.trace_check, a.lead_in))
    sys.exit(main(a.save_stage_inputs))
