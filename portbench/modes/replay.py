"""Replay: one recorded drive replayed through runner.run_sequence as fast
as the program goes, pass after pass from the IMU-initialised start until
the window closes. The last pass is cut to the whole chunks that fit the
time left. Each pass ends in a fence (run_sequence copies each chunk's
outputs to the host); rounds_per_s is every fused round of every pass
over the window's seconds.

After the window every pass is held against the reference over all of
its rounds, the reference replaying the whole drive once, and against
the drive the inputs were made from (check.ate). A traced run drives one
more pass and traces two loop iterations of run_sequence in its middle:
chunk `trace_chunk` (its rounds on the card, their host copy and the
next chunk's host marshalling) with the device's activities alone, for
the numbers, and the chunk after it with the host's operations too, for
the labels of the idle gaps (core/trace.py).

Workload parameters: sequence_s (the drive's length), trace_chunk."""
from __future__ import annotations

import time

import numpy as np

from portbench.core import check, trace
from portbench.core.bench import log
from portbench.reference import replay as reference

CHUNK = 16  # run_sequence's chunk through pipeline.scan_steps


def _fields(res):
    return {f: np.asarray(res[f] if f != "end_time" else res["t"])[None] for f in reference.FIELDS}


def _pass(runner, cfg, groups, cell):
    import torch

    res = runner.run_sequence(cfg, groups, dtype=torch.float32, device=cell.device)
    cell.sync()
    return _fields(res)


def run(cell):
    from malio_tpu_torch import graph, runner

    p = cell.params
    cfg = cell.program_config()
    imu, rounds, traj = cell.sequence(cell.seed, p["sequence_s"])
    groups = cell.groups(imu, rounds)
    n_init = init_groups(groups)
    # set-up: the round captured; two chunks through scan_steps and a round
    # by itself through step, the two ways a pass drives it
    _pass(runner, cfg, groups[: n_init + 2 * CHUNK + 1], cell)

    setup_s = cell.start_window()
    deadline = cell.window_t0 + cell.seconds
    outs, done, pass_s = [], 0, None
    while time.perf_counter() < deadline:
        left = deadline - time.perf_counter()
        sub = groups
        if pass_s is not None and left < pass_s:
            k = max(CHUNK, int(left / pass_s * (len(groups) - n_init)) // CHUNK * CHUNK)
            sub = groups[: n_init + k]
        t = time.perf_counter()
        o = _pass(runner, cfg, sub, cell)
        pass_s = pass_s if len(sub) < len(groups) else time.perf_counter() - t
        outs.append(o)
        done += o["pos"].shape[1]
        if len(sub) < len(groups):
            break
    window_s = cell.end_window()
    peak = cell.memory_peak()
    result = dict(setup_s=setup_s, window_s=window_s, memory_peak_bytes=peak,
                  e2e=dict(rounds_per_s=done / window_s), attempted=done,
                  failed=sum(int(np.sum(~np.all(np.isfinite(o["pos"]), axis=-1))) for o in outs),
                  batch=1, spans={})
    log(f"replay: {len(outs)} passes, {done} fused rounds in {window_s:.3f} s "
        f"({result['e2e']['rounds_per_s']:.4f} rounds/s); a whole pass {len(groups) - n_init} "
        f"rounds in {pass_s} s; set-up {setup_s:.3f} s")
    if outs:
        o = outs[0]
        log(f"replay: first pass map_dropped {int(o['map_dropped'][0, -1])}, nn_miss p50 "
            f"{float(np.median(o['nn_miss'])):.1f}, n_meas_dropped max "
            f"{int(np.max(o['n_meas_dropped']))}")

    if cell.trace:
        for attempt in range(3):
            o, summary = _traced_pass(runner, cfg, groups, cell, p["trace_chunk"])
            outs.append(o)
            if summary is not None:
                break
            log(f"replay: trace {attempt + 1} lost a marker; taking it again")
        result["trace"] = summary
    result["counters"] = counters(graph)
    cell.release(graph)

    t_ref = time.perf_counter()
    ref = reference.replay(cell.reference_config(), [groups], len(groups), device=cell.device)
    log(f"reference: {ref['pos'].shape[1]} rounds of {ref['pos'].shape[0]} sequences in "
        f"{time.perf_counter() - t_ref:.3f} s")
    result["gaps"] = check.worst(*[
        check.gaps(o, {f: v[:, : o["pos"].shape[1]] for f, v in ref.items()}) for o in outs])
    result["gaps"]["ate_m"] = max(check.ate(o["pos"][0], o["end_time"][0], traj) for o in outs)
    result.update(reference=ref, reference_inputs=[groups], trajectories=[traj])
    return result


def _traced_pass(runner, cfg, groups, cell, at):
    """A whole pass, with chunk `at`'s loop iteration traced for the
    numbers and chunk at + 1's for the gaps' labels: a segment opens as
    run_sequence hands a chunk to pipeline.scan_steps and closes as it
    hands over the next. Returns (the pass's outputs, the summary)."""
    from malio_tpu_torch import pipeline

    scan, calls, segs, done = pipeline.scan_steps, [0], [None], []

    def traced(*a, **k):
        i = calls[0]
        calls[0] += 1
        if segs[0] is not None:
            done.append(segs[0].stop(rounds=CHUNK))
            segs[0] = None
        if i in (at, at + 1):
            segs[0] = trace.Segment(host=i != at)
            segs[0].start()
        return scan(*a, **k)

    pipeline.scan_steps = traced
    try:
        o = _pass(runner, cfg, groups, cell)
    finally:
        pipeline.scan_steps = scan
    if segs[0] is not None:  # the pass had no chunk after the traced one
        done.append(segs[0].stop(rounds=CHUNK))
    return o, (trace.labelled(*done) if len(done) == 2 else None)


def init_groups(groups, samples=10):
    """Groups the IMU initialisation takes before the first fused round:
    the first group after one, once `samples` IMU samples are in
    (runner.ImuInitializer's count)."""
    n = 0
    for gi, g in enumerate(groups):
        if gi > 0 and n >= samples:
            return gi
        n += int(np.sum(g["imu_mask"]))
    return len(groups)


def counters(graph):
    """The program's own counters: each capture's nodes, pool bytes and
    replays (graph.captures()) and each kernel's launches by shape
    (ops.wrappers())."""
    from malio_tpu_torch import ops

    caps = [dict(program=k[0], nodes=r.nodes, pool_bytes=r.pool_bytes, replays=r.replays,
                 warmup_s=r.warmup_s, capture_s=r.capture_s)
            for k, r in graph.captures()]
    launches = {name: {str(s): n for s, n in fn.launches_by_shape.items()}
                for name, fn in ops.wrappers().items()}
    return dict(captures=caps, launches=launches)
