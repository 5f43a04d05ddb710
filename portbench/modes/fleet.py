"""Fleet: B recorded drives (seeds seed .. seed + B - 1) replayed in
lockstep through pipeline.scan_steps on one batched carry, in chunks, as
batched.flagship_benchmark drives them: the IMU-initialised carries
stacked and every chunk's groups on the card before the window. Passes
restart from that carry until the window closes; the last is cut to the
chunks that fit the time left. Each pass ends in a fence (a synchronise
and a host copy of the last chunk's positions). rounds_per_s counts a
lockstep round as B sequence-rounds.

After the window each pass is held against the reference over all of
its rounds in `check_sequences` of the B (drawn from the seed; all B
where it is B), and every sequence against the drive its inputs were
made from (check.ate). A traced run drives one more pass and traces
chunk `trace_chunk` with the device's activities alone, for the numbers,
and the chunk after it with the host's operations too, for the labels of
the idle gaps (core/trace.py).

Workload parameters: batch, sequence_s, chunk, check_sequences,
trace_chunk."""
from __future__ import annotations

import time

import numpy as np

from portbench.core import check, trace
from portbench.core.bench import log
from portbench.modes.replay import counters
from portbench.reference import replay as reference


def _pass(pipeline, cfg, carry, chunks, cell, fields, traced_at=None):
    """One pass over `chunks` from `carry`: each chunk's small outputs,
    kept on the device, and the fence's host positions. With `traced_at`,
    (the outputs, the summary of chunk traced_at's numbers with chunk
    traced_at + 1's gap labels)."""
    outs, seg, done = [], None, []
    for i, (group, bases) in enumerate(chunks):
        if seg is not None:
            done.append(seg.stop(rounds=int(chunks[i - 1][1].shape[0])))
            seg = None
        if traced_at is not None and i in (traced_at, traced_at + 1):
            seg = trace.Segment(host=i != traced_at)
            seg.start()
        carry, stacked = pipeline.scan_steps(cfg, carry, group, device=cell.device)
        outs.append(({f: getattr(stacked, f) for f in fields}, bases))
    if seg is not None:
        done.append(seg.stop(rounds=int(chunks[-1][1].shape[0])))
    cell.sync()
    outs[-1][0]["pos"].cpu()
    if traced_at is None:
        return outs
    return outs, (trace.labelled(*done) if len(done) == 2 else None)


def _host(outs, fields):
    """A pass's outputs as {field: array (B, rounds, ...)}, end_time absolute."""
    res = {}
    for f in fields:
        a = np.concatenate([o[f].cpu().numpy() for o, _ in outs])  # (rounds, B, ...)
        if f == "end_time":
            a = a.astype(np.float64) + np.concatenate([b for _, b in outs])
        res[f] = np.moveaxis(a, 0, 1)
    return res


def run(cell):
    import torch
    from malio_tpu_torch import batched, graph, pipeline

    p = cell.params
    B, chunk = p["batch"], p["chunk"]
    cfg = cell.program_config()
    seqs = [(cell.groups(imu, rounds), traj) for imu, rounds, traj in
            cell.sequences([cell.seed + b for b in range(B)], p["sequence_s"])]
    carry0, chunks, n_rounds = batched._prepare(cfg, seqs, torch.float32, chunk, cell.device)
    fields = reference.FIELDS
    _pass(pipeline, cfg, carry0, chunks[:1], cell, fields)  # set-up: the batched round captured

    setup_s = cell.start_window()
    deadline = cell.window_t0 + cell.seconds
    passes, done, pass_s = [], 0, None
    while time.perf_counter() < deadline:
        left = deadline - time.perf_counter()
        sub = chunks
        if pass_s is not None and left < pass_s:
            sub = chunks[: max(1, int(left / pass_s * len(chunks)))]
        t = time.perf_counter()
        passes.append(_pass(pipeline, cfg, carry0, sub, cell, fields))
        pass_s = pass_s if len(sub) < len(chunks) else time.perf_counter() - t
        done += len(sub) * chunk * B
        if len(sub) < len(chunks):
            break
    window_s = cell.end_window()
    peak = cell.memory_peak()
    host = [_host(o, fields) for o in passes]
    result = dict(setup_s=setup_s, window_s=window_s, memory_peak_bytes=peak,
                  e2e=dict(rounds_per_s=done / window_s), attempted=done,
                  failed=sum(int(np.sum(~np.all(np.isfinite(h["pos"]), axis=-1))) for h in host),
                  batch=B, spans={})
    log(f"fleet: B = {B}, {len(passes)} passes, {done} sequence-rounds in {window_s:.3f} s "
        f"({result['e2e']['rounds_per_s']:.4f} rounds/s); a whole pass {n_rounds} lockstep "
        f"rounds in {pass_s} s; set-up {setup_s:.3f} s")
    if host:
        h = host[0]
        log(f"fleet: first pass map_dropped max {int(np.max(h['map_dropped']))}, "
            f"nn_miss p50 {float(np.median(h['nn_miss'])):.1f}, n_meas_dropped max "
            f"{int(np.max(h['n_meas_dropped']))}")

    if cell.trace:
        for attempt in range(3):
            o, summary = _pass(pipeline, cfg, carry0, chunks, cell, fields,
                               traced_at=p["trace_chunk"])
            host.append(_host(o, fields))
            if summary is not None:
                break
            log(f"fleet: trace {attempt + 1} lost a marker; taking it again")
        result["trace"] = summary
    result["counters"] = counters(graph)
    del passes, carry0, chunks
    cell.release(graph)

    pick = np.sort(cell.rng(1).choice(B, size=p["check_sequences"], replace=False))
    t_ref = time.perf_counter()
    ref = reference.replay(cell.reference_config(), [seqs[b][0] for b in pick], n_rounds,
                           device=cell.device)
    log(f"reference: {ref['pos'].shape[1]} rounds of {ref['pos'].shape[0]} sequences in "
        f"{time.perf_counter() - t_ref:.3f} s")
    result["gaps"] = check.worst(*[
        check.gaps({f: v[pick] for f, v in h.items()},
                   {f: v[:, : h["pos"].shape[1]] for f, v in ref.items()})
        for h in host])
    result["gaps"]["ate_m"] = max(check.ate(h["pos"][b], h["end_time"][b], seqs[b][1])
                                  for h in host for b in range(B))
    log(f"fleet: sequences {pick.tolist()} held against the reference over all rounds")
    result.update(reference=ref, reference_inputs=[seqs[b][0] for b in pick],
                  trajectories=[seqs[b][1] for b in pick])
    return result
