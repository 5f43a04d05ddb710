"""Loop: one revisiting drive replayed through runner.run_sequence with the
pose-graph back end observing every round (posegraph.PoseGraphBackend with
feedback, the deployment's `backend` settings), pass after pass from the
IMU-initialised start, each pass with a fresh back end. The observer makes
run_sequence go round by round through pipeline.step; at every keyframe
the back end reads the round's pose and cloud, looks for a revisit, refines
a candidate by ICP, relaxes the whole graph when an edge is accepted and
stages the correction that run_sequence applies to the filter
(pipeline.apply_world_correction, a re-hash of the whole map).

The window holds whole passes: it closes at the end of the pass that
crosses --seconds; rounds_per_s is every fused round over the window's
seconds. Set-up captures the round on a prefix of the drive and warms each
back-end program at the cell's shapes (both ICP stages, one relax over the
whole capacity, one world correction), so nothing is captured in the
window (logged).

What the timed path produced is recorded as it goes (references kept,
copied to the host after the window): each round's outputs; at each
keyframe the store's poses and times as loop detection saw them and its
candidates; each ICP refinement's inputs and result; each relaxation's
poses and edge sets in and poses out; each staged correction and the
round after which run_sequence applied it. After the window every pass is
held to the plain reference (reference/backend.py), see `check_passes`.

A traced run drives one more pass and traces two stretches, each from the
start of a loop-closing keyframe's observe to the end of the world
correction that follows it: the first closure with the device's
activities alone, cut into phases by marker kernels launched around the
refinement, the relaxation and the correction (core/phases.py), for the
numbers; the next with the host's operations, for the labels of the idle
gaps. A keyframe whose candidate is rejected is let go and the next
closure taken.

Workload parameters: sequence_s (the drive's length); the workload's
`backend_control` names the control of the back end's numbers, one of
BACKEND_CONTROLS."""
from __future__ import annotations

import hashlib
import json
import math
import time

import numpy as np
import torch

from portbench.core import check, phases, program_trace, trace
from portbench.core.bench import log
from portbench.reference import backend as plain
from portbench.reference.replay import FIELDS

# the back-end numbers of `check`, each the worst over what it compares
BACKEND_NUMBERS = ("loop_pairs_gap", "icp_fit_gap_m", "icp_trans_gap_m", "icp_rot_gap_rad",
                   "icp_quality_gap", "graph_pos_gap_m", "graph_rot_gap_rad", "correction_gap_m")
# the back end's controls: the plain back end computed in a lower precision
BACKEND_CONTROLS = {"f32_backend": torch.float32}


def backend_params(config):
    """The deployment's PoseGraphBackend keyword arguments (dtype as a
    torch dtype)."""
    b = dict(config["backend"])
    b["dtype"] = getattr(torch, b["dtype"])
    return b


class Recorder:
    """Wraps the back end's public functions (posegraph.detect_loops,
    refine_loop_edge, optimize_sparse) and pipeline.apply_world_correction
    while installed, and records into the pass begun with `begin`. A
    stretch tracer (`tracer`) may be told of each event."""

    def __init__(self):
        self.passes, self.cur, self.tracer = [], None, None

    def install(self):
        from malio_tpu_torch import pipeline
        from malio_tpu_torch import posegraph as pg

        self.mods = pg, pipeline
        self.orig = dict(detect=pg.detect_loops, refine=pg.refine_loop_edge,
                         relax=pg.optimize_sparse, correct=pipeline.apply_world_correction)
        o, rec = self.orig, self

        def detect(pos, times, current, *a, **k):
            out = o["detect"](pos, times, current, *a, **k)
            if rec.cur is not None:
                b = rec.cur["backend"]
                rec.cur["keyframes"].append(dict(
                    k=int(current), round=rec.cur["rounds"] - 1, t=np.array(pos, np.float64),
                    q=np.array(b.q[: b.count], np.float64), times=np.array(times, np.float64),
                    cands=[int(j) for j in out], refined=0))
            return out

        def kept(x):
            # on the CPU the program's inputs share memory with its store,
            # which the feedback moves later: keep a copy there
            return x.clone() if x.device.type == "cpu" else x

        def refine(*a, **k):
            rec.event("icp", 0)
            out = o["refine"](*a, **k)
            rec.event("icp", 1)
            if rec.cur is not None:
                kf = rec.cur["keyframes"][-1]
                rec.cur["refines"].append(dict(kf=len(rec.cur["keyframes"]) - 1, k=kf["k"],
                                               j=kf["cands"][kf["refined"]],
                                               args=tuple(kept(x) for x in a), out=out))
                kf["refined"] += 1
            return out

        def relax(q, t, odo, loops, **k):
            rec.event("relax", 0)
            out = o["relax"](q, t, odo, loops, **k)
            rec.event("relax", 1)
            if rec.cur is not None:
                rec.cur["relaxes"].append(dict(n=rec.cur["backend"].count, q=kept(q), t=kept(t),
                                               odo=odo,
                                               loops=loops, iters=k.get("iters", 10), out=out))
            return out

        def correct(cfg, carry, dq, dt):
            rec.event("correction", 0)
            out = o["correct"](cfg, carry, dq, dt)
            rec.event("correction", 1)
            if rec.cur is not None:
                rec.cur["applied"].append(rec.cur["rounds"] - 1)
            if rec.tracer is not None:
                rec.tracer.closed()
            return out

        pg.detect_loops, pg.refine_loop_edge, pg.optimize_sparse = detect, refine, relax
        pipeline.apply_world_correction = correct
        return self

    def uninstall(self):
        pg, pipeline = self.mods
        pg.detect_loops, pg.refine_loop_edge = self.orig["detect"], self.orig["refine"]
        pg.optimize_sparse = self.orig["relax"]
        pipeline.apply_world_correction = self.orig["correct"]

    def event(self, what, end):
        if self.tracer is not None:
            self.tracer.event(what, end)

    def begin(self, backend):
        """A new pass observed by `backend`: its observe and take_correction
        are wrapped on the instance."""
        cur = dict(backend=backend, rounds=0, keyframes=[], refines=[], relaxes=[],
                   corrections=[], applied=[])
        observe, take, rec = backend.observe, backend.take_correction, self

        def observe_(out, t_base=0.0):
            cur["rounds"] += 1
            if rec.tracer is not None:
                rec.tracer.observing(cur["rounds"] - 1)
            return observe(out, t_base=t_base)

        def take_():
            c = take()
            if c is not None:
                cur["corrections"].append((cur["rounds"] - 1, np.array(c[0], np.float64),
                                           np.array(c[1], np.float64)))
            if rec.tracer is not None and c is None:
                rec.tracer.let_go()
            return c

        backend.observe, backend.take_correction = observe_, take_
        self.cur = cur
        self.passes.append(cur)
        return cur

    def end(self):
        self.cur = None


def _host(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if hasattr(x, "_fields"):
        return {f: _host(getattr(x, f)) for f in x._fields}
    if isinstance(x, (tuple, list)):
        return type(x)(_host(a) for a in x)
    return x


def to_host(p):
    """A recorded pass with every tensor copied to the host, its back end's
    pairs, store clouds and graph trajectory taken."""
    b = p["backend"]
    refines = [dict(kf=r["kf"], k=r["k"], j=r["j"], args=_host(r["args"]), out=_host(r["out"]))
               for r in p["refines"]]
    relaxes = [dict(n=r["n"], q=_host(r["q"]), t=_host(r["t"]), odo=_host(r["odo"]),
                    loops=_host(r["loops"]), iters=r["iters"], out=_host(r["out"][:2]))
               for r in p["relaxes"]]
    ts, gpos, _ = b.trajectory()
    return dict(rounds=p["rounds"], keyframes=p["keyframes"], refines=refines, relaxes=relaxes,
                corrections=p["corrections"], applied=list(p["applied"]),
                pairs=sorted((int(e[0]), int(e[1])) for e in b.edges if e[5] == "loop"),
                clouds=np.array(b.clouds[: b.count]), masks=np.array(b.masks[: b.count]),
                graph_t=ts, graph_pos=gpos, feedback=bool(b.feedback))


def reference_backend(p, bk, dtype=None):
    """The plain back end's answers on a pass's recorded inputs: each
    refinement redone on its inputs, each keyframe's decision taken on the
    store as detection saw it, each relaxation redone on its inputs and the
    correction derived from it. `dtype` float64 (the reference) or float32
    (the control)."""
    dtype = dtype or torch.float64
    icp = [plain.refine(*r["args"], bk["cell_size"], bk["icp_min_pts"], bk["icp_iters"],
                        dtype=dtype) for r in p["refines"]]
    done = {(r["kf"], r["j"]): g for r, g in zip(p["refines"], icp)}
    pairs = set()
    for n, kf in enumerate(p["keyframes"]):
        k = kf["k"]
        for j in plain.detect_loops(kf["t"], kf["times"], k, bk["loop_radius"],
                                    bk["min_time_gap"])[: bk["max_loops_per_kf"]]:
            g = done.get((n, j))
            if g is None:  # a candidate the program did not refine
                g = plain.refine(kf["q"][j], kf["t"][j], p["clouds"][j], p["masks"][j], kf["q"][k],
                                 kf["t"][k], p["clouds"][k], p["masks"][k], bk["cell_size"],
                                 bk["icp_min_pts"], bk["icp_iters"], dtype=dtype)
            if g[2] >= bk["min_quality"]:
                pairs.add((j, k))
    relaxed, corrections = [], []
    for r in p["relaxes"]:
        q, t = plain.relax(r["q"], r["t"], r["odo"], r["loops"], r["n"], r["iters"], dtype=dtype)
        relaxed.append((q, t))
        if p["feedback"]:
            k = r["n"] - 1
            corrections.append(plain.left_delta(q[k], t[k], r["q"][k], r["t"][k]))
    return dict(icp=icp, pairs=pairs, relaxed=relaxed, corrections=corrections)


def program_backend(p):
    """The program's answers in reference_backend's form."""
    icp = [(np.asarray(r["out"][0], np.float64), np.asarray(r["out"][1], np.float64),
            float(r["out"][2])) for r in p["refines"]]
    relaxed = [(np.asarray(r["out"][0], np.float64), np.asarray(r["out"][1], np.float64))
               for r in p["relaxes"]]
    return dict(icp=icp, pairs=set(p["pairs"]), relaxed=relaxed,
                corrections=[(dq, dt) for _, dq, dt in p["corrections"]])


def _angle(qa, qb):
    return plain.angle(torch.as_tensor(np.asarray(qa, np.float64)),
                       torch.as_tensor(np.asarray(qb, np.float64))).numpy()


def _rot(q):
    return plain.qmat(plain.qnorm(torch.as_tensor(np.asarray(q, np.float64)))).numpy()


def compare_backend(p, got, want, bk):
    """The back-end numbers of one pass: `got` (the program's answers, or a
    control's) against `want` (the reference's), each the worst over what
    it compares, 0.0 over nothing. The ICP numbers compare the candidates
    whose edge enters a graph (accepted by either side): on a candidate
    both reject, the overlap is too poor to fix the pose, the ICP's cell
    associations flip with the last bit and the two may end centimetres
    to metres apart, and the result is thrown away; the gate on it is
    held by loop_pairs_gap. Of an entered edge, icp_fit_gap_m is what the
    difference does to its fit (reference/backend.fit_gap); the raw
    translation, angle and quality gaps, which a slide along the planes
    that no plane sees can fill with round-off, are reported beside it."""
    g = dict.fromkeys(BACKEND_NUMBERS, 0.0)
    g["loop_pairs_gap"] = float(len(got["pairs"] ^ want["pairs"]))
    entered = got["pairs"] | want["pairs"]
    for r, (q1, t1, g1), (q2, t2, g2) in zip(p["refines"], got["icp"], want["icp"]):
        if (r["j"], r["k"]) not in entered:
            continue
        a = r["args"]
        g["icp_fit_gap_m"] = max(g["icp_fit_gap_m"], plain.fit_gap(
            a[2], a[3], a[6], a[7], (q1, t1), (q2, t2), bk["cell_size"], bk["icp_min_pts"]))
        g["icp_trans_gap_m"] = max(g["icp_trans_gap_m"], float(np.linalg.norm(t1 - t2)))
        g["icp_rot_gap_rad"] = max(g["icp_rot_gap_rad"], float(_angle(q1, q2)))
        g["icp_quality_gap"] = max(g["icp_quality_gap"], abs(g1 - g2))
    for r, (q1, t1), (q2, t2) in zip(p["relaxes"], got["relaxed"], want["relaxed"]):
        n = r["n"]
        g["graph_pos_gap_m"] = max(g["graph_pos_gap_m"],
                                   float(np.max(np.linalg.norm(t1[:n] - t2[:n], axis=-1))))
        g["graph_rot_gap_rad"] = max(g["graph_rot_gap_rad"], float(np.max(_angle(q1[:n], q2[:n]))))
    if len(got["corrections"]) != len(want["corrections"]):
        g["correction_gap_m"] = math.inf
    else:
        for r, (dq1, dt1), (dq2, dt2) in zip(p["relaxes"], got["corrections"],
                                             want["corrections"]):
            tk = np.asarray(r["t"][r["n"] - 1], np.float64)
            lever = float(np.linalg.norm((_rot(dq1) - _rot(dq2)) @ tk))
            g["correction_gap_m"] = max(g["correction_gap_m"],
                                        float(np.linalg.norm(dt1 - dt2)), lever)
    return {k: (v if math.isfinite(v) else math.inf) for k, v in g.items()}


def corrections_of(p):
    """{round: (dq, dt)} of a pass's staged corrections."""
    return {r: (dq, dt) for r, dq, dt in p["corrections"]}


def same_corrections(a, b):
    return a.keys() == b.keys() and all(
        np.array_equal(a[r][0], b[r][0]) and np.array_equal(a[r][1], b[r][1]) for r in a)


def replays(ref_cfg, groups, passes, device, control=None):
    """The reference round corrected as each pass was, one replay a
    distinct set of corrections: [replay of pass i]."""
    done, out = [], []
    for p in passes:
        c = corrections_of(p)
        hit = next((r for cc, r in done if same_corrections(c, cc)), None)
        if hit is None:
            hit = plain.replay_corrected(ref_cfg, groups, c, device=device, control=control)
            done.append((c, hit))
        out.append(hit)
    return out, len(done)


def inputs_key(p):
    """A digest of everything the plain back end reads of a pass: passes
    with equal digests get the same reference answers."""
    h = hashlib.sha1()

    def add(x):
        if isinstance(x, dict):
            for k in sorted(x):
                add(x[k])
        elif isinstance(x, (list, tuple)):
            for a in x:
                add(a)
        elif x is not None:
            h.update(np.ascontiguousarray(np.asarray(x)).tobytes())

    add([p["keyframes"], [r["args"] for r in p["refines"]], p["clouds"], p["masks"],
         [(r["n"], r["q"], r["t"], r["odo"], r["loops"]) for r in p["relaxes"]]])
    return h.hexdigest()


def check_passes(passes, outs, refs, bk, traj):
    """Every number of the check over whole passes (the worst; 0.0 over
    nothing): the filter's rounds against the reference round corrected at
    the same rounds (core/check.py's numbers and ate_m), the back end's
    answers against the plain back end's (computed once for passes with
    the same inputs), and the witness graph_ate_m (the final graph
    trajectory against the drive, unaligned)."""
    gaps, answers = [], {}
    for p, o, ref in zip(passes, outs, refs):
        R = o["pos"].shape[1]
        g = check.gaps(o, {f: v[:, :R] for f, v in ref.items()})
        g["ate_m"] = check.ate(o["pos"][0], o["end_time"][0], traj)
        key = inputs_key(p)
        if key not in answers:
            answers[key] = reference_backend(p, bk)
        g.update(compare_backend(p, program_backend(p), answers[key], bk))
        g["graph_ate_m"] = check.ate(p["graph_pos"], p["graph_t"], traj)
        gaps.append(g)
    return check.worst(*gaps)


def _fields(res):
    return {f: np.asarray(res[f] if f != "end_time" else res["t"])[None] for f in FIELDS}


def _pass(runner, posegraph, cfg, groups, cell, rec, bk):
    rec.begin(posegraph.PoseGraphBackend(**bk, device=cell.device))
    res = runner.run_sequence(cfg, groups, dtype=torch.float32, device=cell.device,
                              posegraph=rec.cur["backend"])
    cell.sync()
    rec.end()
    return _fields(res)


def _warm(cell, cfg, bk, backend, carry):
    """Each back-end program at the cell's shapes: both ICP stages on the
    set-up pass's first two keyframes, one relax over the whole capacity,
    one world correction of a throwaway carry."""
    from malio_tpu_torch import pipeline
    from malio_tpu_torch import posegraph as pg

    kw = dict(dtype=bk["dtype"], device=cell.device)
    args = []
    for n in (0, 1):
        args += [torch.as_tensor(backend.q[n], **kw), torch.as_tensor(backend.t[n], **kw),
                 torch.as_tensor(backend.clouds[n], **kw),
                 torch.as_tensor(backend.masks[n], device=cell.device)]
    pg.refine_loop_edge(*args, cell_size=bk["cell_size"], min_pts=bk["icp_min_pts"],
                        iters=bk["icp_iters"])
    backend.relax()
    dq = torch.tensor([1.0, 1e-4, 0.0, 0.0], dtype=torch.float32, device=cell.device)
    pipeline.apply_world_correction(cfg, carry, dq, torch.zeros(3, dtype=torch.float32,
                                                                  device=cell.device))
    cell.sync()


def run(cell):
    from malio_tpu_torch import graph, posegraph, runner

    from portbench.modes.replay import counters, init_groups

    p = cell.params
    cfg = cell.program_config()
    bk = backend_params(cell.config)
    imu, rounds, traj = cell.sequence(cell.seed, p["sequence_s"])
    groups = cell.groups(imu, rounds)
    n_init = init_groups(groups)
    # set-up: the round captured through pipeline.step, two keyframes
    setup = posegraph.PoseGraphBackend(**bk, device=cell.device)
    res = runner.run_sequence(cfg, groups[: n_init + 2 * bk["keyframe_every"] + 1],
                              dtype=torch.float32, device=cell.device, posegraph=setup)
    if cell.device == "cuda" and setup.count >= 2:
        _warm(cell, cfg, bk, setup, res["carry"])
    del res, setup
    n_caps = len(graph.captures())

    rec = Recorder().install()
    try:
        setup_s = cell.start_window()
        deadline = cell.window_t0 + cell.seconds
        outs, done = [], 0
        while True:
            o = _pass(runner, posegraph, cfg, groups, cell, rec, bk)
            outs.append(o)
            done += o["pos"].shape[1]
            if time.perf_counter() >= deadline:
                break
        window_s = cell.end_window()
        n_window = len(outs)
        in_window = len(graph.captures()) - n_caps
        passes = [to_host(q) for q in rec.passes]
        rec.passes = []
        closing = [r for r, _, _ in passes[0]["corrections"]] if passes else []
        summary = None
        if cell.trace:
            summary, o = _traced_pass(runner, posegraph, cfg, groups, cell, rec, bk, closing)
            outs.append(o)
            passes.append(to_host(rec.passes[-1]))
    finally:
        rec.uninstall()
    peak = cell.memory_peak()
    closures = [len(q["pairs"]) for q in passes[:n_window]]
    result = dict(setup_s=setup_s, window_s=window_s, memory_peak_bytes=peak,
                  e2e=dict(rounds_per_s=done / window_s), attempted=done,
                  failed=sum(int(np.sum(~np.all(np.isfinite(o["pos"]), axis=-1))) for o in outs),
                  batch=1, spans={}, passes=n_window, trace=summary)
    log(f"loop: {n_window} whole passes, {done} fused rounds in {window_s:.3f} s "
        f"({result['e2e']['rounds_per_s']:.4f} rounds/s); set-up {setup_s:.3f} s; captures "
        f"inside the window {in_window}")
    for i, q in enumerate(passes):
        log(f"loop: pass {i}: {q['rounds']} rounds, {len(q['keyframes'])} keyframes, "
            f"{len(q['refines'])} candidates refined, loops closed {q['pairs']}, "
            f"{len(q['relaxes'])} relaxes, corrections after rounds "
            f"{[r for r, _, _ in q['corrections']]} (applied after {q['applied']})")
    stages = relax_stages(result, cell)
    if stages is not None:
        log("relax stages: " + json.dumps(stages))
    spans = program_trace.span_table(result, cell, "posegraph.")
    if spans:
        spans.update(program_trace.span_table(result, cell, "runner.correction") or {})
        log("back-end spans: " + json.dumps(spans))
    result["counters"] = counters(graph)
    cell.release(graph)

    t_ref = time.perf_counter()
    refs, distinct = replays(cell.reference_config(), groups, passes, cell.device)
    result["gaps"] = check_passes(passes, outs, refs, bk, traj)
    log(f"reference: {len(passes)} passes against {distinct} corrected replays and the plain "
        f"back end in {time.perf_counter() - t_ref:.3f} s")
    result.update(records=passes, outs=outs, references=refs, reference_inputs=[groups],
                  trajectories=[traj], closures=closures)
    return result


class _Stretches:
    """The traced pass's stretches: one opens at the observe of a round
    after which the window's first pass applied a correction, and closes
    at the end of the world correction that follows; a keyframe that
    stages none is let go. The first kept stretch records the device's
    activities alone, with a marker at each entry into and exit from the
    refinement, the relaxation and the correction; the second the host's
    operations too, without markers (`labelling`)."""

    def __init__(self, closing):
        self.closing, self.seg, self.done, self.labels = set(closing), None, [], []

    @property
    def labelling(self):
        return len(self.done) == 1

    def observing(self, r):
        if self.seg is None and r in self.closing and len(self.done) < 2:
            self.seg = trace.Segment(host=self.labelling)
            self.labels = []
            self.seg.start()

    def event(self, what, end):
        if self.seg is not None and not self.labelling:
            phases.mark()
            self.labels.append(f"{what}{end}")

    def let_go(self):
        if self.seg is not None:
            self.seg.end()
            self.seg = None

    def closed(self):
        if self.seg is None:
            return
        self.seg.end()
        events = self.seg.prof.profiler.kineto_results.events()
        s = trace.summarize(events, 1)
        if s is not None and not self.labelling:
            s["phases"] = phases.phases(events, self.labels)
            s = s if s["phases"] is not None else None
        if s is not None:
            self.done.append(s)
        self.seg = None


def _traced_pass(runner, posegraph, cfg, groups, cell, rec, bk, closing):
    """A whole pass with two loop closures traced (see the module's
    docstring); returns (summary or None, the pass's outputs)."""
    st = _Stretches(closing)
    rec.tracer = st
    try:
        o = _pass(runner, posegraph, cfg, groups, cell, rec, bk)
    finally:
        rec.tracer = None
        if st.seg is not None:
            st.let_go()
    if not st.done:
        log("loop: no loop closure traced")
        return None, o
    numbers = st.done[0]
    summary = (trace.labelled(numbers, st.done[1]) if len(st.done) > 1
               else dict(numbers, gaps=[], n_gaps=0))
    summary["relax_iters"] = bk["relax_iters"]
    log("loop: traced phases: " + json.dumps(
        {k: v["busy_s"] * 1e3 for k, v in numbers["phases"].items()}) + " ms")
    return summary, o


def relax_stages(run, cell):
    """The median device ms of each stage of the sparse LM iteration over
    the window (the program's stamps inside optimize_sparse's captured
    iteration) and the graph nodes the capture counted a stage, or None."""
    snap = program_trace.snapshot(run)
    if snap is None:
        return None
    pid = {v: k for k, v in snap["programs"].items()}.get("optimize_sparse")
    try:
        from malio_tpu_torch.trace import SPARSE_STAGES
    except ImportError:
        return None
    if pid is None:
        return None
    lo, hi = program_trace.window_ns(run, cell)
    n = len(SPARSE_STAGES) + 1
    rows = [s["t"][s["program"] == pid][:, :n] for s in snap["stamps"].values()]
    t = np.concatenate(rows) if rows else np.zeros((0, n), np.int64)
    t = t[(t > 0).all(axis=1) & (t[:, 0] >= lo) & (t[:, -1] <= hi)]
    if not len(t):
        return None
    med = np.median(np.diff(t, axis=1), axis=0) / 1e6
    return dict(iterations=int(len(t)), stages=[
        dict(stage=s, ms=float(m), nodes=snap["counters"].get(f"graph_nodes.optimize_sparse.{s}"))
        for s, m in zip(SPARSE_STAGES, med)])
