"""The port's tracer (malio_tpu_torch/trace.py) on the CPU, at the golden
replay configuration's size (1 LiDAR, 256 points, 1.4 s):

  * the eager round writes its 7 stamps in stage order, and the six
    stages tile it; outputs are bit-equal with and without the stamps;
  * an eager back-end program (graph.run) fills a slot an iteration;
  * spans nest, carry their parent and round id, and a span's self time
    is its length less its children's;
  * spans recorded under a CPU profiler session are among the session's
    events, their starts within 50 us of the ring's (the median) once the
    two clocks (the profiler's wall clock, perf_counter_ns) are aligned;
  * the span ring and the stamp ring wrap keeping the newest entries;
  * `host_copies` counts run_sequence's and poll()'s copies exactly; a
    live round's spans and its slot share one round id.

Card cases (marked cuda, skipped without a card): a captured graph of
torch.cuda._sleep(N) then _sleep(2N) between stamps reads the second stage
at 2x the first over 50 replays, each replay in its own slot, and the
capture counts a node a stage; snapshot() after graph.release() still
holds the replays; the compiled round's capture counts each stage's
nodes and its replays fill a slot each.

    python -m pytest tests/test_torch_trace.py -q
"""
import time

import numpy as np
import pytest
import torch

from malio_tpu_torch import graph, online, pipeline, runner, trace, tree
from malio_tpu_torch import propagate as prop
from malio_tpu_torch.config import Config
from malio_tpu_torch.io.assemble import assemble_groups
from malio_tpu_torch.io.synthetic import SyntheticSequence

torch.set_num_threads(1)

GOLDEN = dict(
    num_lidars=1, lid_type=(3,), n_scans=(64,), point_filter_num=(1,),
    extrinsic_T=(0.2, 0.0, 0.0), extrinsic_R=(1.0, 0, 0, 0),
    max_raw_points=256, max_points_per_scan=256, max_imu_per_group=32,
    traj_capacity=64, spline_capacity=64, epoch_capacity=32,
    map_capacity=1 << 16, filter_size_surf=0.4, filter_size_map=0.4,
    cube_len=300.0, det_range=60.0, plane_th=0.1, cov_threshold=30.0,
)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def seq():
    cfg = Config(**GOLDEN)
    s = SyntheticSequence(duration=1.4, num_lidars=1, points_per_scan=256,
                          ext_t=np.array([[0.2, 0.0, 0.0]]), seed=42)
    imu, rounds, _ = s.generate()
    return cfg, imu, rounds, assemble_groups(cfg, imu, rounds)


def _slots(program):
    """The CPU ring's slots of `program`: (seq, t (n, COLS))."""
    s = trace.snapshot()["stamps"]["cpu"]
    keep = s["program"] == trace.program_id(program)
    return s["seq"][keep], s["t"][keep]


def _two_rounds(cfg, groups):
    """The carry after the first fused round and the next group, on the CPU."""
    res = runner.run_sequence(cfg, groups[:5], dtype=torch.float32, device="cpu")
    assert len(res["t"]) >= 1
    arrays, _ = runner._chunk_arrays(groups[5:6], np.float32, runner.group_base(groups[4]))
    group = prop.MeasureGroup(*(torch.as_tensor(a[0]) for a in arrays.values()))
    return res["carry"], group


def test_eager_round_writes_seven_stamps_that_tile_it(seq):
    cfg, _, _, groups = seq
    carry, group = _two_rounds(cfg, groups)
    n0 = trace.next_round(CPU)
    t0 = time.perf_counter_ns()
    pipeline.step_eager(cfg, carry, group, device="cpu")
    t1 = time.perf_counter_ns()
    s, t = _slots("round")
    assert trace.next_round(CPU) == n0 + 1 and s[-1] == n0
    row = t[-1]
    assert (row[7:] == -1).all()  # 7 stamps of COLS
    stamps = row[:7]
    assert t0 <= stamps[0] and stamps[-1] <= t1
    stages = np.diff(stamps)
    assert len(stages) == len(trace.ROUND_STAGES) == 6
    assert (stages >= 0).all() and stages.sum() == stamps[-1] - stamps[0]
    assert stages[trace.ROUND_STAGES.index("update")] > 0


def test_outputs_are_bit_equal_with_the_stamps(seq, monkeypatch):
    cfg, _, _, groups = seq
    carry, group = _two_rounds(cfg, groups)
    stamped = pipeline.step_eager(cfg, carry, group, device="cpu")
    monkeypatch.setattr(trace, "stamp", lambda *a: None)
    plain = pipeline.step_eager(cfg, carry, group, device="cpu")
    for a, b in zip(tree.leaves(stamped), tree.leaves(plain)):
        assert torch.equal(a, b)


def test_eager_program_fills_a_slot_an_iteration():
    def fn(c, g):
        return c + g, c.sum()

    n0 = trace.next_round(CPU)
    carry, outs = graph.run(("toy_program",), fn, torch.zeros(3), torch.ones(3), 4, eager=True)
    assert torch.equal(carry, torch.full((3,), 4.0)) and outs.shape == (4,)
    s, t = _slots("toy_program")
    assert list(s[-4:]) == list(range(n0, n0 + 4))
    assert (t[-4:, 1] >= t[-4:, 0]).all() and (t[-4:, 2:] == -1).all()


def _spans(names):
    sp = trace.snapshot()["spans"]
    keep = np.isin(sp["name"], names)
    return {k: v[keep] for k, v in sp.items()}


def test_spans_nest_with_parent_and_round():
    with trace.span("t.outer", round=41):
        with trace.span("t.inner"):
            with trace.span("t.leaf", round=43):
                pass
        with trace.span("t.inner2"):
            pass
    sp = _spans(["t.outer", "t.inner", "t.leaf", "t.inner2"])
    by = {n: j for j, n in enumerate(sp["name"])}
    outer, inner, leaf, inner2 = (sp["id"][by[n]] for n in ("t.outer", "t.inner", "t.leaf",
                                                             "t.inner2"))
    assert sp["parent"][by["t.outer"]] == -1
    assert sp["parent"][by["t.inner"]] == outer and sp["parent"][by["t.inner2"]] == outer
    assert sp["parent"][by["t.leaf"]] == inner
    assert [sp["round"][by[n]] for n in ("t.outer", "t.inner", "t.leaf", "t.inner2")] == \
        [41, 41, 43, 41]
    for child, parent in (("t.inner", "t.outer"), ("t.leaf", "t.inner"), ("t.inner2", "t.outer")):
        assert sp["start"][by[parent]] <= sp["start"][by[child]]
        assert sp["end"][by[child]] <= sp["end"][by[parent]]


def test_self_time_is_the_span_less_its_children():
    with trace.span("s.outer"):
        time.sleep(0.002)
        with trace.span("s.a"):
            time.sleep(0.003)
        with trace.span("s.b"):
            with trace.span("s.c"):
                time.sleep(0.001)
    sp = _spans(["s.outer", "s.a", "s.b", "s.c"])
    own = trace.self_ns(sp)
    dur = sp["end"] - sp["start"]
    by = {n: j for j, n in enumerate(sp["name"])}
    o, a, b, c = (by[n] for n in ("s.outer", "s.a", "s.b", "s.c"))
    assert own[o] == dur[o] - dur[a] - dur[b]
    assert own[b] == dur[b] - dur[c] and own[c] == dur[c] and own[a] == dur[a]
    assert own[o] >= 2_000_000 and dur[o] >= 6_000_000


def test_a_span_lands_in_an_open_profiler_session_on_the_shared_clock():
    from torch.profiler import ProfilerActivity, profile

    names = [f"p.span{i}" for i in range(8)]
    with trace.span("p.before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("p.warm"):  # the session's first record_function sets itself up
            pass
        for name in names:
            with trace.span(name):
                time.sleep(0.001)
            time.sleep(0.001)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("p.")}
    assert set(events) == {"p.warm", *names}
    sp = _spans(names)
    assert list(sp["name"]) == names
    # the profiler stamps its events on the wall clock, the ring on
    # perf_counter_ns: the median offset aligns the two
    gap = np.asarray([events[n].start_ns() for n in names]) - sp["start"]
    gap -= int(np.median(gap))
    assert np.median(np.abs(gap)) < 50_000 and np.abs(gap).max() < 500_000, gap
    dur = np.asarray([events[n].duration_ns() for n in names])
    assert (dur >= (sp["end"] - sp["start"]) - 50_000).all()


def test_the_span_ring_wraps_keeping_the_newest():
    n = trace.SPANS + 100
    first = trace._spans[0]
    for i in range(n):
        with trace.span("w.span", round=i):
            pass
    sp = trace.snapshot()["spans"]
    assert len(sp["id"]) == trace.SPANS
    assert sp["id"][-1] == first + n - 1 and sp["id"][0] == first + n - trace.SPANS
    assert (np.diff(sp["id"]) == 1).all()
    assert sp["round"][-1] == n - 1 and sp["round"][0] == n - trace.SPANS
    assert (sp["start"][1:] >= sp["start"][:-1]).all()


def test_the_stamp_ring_wraps_keeping_the_newest():
    n0 = trace.next_round(CPU)
    n = trace.SLOTS + 10
    for _ in range(n):
        trace.stamp("wrap_program", 0, CPU)
        trace.stamp("wrap_program", 1, CPU)
    s = trace.snapshot()["stamps"]["cpu"]
    assert len(s["seq"]) == trace.SLOTS and s["seq"][-1] == n0 + n - 1
    assert (np.diff(s["seq"]) == 1).all() and s["seq"][0] == n0 + n - trace.SLOTS
    last = s["program"] == trace.program_id("wrap_program")
    assert last.sum() == trace.SLOTS
    assert (s["t"][:, 1] >= s["t"][:, 0]).all() and (np.diff(s["t"][:, 0]) >= 0).all()


def test_host_copies_counts_run_sequence_exactly(seq):
    cfg, _, _, groups = seq
    n0 = trace.counter("host_copies")
    res = runner.run_sequence(cfg, groups, dtype=torch.float32, device="cpu", prefetch_chunk=4)
    fused = len(res["t"])
    chunks, rest = divmod(fused, 4)
    assert chunks and rest
    # 9 fields up a chunk; 10 down a whole chunk, 10 a round of the last
    want = 9 * (chunks + 1) + len(runner._SMALL) * (chunks + rest)
    assert trace.counter("host_copies") - n0 == want
    # marshal, h2d, scan and two fetches a whole chunk; marshal, h2d, a
    # step a round and a fetch the last
    names = list(trace.snapshot()["spans"]["name"][-(5 * chunks + 3 + rest):])
    assert names[:5] == ["runner.marshal", "runner.h2d", "runner.scan", "runner.fetch",
                         "runner.fetch"]
    assert names.count("runner.scan") == chunks and names.count("runner.step") == rest


def test_poll_counts_its_copies_and_a_live_round_lines_up(seq):
    cfg, imu, rounds, _ = seq
    est = online.OnlineEstimator(cfg, dtype=torch.float32, device="cpu")
    events = [(row[0], 0, "imu", row) for row in imu]
    for rnd in rounds:
        for l, s in enumerate(rnd):
            rel = s["pts"].copy()
            rel[:, 3] -= s["beg_t"]
            events.append((s["end_t"], 1, "scan", (l, s["beg_t"], rel, s["end_t"] - s["beg_t"])))
    events.sort(key=lambda e: (e[0], e[1]))
    polled = 0
    for _, _, kind, x in events:
        if kind == "imu":
            est.push_imu(x[0], x[1:4], x[4:7])
        else:
            est.push_scan(x[0], x[1], x[2], duration=x[3])
        if est.n_rounds > polled and est.n_rounds >= 2:
            n0 = trace.counter("host_copies")
            k = len(est._pending)
            rid = est._pending[0][2]
            out = est.poll()
            assert len(out) == k
            assert trace.counter("host_copies") - n0 == len(online._POLLED) * k
            polled = est.n_rounds
            break
    assert polled >= 2
    snap = trace.snapshot()
    sp = snap["spans"]
    assert {"online.fuse", "online.assemble", "online.h2d", "online.launch",
            "online.poll", "online.fetch"} <= set(sp["name"][sp["round"] == rid])
    cpu = snap["stamps"]["cpu"]
    slot = cpu["seq"] == rid
    assert slot.sum() == 1 and cpu["program"][slot][0] == trace.program_id("round")
    launch = (sp["name"] == "online.launch") & (sp["round"] == rid)
    t_slot = cpu["t"][slot][0]
    assert sp["start"][launch][0] <= t_slot[0] and t_slot[6] <= sp["end"][launch][0]
    fuse = (sp["name"] == "online.fuse") & (sp["round"] == rid)
    assert sp["parent"][launch][0] == sp["id"][fuse][0]
    assert sp["name"][np.isin(sp["id"], sp["parent"][fuse])][0] == "online.push"


def _sparse_graph(K=8):
    """A drifted chain of K poses with one loop edge (posegraph's EdgeSets)."""
    from malio_tpu_torch import posegraph as pg

    rng = np.random.default_rng(5)
    t = torch.as_tensor(np.cumsum(rng.normal(size=(K, 3)), axis=0))
    q = torch.as_tensor(np.tile([1.0, 0, 0, 0], (K, 1)))
    b = pg.PoseGraphBackend(capacity=K, cloud_points=1, device="cpu")
    ident = (np.array([1.0, 0, 0, 0]),)
    odo = [(i, i + 1, *ident, np.array([1.0, 0, 0]), 1.0, "odo") for i in range(K - 1)]
    loops = [(0, K - 1, *ident, np.array([float(K - 1), 0, 0]), 3.0, "loop")]
    return q, t, b._pack_edges(odo, K - 1), b._pack_edges(loops, 2)


def test_sparse_stage_stamps_tile_one_eager_iteration():
    from malio_tpu_torch import posegraph as pg

    q, t, odo, loops = _sparse_graph()
    n0 = trace.next_round(CPU)
    t0 = time.perf_counter_ns()
    pg.optimize_sparse_eager(q, t, odo, loops, iters=1)
    t1 = time.perf_counter_ns()
    s, ts = _slots("optimize_sparse")
    assert trace.next_round(CPU) == n0 + 1 and s[-1] == n0
    assert trace.stages("optimize_sparse") == trace.SPARSE_STAGES
    n = len(trace.SPARSE_STAGES) + 1
    row = ts[-1]
    assert (row[n:] == -1).all()  # 6 stamps of COLS
    stages = np.diff(row[:n])
    assert t0 <= row[0] and row[n - 1] <= t1
    assert (stages >= 0).all() and stages.sum() == row[n - 1] - row[0]
    assert stages[trace.SPARSE_STAGES.index("edge_blocks")] > 0


class _KeyframeOut:
    """The fields of a round's output the back end reads."""

    def __init__(self, pos, end_time, P=4):
        self.pos = torch.as_tensor(pos, dtype=torch.float64)
        self.quat = torch.tensor([1.0, 0, 0, 0], dtype=torch.float64)
        self.end_time = torch.tensor(end_time, dtype=torch.float64)
        self.kf_pts = torch.zeros((P, 3))
        self.kf_mask = torch.ones(P, dtype=torch.bool)


def test_posegraph_spans_and_counters(monkeypatch):
    """Eight keyframes on a 1 m circle, a loop candidate from the fourth on;
    the ICP stubbed to accept every candidate exactly (the spans, not the
    ICP, are under test)."""
    from malio_tpu_torch import posegraph as pg

    def refine(q_i, t_i, c_i, m_i, q_j, t_j, c_j, m_j, **kw):
        zq, zt = pg.relative_pose(q_i, t_i, q_j, t_j)
        return zq, zt, torch.tensor(1.0, dtype=torch.float64)

    monkeypatch.setattr(pg, "refine_loop_edge", refine)
    names = ("keyframes", "candidates", "loops_closed", "relaxes", "corrections")
    c0 = {n: trace.counter(f"posegraph.{n}") for n in names}
    b = pg.PoseGraphBackend(capacity=16, loop_capacity=4, keyframe_every=2, cloud_points=4,
                            loop_radius=1.5, min_time_gap=1.0, feedback=True, device="cpu")
    first = trace._spans[0]
    for r in range(16):
        th = 2 * np.pi * r / 8
        b.observe(_KeyframeOut([np.cos(th), np.sin(th), 0.0], 0.5 * r))
        b.take_correction()
    counted = {n: trace.counter(f"posegraph.{n}") - c0[n] for n in names}
    assert counted["keyframes"] == 8
    assert counted["candidates"] >= 1 and counted["loops_closed"] == counted["candidates"]
    assert counted["relaxes"] == counted["corrections"] == b.n_feedback >= 1
    sp = trace.snapshot()["spans"]
    keep = sp["id"] >= first
    sp = {k: v[keep] for k, v in sp.items()}
    observe = sp["id"][sp["name"] == "posegraph.observe"]
    assert len(observe) == 8  # one a keyframe round, none between
    for child, n in (("read", 8), ("detect", 8), ("icp", counted["candidates"]),
                     ("relax", counted["relaxes"]), ("feedback", counted["corrections"])):
        k = sp["name"] == f"posegraph.{child}"
        assert k.sum() == n, child
        assert np.isin(sp["parent"][k], observe).all(), child


def test_run_sequence_spans_the_correction(seq):
    cfg, _, _, groups = seq

    class Stub:
        rounds = 0

        def observe(self, out, t_base=0.0):
            self.rounds += 1

        def take_correction(self):
            if self.rounds == 3:
                return np.array([1.0, 0, 0, 0]), np.array([0.1, 0.0, 0.0])
            return None

        def trajectory(self):
            return np.zeros(0), np.zeros((0, 3)), np.zeros((0, 4))

    first = trace._spans[0]
    runner.run_sequence(cfg, groups, dtype=torch.float32, device="cpu", posegraph=Stub())
    sp = trace.snapshot()["spans"]
    names = list(sp["name"][sp["id"] >= first])
    assert names.count("runner.correction") == 1
    assert "runner.scan" not in names  # an observer: round by round
    k = names.index("runner.correction")
    assert names[k - 1] == "runner.step"


# ---- on a card --------------------------------------------------------------

cuda = pytest.mark.cuda
needs_card = pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
SLEEP = 2_000_000  # cycles: ~1 ms at 1.98 GHz


def _sleeps(c, g):
    dev = c.device
    trace.stamp("sleeps", 0, dev)
    torch.cuda._sleep(SLEEP)
    trace.stamp("sleeps", 1, dev)
    torch.cuda._sleep(2 * SLEEP)
    trace.stamp("sleeps", 2, dev)
    return c + g, c.sum()


@cuda
@needs_card
def test_card_stamps_time_a_captured_graph_replay_by_replay():
    dev = torch.device("cuda", torch.cuda.current_device())
    r = graph.compiled(("sleeps",), _sleeps, torch.zeros(4, device=dev),
                       torch.ones(4, device=dev), stamped=True)
    assert r.trace_begins == 1
    assert sorted(r.trace_nodes["sleeps"].values()) == [1, 1]
    n0 = trace.next_round(dev)
    r.repeat(torch.zeros(4, device=dev), torch.ones(4, device=dev), 50)
    s = trace.snapshot()["stamps"][str(dev)]
    assert s["opened"] == s["host_count"] == trace.next_round(dev) == n0 + 50
    mine = s["program"] == trace.program_id("sleeps")
    seq, t = s["seq"][mine][-50:], s["t"][mine][-50:]
    assert list(seq) == list(range(n0, n0 + 50))  # a slot a replay
    first, second = t[:, 1] - t[:, 0], t[:, 2] - t[:, 1]
    assert (first > 0).all() and (t[:, 3:] == -1).all()
    ratio = second / first
    assert np.all(np.abs(ratio - 2.0) < 0.1), ratio
    assert abs(np.median(ratio) - 2.0) < 0.1


@cuda
@needs_card
def test_card_snapshot_after_release_keeps_the_replays():
    dev = torch.device("cuda", torch.cuda.current_device())
    r = graph.compiled(("sleeps_release",), _sleeps, torch.zeros(2, device=dev),
                       torch.ones(2, device=dev), stamped=True)
    n0 = trace.next_round(dev)
    r.repeat(torch.zeros(2, device=dev), torch.ones(2, device=dev), 8)
    del r
    graph.release()
    torch.cuda.empty_cache()
    torch.zeros(1 << 20, device=dev).fill_(7)  # reuse freed memory
    s = trace.snapshot()["stamps"][str(dev)]
    keep = s["seq"] >= n0
    assert keep.sum() == 8 and (s["t"][keep][:, :3] > 0).all()
    assert (np.diff(s["t"][keep][:, 0]) > 0).all()


@cuda
@needs_card
def test_card_compiled_round_counts_its_stage_nodes(seq):
    cfg, _, _, groups = seq
    dev = torch.device("cuda", torch.cuda.current_device())
    res = runner.run_sequence(cfg, groups, dtype=torch.float32, device=dev, prefetch_chunk=3)
    cap = [r for r in pipeline.compiled_rounds() if r.device == dev][-1]
    stages = cap.trace_nodes["round"]
    assert tuple(stages) == trace.ROUND_STAGES and all(n > 0 for n in stages.values())
    assert sum(stages.values()) + 7 <= cap.nodes
    s = trace.snapshot()["stamps"][str(dev)]
    rounds = (s["program"] == 0) & (s["t"][:, 6] > 0)
    assert rounds.sum() >= len(res["t"])
    assert (np.diff(s["t"][rounds][:, :7], axis=1) >= 0).all()
