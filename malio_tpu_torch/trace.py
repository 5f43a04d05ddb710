"""The port's tracer: stage stamps, host spans and counters, always on,
kept in bounded memory and read only by `snapshot()`.

Stamps. `stamp(program, col, device)` marks a point of a traced program:
column 0 opens a new slot of a ring, a later column writes into that slot.
On a card a stamp is the one-thread kernel of `csrc/trace_stamp.cu`,
launched on the current stream: it reads the card's global timer once the
work queued before it is done, and launched while the stream is captured
it is a node of the CUDA graph, which writes a new slot at every replay
(the slot comes from a counter on the card; nothing is read on the host).
On the CPU a stamp records the host clock into a ring of its own. The
fusion round (`pipeline._round`) holds 7 stamps that bound its six stages
(`ROUND_STAGES`) and posegraph's sparse LM iteration 6 that bound its five
(`SPARSE_STAGES`); `graph.CompiledRound` and `graph.run` put a begin and an
end stamp around every other program (posegraph's dense LM iteration and
ICP, `ba.optimize_window`). A ring holds the last `SLOTS` slots. While a graph
is captured each stamp also notes the capturing graph's node count, so a
stage's nodes are known at no cost at replay (`captures`, and the counters
`graph_nodes.<program>.<stage>`).

Spans. `with span(name):` records the name, start and end on the host
clock (`time.perf_counter_ns`, the clock `time.perf_counter` reads),
the enclosing span and a round id into a ring of `SPANS` entries. While a
torch.profiler session is open it also opens a `record_function` of the
same name, so the span sits on the profiler's timeline beside the
device's activities.

Counters. `count(name, n)` adds to a running total and notes the time, so
a reader can take the change over a window (`host_copies`: the copies
between the host's arrays and the round's tensors on the replay and live
paths, counted where they are made, also on the CPU, where they move
nothing).

Round ids. A ring's slots are numbered in the order their column-0 stamps
run on its device; the host keeps the same count (an eager stamp adds one,
a replay of a graph adds the column-0 stamps captured in it), so
`next_round(device)` is the number the next traced program launched there
will write. A span given that number as `round` lines up with its slot;
a span without one takes its parent's.

`snapshot()` copies the rings to the host, converts the card's stamps to
the host clock by a calibration made then (a stamp on an idle stream
between two readings of the host clock) and returns them with the spans
and the counters. Nothing else reads a ring.
"""
from __future__ import annotations

import ctypes
import threading
import time

import numpy as np
import torch

SLOTS = 8192  # replays a ring keeps
COLS = 8  # stamps a slot
PROGRAMS = 32  # programs a card's ring can tell apart
SPANS = 1 << 16
COUNTS = 1 << 16
ROUND_STAGES = ("undistort", "downsample", "compact_evict", "uncertainty", "update", "insert")
# posegraph.optimize_sparse's LM iteration, stamped inside its body
SPARSE_STAGES = ("edge_blocks", "assembly", "tridiag", "woodbury", "lm_step")
PROGRAM_STAGES = {"round": ROUND_STAGES, "optimize_sparse": SPARSE_STAGES}

_clock = time.perf_counter_ns


class _Ring:
    """The stamps of one device: on a card a (SLOTS, 2 + COLS) int64 tensor
    and its counter and current slots (`state`); on the CPU a numpy array
    and the same counters on the host. `count` is the host's count of the
    slots opened."""

    def __init__(self, device):
        self.device = device
        self.count = 0
        if device.type == "cuda":
            self.ring = torch.zeros((SLOTS, 2 + COLS), dtype=torch.int64, device=device)
            self.state = torch.zeros(1 + PROGRAMS, dtype=torch.int64, device=device)
            self.clock = torch.zeros(8, dtype=torch.int64, device=device)
            self.side = torch.cuda.Stream(device)
        else:
            self.ring = np.zeros((SLOTS, 2 + COLS), np.int64)
            self.cur = [0] * PROGRAMS


_rings = {}  # torch.device -> _Ring
_programs = {}  # program name -> id
_capture_log = []  # (device, program id, column, capturing graph's nodes before the stamp)
_captures = []  # [{program: {stage: nodes}}], one a capture
_counters = {}
_count_t = [0] * COUNTS
_count_name = [""] * COUNTS
_count_n = [0] * COUNTS
_counts = [0]
_span_name = [""] * SPANS
_span_start = [0] * SPANS
_span_end = [0] * SPANS
_span_parent = [-1] * SPANS
_span_round = [-1] * SPANS
_spans = [0]
_local = threading.local()
_lib = None


def _load():
    global _lib
    if _lib is None:
        from .ops import _build

        lib = _build.load("trace_stamp")
        lib.trace_stamp_launch.restype = ctypes.c_int
        lib.trace_stamp_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
        lib.trace_clock_launch.restype = ctypes.c_int
        lib.trace_clock_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.trace_capture_nodes.restype = ctypes.c_int
        lib.trace_capture_nodes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
    return _lib


def _device(device):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def program_id(name):
    """The id a program's slots carry (the round is 0, others in order of
    first use)."""
    pid = _programs.get(name)
    if pid is None:
        if len(_programs) >= PROGRAMS:
            raise RuntimeError(f"trace: more than {PROGRAMS} traced programs")
        pid = _programs[name] = len(_programs)
    return pid


program_id("round")


def stages(program):
    """The stages between a program's stamps: the round's six, the sparse
    LM iteration's five, else the program itself (a begin and an end
    stamp)."""
    return PROGRAM_STAGES.get(program, (program,))


def ready(device):
    """The ring of `device`, made where it does not exist yet: call it
    before a capture (a ring made while capturing would live in the
    graph's pool)."""
    dev = _device(device)
    r = _rings.get(dev)
    if r is None:
        if dev.type == "cuda":
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("trace: make the card's ring (trace.ready) before capturing")
            _load()
        r = _rings[dev] = _Ring(dev)
    return r


def stamp(program, col, device):
    """Stamp column `col` of `program` on `device` (see the module's
    docstring)."""
    r = _rings.get(device)
    if r is None:
        r = ready(device)
    pid = program_id(program)
    if r.device.type != "cuda":
        if col == 0:
            slot = r.count % SLOTS
            r.ring[slot, 0] = r.count
            r.ring[slot, 1] = pid
            r.ring[slot, 3:] = 0
            r.cur[pid] = slot
            r.count += 1
        r.ring[r.cur[pid], 2 + col] = _clock()
        return
    lib = _lib
    stream = torch.cuda.current_stream(r.device).cuda_stream
    if torch.cuda.is_current_stream_capturing():
        n = ctypes.c_int64(-1)
        lib.trace_capture_nodes(stream, ctypes.byref(n))
        _capture_log.append((r.device, pid, col, n.value))
    elif col == 0:
        r.count += 1
    err = lib.trace_stamp_launch(r.ring.data_ptr(), r.state.data_ptr(), SLOTS, COLS, pid, col,
                                 stream)
    if err:
        raise RuntimeError(f"trace_stamp_launch: CUDA error {err}")


def capture_mark():
    """A mark in the capture log: `captured_since` reads what a capture
    stamped after it."""
    return len(_capture_log)


def captured_since(mark, device):
    """What a capture stamped on `device` since `mark`: the column-0 stamps
    (slots a replay opens, `begins`) and the graph nodes of each stage,
    stamps left out ({program: {stage: nodes}}, also the counters
    `graph_nodes.<program>.<stage>`)."""
    dev = _device(device)
    log = [e for e in _capture_log[mark:] if e[0] == dev]
    del _capture_log[mark:]
    names = {v: k for k, v in _programs.items()}
    nodes, last = {}, {}
    for _, pid, col, n in log:
        prev = last.get(pid)
        if col > 0 and prev is not None and prev[0] == col - 1 and n >= 0 and prev[1] >= 0:
            prog = names[pid]
            st = stages(prog)[col - 1] if col - 1 < len(stages(prog)) else f"stage{col - 1}"
            per = nodes.setdefault(prog, {})
            per[st] = per.get(st, 0) + n - prev[1] - 1
        last[pid] = (col, n)
    for prog, per in nodes.items():
        for st, n in per.items():
            _counters[f"graph_nodes.{prog}.{st}"] = n
    _captures.append(nodes)
    return dict(begins=sum(1 for e in log if e[2] == 0), nodes=nodes)


def replayed(device, begins):
    """A replay of a graph that opens `begins` slots on `device`."""
    if begins:
        _rings[device].count += begins


def next_round(device):
    """The number the next slot opened on `device` will carry."""
    r = _rings.get(_device(device))
    return r.count if r is not None else 0


class span:
    """`with span(name, round=None):` a host span (see the module's
    docstring); `round` defaults to the enclosing span's."""

    __slots__ = ("name", "round", "i", "rf")

    def __init__(self, name, round=None):
        self.name = name
        self.round = round

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        i = _spans[0]
        _spans[0] = i + 1
        k = i % SPANS
        parent = stack[-1] if stack else -1
        rnd = self.round
        if rnd is None:
            rnd = _span_round[parent % SPANS] if parent >= 0 else -1
        stack.append(i)
        self.i = i
        self.rf = None
        _span_name[k] = self.name
        _span_parent[k] = parent
        _span_round[k] = rnd
        _span_end[k] = 0
        if torch.autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        _span_start[k] = _clock()
        return self

    def __exit__(self, *exc):
        t = _clock()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _span_end[self.i % SPANS] = t
        _local.stack.pop()
        return False


def count(name, n=1):
    """Add n to counter `name`, noting the time."""
    _counters[name] = _counters.get(name, 0) + n
    i = _counts[0]
    _counts[0] = i + 1
    k = i % COUNTS
    _count_t[k] = _clock()
    _count_name[k] = name
    _count_n[k] = n


def counter(name):
    """The running total of counter `name`."""
    return _counters.get(name, 0)


def _calibrate(r):
    """Card clock minus host clock (ns) from the tightest of eight stamps,
    each on an idle stream between two host readings; and that reading's
    width (ns)."""
    lib = _load()
    torch.cuda.synchronize(r.device)
    reads = []
    for k in range(r.clock.shape[0]):
        h0 = _clock()
        err = lib.trace_clock_launch(r.clock[k:].data_ptr(), r.side.cuda_stream)
        r.side.synchronize()
        h1 = _clock()
        if err:
            raise RuntimeError(f"trace_clock_launch: CUDA error {err}")
        reads.append((h1 - h0, (h0 + h1) // 2))
    dev = r.clock.cpu().numpy()
    k = min(range(len(reads)), key=lambda j: reads[j][0])
    return int(dev[k]) - reads[k][1], reads[k][0]


def _slots(r):
    """A ring's written slots in order, times on the host clock (-1: a
    column not written)."""
    if r.device.type == "cuda":
        offset, width = _calibrate(r)
        rows = r.ring.cpu().numpy()
        opened = int(r.state[0].item())
    else:
        offset, width, rows, opened = 0, 0, r.ring.copy(), r.count
    n = min(opened, SLOTS)
    rows = rows[np.argsort(rows[:n, 0], kind="stable")] if n else rows[:0]
    t = rows[:, 2:].copy()
    t = np.where(t > 0, t - offset, -1)
    return dict(device=str(r.device), seq=rows[:, 0].copy(), program=rows[:, 1].copy(), t=t,
                opened=opened, host_count=r.count, offset_ns=offset, calibration_ns=width)


def snapshot():
    """Everything recorded, on the host clock (ns of time.perf_counter_ns):

    stamps    {device: dict(seq (n,), program (n,) ids, t (n, COLS) with
              -1 for a column not written, opened (slots opened on the
              device), host_count (the host's count of them), offset_ns
              and calibration_ns (the card's clock minus the host's and
              the width of the reading that set it))}, oldest slot first
    programs  {id: name}
    spans     dict(id, name, start, end, parent, round) arrays of the
              closed spans still in the ring, oldest first
    counters  {name: total}; counts: dict(t, name, n) arrays of the
              increments still in their ring
    captures  [{program: {stage: graph nodes}}], one a capture"""
    n = _spans[0]
    ids = np.arange(max(0, n - SPANS), n, dtype=np.int64)
    k = ids % SPANS
    end = np.asarray(_span_end, np.int64)[k]
    done = end > 0
    ids, k = ids[done], k[done]
    spans = dict(id=ids, name=np.asarray(_span_name, object)[k],
                 start=np.asarray(_span_start, np.int64)[k], end=end[done],
                 parent=np.asarray(_span_parent, np.int64)[k],
                 round=np.asarray(_span_round, np.int64)[k])
    m = _counts[0]
    ck = np.arange(max(0, m - COUNTS), m, dtype=np.int64) % COUNTS
    counts = dict(t=np.asarray(_count_t, np.int64)[ck],
                  name=np.asarray(_count_name, object)[ck],
                  n=np.asarray(_count_n, np.int64)[ck])
    return dict(stamps={str(d): _slots(r) for d, r in _rings.items()},
                programs={v: k for k, v in _programs.items()}, spans=spans,
                counters=dict(_counters), counts=counts, captures=list(_captures))


def self_ns(spans):
    """Each span's duration less its children's (ns), over `spans` as
    snapshot() gives them."""
    dur = spans["end"] - spans["start"]
    out = dur.copy()
    pos = {int(i): j for j, i in enumerate(spans["id"])}
    for j, p in enumerate(spans["parent"]):
        q = pos.get(int(p))
        if q is not None:
            out[q] -= dur[j]
    return out
