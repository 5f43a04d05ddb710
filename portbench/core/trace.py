"""A traced segment of a run: torch.profiler (CUPTI) over a stretch of the
program's work, between two marker kernels, reduced to the device's busy
time (the union of its activities' intervals), its operations by name
and the idle gaps with what the host was doing in each.

The arithmetic is chip_smoke.py's profile (copied): a lead-in of host
time and one-element adds that a session may drop before its first
marker, a marker (torch.cuda._sleep's spin kernel) at each end, busy =
the union of the device intervals between the markers, idle = 1 - busy
/ window, both from the same session. A session that records the host's
operations too slows the host, and so stretches the window; the numbers
therefore come from a session of the device's activities alone
(`Segment(host=False)`), and the labels of the idle gaps from another
session over a neighbouring stretch of the same kind. A segment whose
two markers are not both in the trace lost device events and is taken
again by the caller."""
from __future__ import annotations

import time

LEAD_IN_S = 0.1
LEAD_IN_ADDS = 16
MARKER = "spin_kernel"
TOP = 10
NAME_CHARS = 160  # a kernel's name in the breakdown: templates run to ~600 characters


class Segment:
    """start() ... the program's work ... stop() -> summary (None if a
    marker was lost). `host`: record the host's operations too (for the
    gaps' labels)."""

    def __init__(self, host=True):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
        self.prof = profile(activities=acts)

    def start(self):
        torch = self.torch
        self.prof.start()
        time.sleep(LEAD_IN_S)
        x = torch.zeros(1, device="cuda")
        for _ in range(LEAD_IN_ADDS):
            x.add_(1.0)
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)

    def stop(self, rounds):
        self.end()
        return self.reduce(rounds)

    def end(self):
        """Close the session; reduce() reads it later (a live run reduces
        after its window)."""
        torch = self.torch
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(LEAD_IN_S)
        self.prof.stop()

    def reduce(self, rounds):
        return summarize(self.prof.profiler.kineto_results.events(), rounds)


def warm():
    """A short session before the window: the profiler's first start in a
    process loads CUPTI, which held a live run's pushes for seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1.0)
        torch.cuda.synchronize()


def _dev_type(e):
    return str(e.device_type()).split(".")[-1]


def summarize(events, rounds):
    """The segment between the first and the last marker: window_s,
    busy_s, device_ops, by_name (name -> seconds), gaps ([(label,
    seconds)], longest first) and rounds (lockstep rounds in it)."""
    dev, host = [], []
    for e in events:
        kind = _dev_type(e)
        if kind == "CUDA" and not e.is_user_annotation():
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif kind == "CPU":
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    dev.sort()
    marks = [i for i, d in enumerate(dev) if MARKER in d[2]]
    if len(marks) < 2:
        return None
    w0, w1 = dev[marks[0]][1], dev[marks[-1]][0]
    inside = [d for d in dev[marks[0] + 1 : marks[-1]] if MARKER not in d[2]]
    busy, by_name, gaps = 0, {}, []
    cur_s = cur_e = None
    edge = w0
    for s, e, name in inside:
        by_name[name] = by_name.get(name, 0) + (e - s)
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > edge:
                gaps.append((edge, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        edge = max(edge, cur_e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if w1 > edge:
        gaps.append((edge, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort()
    labelled = [(_host_at(host, (a + b) // 2), (b - a) / 1e9) for a, b in gaps[:TOP]]
    return dict(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, device_ops=len(inside),
                rounds=rounds, by_name={k: v / 1e9 for k, v in by_name.items()},
                gaps=labelled, n_gaps=len(gaps))


def _host_at(host, t):
    """What the host was doing at time t: the innermost traced host
    operation that spans it, else its Python between operations."""
    best = None
    for s, e, name in host:
        if s > t:
            break
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return f"host: {best[2]}" if best else "host: python between traced operations"


def labelled(numbers, labels):
    """The numbers' summary with the idle gaps of the labels' session (a
    neighbouring stretch traced with the host's operations), or None if
    either lost a marker."""
    if numbers is None or labels is None:
        return None
    return dict(numbers, gaps=labels["gaps"], n_gaps=labels["n_gaps"],
                labels_window_s=labels["window_s"], labels_busy_s=labels["busy_s"])


def kernel_s(summary, pattern):
    """Device seconds of the operations whose name holds `pattern`, or None
    when the segment holds none."""
    hits = [s for name, s in summary["by_name"].items() if pattern in name]
    return sum(hits) if hits else None


def breakdown(summary):
    """The result line's breakdown: the device operations that took most
    time and the longest idle gaps, with all their digits."""
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:TOP]
    return dict(device_ops=[[n[:NAME_CHARS], s] for n, s in ops],
                idle_gaps=[[n, s] for n, s in summary["gaps"]])
