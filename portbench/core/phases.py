"""A traced segment cut into phases by marker kernels: the harness launches
a marker (torch.cuda._sleep's spin kernel, core/trace.MARKER) on the
program's stream at each host point it names, so the device's work
between two markers is the work the host queued between those points.
Each phase's busy time is the union of the device intervals between its
two markers; the first and the last marker are the segment's own.

    phases(events, labels) -> {"<label a>-><label b>": dict(busy_s, by_name)}

`labels` names the markers launched between the segment's two, in order;
a segment whose markers do not number len(labels) + 2 gives None."""
from __future__ import annotations

from .trace import MARKER, _dev_type


def mark():
    """A marker on the current stream (no wait)."""
    import torch

    torch.cuda._sleep(1000)


def phases(events, labels):
    dev = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
                 if _dev_type(e) == "CUDA" and not e.is_user_annotation())
    marks = [i for i, d in enumerate(dev) if MARKER in d[2]]
    if len(marks) != len(labels) + 2:
        return None
    names = ["start", *labels, "end"]
    out = {}
    for a, b, na, nb in zip(marks[:-1], marks[1:], names[:-1], names[1:]):
        lo, hi = dev[a][1], dev[b][0]
        busy, cur_s, cur_e, by_name = 0, None, None, {}
        for s, e, name in dev[a + 1 : b]:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        out[f"{na}->{nb}"] = dict(busy_s=busy / 1e9, by_name=by_name)
    return out
