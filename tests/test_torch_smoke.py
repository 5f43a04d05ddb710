"""How `chip_smoke.py` reads a marked torch.profiler trace, on the CPU:
`marked_calls` takes a call's device activities from between two
consecutive marker kernels, keeps the calls that hold the most common
number of activities, and says whether the trace is whole. A trace that
lost its first activities (as one on an H100 lost its first 35 of 120,
five times in a row) keeps its later calls; a call that lost a marker or
an activity is left out. `chip_smoke.py` imports neither jax nor
malio_tpu."""
import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

MARK = ("void at::native::(anonymous namespace)::spin_kernel(long)", 1000.0)


def _trace(n, per_call, lead=19):
    """A session's device activities: `lead` lead-in adds and warm-up
    launches, then n calls of `per_call` activities, each after a marker,
    and a marker after the last."""
    ev = [("add", 1.0)] * lead
    for i in range(n):
        ev.append(MARK)
        ev += [(f"kernel{k}", 10.0 + i) for k in range(per_call)]
    return ev + [MARK]


@pytest.mark.parametrize("per_call", [1, 2])
def test_a_whole_trace_keeps_every_call(per_call):
    calls, whole = chip_smoke.marked_calls(_trace(50, per_call), 50)
    assert whole and len(calls) == 50
    assert [c[0][1] for c in calls] == [10.0 + i for i in range(50)]
    assert all(len(c) == per_call for c in calls)


def test_a_trace_that_lost_its_first_events_keeps_its_later_calls():
    ev = _trace(50, 1)[35:]  # 85 of 120 recorded, 43 of 51 markers
    calls, whole = chip_smoke.marked_calls(ev, 50)
    assert not whole and len(ev) == 85
    assert [c[0][1] for c in calls] == [10.0 + i for i in range(8, 50)]


def test_a_call_that_lost_a_marker_or_an_activity_is_left_out():
    ev = _trace(50, 2)
    marks = [i for i, e in enumerate(ev) if e == MARK]
    del ev[marks[30]]  # calls 29 and 30 run together
    del ev[marks[10] + 1]  # call 10 lost an activity
    calls, whole = chip_smoke.marked_calls(ev, 50)
    assert not whole
    assert [c[0][1] for c in calls] == [10.0 + i for i in range(50) if i not in (10, 29, 30)]
    assert chip_smoke.marked_calls([], 50) == ([], False)
