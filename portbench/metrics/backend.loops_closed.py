"""backend.loops_closed (loops): the loop edges the back end accepted in
the untraced window a whole pass: the change of the program's counter
`posegraph.loops_closed` over the window over its passes; 0.0 where the
window counted keyframes (`posegraph.keyframes`) and closed no loop
(core/program_trace.py)."""
from portbench.core import program_trace


def read(run, cell):
    if program_trace.counted(run, cell, "posegraph.keyframes") is None:
        return None
    n = program_trace.counted(run, cell, "posegraph.loops_closed") or 0
    return float(n) / max(int(run.get("passes") or 1), 1)
