"""round_graph_ms.window (ms): the median device time of a round replay
over the untraced window, from the round's first stamp to its last (the
program's stage stamps, malio_tpu_torch/trace.py: kernels in the captured
graph that read the card's global timer), a lockstep round of B
sequences a replay. Logs the stage table (median ms, share, the graph
nodes the capture counted a stage) on an earlier line."""
import json

from portbench.core import program_trace
from portbench.core.bench import log


def read(run, cell):
    table = program_trace.stage_table(run, cell)
    if table is not None:
        log("round stages: " + json.dumps(table))
    return program_trace.round_ms(run, cell)
