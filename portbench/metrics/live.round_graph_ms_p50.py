"""live.round_graph_ms_p50 (ms): the median device time of a live round
replay, first to last stamp (malio_tpu_torch/trace.py), over the window
up to its first traced stretch: the card's share of a poll(). Logs the
stage table on an earlier line."""
import json

from portbench.core import program_trace
from portbench.core.bench import log


def read(run, cell):
    table = program_trace.stage_table(run, cell)
    if table is not None:
        log("round stages: " + json.dumps(table))
    return program_trace.round_ms(run, cell)
