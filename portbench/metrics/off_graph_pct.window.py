"""off_graph_pct.window (%): the share of the untraced window in which no
round replay ran on the card, 100 (1 - the summed first-to-last stamp
intervals of the window's rounds / the window): the host's marshalling,
launches, copies and fences between rounds, and the copies between
replays, with no profiler session open (malio_tpu_torch/trace.py)."""
from portbench.core import program_trace


def read(run, cell):
    return program_trace.off_graph_pct(run, cell)
