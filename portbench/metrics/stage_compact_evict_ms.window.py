"""stage_compact_evict_ms.window (ms): the median device time of the
round's `compact_evict` stage over the untraced window: the measurement-
lane compaction, the local-map box (_fov_segment) and the eviction; the
interval between its two stamps (malio_tpu_torch/trace.py) in each round
replay."""
from portbench.core import program_trace


def read(run, cell):
    return program_trace.stage_ms(run, cell, "compact_evict")
