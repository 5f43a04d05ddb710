"""live.pose_latency_p95_ms (ms): the 95th percentile of the rounds'
latencies (modes/live.py: from the scheduled time of the push that made
a round ready to poll() returning its pose), over the window up to its
traced stretch. The tail sits where a few rounds a hundred wait some 10 ms
longer, so its reading jumps from run to run; pose_latency_p50_ms, the
median over the whole window, is the end-to-end metric."""
import numpy as np


def read(run, cell):
    v = run.get("spans", {}).get("live.latency_ms")
    return float(np.percentile(v, 95)) if v else None
