"""live.poll_ms_p50 (ms): the median host time of a poll() that returns a
pose (the round's wait on the card and the host fetch), from the
benchmark's host-clock spans around each call, over the window up to
its traced stretch (modes/live.py)."""
import numpy as np


def read(run, cell):
    v = run.get("spans", {}).get("live.poll_ms")
    return float(np.median(v)) if v else None
