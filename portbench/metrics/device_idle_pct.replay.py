"""device_idle_pct.replay (%): the share of a traced stretch of steady
rounds in which no operation ran on the card, chip_smoke.py's
arithmetic (copied): 100 (1 - busy / window), both from one profiler
session of the device's activities alone (core/trace.py) between its
two markers: busy the union of the device intervals, window the time
from the first marker's end to the last's start. The stretch is one
loop iteration of the pass in its middle (modes/replay.py, fleet.py)."""


def read(run, cell):
    t = run.get("trace")
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
