"""round_busy_ms.replay (ms): device-busy milliseconds a lockstep round of
the traced window (the union of the device intervals over its rounds)."""


def read(run, cell):
    t = run.get("trace")
    if not t or not t["rounds"]:
        return None
    return t["busy_s"] * 1e3 / t["rounds"]
