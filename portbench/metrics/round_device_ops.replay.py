"""round_device_ops.replay (ops): device operations (kernels, copies,
memsets) a lockstep round of the traced window."""


def read(run, cell):
    t = run.get("trace")
    if not t or not t["rounds"]:
        return None
    return t["device_ops"] / t["rounds"]
