"""deskew.roofline_pct (%): the spline deskew of every raw point slot
(ops/deskew.py, csrc/deskew.cu) against its roofline: the least time of
core/bounds.deskew_round's bytes and operations for the cell's shapes
(the sensors' points a round inside the spline window), over the device
time of the kernels named deskew in the traced window, a round."""
from portbench.core import bounds, trace


def read(run, cell):
    t = run.get("trace")
    s = trace.kernel_s(t, "deskew") if t and t["rounds"] else None
    if not s:
        return None
    inside = sum(cell.config["sensors"]["points"])
    ms, _ = bounds.bound(*bounds.deskew_round(cell.config["config"], run["batch"], inside),
                         run["device_kind"])
    return 100.0 * ms / (s * 1e3 / t["rounds"])
