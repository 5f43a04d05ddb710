"""merge_rows.roofline_pct (%): the map insert's table write (ops/merge.py,
csrc/merge_rows.cu) against its roofline: the least time of
core/bounds.merge_round's bytes (merge_bytes of the B tables and a
lane's update entries), over the device time of the kernels named
merge_rows in the traced window, a round."""
from portbench.core import bounds, trace


def read(run, cell):
    t = run.get("trace")
    s = trace.kernel_s(t, "merge_rows") if t and t["rounds"] else None
    if not s:
        return None
    ms, _ = bounds.bound(*bounds.merge_round(cell.config["config"], run["batch"]), run["device_kind"])
    return 100.0 * ms / (s * 1e3 / t["rounds"])
