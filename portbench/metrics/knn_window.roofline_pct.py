"""knn_window.roofline_pct (%): the round's k-NN searches (ops/knn.py,
csrc/knn_window.cu) against their roofline: the least time of the bytes
core/bounds.knn_round counts for the cell's shapes, over the device time
of the kernels named knn_window in the traced window, a round."""
from portbench.core import bounds, trace


def read(run, cell):
    t = run.get("trace")
    s = trace.kernel_s(t, "knn_window") if t and t["rounds"] else None
    if not s:
        return None
    ms, _ = bounds.bound(*bounds.knn_round(cell.config["config"], run["batch"]), run["device_kind"])
    return 100.0 * ms / (s * 1e3 / t["rounds"])
