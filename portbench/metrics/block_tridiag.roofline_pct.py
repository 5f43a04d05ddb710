"""block_tridiag.roofline_pct (%): the relaxation's block-tridiagonal solve
(ops/block_tridiag.py, csrc/block_tridiag.cu) against its roofline: the
least time of core/bounds_backend's count of one solve at the cell's
capacity and loop capacity (the fixed shape the program solves, whatever
part of it is live), over one solve's device time, the kernels
named block_tridiag in the traced closure's relaxation summed and divided
by its LM iterations (one solve each)."""
from portbench.core import bounds_backend


def read(run, cell):
    t = run.get("trace") or {}
    p = (t.get("phases") or {}).get("relax0->relax1")
    if p is None:
        return None
    s = sum(v for k, v in p["by_name"].items() if "block_tridiag" in k)
    if not s:
        return None
    b = cell.config["backend"]
    ms, _ = bounds_backend.tridiag_ms(b["capacity"], bounds_backend.columns(b["loop_capacity"]),
                                      run["device_kind"])
    return 100.0 * ms / (s * 1e3 / t["relax_iters"])
