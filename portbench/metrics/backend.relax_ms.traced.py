"""backend.relax_ms.traced (ms): the device's busy time over the traced
loop closure's relaxation (posegraph.optimize_sparse, its relax_iters LM
iterations replayed from the captured iteration, with their copies),
between the marker kernels launched as the program entered and left it
(modes/loop.py, core/phases.py)."""


def read(run, cell):
    p = ((run.get("trace") or {}).get("phases") or {}).get("relax0->relax1")
    return None if p is None else p["busy_s"] * 1e3
