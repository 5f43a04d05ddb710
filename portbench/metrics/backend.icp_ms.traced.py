"""backend.icp_ms.traced (ms): the device's busy time over the traced
loop closure's candidate refinement (posegraph.refine_loop_edge: the
coarse and the fine point-to-plane ICP stages, each a captured graph,
and the pick), between the marker kernels launched as the program
entered and left it (modes/loop.py, core/phases.py)."""


def read(run, cell):
    p = ((run.get("trace") or {}).get("phases") or {}).get("icp0->icp1")
    return None if p is None else p["busy_s"] * 1e3
