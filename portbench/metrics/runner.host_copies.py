"""runner.host_copies (copies): the copies between the host's arrays and
the card over the untraced window (the program's `host_copies` counter,
malio_tpu_torch/trace.py: a chunk's upload a field, the small outputs'
fetch a field), per fused round of the window."""
from portbench.core import program_trace


def read(run, cell):
    n = program_trace.counted(run, cell, "host_copies")
    if n is None or not run.get("attempted"):
        return None
    return n / run["attempted"]
