"""HostReads, a TorchDispatchMode that lists the operations of a round
that read a device value on the host or make a tensor from host data:
each fails a CUDA graph capture (malio_tpu_torch/graph.py). It imports
torch alone, so processes of a distributed world can use it too."""
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# operations that read a device value on the host (item, bool, int, a
# data-dependent shape, a solver's status) or make a tensor from host data
_HOST_OPS = {"aten::_local_scalar_dense", "aten::nonzero", "aten::bincount",
             "aten::masked_select", "aten::_linalg_eigh", "aten::linalg_eigh", "aten::_unique2",
             "aten::unique_dim", "aten::unique_consecutive", "aten::lift_fresh",
             "aten::_linalg_check_errors"}


class HostReads(TorchDispatchMode):
    """Every host read of the operations run under it, with the port's
    line that made it (`seen`), and every c10d collective by name
    (`collectives`)."""

    def __init__(self):
        super().__init__()
        self.seen = []
        self.collectives = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        bool_index = name in ("aten::index", "aten::index_put", "aten::index_put_") and any(
            torch.is_tensor(i) and i.dtype == torch.bool for i in (args[1] or ()))
        tensor_repeats = name == "aten::repeat_interleave" and func._overloadname != "self_int"
        if name.startswith("c10d::"):
            self.collectives.append(name)
        elif name in _HOST_OPS or bool_index or tensor_repeats:
            where = [f for f in traceback.extract_stack() if "malio_tpu_torch" in f.filename]
            self.seen.append((name, f"{where[-1].filename}:{where[-1].lineno}" if where else "?"))
        return func(*args, **(kwargs or {}))
