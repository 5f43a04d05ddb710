"""Hand-written CUDA kernels (`csrc/`) behind wrappers with plain PyTorch
versions beside them."""
import torch


def wrappers():
    """Each kernel's wrapper by name. A wrapper counts its launches:
    `launches`, and `launches_by_shape` keyed by the shape it was given."""
    from . import deskew, knn, merge

    return {"knn_window": knn.knn_window, "deskew": deskew.deskew_points,
            "merge_rows": merge.merge_rows}


def reset_launches():
    """Every wrapper's launch counts to 0."""
    for fn in wrappers().values():
        fn.launches = 0
        fn.launches_by_shape = {}


def kernel_enabled(flag, t) -> bool:
    """A config kernel switch (`knn_kernel`, `deskew_kernel`) for tensor
    `t`: None means on for float32 CUDA tensors and off otherwise."""
    if flag is None:
        return t.device.type == "cuda" and t.dtype == torch.float32
    return bool(flag)
