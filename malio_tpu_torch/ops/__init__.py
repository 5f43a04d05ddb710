"""Hand-written CUDA kernels (`csrc/`) behind wrappers with plain PyTorch
versions beside them."""
import torch


def kernel_enabled(flag, t) -> bool:
    """A config kernel switch (`knn_kernel`, `deskew_kernel`) for tensor
    `t`: None means on for float32 CUDA tensors and off otherwise."""
    if flag is None:
        return t.device.type == "cuda" and t.dtype == torch.float32
    return bool(flag)
