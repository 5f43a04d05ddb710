"""The plain PyTorch versions of the program's kernels: the reference
launches no hand-written kernel."""


def kernel_enabled(flag, t) -> bool:
    return False
