"""Hand-written CUDA kernels (`csrc/`) behind wrappers with plain PyTorch
versions beside them."""
import torch


def wrappers():
    """Each kernel's wrapper by name. A wrapper counts its launches:
    `launches`, and `launches_by_shape` keyed by the shape it was given.
    The merge's and the block-tridiagonal solve's are the wrappers that
    count, also while a caller has rebound `merge.merge_rows` or
    `block_tridiag.block_tridiag_solve` to a recording or timing wrapper
    around it."""
    from . import block_tridiag, deskew, imu_propagate, knn, merge, voxel_sums

    return {"knn_window": knn.knn_window, "deskew": deskew.deskew_points,
            "merge_rows": merge._counted, "block_tridiag": block_tridiag._counted,
            "imu_propagate": imu_propagate.mean_chain, "voxel_sums": voxel_sums.voxel_sums}


def reset_launches():
    """Every wrapper's launch counts to 0."""
    for fn in wrappers().values():
        fn.launches = 0
        fn.launches_by_shape = {}


def count_launch(fn, shape):
    """One launch of `fn`'s kernel at `shape`, counted by the wrapper where
    it launches: in `launches` / `launches_by_shape`, or, while the stream
    is being captured into a CUDA graph, in `captured` (the launch runs at
    each replay, which `add_launches` counts)."""
    if torch.cuda.is_current_stream_capturing():
        fn.captured[shape] = fn.captured.get(shape, 0) + 1
        return
    fn.launches += 1
    fn.launches_by_shape[shape] = fn.launches_by_shape.get(shape, 0) + 1


def captured():
    """Each wrapper's launches recorded into CUDA graphs so far, by shape."""
    return {name: dict(fn.captured) for name, fn in wrappers().items()}


def add_launches(per_replay, replays: int):
    """Count `replays` replays of a CUDA graph whose launches by kernel and
    shape are `per_replay` (a difference of two `captured()`)."""
    for name, fn in wrappers().items():
        for shape, n in per_replay.get(name, {}).items():
            fn.launches += n * replays
            fn.launches_by_shape[shape] = fn.launches_by_shape.get(shape, 0) + n * replays


def kernel_enabled(flag, t) -> bool:
    """A config kernel switch (`knn_kernel`, `deskew_kernel`) for tensor
    `t`: None means on for float32 CUDA tensors and off otherwise."""
    if flag is None:
        return t.device.type == "cuda" and t.dtype == torch.float32
    return bool(flag)
