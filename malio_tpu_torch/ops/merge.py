"""Row merge into a table: the CUDA kernel `csrc/merge_rows.cu` (which
replaces the TPU kernel benchmarks/micro_r4b.py:pallas_merge, a
replacement for the map insert's scatter, malio_tpu/map/voxel_hash.py:
292-294) and its plain PyTorch version, the insert's former write.

`merge_rows(tab, idx, rec)` returns a new table: `tab` with
`out[idx[j]] = rec[j]` for every j with 0 <= idx[j] < T. Entries outside
[0, T) are skipped; the valid entries must be unique, in any order. The
write is a copy, so kernel and plain version give the same bits. CPU
tensors run the plain version; CUDA tensors launch the kernel; there is
no other fallback.

The kernel is one launch: a persistent grid copies the table tile by
tile and writes each update once the tiles its row lies in are copied,
which per-tile flags in a scratch tensor tell (one per device, zeroed at
the first call and kept: the kernel advances its own stamp, so a launch
captured in a CUDA graph replays as it runs). Calls on one device share
that scratch and must run in stream order; a capture before the first
eager call on the device raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, count_launch


def merge_rows_plain(tab, idx, rec):
    """The table with the valid rows written: a dump row appended, invalid
    targets sent to it, one index_put_, the dump row sliced off."""
    T = tab.shape[0]
    flat = torch.cat([tab, tab.new_zeros((1,) + tuple(tab.shape[1:]))])
    valid = (idx >= 0) & (idx < T)
    flat[torch.where(valid, idx, torch.full_like(idx, T))] = rec
    return flat[:T]


# tile flags in the scratch: tables up to 2^16 tiles of 32 KB (2 GiB) take
# one flag a tile, larger ones tiles of a power-of-two multiple of 32 KB
FLAGS = 1 << 16
_HEADER = 4  # the last call's stamp, the tile ticket, blocks copied, one unused
_scratch = {}  # device -> int64 (_HEADER + FLAGS,)
_loaded = None


def _lib():
    global _loaded
    if _loaded is None:
        lib = _build.load("merge_rows")
        lib.merge_rows_launch.restype = ctypes.c_int
        lib.merge_rows_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p])
        lib.merge_rows_tile_words.restype = ctypes.c_int64
        lib.merge_rows_tile_words.argtypes = [ctypes.c_int64] * 2
        _loaded = lib
    return _loaded


def tile_words(words):
    """Words in a tile of the kernel's copy for a table of `words` 4-byte
    words (the card's build; for tests at tile boundaries)."""
    return int(_lib().merge_rows_tile_words(words, FLAGS))


def merge_rows(tab, idx, rec):
    """Same contract as `merge_rows_plain`. CUDA tensors launch the kernel,
    which takes a contiguous (T, W) table, contiguous int64 idx (N,) and
    records (N, W) of the table's dtype, all on one card; rows must be a
    whole number of 4-byte words."""
    args = (tab, idx, rec)
    if all(t.device.type == "cpu" for t in args):
        return merge_rows_plain(tab, idx, rec)
    dev = tab.device
    if dev.type != "cuda" or any(t.device != dev for t in args):
        raise ValueError(f"merge_rows: tensors must lie on one CUDA device, got "
                         f"{[str(t.device) for t in args]}")
    if tab.dim() != 2 or not all(t.is_contiguous() for t in args):
        raise ValueError("merge_rows: tab (T, W), idx (N,) and rec (N, W) must be contiguous")
    T, W = tab.shape
    N = idx.shape[0]
    if idx.dtype != torch.int64 or idx.dim() != 1:
        raise ValueError(f"merge_rows: idx must be (N,) int64, got {tuple(idx.shape)} {idx.dtype}")
    if rec.dtype != tab.dtype or tuple(rec.shape) != (N, W):
        raise ValueError(f"merge_rows: rec must be ({N}, {W}) {tab.dtype}, got "
                         f"{tuple(rec.shape)} {rec.dtype}")
    row_bytes = W * tab.element_size()
    if row_bytes % 4:
        raise ValueError(f"merge_rows: a row of {row_bytes} bytes is not a whole number of words")
    launch = _lib().merge_rows_launch
    state = _scratch.get(dev)
    if state is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("merge_rows: call it once on this device before capturing it "
                               "in a CUDA graph (the first call makes its scratch)")
        state = _scratch[dev] = torch.zeros(_HEADER + FLAGS, dtype=torch.int64, device=dev)
    out = torch.empty_like(tab)
    err = launch(tab.data_ptr(), out.data_ptr(), idx.data_ptr(), rec.data_ptr(), T, N,
                 row_bytes // 4, state.data_ptr(), FLAGS,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "merge_rows_launch")
    count_launch(_counted, (T, N))
    return out


merge_rows.launches = 0
merge_rows.launches_by_shape = {}  # (table rows T, updates N) -> launches
merge_rows.captured = {}  # the same, recorded into CUDA graphs
# the counts stay on the wrapper when a caller rebinds merge.merge_rows
# (a recording or timing wrapper around it)
_counted = merge_rows
