"""ctypes bindings for the native (C++) dataset decoder, the same
`native/libmalio_native.so` the JAX package binds (plain C++, host code).

`available()` is False when the shared library is missing or does not load
on this host (build it with `make -C native`); callers then use the NumPy
decoders of io.dataset. The native path decodes a whole sensor stream with
a thread pool — the runtime replacement for the file player's per-sensor
reader threads."""
from __future__ import annotations

import ctypes
import pathlib

import numpy as np

_LIB_PATH = pathlib.Path(__file__).resolve().parents[2] / "native" / "libmalio_native.so"
_lib = None

SENSOR_TYPE = {"ouster": 0, "livox": 1, "velodyne": 2}


def available() -> bool:
    return _load() is not None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:  # built for another host (C++ runtime, architecture)
        return None
    lib.batch_decode.restype = ctypes.c_long
    lib.batch_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_double),
        ctypes.c_long,
    ]
    _lib = lib
    return lib


def batch_decode(
    files,
    sensor: str,
    point_filter_num=1,
    n_scans=8,
    blind=0.0,
    time_unit_scale=1e3,
    cap=200000,
    n_threads=0,
):
    """Decode many scan files in parallel.

    Returns (pts (n_files, cap, 4) f64, counts (n_files,), durations)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder not built; run `make -C native`")
    n = len(files)
    blob = b"".join(str(f).encode() + b"\0" for f in files)
    out = np.zeros((n, cap, 4), np.float64)
    counts = np.zeros(n, np.int64)
    durations = np.zeros(n, np.float64)
    rc = lib.batch_decode(
        blob,
        n,
        SENSOR_TYPE[sensor],
        point_filter_num,
        n_scans,
        blind,
        time_unit_scale,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cap,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        durations.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_threads,
    )
    if rc < 0:
        raise IOError(f"{-rc} files failed to decode")
    return out, counts, durations
