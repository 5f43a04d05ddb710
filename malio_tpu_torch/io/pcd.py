"""Minimal PCD writer — the reference's pcd_save output
(laserMapping.cpp:467-488, PCD/scans_*.pcd) without PCL (the port's copy
of the JAX package's io/pcd.py)."""
from __future__ import annotations

import pathlib

import numpy as np


def write_pcd(path, points, intensity=None, binary=True):
    """points (N,3) float; optional intensity (N,)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    pts = np.asarray(points, np.float32)
    n = pts.shape[0]
    fields = "x y z" + (" intensity" if intensity is not None else "")
    count = 3 + (1 if intensity is not None else 0)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {fields}\n"
        f"SIZE {' '.join(['4'] * count)}\n"
        f"TYPE {' '.join(['F'] * count)}\n"
        f"COUNT {' '.join(['1'] * count)}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    data = pts if intensity is None else np.concatenate(
        [pts, np.asarray(intensity, np.float32)[:, None]], axis=1
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(np.ascontiguousarray(data, np.float32).tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")


def read_pcd(path):
    """Read back PCDs written by write_pcd (binary or ascii, float32)."""
    raw = pathlib.Path(path).read_bytes()
    head_end = raw.index(b"DATA")
    header = raw[: head_end + 64].decode("ascii", "ignore")
    lines = {l.split()[0]: l.split()[1:] for l in header.splitlines() if l.strip()}
    n = int(lines["POINTS"][0])
    count = len(lines["FIELDS"])
    mode = raw[head_end:].splitlines()[0].split()[1].decode()
    body_start = raw.index(b"\n", head_end) + 1
    if mode == "binary":
        data = np.frombuffer(raw[body_start:], np.float32, count * n).reshape(n, count)
    else:
        data = np.loadtxt(raw[body_start:].decode().splitlines()).reshape(n, count)
    return data
