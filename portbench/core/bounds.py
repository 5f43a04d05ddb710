"""The yardstick's arithmetic of rooflines: the table of peaks, `bound`
and `merge_bytes` as chip_smoke.py computes them (copied), and the bytes
and operations a fusion round's kernel work needs, from the cell's shapes
alone, so that they read the same work whatever implements it.

Every count is of what the work needs: each input byte read once, each
output byte written once. Where that depends on the data (the k-NN's
table rows, the lanes alive in a window) the count leaves it out, so a
share of the roofline is a lower bound on the true share and never
passes 100% while the time holds the whole work."""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates: HBM3 bandwidth, f32 outside
# the tensor cores; the rates assume the 700 W power limit
PEAKS = {"NVIDIA H100 80GB HBM3": dict(bytes_per_s=3.35e12, f32_ops_per_s=67e12)}
DEFAULT_PEAK = "NVIDIA H100 80GB HBM3"

MAP_SLOT_BYTES = 5 * 4  # one map slot: [fingerprint, x, y, z, cov] f32
SLOTS = 32  # slots a hash-table row
KNN_K = 16  # the round's k-NN keeps 16 candidates a lane (measurement.CAND_K)
KNN_OUT_BYTES = 3 * 4 + 4 + 4  # a kept candidate: point, covariance, d2 (f32)
# f32 operations per point of the deskew inside its spline window and
# outside it (chip_smoke.py, counted from csrc/deskew.cu's source)
DESKEW_OPS_PER_POINT = 560
DESKEW_OPS_OUTSIDE = 10


def peak(kind):
    return PEAKS.get(kind, PEAKS[DEFAULT_PEAK])


def bound(nbytes, nops, kind=DEFAULT_PEAK):
    """The least time (ms) of nbytes moved and nops f32 operations at the
    card's peaks, and which of the two sets it."""
    p = peak(kind)
    t_bytes = nbytes / p["bytes_per_s"] * 1e3
    t_ops = nops / p["f32_ops_per_s"] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def merge_bytes(T, N, n_valid, row_bytes):
    """The least bytes the merge moves: the table's rows that no update
    overwrites read once, the valid records read once, the table written
    once, idx (8 B an entry) read once."""
    return (T - n_valid) * row_bytes + n_valid * row_bytes + T * row_bytes + N * 8


def lanes(cfg):
    """Measurement lanes a sequence's round searches and inserts."""
    M = cfg["num_lidars"] * cfg["max_points_per_scan"]
    cap = cfg.get("max_meas_points")
    return min(M, cap) if cap else M


def knn_round(cfg, B):
    """(bytes, ops) of a round's k-NN searches for B sequences: every lane
    at the base window and the wide window's budget of queries; each
    query's point read once and its K candidates written once. The table
    rows a window reads depend on the data and are not counted."""
    Q = B * (lanes(cfg) + cfg["knn_wide_budget"])
    return Q * 12 + Q * KNN_K * KNN_OUT_BYTES, 0


def merge_round(cfg, B):
    """(bytes, ops) of a round's map write for B sequences: the B tables
    of map_capacity slots, one update entry a lane."""
    T = B * cfg["map_capacity"]
    return merge_bytes(T, B * lanes(cfg), 0, MAP_SLOT_BYTES), 0


def deskew_round(cfg, B, points_inside):
    """(bytes, ops) of a round's deskew for B sequences: every raw point
    slot read and written (x, y, z, t in; x, y, z, ok out), the spline and
    the frames; points_inside (a sequence's points a round) at the spline
    window's cost, the other slots at the interval test's."""
    L, N, C = cfg["num_lidars"], cfg["max_raw_points"], cfg["spline_capacity"]
    nbytes = B * (L * N * 32 + C * (16 + 6) * 4 + L * 14 * 4 + 8)
    inside = B * points_inside
    return nbytes, inside * DESKEW_OPS_PER_POINT + (B * L * N - inside) * DESKEW_OPS_OUTSIDE
