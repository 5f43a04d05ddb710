"""The CUDA kernels against their plain versions on the card, at edge shapes
the flagship path does not give them: windows of 1, 3, 8, 12 and 208 rows
(both launch geometries of the fused k-NN window kernel, the wide one
also at 12 rows, one or two a warp) with distance ties, windows with fewer
valid lanes than K (lane 0 valid, invalid and dead), all-invalid windows,
masked-off queries and duplicate rows; a batch of maps as one flat table,
with windows that reach the last sequence's last row. The deskew kernel in both layouts
(three lanes a point with the spline read through the cache, one lane with
it staged in shared memory) on ragged point counts whose warps hold points
of two LiDARs, 1 to 32 LiDARs, splines with no and with one valid
interval, times exactly on the control grid and NaN times, and 3 x 65,536
points; the layout the wrapper picks by point count; a slice of the raw
point axis (an mp rank's) deskewed in the whole set's layout keeps the
whole set's bits; its refusals. A batch
of sequences in one launch: each sequence equals its own launch (B = 1)
and the plain version, with sequences of different spline windows and
time origins, one whose times are all NaN, and point counts whose warps
and blocks end inside a sequence. k-NN is bit-equal; deskew
agrees within atol 2e-5 with the plain version run in f64 (the exact
deskew) and has the f32 plain version's ok flags (rotation matrices in
the kernel, quaternions in the plain version). `vh.knn` at K = 5 through the
kernel equals it through the plain version; the back end's per-cell sums
are the same bits on every call. The merge kernel (the insert's table
write) equals its plain version and index_copy bit for bit: the first
and the last row, unsorted rows mixed with entries outside the table,
nothing valid, no update, f32 and f64 rows, tables whose size leaves a
tail past the 16-byte copy, a 2^21-row table; at the edges of its copy's
tiles (updates on a tile's first and last row, rows that straddle two
tiles, tables one row under and over a tile multiple, all updates in one
tile, every row updated, every entry dead); 1,000 back-to-back calls of
two shapes; replays of a CUDA graph that captured it; the insert through
it equals the insert through the plain version; its refusals. All three
at the soak's shapes (malio_tpu_torch/soak.py: 3 x 1024 raw points, 3072
measurement lanes, a 2^19-slot map of 16,384 rows): the k-NN base window
Q = 3072, V = 8 and the wide tiers Q = 256 / 1024, V = 208; the deskew at
1 x 3 x 1024 in both layouts; the insert's write into 2^19 table rows
from 3072 entries, some or all of them dead. The compiled round
(pipeline.step on the card, a CUDA graph of the fusion round) captured at
B = 1 and B = 2 replays the eager round (pipeline.step_eager) bit for bit
over four rounds, through step and through scan_steps, and each replay
counts the launches its capture recorded; a carry kept from an earlier
round is not overwritten by later replays; a round that reads a device
value on the host fails to capture and pipeline.step raises; a steady
round and a scan_steps chunk make no host sync. An mp rank's round over
NCCL (the sharding worker, dp1xmp2 on two cards, dp2xmp2 on four) replays
its capture bit-equal to the eager NCCL round with the three kernels and
its collectives in each replay and no host sync; a capture that fails on
one rank fails the world (these skip with fewer cards than ranks). The
back end's programs
(posegraph.optimize, optimize_sparse, icp_point_to_plane,
refine_loop_edge, ba.optimize_window) on small scenes: each replay of
its capture bit-equal to its _eager version, a second call reusing the
capture, no host sync in a replay, a program with a host read failing to
capture (it raises). The block-tridiagonal kernel against its plain
version at (K, r) = (64, 385) and (2048, 193) (column by column within
1e-9, the residual within 4x), and its refusals.

Every test needs a CUDA device and skips without one. On a machine with a
card (and without JAX, which the repo's conftest configures):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from malio_tpu_torch import ba, ops, pipeline, posegraph, tree
from malio_tpu_torch import spline as spl
from malio_tpu_torch.geometry import se3, so3
from malio_tpu_torch.map import voxel_hash as vh
from malio_tpu_torch.ops import deskew, knn, merge

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the merge's tile-edge rows)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _window(Q, V, seed, dev, R=64):
    """A table with twin points and two sparse rows (slot 0 occupied /
    empty), and windows of V random rows over it with the edge cases
    planted at fixed queries (Q >= 12)."""
    rng = np.random.default_rng(seed)
    tab = np.zeros((R, vh.SLOTS, 5), np.float32)
    tab[..., 1:4] = rng.uniform(-3, 3, size=(R, vh.SLOTS, 3))
    tab[..., 0] = np.where(rng.uniform(size=(R, vh.SLOTS)) < 0.6, 3.0, 0.0)
    tab[::3, 7, 1:4] = tab[::3, 2, 1:4]  # ties inside a row
    tab[1::4, 9, 1:4] = tab[0, 5, 1:4]  # ties across rows
    tab[R - 1, :, 0] = 0
    tab[R - 1, [0, 3, 9], 0] = 7
    tab[R - 2, :, 0] = 0
    tab[R - 2, [4, 11], 0] = 9
    tab[..., 4] = np.where(tab[..., 0] != 0, rng.uniform(0.01, 0.2, size=(R, vh.SLOTS)), np.inf)
    qs = rng.uniform(-3, 3, size=(Q, 3)).astype(np.float32)
    qs[6] = tab[3, 7, 1:4]
    rows = rng.integers(0, R - 2, size=(Q, V))
    alive = rng.uniform(size=(Q, V)) < 0.9
    alive[3] = False  # all-invalid window
    rows[5], alive[5] = 0, False  # masked-off query
    rows[7, 0], alive[7, 1:] = R - 1, False  # 3 valid lanes, lane 0 valid
    rows[8, 0], alive[8, 1:] = R - 2, False  # 2 valid lanes, lane 0 invalid
    alive[9, 0] = False  # lane 0 dead
    if V > 2:
        rows[10, 2], alive[10, 2] = rows[10, 1], False  # duplicate row, dead
        rows[11, 1:3], alive[11, 1:3] = rows[11, 0], True  # duplicate rows, alive
    return [torch.as_tensor(a, device=dev) for a in (tab, qs, rows, alive)]


SOAK_ROWS = (1 << 19) // vh.SLOTS  # the soak's map: 2^19 slots


@pytest.mark.parametrize("Q,V,K,R", [(12, 1, 16, 64), (37, 3, 5, 64), (300, 8, 16, 64),
                                     (40, 12, 16, 64), (64, 208, 16, 64),
                                     (3072, 8, 16, SOAK_ROWS), (256, 208, 16, SOAK_ROWS),
                                     (1024, 208, 16, SOAK_ROWS)])
def test_knn_kernel_bit_equal_to_plain(card, Q, V, K, R):
    args = _window(Q, V, seed=V, dev=card, R=R)
    before = knn.knn_window.launches
    got = knn.knn_window(*args, K)
    torch.cuda.synchronize()
    assert knn.knn_window.launches == before + 1
    for a, b in zip(got, knn.knn_window_plain(*args, K)):
        assert torch.equal(a, b)


def test_knn_wrapper_refuses_what_the_kernel_does_not_take(card):
    tab, qs, rows, alive = _window(16, 8, seed=1, dev=card)
    with pytest.raises(ValueError):
        knn.knn_window(tab, qs, rows, alive, 17)  # K past the register list
    with pytest.raises(ValueError):
        knn.knn_window(tab, qs, rows.int(), alive, 4)  # int32 row ids
    with pytest.raises(ValueError):
        knn.knn_window(tab[:, :16].contiguous(), qs, rows, alive, 4)  # 16 slots a row
    with pytest.raises(ValueError):
        knn.knn_window(tab, qs.cpu(), rows, alive, 4)  # mixed devices


def test_knn_window_refuses_non_contiguous_or_f64(card):
    tab, qs, rows, alive = _window(16, 8, seed=2, dev=card)
    before = knn.knn_window.launches
    with pytest.raises(ValueError):
        knn.knn_window(tab.double(), qs, rows, alive, 4)
    with pytest.raises(ValueError):
        knn.knn_window(tab, qs.double(), rows, alive, 4)
    with pytest.raises(ValueError):
        knn.knn_window(tab, qs.t().contiguous().t(), rows, alive, 4)
    with pytest.raises(ValueError):
        knn.knn_window(tab, qs, rows.t().contiguous().t(), alive, 4)
    assert knn.knn_window.launches == before


def test_knn_cached_kernel_equals_plain_on_the_card(card):
    rng = np.random.default_rng(3)
    pts = torch.as_tensor(rng.uniform(-8, 8, size=(3000, 3)).astype(np.float32), device=card)
    covs = torch.as_tensor(rng.uniform(0.01, 0.2, size=3000).astype(np.float32), device=card)
    m = vh.insert(vh.create(1 << 14, 0.5, torch.float32, card), pts, covs,
                  torch.ones(3000, dtype=torch.bool, device=card))
    far = torch.as_tensor(rng.uniform(12, 20, size=(300, 3)).astype(np.float32), device=card)
    qs = torch.cat([pts[:500] + 0.1, far])
    kw = dict(radius=1, wide_radius=5, wide_budget=512, cache_k=16)
    before = dict(knn.knn_window.launches_by_shape)
    got = vh.knn_cached(m, qs, use_kernel=True, **kw)
    want = vh.knn_cached(m, qs, use_kernel=False, **kw)
    after = knn.knn_window.launches_by_shape
    assert after.get((800, 8, 16), 0) == before.get((800, 8, 16), 0) + 1, after
    assert sum(after.values()) == sum(before.values()) + 2, after
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_vh_knn_kernel_equals_plain_at_k5(card, monkeypatch):
    """vh.knn (K = 5, base window and budgeted wide escalation) runs the
    fused kernel on an f32 map on the card; with the wrapper's plain
    version in its place the results are the same bits."""
    rng = np.random.default_rng(4)
    pts = torch.as_tensor(rng.uniform(-8, 8, size=(3000, 3)).astype(np.float32), device=card)
    covs = torch.as_tensor(rng.uniform(0.01, 0.2, size=3000).astype(np.float32), device=card)
    m = vh.insert(vh.create(1 << 14, 0.5, torch.float32, card), pts, covs,
                  torch.ones(3000, dtype=torch.bool, device=card))
    # past the map's edge: the base window misses, the wide one finds some
    far = torch.as_tensor(rng.uniform(8.3, 10.0, size=(300, 3)).astype(np.float32), device=card)
    qs = torch.cat([pts[:500] + 0.1, far])
    kw = dict(k=5, radius=1, wide_radius=5, wide_budget=512)
    before = dict(knn.knn_window.launches_by_shape)
    got = vh.knn(m, qs, **kw)
    after = knn.knn_window.launches_by_shape
    assert after.get((800, 8, 5), 0) == before.get((800, 8, 5), 0) + 1, after
    assert after.get((512, 208, 5), 0) == before.get((512, 208, 5), 0) + 1, after
    monkeypatch.setattr(knn, "knn_window", knn.knn_window_plain)
    want = vh.knn(m, qs, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[4]) < int(vh.knn(m, qs, k=5)[4])  # escalation recovered misses


def test_back_end_sums_are_the_same_bits_on_every_call(card):
    """The BA window cost and the ICP plane model sum per cell in a fixed
    order (segment.segment_sum), so two calls give the same bits; with
    index_add_ the atomics would add in a run-dependent order."""
    rng = np.random.default_rng(5)
    W, P = 8, 2048
    f64 = dict(dtype=torch.float64, device=card)
    win = ba.KeyframeWindow(
        q=torch.tensor([[1.0, 0, 0, 0]], **f64).repeat(W, 1),
        t=torch.as_tensor(rng.normal(size=(W, 3)) * 0.3, **f64),
        pts=torch.as_tensor(rng.uniform(-6, 6, size=(W, P, 3)) * [1, 1, 0.05], **f64),
        mask=torch.ones((W, P), dtype=torch.bool, device=card),
        valid=torch.ones((W,), dtype=torch.bool, device=card))
    dx = torch.as_tensor(rng.normal(size=(W, 6)) * 0.01, **f64)
    cs = torch.tensor(1.0, **f64)
    cost = [ba._window_cost(dx, win, cs, 16384, 6) for _ in range(2)]
    assert torch.equal(cost[0], cost[1]) and float(cost[0]) > 0
    cloud = win.pts[0] + torch.as_tensor(rng.normal(size=(P, 3)) * 0.01, **f64)
    models = [posegraph._plane_model(cloud, win.mask[0], cs, 8192, 4) for _ in range(2)]
    for a, b in zip(*models):
        assert torch.equal(a[models[0][2]], b[models[0][2]])
    assert bool(models[0][2].any())


def _spline(n_ctrl, dev, cap=64, start=0.37):
    xi = torch.tensor([0.2, -0.1, 0.3, 1.0, 0.5, -0.2], dtype=torch.float32, device=dev)
    ts = torch.arange(n_ctrl, dtype=torch.float32, device=dev) * 0.01
    Ts = se3.exp_se3(ts[:, None] * xi[None])
    return spl.feed_trajectory(ts + start, so3.mat_to_quat(Ts[:, :3, :3]),
                               Ts[:, :3, 3].contiguous(),
                               torch.ones(n_ctrl, dtype=torch.bool, device=dev), cap=cap)


def _deskew_args(L, N, C, num_valid, times, dev):
    """Seeded points of L LiDARs around a spline of C control points
    (num_valid of them valid), with times drawn as `times` says:
    'spread' over the window and beyond both ends, 'first' near the first
    interval, 'grid' exactly on t0 + k dt, 'nan' spread with every 7th
    time NaN."""
    rng = np.random.default_rng(L * 100003 + N)
    sp = _spline(min(C, 40), dev, cap=C)
    if num_valid is not None:
        sp = sp._replace(num_valid=torch.tensor(num_valid, dtype=torch.int32, device=dev))
    t0 = np.float32(sp.t0.item())
    span = int(sp.num_valid.item()) * 0.01
    if times == "first":
        t = t0 + rng.uniform(0.0, 0.03, size=(L, N))
    elif times == "grid":
        k = rng.integers(-2, int(sp.num_valid.item()) + 2, size=(L, N)).astype(np.float32)
        t = t0 + k * np.float32(0.01)
    else:
        t = t0 + rng.uniform(-0.05, span + 0.05, size=(L, N))
    if times == "nan":
        t.reshape(-1)[::7] = np.nan
    pts = np.concatenate([rng.normal(size=(L, N, 3)) * 10, t[..., None]], -1).astype(np.float32)
    small = lambda s: torch.as_tensor(rng.normal(size=(L, 3)) * s, dtype=torch.float32,
                                      device=dev)
    return (torch.as_tensor(pts, device=dev), sp, so3.exp_so3(small(0.2)), small(0.5),
            so3.exp_so3(small(0.1)), small(1.0))


def _f64(args):
    return tree.map_tensors(lambda t: t.double() if t.is_floating_point() else t, args)


_DESKEW_CASES = [
    (2, 777, 64, None, "spread"),  # ragged end, two LiDARs in a warp
    (3, 256, 64, 3, "spread"),  # num_valid 3: no point is ok
    (3, 300, 64, 4, "first"),  # num_valid 4: one interval is ok
    (1, 1, 64, None, "spread"),
    (3, 4097, 64, None, "spread"),  # the path's L, one past its N
    (32, 33, 64, None, "spread"),  # the LiDAR cap
    (2, 500, 64, None, "grid"),  # times exactly on t0 + k dt
    (2, 500, 64, None, "nan"),  # NaN times: unchanged, not ok
    (2, 40001, 96, None, "spread"),  # ragged, above the three-lane point count
    (3, 65536, 96, None, "spread"),  # 3 LiDARs at the Config default capacity
    (3, 1024, 64, None, "spread"),  # the soak's raw points
]


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("L,N,C,num_valid,times", _DESKEW_CASES)
def test_deskew_kernel_matches_plain(card, L, N, C, num_valid, times, lanes):
    args = _deskew_args(L, N, C, num_valid, times, card)
    before = deskew.deskew_points.launches
    got = deskew._launch(*args, lanes=lanes)
    want = deskew.deskew_points_plain(*args)
    torch.cuda.synchronize()
    assert deskew.deskew_points.launches == before + 1
    assert torch.equal(got[..., 3], want[..., 3])
    # held to the exact deskew, the plain version run in f64 (two f32
    # results lie up to ~5 ulp apart 35 m out)
    exact = deskew.deskew_points_plain(*_f64(args))
    same = want[..., 3] == exact[..., 3]
    assert float((got[..., :3].double() - exact[..., :3])[same].abs().max()) <= 2e-5
    ok = want[..., 3] == 1
    if num_valid == 3:
        assert not ok.any()
    elif times == "first":
        rel = (args[0][..., 3] - args[1].t0) / torch.tensor(spl.CONTROL_DT, device=card)
        assert ok.any() and bool((torch.floor(rel[ok]) == 1).all())
    elif L * N > 100:
        assert ok.any() and not ok.all()
    # a point outside the window comes back as it went in
    assert torch.equal(got[..., :3][~ok], args[0][..., :3][~ok])
    if times == "nan":
        assert not ok.reshape(-1)[::7].any()


@pytest.mark.parametrize("L,N", [(3, 4096), (1, 65536), (2, 40001), (3, 65536)])
def test_deskew_wrapper_picks_the_layout_by_point_count(card, L, N):
    args = _deskew_args(L, N, 96, None, "spread", card)
    lanes = 3 if L * N <= deskew.THREE_LANES_MAX_POINTS else 1
    assert deskew.lanes_for(L * N) == lanes
    before = dict(deskew.deskew_points.launches_by_shape)
    got = deskew.deskew_points(*args)
    want = deskew._launch(*args, lanes=lanes)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    after = deskew.deskew_points.launches_by_shape
    assert after[1, L, N, 96] == before.get((1, L, N, 96), 0) + 2


def test_deskew_wrapper_refuses_what_the_kernel_does_not_take(card):
    before = deskew.deskew_points.launches
    many = _deskew_args(33, 8, 64, None, "spread", card)  # MAX_LIDARS is 32
    long = _deskew_args(2, 8, 513, None, "spread", card)  # MAX_CONTROL_POINTS is 512
    small = _deskew_args(2, 8, 64, None, "spread", card)
    for args in (many, long):
        with pytest.raises(ValueError):
            deskew.deskew_points(*args)
        for lanes in (1, 3):
            with pytest.raises(ValueError):
                deskew._launch(*args, lanes=lanes)
    with pytest.raises(ValueError):
        deskew._launch(*small, lanes=2)
    with pytest.raises(ValueError):
        deskew.deskew_points(small[0].double(), *small[1:])
    assert deskew.deskew_points.launches == before


def _deskew_batch(L, N, dev):
    """Four sequences of L LiDARs x N points, each its own points, frames
    and spline: the full window, no ok interval (num_valid 3), one ok
    interval (num_valid 4) with its time origin moved, and every time NaN."""
    from malio_tpu_torch import tree

    seqs = []
    for b, (num_valid, times) in enumerate(((None, "spread"), (3, "spread"), (4, "first"),
                                             (None, "nan"))):
        pts, sp, *frames = _deskew_args(L, N, 64, num_valid, times, dev)
        if b == 3:
            pts[..., 3] = float("nan")
        seqs.append((pts, sp._replace(t0=sp.t0 + 0.0025 * b), *frames))
    return tree.stack(seqs), seqs


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("L,N", [(3, 4096), (2, 777), (1, 41)])
def test_deskew_batch_equals_each_sequence(card, L, N, lanes):
    """One launch over a batch gives every sequence what its own launch
    gives it, bit for bit, and the plain version's result in f64 within
    atol 2e-5 with the f32 plain version's ok flags; ragged N puts warp
    and block ends inside a sequence (a block never straddles two)."""
    batch, seqs = _deskew_batch(L, N, card)
    before = deskew.deskew_points.launches
    got = deskew._launch(*batch, lanes=lanes)
    want = deskew.deskew_points_plain(*batch)
    torch.cuda.synchronize()
    assert deskew.deskew_points.launches == before + 1
    for b, args in enumerate(seqs):
        assert torch.equal(got[b], deskew._launch(*args, lanes=lanes)), b
    assert torch.equal(got[..., 3], want[..., 3])
    exact = deskew.deskew_points_plain(*_f64(batch))
    same = want[..., 3] == exact[..., 3]
    assert float((got[..., :3].double() - exact[..., :3])[same].abs().max()) <= 2e-5
    ok = want[..., 3] == 1
    assert ok[0].any() and not ok[1].any() and not ok[3].any()
    assert torch.equal(got[3, ..., :3], batch[0][3, ..., :3])  # NaN times: unchanged


def test_deskew_wrapper_counts_batched_shapes(card):
    batch, _ = _deskew_batch(3, 4096, card)
    before = dict(deskew.deskew_points.launches_by_shape)
    deskew.deskew_points(*batch)
    torch.cuda.synchronize()
    after = deskew.deskew_points.launches_by_shape
    assert after[4, 3, 4096, 64] == before.get((4, 3, 4096, 64), 0) + 1
    assert deskew.lanes_for(4 * 3 * 4096) == 1  # 49,152 points: past THREE_LANES_MAX_POINTS


@pytest.mark.parametrize("L,N,mp", [(1, 65536, 2), (3, 4096, 2), (2, 40000, 4)])
def test_deskew_slice_keeps_the_whole_sets_bits(card, L, N, mp):
    """An mp rank's contiguous slice of the raw point axis, deskewed in the
    layout of the whole set (`layout_points`), gets the bits of the whole
    set's launch. The two layouts differ in the last bits of some points,
    and at L = 1, N = 65,536 over mp = 2 (and L = 2, N = 40,000 over
    mp = 4) the slice alone would take three lanes a point where the
    whole set takes one."""
    args = _deskew_args(L, N, 96, None, "spread", card)
    whole = deskew.deskew_points(*args)
    n = N // mp
    for j in range(mp):
        part = deskew.deskew_points(args[0][:, j * n : (j + 1) * n].contiguous(), *args[1:],
                                    layout_points=L * N)
        assert torch.equal(part, whole[:, j * n : (j + 1) * n]), j
    if L * N > deskew.THREE_LANES_MAX_POINTS:
        assert (deskew.lanes_for(L * N), deskew.lanes_for(L * n)) == (1, 3)


def _batched_map(B, dev, seed=11):
    rng = np.random.default_rng(seed)
    maps = []
    for b in range(B):
        pts = torch.as_tensor(rng.uniform(-8, 8, size=(3000, 3)).astype(np.float32), device=dev)
        covs = torch.as_tensor(rng.uniform(0.01, 0.2, size=3000).astype(np.float32), device=dev)
        maps.append(vh.insert(vh.create(1 << 12, 0.5, torch.float32, dev), pts, covs,
                              torch.ones(3000, dtype=torch.bool, device=dev)))
    from malio_tpu_torch import tree

    return tree.stack(maps), rng


def test_knn_window_batch_reaches_the_last_row(card):
    """A batch of tables as one flat (B R) table, windows with rows offset
    by b R and some reaching the last sequence's last row: bit-equal to
    the plain version at K = 16 and 5."""
    B = 3
    m, rng = _batched_map(B, card)
    R = m.tab.shape[1]
    m.tab[-1, -1, :, 0] = 7.0  # the last row of the last table: every slot occupied
    m.tab[-1, -1, :, 1:4] = torch.as_tensor(rng.uniform(-1, 1, size=(32, 3)).astype(np.float32),
                                            device=card)
    m.tab[-1, -1, :, 4] = 0.05
    qs = torch.as_tensor(rng.uniform(-8, 8, size=(B, 500, 3)).astype(np.float32), device=card)
    local, alive = vh._window_rows(m, qs, 1)
    local[-1, ::7, 0] = R - 1
    alive[-1, ::7, 0] = True
    tab, rows = vh._batch_rows(m, local)
    assert int(rows.max()) == B * R - 1
    V = rows.shape[-1]
    args = (tab, qs.reshape(-1, 3), rows.reshape(-1, V).contiguous(), alive.reshape(-1, V).contiguous())
    for K in (16, 5):
        got = knn.knn_window(*args, K)
        want = knn.knn_window_plain(*args, K)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert bool((want[2][-500:][::7, 0] < 3.0e38).all())


def test_knn_cached_batch_kernel_equals_plain(card):
    m, rng = _batched_map(3, card, seed=12)
    qs = torch.as_tensor(np.concatenate([rng.uniform(-8, 8, size=(3, 500, 3)),
                                         rng.uniform(12, 20, size=(3, 300, 3))], 1)
                         .astype(np.float32), device=card)
    kw = dict(radius=1, wide_radius=5, wide_budget=512, cache_k=16)
    before = dict(knn.knn_window.launches_by_shape)
    got = vh.knn_cached(m, qs, use_kernel=True, **kw)
    want = vh.knn_cached(m, qs, use_kernel=False, **kw)
    after = knn.knn_window.launches_by_shape
    assert after.get((2400, 8, 16), 0) == before.get((2400, 8, 16), 0) + 1, after
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _merge_case(T, rows, dtype, seed, dev):
    rng = np.random.default_rng(seed)
    tab = torch.as_tensor(rng.normal(size=(T, 5)), dtype=dtype, device=dev)
    idx = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
    rec = torch.as_tensor(rng.normal(size=(len(rows), 5)), dtype=dtype, device=dev)
    return tab, idx, rec


def _merge_rows_cases(T, rng):
    mixed = np.concatenate([rng.choice(T, T // 3, replace=False), [-1, -1, -7], [T, T + 5]])
    rng.shuffle(mixed)
    inner = rng.choice(np.arange(1, T - 1), min(T - 2, 300), replace=False) if T > 2 else []
    return {
        "first_last": np.concatenate([[T - 1], inner, [0]]) if T > 1 else np.zeros(1, np.int64),
        "unsorted_invalid": mixed,
        "all_invalid": np.array([-1, T, 2 * T, -3]),
        "none": np.zeros(0, np.int64),
        "every_row": rng.permutation(T),
    }


@pytest.mark.parametrize("T", [1, 7, 1001, 4096, 1 << 21])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_merge_rows_kernel_bit_equal_to_plain(card, T, dtype):
    rng = np.random.default_rng(T)
    for name, rows in _merge_rows_cases(T, rng).items():
        tab, idx, rec = _merge_case(T, rows, dtype, T + len(rows), card)
        before = merge.merge_rows.launches_by_shape.get((T, len(rows)), 0)
        got = merge.merge_rows(tab, idx, rec)
        want = merge.merge_rows_plain(tab, idx, rec)
        ok = (idx >= 0) & (idx < T)
        lib = tab.index_copy(0, idx[ok], rec[ok])
        torch.cuda.synchronize()
        assert got.data_ptr() != tab.data_ptr(), name
        assert torch.equal(got, want), name
        assert torch.equal(got, lib), name
        assert merge.merge_rows.launches_by_shape[T, len(rows)] == before + 1


@pytest.mark.parametrize("n_valid", [0, 611, 3072])
def test_merge_rows_kernel_at_the_soak_insert(card, n_valid):
    tab, idx, rec = chip_smoke.merge_path_inputs(1 << 19, 3072, n_valid, seed=n_valid)
    got = merge.merge_rows(tab, idx, rec)
    ok = idx >= 0
    lib = tab.index_copy(0, idx[ok], rec[ok])
    torch.cuda.synchronize()
    assert torch.equal(got, merge.merge_rows_plain(tab, idx, rec))
    assert torch.equal(got, lib)


def _tile_case(kind, W, tw, rng):
    """(T, rows) of a tile-edge case for rows of W words and tiles of tw
    words: `edges_*` update the first and the last row of every tile and
    their neighbours (with W = 5 or 10 a row straddles two tiles) in a table
    one row under, at or over 40 tiles; `one_tile` updates rows wholly
    inside tile 1; the others a table of 40.5 tiles."""
    two, big = 40 * tw // W, 81 * tw // (2 * W)
    T = {"edges_under": two - 1, "edges_at": two, "edges_over": two + 1}.get(kind, big)
    if kind.startswith("edges"):
        return T, chip_smoke.merge_tile_edges(T, W, tw, rng)
    if kind == "one_tile":
        return T, rng.permutation(np.arange(tw // W + 1, 2 * tw // W - 1))[::2]
    if kind == "every_row":
        return T, rng.permutation(T)
    return T, np.where(rng.random(T) < 0.5, -1, T + rng.integers(0, T, T))  # every_dead


@pytest.mark.parametrize("kind", ["edges_under", "edges_at", "edges_over", "one_tile",
                                  "every_row", "every_dead"])
@pytest.mark.parametrize("W, dtype", [(4, torch.float32), (5, torch.float32),
                                      (5, torch.float64)])
def test_merge_rows_kernel_at_tile_edges(card, kind, W, dtype):
    words = W * torch.finfo(dtype).bits // 32  # 4-byte words a row
    tw = merge.tile_words(1)
    rng = np.random.default_rng(W + len(kind))
    T, rows = _tile_case(kind, words, tw, rng)
    g = np.random.default_rng(T)
    tab = torch.as_tensor(g.normal(size=(T, W)), dtype=dtype, device=card)
    idx = torch.as_tensor(np.asarray(rows, np.int64), device=card)
    rec = torch.as_tensor(g.normal(size=(len(rows), W)), dtype=dtype, device=card)
    got = merge.merge_rows(tab, idx, rec)
    ok = (idx >= 0) & (idx < T)
    lib = tab.index_copy(0, idx[ok], rec[ok])
    torch.cuda.synchronize()
    assert torch.equal(got, merge.merge_rows_plain(tab, idx, rec))
    assert torch.equal(got, lib)


def test_merge_rows_back_to_back_calls(card):
    """1,000 calls in turns at two shapes (43 and 4 tiles, f32 and f64),
    100 at a time with no other launch between them, each with new records:
    every result bit-equal to the plain version (stale flags or tickets
    from the call before would write an update before its copy)."""
    rng = np.random.default_rng(7)
    shapes = []
    for T, N, dtype in ((70_001, 4096, torch.float32), (3000, 1000, torch.float64)):
        rows = np.concatenate([rng.choice(T, N - 96, replace=False), np.full(96, -1)])
        rng.shuffle(rows)
        shapes.append((torch.as_tensor(rng.normal(size=(T, 5)), dtype=dtype, device=card),
                       torch.as_tensor(rows, device=card),
                       torch.as_tensor(rng.normal(size=(N, 5)), dtype=dtype, device=card)))
    for group in range(10):
        recs = [shapes[i % 2][2] + (100 * group + i) for i in range(100)]
        outs = [merge.merge_rows(shapes[i % 2][0], shapes[i % 2][1], recs[i])
                for i in range(100)]
        for i, out in enumerate(outs):
            tab, idx, _ = shapes[i % 2]
            assert torch.equal(out, merge.merge_rows_plain(tab, idx, recs[i])), (group, i)


def test_merge_rows_replays_in_a_cuda_graph(card):
    """merge_rows captured on static buffers, replayed three times with
    new tables, targets and records copied in (an eager call between
    replays): each replay bit-equal to merge_rows_plain on its inputs."""
    T, N = 50_000, 3000
    rng = np.random.default_rng(11)

    def inputs():
        rows = np.concatenate([rng.choice(T, N - 200, replace=False), np.full(100, -1),
                               T + np.arange(100)])
        rng.shuffle(rows)
        return (torch.as_tensor(rng.normal(size=(T, 5)), dtype=torch.float32, device=card),
                torch.as_tensor(rows, device=card),
                torch.as_tensor(rng.normal(size=(N, 5)), dtype=torch.float32, device=card))

    tab, idx, rec = inputs()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as CUDA graphs ask
        for _ in range(3):
            merge.merge_rows(tab, idx, rec)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = merge.merge_rows(tab, idx, rec)
    for r in range(3):
        for dst, src in zip((tab, idx, rec), inputs()):
            dst.copy_(src)
        graph.replay()
        want = merge.merge_rows_plain(tab, idx, rec)
        eager = merge.merge_rows(tab, idx, rec)
        torch.cuda.synchronize()
        assert torch.equal(out, want), r
        assert torch.equal(eager, want), r


def test_insert_through_merge_kernel_equals_plain(card, monkeypatch):
    """A map whose rows fill (drops), then new voxels with low covariances
    (evictions): the insert through the kernel and through
    merge_rows_plain give the same table and counters."""
    rng = np.random.default_rng(21)
    batches = [(rng.uniform(-2, 2, size=(4000, 3)), rng.uniform(0.01, 0.2, size=4000)),
                (rng.uniform(5, 9, size=(40, 3)), np.full(40, 0.001))]
    args = [tuple(torch.as_tensor(a.astype(np.float32), device=card) for a in b) for b in batches]

    def fill():
        m = vh.create(1 << 10, 0.25, torch.float32, card)
        for p, c in args:
            m = vh.insert(m, p, c, torch.ones(c.shape, dtype=torch.bool, device=card))
        return m

    got = fill()
    monkeypatch.setattr(merge, "merge_rows", merge.merge_rows_plain)
    want = fill()
    assert torch.equal(got.tab, want.tab)
    assert int(got.n_evicted) == int(want.n_evicted) > 0
    assert int(got.n_dropped) == int(want.n_dropped) > 0


def test_merge_rows_refuses_what_the_kernel_does_not_take(card):
    tab, idx, rec = _merge_case(64, [3, 9], torch.float32, 0, card)
    with pytest.raises(ValueError):
        merge.merge_rows(tab.t(), idx, rec)  # not contiguous
    with pytest.raises(ValueError):
        merge.merge_rows(tab, idx.to(torch.int32), rec)
    with pytest.raises(ValueError):
        merge.merge_rows(tab, idx, rec.double())
    with pytest.raises(ValueError):
        merge.merge_rows(tab, idx.cpu(), rec)
    with pytest.raises(ValueError):
        merge.merge_rows(tab.to(torch.float16)[:, :3].contiguous(), idx,
                         rec.to(torch.float16)[:, :3].contiguous())  # 6-byte rows


def _card_rounds(dev, B, n=4):
    """A small flagship config (256 points a LiDAR, 2^15 map slots), the
    carry of B sequences (seeds 0 ..) at their first fused round and
    their next n groups stacked (n, B, ...) on the card; one sequence
    without the batch axis for B = 1."""
    from malio_tpu_torch import batched
    from malio_tpu_torch.config import flagship_config

    cfg = flagship_config(points_per_lidar=256, map_slots=1 << 15)
    seqs = [chip_smoke.flagship_groups(cfg, 2.0, seed) for seed in range(B)]
    carry, chunks, _ = batched._prepare(cfg, seqs, torch.float32, n, dev)
    groups = chunks[0][0]
    if B == 1:
        return cfg, tree.squeeze(carry), tree.map_tensors(lambda a: a[:, 0], groups)
    return cfg, carry, groups


def _bit_equal(got, want, what):
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=str(what))


@pytest.mark.parametrize("B", [1, 2])
def test_compiled_round_replays_the_eager_round(card, B):
    """Four rounds through step (the graph captured at the first) and
    through one scan_steps chunk, each bit-equal to four step_eager rounds
    in every carry and output field; the replays count the launches the
    capture recorded, each kernel's at least once a round."""
    cfg, carry, groups = _card_rounds(card, B)
    c_e, c_g, outs = carry, carry, []
    for k in range(4):
        g = tree.index(groups, k)
        c_e, o_e = pipeline.step_eager(cfg, c_e, g, device=card)
        c_g, o_g = pipeline.step(cfg, c_g, g, device=card)
        _bit_equal((c_g, o_g), (c_e, o_e), f"round {k}")
        outs.append(o_e)
    ops.reset_launches()
    c_s, o_s = pipeline.scan_steps(cfg, carry, groups, device=card)
    _bit_equal((c_s, o_s), (c_e, tree.stack(outs)), "scan_steps")
    batched = (carry, groups) if B > 1 else (tree.unsqueeze(carry), tree.map_tensors(
        lambda a: a[:, None], groups))
    cr = pipeline._compiled_round(cfg, batched[0], tree.index(batched[1], 0))
    assert cr.replays >= 8 and cr.nodes
    for name in ("knn_window", "deskew", "merge_rows"):  # the round's kernels
        fn = ops.wrappers()[name]
        per_round = cr.launches[name]
        assert sum(per_round.values()) >= 1, name
        assert fn.launches_by_shape == {s: 4 * n for s, n in per_round.items()}, name


def test_an_old_carry_is_not_overwritten_by_later_replays(card):
    cfg, carry, groups = _card_rounds(card, 1)
    c1, o1 = pipeline.step(cfg, carry, tree.index(groups, 0), device=card)
    kept = tree.map_tensors(torch.clone, (carry, c1, o1))
    c = c1
    for k in range(1, 4):
        c, _ = pipeline.step(cfg, c, tree.index(groups, k), device=card)
    pipeline.scan_steps(cfg, carry, groups, device=card)
    torch.cuda.synchronize()
    _bit_equal((carry, c1, o1), kept, "a kept carry")


def _failed_capture_child():
    """In a process of its own (a failed capture leaves the process's CUDA
    libraries as they were mid-capture): a round whose map size is read on
    the host. The eager round runs; pipeline.step raises at the capture."""
    from malio_tpu_torch.map import voxel_hash as vh

    cfg, carry, groups = _card_rounds(torch.device("cuda"), 1)
    size = vh.size
    vh.size = lambda m, shard=None: size(m, shard) + 0 * int(size(m, shard).sum())
    pipeline.step_eager(cfg, carry, tree.index(groups, 0), device="cuda")
    try:
        pipeline.step(cfg, carry, tree.index(groups, 0), device="cuda")
    except RuntimeError as e:
        print(f"capture raised {type(e).__name__}: {str(e).splitlines()[0]}")
        return
    raise AssertionError("a round with a host read was captured")


def test_a_failed_capture_raises(card):
    here = pathlib.Path(__file__).resolve().parent
    code = (f"import sys; sys.path[:0] = [{str(here)!r}, {str(here.parent)!r}]; "
            "import test_torch_cuda as t; t._failed_capture_child()")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "capture raised" in r.stdout


def test_a_compiled_round_makes_no_host_sync(card):
    cfg, carry, groups = _card_rounds(card, 2)
    c, _ = pipeline.step(cfg, carry, tree.index(groups, 0), device=card)  # the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        c, _ = pipeline.step(cfg, c, tree.index(groups, 1), device=card)
        pipeline.scan_steps(cfg, c, groups, device=card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


# ---- the back end's programs as captured graphs, and the block-tridiagonal
# kernel ----


def _pose_graph(dev, K=48, n=32, seed=0):
    """The 48-node scene of tests/test_torch_backend.py built with the
    port's own code: 32 nodes on a circle with drifted positions, 16 inert,
    an odometry chain and three loop edges. Returns (q, t, odo, loops,
    all edges) on dev, f64."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    t_gt = np.stack([5 * np.cos(th), 5 * np.sin(th), 0.1 * np.sin(3 * th)], -1)
    q_gt = np.stack([np.cos(th / 2), np.zeros(n), np.zeros(n), np.sin(th / 2)], -1)
    t_est = np.zeros((K, 3))
    q_est = np.tile([1.0, 0, 0, 0], (K, 1))
    t_est[:n] = t_gt + np.cumsum(rng.normal(size=(n, 3)) * 0.02, axis=0)
    q_est[:n] = q_gt

    def rel(i, j):
        zq, zt = posegraph.relative_pose(*(torch.as_tensor(a) for a in
                                           (q_gt[i], t_gt[i], q_gt[j], t_gt[j])))
        return zq.numpy(), zt.numpy()

    odo = [(i, i + 1, *rel(i, i + 1), 1.0, "odo") for i in range(n - 1)]
    loops = [(i, j, *rel(i, j), 3.0, "loop") for (i, j) in [(0, n // 2), (3, n - 2), (1, n // 3)]]
    pack = posegraph.PoseGraphBackend(capacity=K, cloud_points=1, device=dev)._pack_edges
    f64 = dict(dtype=torch.float64, device=dev)
    return (torch.as_tensor(q_est, **f64), torch.as_tensor(t_est, **f64), pack(odo, K - 1),
            pack(loops, 8), pack(odo + loops, K + 8))


def _planes(rng, n):
    """n points on a floor, two walls and a slanted face, with 5 mm noise."""
    u = rng.uniform(-6, 6, size=(n, 2))
    face = rng.integers(0, 4, n)
    p = np.zeros((n, 3))
    p[face == 0] = np.c_[u[face == 0], np.zeros((face == 0).sum())]
    p[face == 1] = np.c_[np.full((face == 1).sum(), 6.0), u[face == 1]]
    p[face == 2] = np.c_[u[face == 2, 0], np.full((face == 2).sum(), -5.0), u[face == 2, 1] + 6]
    p[face == 3] = np.c_[u[face == 3], 0.5 * u[face == 3, 0] + 8.0]
    return p + rng.normal(size=p.shape) * 0.005


def _icp_scene(dev, P=1200, seed=3):
    """Two keyframes 0.6 m and 0.1 rad apart seeing one planar scene, and a
    guess of the second 0.15 m and 0.03 rad off."""
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device=dev)
    qi, ti = torch.tensor([1.0, 0, 0, 0], **f64), torch.zeros(3, **f64)
    qj = so3.quat_normalize(torch.tensor([np.cos(0.05), 0, 0, np.sin(0.05)], **f64))
    tj = torch.tensor([0.6, 0.2, 0.0], **f64)
    ci = torch.as_tensor(_planes(rng, P), **f64)
    cj = so3.quat_rotate_inv(qj, torch.as_tensor(_planes(rng, P), **f64) - tj)
    mask = torch.ones(P, dtype=torch.bool, device=dev)
    mask[::11] = False
    qj_bad = so3.boxplus(qj, torch.tensor([0.0, 0.0, 0.03], **f64))
    tj_bad = tj + torch.tensor([0.15, -0.1, 0.05], **f64)
    return qi, ti, ci, mask, qj_bad, tj_bad, cj, mask


def _bundle_window(dev, W=4, P=400, seed=11):
    """A window of W keyframes seeing one planar scene from poses 1 m
    apart, the poses after the first perturbed."""
    rng = np.random.default_rng(seed)
    q = np.tile([1.0, 0, 0, 0], (W, 1))
    t = np.stack([np.arange(W) * 1.0, np.zeros(W), np.zeros(W)], -1)
    pts = np.stack([_planes(rng, P) - t[w] for w in range(W)])
    d = np.concatenate([rng.normal(size=(W, 3)) * 0.01, rng.normal(size=(W, 3)) * 0.03], -1)
    d[0] = 0
    qt = so3.boxplus(torch.as_tensor(q), torch.as_tensor(d[:, :3]))
    f64 = dict(dtype=torch.float64, device=dev)
    return ba.KeyframeWindow(q=qt.to(**f64), t=torch.as_tensor(t + d[:, 3:], **f64),
                             pts=torch.as_tensor(pts, **f64),
                             mask=torch.ones((W, P), dtype=torch.bool, device=dev),
                             valid=torch.ones(W, dtype=torch.bool, device=dev))


def _program(name, dev):
    """(public function, its _eager version, args, kwargs) of a back-end
    program on a small scene."""
    if name in ("optimize", "optimize_sparse"):
        q, t, odo, loops, edges = _pose_graph(dev)
        if name == "optimize":
            return posegraph.optimize, posegraph.optimize_eager, (q, t, edges), dict(iters=5)
        return (posegraph.optimize_sparse, posegraph.optimize_sparse_eager, (q, t, odo, loops),
                dict(iters=5))
    if name == "icp_point_to_plane":
        qi, ti, ci, mi, qj, tj, cj, mj = _icp_scene(dev)
        zq0, zt0 = posegraph.relative_pose(qi, ti, qj, tj)
        return (posegraph.icp_point_to_plane, posegraph.icp_point_to_plane_eager,
                (ci, mi, cj, mj, zq0, zt0), dict(cell_size=1.5, iters=6))
    if name == "refine_loop_edge":
        return (posegraph.refine_loop_edge, posegraph.refine_loop_edge_eager, _icp_scene(dev),
                dict(cell_size=1.5, iters=6))
    return (ba.optimize_window, ba.optimize_window_eager, (_bundle_window(dev),),
            dict(cell_size=2.0, num_cells=8192, min_pts=8, iters=3))


PROGRAMS = ["optimize", "optimize_sparse", "icp_point_to_plane", "refine_loop_edge",
            "optimize_window"]


@pytest.mark.parametrize("name", PROGRAMS)
def test_back_end_program_replays_its_eager_version(card, name):
    """The public function on the card replays a capture, bit-equal to the
    _eager version op by op; a second call reuses the capture (no new
    entry in graph.captures(), its replays grow)."""
    from malio_tpu_torch import graph

    fn, eager, args, kw = _program(name, card)
    want = eager(*args, **kw)
    got = fn(*args, **kw)
    n = len(graph.captures())
    replays = sum(cr.replays for _, cr in graph.captures())
    again = fn(*args, **kw)
    assert len(graph.captures()) == n
    assert sum(cr.replays for _, cr in graph.captures()) > replays
    _bit_equal(got, want, f"{name}: graph against eager")
    _bit_equal(again, want, f"{name}: a second replay")
    if name == "optimize_sparse":
        key, cr = [(k, c) for k, c in graph.captures("optimize_sparse")][-1]
        assert cr.launches["block_tridiag"] == {(48, 1 + 6 * 8): 1}


@pytest.mark.parametrize("name", PROGRAMS)
def test_back_end_replay_makes_no_host_sync(card, name):
    fn, _, args, kw = _program(name, card)
    fn(*args, **kw)  # the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _failed_back_end_capture_child():
    """In a process of its own: ICP whose 6x6 solve checks its status on
    the host (torch.linalg.solve). The eager version runs; the capture
    raises."""
    posegraph._solve = lambda A, b: torch.linalg.solve(A, b)
    fn, eager, args, kw = _program("icp_point_to_plane", torch.device("cuda"))
    eager(*args, **kw)
    try:
        fn(*args, **kw)
    except RuntimeError as e:
        print(f"capture raised {type(e).__name__}: {str(e).splitlines()[0]}")
        return
    raise AssertionError("a program with a host read was captured")


def test_a_failed_back_end_capture_raises(card):
    here = pathlib.Path(__file__).resolve().parent
    code = (f"import sys; sys.path[:0] = [{str(here)!r}, {str(here.parent)!r}]; "
            "import test_torch_cuda as t; t._failed_back_end_capture_child()")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "capture raised" in r.stdout


@pytest.mark.parametrize("K,r", [(64, 385), (2048, 193)])
def test_block_tridiag_kernel_matches_plain(card, K, r):
    """Column by column within 1e-9 of the plain column's largest entry,
    and a residual |T Y - RHS| within 4x the plain version's, on a seeded
    system of optimize_sparse's structure (chip_smoke.tridiag_inputs);
    one launch counted at (K, r)."""
    from malio_tpu_torch.ops import block_tridiag as bt

    args = [torch.as_tensor(a, device=card) for a in chip_smoke.tridiag_inputs(K, r, seed=K)]
    ops.reset_launches()
    chk = chip_smoke.tridiag_check(*args)
    assert bt.block_tridiag_solve.launches_by_shape == {(K, r): 1}
    assert chk["finite"] and chk["rel_colwise"] <= chip_smoke.TRIDIAG_REL, chk
    assert chk["residual"] <= chip_smoke.TRIDIAG_RESIDUAL_X * chk["residual_plain"], chk


def test_block_tridiag_refuses_what_the_kernel_does_not_take(card):
    from malio_tpu_torch.ops import block_tridiag as bt

    D, Boff, RHS = (torch.as_tensor(a, device=card) for a in chip_smoke.tridiag_inputs(8, 5))
    with pytest.raises(ValueError, match="f64"):
        bt.block_tridiag_solve(D.float(), Boff.float(), RHS.float())
    with pytest.raises(ValueError, match="one CUDA device"):
        bt.block_tridiag_solve(D, Boff.cpu(), RHS)
    with pytest.raises(ValueError, match="K-1"):
        bt.block_tridiag_solve(D, Boff[:-1], RHS)
    # non-contiguous inputs are made contiguous
    Y = bt.block_tridiag_solve(D, Boff, RHS.transpose(0, 2).contiguous().transpose(0, 2))
    torch.testing.assert_close(Y, bt.block_tridiag_solve(D, Boff, RHS), rtol=0, atol=0)


# ---- the mp round over NCCL, a card a rank: one CUDA graph with the
# collectives inside ----

NCCL_ROUNDS = 6
NCCL_DEADLINE_S = 300
NCCL_MESHES = {"dp1_mp2": (1, 2), "dp2_mp2": (2, 2)}


def _cards(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices (NCCL takes one rank a card)")


@pytest.fixture(scope="module")
def nccl_inputs(tmp_path_factory):
    """Two small flagship sequences (dist_worlds.small_config), seeds 0 and
    1, NCCL_ROUNDS rounds each, as the sharding worker reads them."""
    _cards(2)
    import dist_worlds

    d = tmp_path_factory.mktemp("nccl")
    dist_worlds.make_inputs(d / "in.npz", seeds=(0, 1), rounds=NCCL_ROUNDS)
    return d


def _world(d, name, dp, mp, eager):
    """The sharding worker on nccl_inputs in dp x mp processes, a card each:
    (outputs, final carry as numpy, every rank's stats)."""
    import dist_worlds
    from malio_tpu_torch import interop
    from malio_tpu_torch.distributed import sharding

    cfg = dist_worlds.small_config()
    stats = sharding.run_local(d / "in.npz", d / f"{name}.npz", dp * mp, mp,
                               deadline_s=NCCL_DEADLINE_S, eager=eager)
    outs, carry = sharding.load_outputs(d / f"{name}.npz",
                                        sharding.carry_template(cfg, 2, torch.float32))
    return outs, interop.carry_to_numpy(carry), stats


@pytest.mark.parametrize("mesh", list(NCCL_MESHES))
def test_mp_round_over_nccl_replays_the_eager_round(nccl_inputs, mesh):
    """The sharding worker over NCCL through the captured round and through
    the eager round: every output and the final carry bit-equal on every
    rank; each rank's replay holds the three kernels (the k-NN at the base
    window and the wide tier) and its collectives, and a steady replay
    made no host sync (the worker's set_sync_debug_mode("error") round)."""
    dp, mp = NCCL_MESHES[mesh]
    _cards(dp * mp)
    graph = _world(nccl_inputs, f"{mesh}_graph", dp, mp, eager=False)
    eager = _world(nccl_inputs, f"{mesh}_eager", dp, mp, eager=True)
    for f, v in eager[0].items():
        np.testing.assert_array_equal(graph[0][f], v, err_msg=f)
    for a, b in zip(tree.leaves(graph[1]), tree.leaves(eager[1])):
        np.testing.assert_array_equal(a, b)
    for s in graph[2]:
        assert s["backend"] == "nccl" and s["path"] == "graph" and s["sync_check"], s
        c = s["compiled"]
        per_replay = {k: sum(v.values()) for k, v in c["launches"].items()}
        assert per_replay["knn_window"] == 2 and per_replay["deskew"] == 1, c
        assert per_replay["merge_rows"] == 1 and c["collectives"]["calls"] > 0, c
        for name in ("knn_window", "deskew", "merge_rows"):  # the warm-up round and the replays
            assert sum(s["launches"][name].values()) == (NCCL_ROUNDS + 1) * per_replay[name]
        assert s["collectives_per_round"][1:] == [c["collectives"]["calls"]] * (NCCL_ROUNDS - 1)
    for s in eager[2]:
        assert s["backend"] == "nccl" and s["path"] == "eager" and not s["sync_check"], s


def test_a_failed_mp_capture_fails_the_world(nccl_inputs, tmp_path):
    """Process 0's round reads the host (dist_worlds.failed_capture): its
    capture raises and the process exits; process 1, which captured and
    waits in a replay's collective, is killed with it, well within the
    deadline."""
    import dist_worlds

    runs, _, elapsed = dist_worlds.spawn(
        "failed_capture", 2, dict(dir=str(tmp_path), inputs=str(nccl_inputs / "in.npz")),
        backend="nccl", deadline_s=NCCL_DEADLINE_S)
    assert runs[0][0] != 0 and "capture" in runs[0][1].lower(), runs[0][1][-3000:]
    assert elapsed < NCCL_DEADLINE_S / 2, elapsed
