"""The CUDA kernels against their plain versions on the card, at edge shapes
the flagship path does not give them: windows of 1, 3, 8, 12 and 208 rows
(both launch geometries of the fused k-NN window kernel, the wide one
also at 12 rows, one or two a warp) with distance ties, windows with fewer
valid lanes than K (lane 0 valid, invalid and dead), all-invalid windows,
masked-off queries and duplicate rows. The deskew kernel in both layouts
(three lanes a point with the spline read through the cache, one lane with
it staged in shared memory) on ragged point counts whose warps hold points
of two LiDARs, 1 to 32 LiDARs, splines with no and with one valid
interval, times exactly on the control grid and NaN times, and 3 x 65,536
points; the layout the wrapper picks by point count; its refusals. k-NN is bit-equal; deskew
agrees within atol 2e-5 with equal ok flags (rotation matrices in the
kernel, quaternions in the plain version).

Every test needs a CUDA device and skips without one. On a machine with a
card (and without JAX, which the repo's conftest configures):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from malio_tpu_torch import spline as spl
from malio_tpu_torch.geometry import se3, so3
from malio_tpu_torch.map import voxel_hash as vh
from malio_tpu_torch.ops import deskew, knn

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


@pytest.mark.parametrize("Q,V,K", [(12, 1, 16), (37, 3, 5), (300, 8, 16), (40, 12, 16),
                                   (64, 208, 16)])
def test_knn_kernel_bit_equal_to_plain(card, Q, V, K):
    args = _window(Q, V, seed=V, dev=card)
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
    assert after.get((800, 8), 0) == before.get((800, 8), 0) + 1, after
    assert sum(after.values()) == sum(before.values()) + 2, after
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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
    assert float((got[..., :3] - want[..., :3]).abs().max()) <= 2e-5
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
    assert after[L, N, 96] == before.get((L, N, 96), 0) + 2


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
