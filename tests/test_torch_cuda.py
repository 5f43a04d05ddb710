"""The CUDA kernels against their plain versions on the card, at edge shapes
the flagship path does not give them: windows of 1, 3, 8, 12 and 208 rows
(both launch geometries of the fused k-NN window kernel, the wide one
also at 12 rows, one or two a warp) with distance ties, windows with fewer
valid lanes than K (lane 0 valid, invalid and dead), all-invalid windows,
masked-off queries and duplicate rows; a point count off the block size;
a spline with too few control points. k-NN is
bit-equal; deskew agrees within atol 2e-5 with equal ok flags (rotation
matrices in the kernel, quaternions in the plain version).

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


def _spline(n_ctrl, dev):
    xi = torch.tensor([0.2, -0.1, 0.3, 1.0, 0.5, -0.2], dtype=torch.float32, device=dev)
    ts = torch.arange(n_ctrl, dtype=torch.float32, device=dev) * 0.01
    Ts = se3.exp_se3(ts[:, None] * xi[None])
    return spl.feed_trajectory(ts, so3.mat_to_quat(Ts[:, :3, :3]), Ts[:, :3, 3].contiguous(),
                               torch.ones(n_ctrl, dtype=torch.bool, device=dev), cap=64)


@pytest.mark.parametrize("L,N,n_ctrl", [(2, 777, 40), (3, 256, 5), (1, 1, 40)])
def test_deskew_kernel_matches_plain(card, L, N, n_ctrl):
    rng = np.random.default_rng(N)
    sp = _spline(n_ctrl, card)
    pts = np.concatenate([rng.normal(size=(L, N, 3)) * 10,
                          rng.uniform(-0.05, 0.45, size=(L, N, 1))], -1).astype(np.float32)
    small = lambda s: torch.as_tensor(rng.normal(size=(L, 3)) * s, dtype=torch.float32,
                                      device=card)
    args = (torch.as_tensor(pts, device=card), sp, so3.exp_so3(small(0.2)), small(0.5),
            so3.exp_so3(small(0.1)), small(1.0))
    before = deskew.deskew_points.launches
    got = deskew.deskew_points(*args)
    want = deskew.deskew_points_plain(*args)
    torch.cuda.synchronize()
    assert deskew.deskew_points.launches == before + 1
    assert torch.equal(got[..., 3], want[..., 3])
    assert float((got[..., :3] - want[..., :3]).abs().max()) <= 2e-5
