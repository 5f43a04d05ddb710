"""The CUDA kernels against their plain versions on the card, at edge shapes
the flagship path does not give them: a window narrower than a warp or not
a multiple of 32, K = C, a window whose rows need more than 48 KB of shared
memory, a point count off the block size, a spline with too few control
points. k-NN is bit-equal; deskew agrees within atol 2e-5 with equal ok
flags (rotation matrices in the kernel, quaternions in the plain version).

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


def _window(Q, C, seed, dev):
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.uniform(-5, 5, size=(Q, 3)).astype(np.float32), device=dev)
    pts = rng.uniform(-6, 6, size=(Q, C, 3)).astype(np.float32)
    valid = rng.uniform(size=(Q, C)) < 0.7
    valid[::7] = False  # all-invalid rows
    pts[1::5, C // 2] = pts[1::5, 0]  # distance ties
    p = torch.as_tensor(pts, device=dev)
    v = torch.as_tensor(valid, device=dev)
    c = torch.as_tensor(rng.uniform(0.01, 0.5, size=(Q, C)).astype(np.float32), device=dev)
    d2 = torch.where(v, vh._sqdist(p, q[:, None, :]), torch.finfo(torch.float32).max)
    return d2.contiguous(), p, torch.where(v, c, 0.0).contiguous()


@pytest.mark.parametrize("Q,C,K", [(1, 16, 16), (37, 40, 5), (300, 256, 16), (64, 16384, 16)])
def test_knn_kernel_bit_equal_to_plain(card, Q, C, K):
    d2, p, c = _window(Q, C, seed=C, dev=card)
    before = knn.topk_candidates.launches
    got = knn.topk_candidates(d2, p, c, K)
    torch.cuda.synchronize()
    assert knn.topk_candidates.launches == before + 1
    for a, b in zip(got, knn.topk_candidates_plain(d2, p, c, K)):
        assert torch.equal(a, b)


def test_knn_wrapper_refuses_what_the_kernel_does_not_take(card):
    d2, p, c = _window(8, 64, seed=1, dev=card)
    with pytest.raises(ValueError):
        knn.topk_candidates(d2.double(), p, c, 4)
    with pytest.raises(ValueError):
        knn.topk_candidates(d2, p.transpose(0, 1).contiguous().transpose(0, 1), c, 4)
    with pytest.raises(ValueError):
        knn.topk_candidates(d2, p, c, 65)


def test_knn_cached_kernel_equals_plain_on_the_card(card):
    rng = np.random.default_rng(3)
    pts = torch.as_tensor(rng.uniform(-8, 8, size=(3000, 3)).astype(np.float32), device=card)
    covs = torch.as_tensor(rng.uniform(0.01, 0.2, size=3000).astype(np.float32), device=card)
    m = vh.insert(vh.create(1 << 14, 0.5, torch.float32, card), pts, covs,
                  torch.ones(3000, dtype=torch.bool, device=card))
    far = torch.as_tensor(rng.uniform(12, 20, size=(300, 3)).astype(np.float32), device=card)
    qs = torch.cat([pts[:500] + 0.1, far])
    kw = dict(radius=1, wide_radius=5, wide_budget=512, cache_k=16)
    got = vh.knn_cached(m, qs, use_kernel=True, **kw)
    want = vh.knn_cached(m, qs, use_kernel=False, **kw)
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
