"""Parity of the port's voxel-hash map and k-NN select with the JAX
package in f32, bit for bit: the int32 hash and fingerprint (negative keys
included), the table after inserts (ties, row overflow, evict-replace),
the eviction pass, and knn_cached / the select stage against both JAX
paths — the Pallas kernel run in interpret mode and its jnp twin — on
windows with distance ties, sparse rows and all-invalid rows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from malio_tpu.map import voxel_hash as jvh

from malio_tpu_torch.map import voxel_hash as tvh
from malio_tpu_torch.ops import knn as tknn

torch.set_num_threads(1)


def _keys(seed, n=4096):
    rng = np.random.default_rng(seed)
    k = rng.integers(-(1 << 30), 1 << 30, size=(n, 3), dtype=np.int64)
    k[:64] = rng.integers(-40, 40, size=(64, 3))  # dense small keys
    k[64] = [-1, -1, -1]
    k[65] = [-(1 << 31), (1 << 31) - 1, 0]
    return k


def test_hash_and_fingerprint_bit_equal():
    k = _keys(0)
    for R in (1 << 4, 1 << 16):
        want = np.asarray(jvh._hash(jnp.asarray(k, jnp.int32), R))
        got = tvh._hash(torch.as_tensor(k), R).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tvh._fingerprint(torch.as_tensor(k)).numpy(),
        np.asarray(jvh._fingerprint(jnp.asarray(k, jnp.int32))),
    )
    np.testing.assert_array_equal(
        tvh._svx(torch.as_tensor(k)).numpy(), np.asarray(jvh._svx(jnp.asarray(k, jnp.int32)))
    )


def _batch(rng, n, spread, cov_lo, cov_hi):
    pts = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    pts[n // 2 : n // 2 + 40] = pts[:40] + 0.01  # same voxels offered twice
    covs = rng.uniform(cov_lo, cov_hi, size=n).astype(np.float32)
    mask = rng.uniform(size=n) < 0.9
    return pts, covs, mask


def _insert_both(jm, tm, pts, covs, mask):
    jm = jvh.insert(jm, jnp.asarray(pts), jnp.asarray(covs), jnp.asarray(mask))
    tm = tvh.insert(tm, torch.as_tensor(pts), torch.as_tensor(covs), torch.as_tensor(mask))
    return jm, tm


def _same_map(tm, jm):
    np.testing.assert_array_equal(tm.tab.numpy(), np.asarray(jm.tab))
    assert int(tm.n_dropped) == int(jm.n_dropped)
    assert int(tm.n_evicted) == int(jm.n_evicted)
    assert int(tvh.size(tm)) == int(jvh.size(jm))


@pytest.mark.parametrize("capacity", [1 << 8, 1 << 12])
def test_insert_and_evict_tables_equal(capacity):
    rng = np.random.default_rng(capacity)
    jm = jvh.create(capacity, 0.5, jnp.float32)
    tm = tvh.create(capacity, 0.5, torch.float32)
    # first batch: every candidate at cov 0.001 (the first round's seed
    # covariance), so ties within a voxel fall to batch order
    jm, tm = _insert_both(jm, tm, *_batch(rng, 700, 8.0, 0.001, 0.001))
    _same_map(tm, jm)
    # second batch straddles the stored 0.001: a full row may displace its
    # worst record (evict-replace) or drop the candidate
    pts, covs, mask = _batch(rng, 700, 8.0, 1e-4, 2e-3)
    jm, tm = _insert_both(jm, tm, pts, covs, mask)
    _same_map(tm, jm)
    # third batch re-offers stored voxels at a lower covariance: updates
    jm, tm = _insert_both(jm, tm, pts[:100] + 0.01, np.full(100, 5e-5, np.float32), mask[:100])
    _same_map(tm, jm)
    lo, hi = np.array([-5.0, -6.0, -4.0], np.float32), np.array([6.0, 5.0, 7.0], np.float32)
    jm = jvh.evict_outside(jm, jnp.asarray(lo), jnp.asarray(hi))
    tm = tvh.evict_outside(tm, torch.as_tensor(lo), torch.as_tensor(hi))
    _same_map(tm, jm)
    if capacity == 1 << 8:
        assert int(jm.n_dropped) > 0 and int(jm.n_evicted) > 0  # overflow paths ran
    assert np.any(np.asarray(jm.tab)[..., 4] == np.float32(5e-5))  # update path ran


def test_topk_min_matches_jax():
    rng = np.random.default_rng(3)
    d2 = rng.uniform(0, 10, size=(50, 40)).astype(np.float32)
    d2[3, 5:9] = d2[3, 4]  # ties
    d2[7] = np.finfo(np.float32).max
    jv, ji = jvh.topk_min(jnp.asarray(d2), 9)
    tv, ti = tknn.topk_min(torch.as_tensor(d2), 9)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _window(Q, C, seed):
    rng = np.random.default_rng(seed)
    qs = rng.uniform(-5, 5, size=(Q, 3)).astype(np.float32)
    pts = rng.uniform(-6, 6, size=(Q, C, 3)).astype(np.float32)
    valid = rng.uniform(size=(Q, C)) < 0.7
    valid[3] = False  # all-invalid row
    valid[4, 10:] = False  # fewer valid lanes than K
    pts[2, 20] = pts[2, 4]  # exact duplicate: distance tie
    pts[5, 1::2] = pts[5, 0]  # many-way tie
    covs = rng.uniform(0.01, 0.5, size=(Q, C)).astype(np.float32)
    return qs, pts, covs, valid


@pytest.mark.parametrize("Q,C,K", [(37, 96, 16), (6, 40, 8), (12, 256, 16)])
def test_select_stage_matches_pallas_interpret_and_jnp(Q, C, K):
    qs, pts, covs, valid = _window(Q, C, seed=C)
    j = [jvh._topk_extract(*(jnp.asarray(a) for a in (qs, pts, covs, valid)), K, p)
         for p in (True, False)]
    t = tvh._topk_extract(*(torch.as_tensor(a) for a in (qs, pts, covs, valid)), K, True)
    for jj in j:
        for a, b, name in zip(t, jj, ("pts", "covs", "d2")):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    d2 = t[2].numpy()
    assert (d2[3] == np.finfo(np.float32).max).all()


def _map_and_queries(seed, n_far):
    rng = np.random.default_rng(seed)
    n = 600
    pts = rng.uniform(-8, 8, size=(n, 3)).astype(np.float32)
    covs = rng.uniform(0.01, 0.2, size=n).astype(np.float32)
    jm = jvh.create(1 << 12, 0.5, jnp.float32)
    tm = tvh.create(1 << 12, 0.5, torch.float32)
    jm, tm = _insert_both(jm, tm, pts, covs, np.ones(n, bool))
    q_near = pts[:40] + 0.1
    q_far = rng.uniform(20, 28, size=(n_far, 3)).astype(np.float32)
    qs = np.concatenate([q_near, q_far])
    qmask = np.ones(qs.shape[0], bool)
    qmask[-3:] = False
    return jm, tm, qs, qmask


@pytest.mark.parametrize("budget,n_far", [(32, 24), (300, 280)])
def test_knn_cached_matches_both_jax_paths(budget, n_far):
    """Bit-equal to the JAX function run op by op. Under jit, XLA:CPU fuses
    the d2 = sum((p - q)^2) pass and contracts it to fused multiply-adds,
    which moves the returned nn_d2 without changing any selection: against
    the jitted function everything else is bit-equal and nn_d2 agrees to
    2 ulp (one rounding saved in each of the two contracted products)."""
    jm, tm, qs, qmask = _map_and_queries(7, n_far)
    kw = dict(radius=1, wide_radius=3, wide_budget=budget, cache_k=16)
    names = ["nn_pts", "nn_covs", "nn_d2", "nn_cnt", "n_miss", "cache_pts", "cache_covs",
             "cache_valid"]
    for flag in (True, False):
        got = tvh.knn_cached(tm, torch.as_tensor(qs), qmask=torch.as_tensor(qmask),
                             use_kernel=flag, **kw)
        with jax.disable_jit():
            eager = jvh.knn_cached(jm, jnp.asarray(qs), qmask=jnp.asarray(qmask),
                                   use_pallas=flag, **kw)
        jitted = jvh.knn_cached(jm, jnp.asarray(qs), qmask=jnp.asarray(qmask),
                                use_pallas=flag, **kw)
        for nm, a, b, c in zip(names, got, eager, jitted):
            msg = f"{nm} kernel={flag}"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=msg)
            if nm == "nn_d2":
                np.testing.assert_array_max_ulp(a.numpy(), np.asarray(c), maxulp=2)
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(c), err_msg=msg)


def test_cache_width_must_cover_acceptance():
    _, tm, qs, _ = _map_and_queries(8, 4)
    with pytest.raises(AssertionError):
        tvh.knn_cached(tm, torch.as_tensor(qs), accept_k=5, cache_k=4)


def test_kernel_wrapper_refuses_bad_cuda_inputs():
    """On a CPU tensor the wrapper runs the plain version; it never moves
    a tensor between devices or falls back."""
    qs, pts, covs, valid = _window(6, 32, seed=1)
    d2 = torch.rand(6, 32)
    out = tknn.topk_candidates(d2, torch.as_tensor(pts), torch.as_tensor(covs), 4)
    ref = tknn.topk_candidates_plain(d2, torch.as_tensor(pts), torch.as_tensor(covs), 4)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert tknn.topk_candidates.launches == 0
