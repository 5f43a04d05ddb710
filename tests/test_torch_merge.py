"""The row merge (ops/merge.py, the map insert's table write) against the
JAX package on the CPU: `merge_rows` equals the JAX scatter
`t.at[i].set(r)` and the searchsorted merge pass of
benchmarks/micro_r4b.py (copied below; the TPU kernel pallas_merge computes
it tile by tile), exactly, at T = 2^12 rows and N = 300 updates, for
sorted, unsorted and out-of-range entries in f32 and f64. The insert
through it equals the insert through the former write (a dump row for the
lanes that write nothing) and the JAX insert, bit for bit, on a map whose
rows fill (drops) and then take new voxels (evictions). The byte count
that `chip_smoke.py` bounds the merge kernel by, at the paths' shapes."""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from malio_tpu.map import voxel_hash as jvh

from malio_tpu_torch.map import voxel_hash as tvh
from malio_tpu_torch.ops import merge

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (imports neither jax nor malio_tpu)

torch.set_num_threads(1)
T, N = 1 << 12, 300


def searchsorted_merge(t, i, r):
    """benchmarks/micro_r4b.py:57-62: each row finds its update by a binary
    search over the sorted indices."""
    rows = jnp.arange(t.shape[0], dtype=jnp.int32)
    j = jnp.minimum(jnp.searchsorted(i, rows), i.shape[0] - 1)
    hit = i[j] == rows
    return jnp.where(hit[:, None], r[j], t)


def _inputs(kind, dtype, seed):
    rng = np.random.default_rng(seed)
    tab = rng.normal(size=(T, 5)).astype(dtype)
    idx = np.concatenate([[0, T - 1], rng.choice(np.arange(1, T - 1), N - 2, replace=False)])
    if kind == "sorted":
        idx = np.sort(idx)
    else:
        rng.shuffle(idx)
    if kind == "invalid":
        idx[::7] = -1
        idx[3::11] = T + np.arange(len(idx[3::11]))
    rec = rng.normal(size=(N, 5)).astype(dtype)
    return tab, idx.astype(np.int64), rec


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["sorted", "unsorted", "invalid"])
def test_merge_rows_equals_the_jax_scatter(kind, dtype):
    tab, idx, rec = _inputs(kind, dtype, seed=len(kind))
    got = merge.merge_rows(*(torch.as_tensor(a) for a in (tab, idx, rec))).numpy()
    # JAX wraps negative indices; out-of-range ones it drops in "drop" mode
    j_idx = np.where(idx < 0, T, idx)
    want = np.asarray(jnp.asarray(tab).at[jnp.asarray(j_idx)].set(jnp.asarray(rec), mode="drop"))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(merge.merge_rows_plain(*(torch.as_tensor(a) for a in
                                                          (tab, idx, rec))).numpy(), want)
    if kind == "sorted":  # micro_r4b's inputs: sorted, unique, all valid
        mp = jax.jit(searchsorted_merge)(jnp.asarray(tab), jnp.asarray(idx), jnp.asarray(rec))
        np.testing.assert_array_equal(got, np.asarray(mp))


def test_merge_rows_leaves_its_input_and_takes_nothing():
    tab, idx, rec = (torch.as_tensor(a) for a in _inputs("unsorted", np.float32, 5))
    before = tab.clone()
    out = merge.merge_rows(tab, idx[:0], rec[:0])
    assert torch.equal(out, before) and torch.equal(tab, before)
    out = merge.merge_rows(tab, torch.full((4,), -1), rec[:4])
    assert torch.equal(out, before)
    merge.merge_rows(tab, idx, rec)
    assert torch.equal(tab, before)


def _dump_row_write(tab, idx, rec):
    """The insert's former write (before the merge): the table with one
    dump row appended, every lane that writes nothing sent there, one
    index_put_, the dump row sliced off."""
    T_ = tab.shape[0]
    flat = torch.cat([tab, torch.zeros((1, 5), dtype=tab.dtype)])
    flat[torch.where(idx < 0, torch.full_like(idx, T_), idx)] = rec
    return flat[:T_]


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_insert_before_and_after_the_merge(dtype, monkeypatch):
    rng = np.random.default_rng(21)
    np_dt = np.float32 if dtype == "f32" else np.float64
    batches = [(rng.uniform(-2, 2, size=(4000, 3)), rng.uniform(0.01, 0.2, size=4000)),
               (rng.uniform(5, 9, size=(40, 3)), np.full(40, 0.001))]
    batches = [(p.astype(np_dt), c.astype(np_dt)) for p, c in batches]

    def port():
        m = tvh.create(1 << 10, 0.25, torch.float32 if dtype == "f32" else torch.float64, "cpu")
        for p, c in batches:
            m = tvh.insert(m, torch.as_tensor(p), torch.as_tensor(c),
                           torch.ones(len(c), dtype=torch.bool))
        return m

    after = port()
    monkeypatch.setattr(merge, "merge_rows", _dump_row_write)
    before = port()
    jm = jvh.create(1 << 10, 0.25, jnp.float32 if dtype == "f32" else jnp.float64)
    for p, c in batches:
        jm = jvh.insert(jm, jnp.asarray(p), jnp.asarray(c), jnp.ones(len(c), bool))
    assert int(after.n_evicted) > 0 and int(after.n_dropped) > 0
    for m in (before, jm):
        np.testing.assert_array_equal(after.tab.numpy(), np.asarray(m.tab))
        assert int(after.n_evicted) == int(np.asarray(m.n_evicted))
        assert int(after.n_dropped) == int(np.asarray(m.n_dropped))


@pytest.mark.parametrize("T_, N_, want", [
    (1 << 21, 1 << 21, 100_663_296),  # a correction's re-insert of the map
    (1 << 21, 9984, 83_965_952),  # the main path's insert
])
def test_merge_bytes_at_the_paths_shapes(T_, N_, want):
    """The table read once (its overwritten rows as records instead), the
    table written once, idx read once: whatever the valid count."""
    for n_valid in (0, 551, 38_600, min(N_, T_)):
        assert chip_smoke.merge_bytes(T_, N_, n_valid, 5 * 4) == want
