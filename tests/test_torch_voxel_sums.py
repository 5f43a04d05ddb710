"""The voxel downsample's segment sums: the CUDA kernel (`csrc/voxel_sums.cu`,
one launch a `voxel_downsample` on the card) and its plain version
(`preprocess.voxel_sums_plain`, three torch.segment_reduce sums).

On the CPU: a mirror of the kernel's threads in Python (`_kernel_mirror`:
a thread per sorted row walks its kept segment, a thread per output slot
zeroes a slot past the group's segments, the masked rows' segment, which
the sort keeps apart from every valid row, told by its first row and never
walked) gives the plain version's bits, writing every slot once, on groups
with no valid point, caps that overflow into the dump, valid points on the
JAX package's masked key (0xFFFFFFFF) and f64;
a replay of run_sequence with the kernel's path (a CPU stand-in that runs
the mirror and counts its launch on the wrapper) gives the plain run's
bits, one launch a round, counted as `captured` under a capture; the
wrapper raises on CPU tensors, wrong types and shapes, non-contiguous
input, and is listed and counted among `ops.wrappers()`.

On the card (the `cuda` marker; each test skips without a device): the
kernel bit-equal to the plain version (values and valid) at City's
(G = 3, P = 65,536, out_cap 16,384, A = 1), UrbanNav's (G = 2) and the
fleet's (G = 48) widths on scans with the cells' point counts, and on the
edge cases above; two launches bit-equal; captured City rounds through
the kernel against the eager rounds with the plain sums, bit for bit; the
wrapper's refusals. This file imports no JAX. On a machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_voxel_sums.py -q
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

from malio_tpu_torch import ops, preprocess as pre, runner, tree
from malio_tpu_torch.config import city_config
from malio_tpu_torch.io.assemble import assemble_groups
from malio_tpu_torch.io.synthetic import SyntheticSequence
from malio_tpu_torch.ops import voxel_sums as vs

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the scans and the cells' widths)

torch.set_num_threads(1)

# a cell whose spatial hash is 0xFFFFFFFF, the JAX package's masked key:
# k2 solved for over a grid of (k0, k1), the third multiplier being odd
MASKED_KEY_CELL = (1195, 544, 0)


def _kernel_mirror(pts, aux, mask, order, seg, out_cap):
    """csrc/voxel_sums.cu's threads run one after another on the CPU, with
    the kernel's arithmetic (sums rounded one by one, in the tensors' type).
    Slots no thread writes stay NaN with valid 2, so a slot left out shows."""
    G, P = mask.shape
    A, C = aux.shape[-1], out_cap
    dt = pts.numpy().dtype.type
    x = np.concatenate([pts.reshape(G * P, 3).numpy(), aux.reshape(G * P, A).numpy()], 1)
    m, o, s = mask.reshape(-1).numpy(), order.numpy(), seg.reshape(-1).numpy()
    out = np.full((G * C, 3 + A), np.nan, dt)
    valid = np.full(G * C, 2, np.uint8)
    starts = [t for t in range(G * P) if t % P == 0 or s[t] != s[t - 1]]
    for t in range(G * C):  # a slot past the group's segments
        g, j = divmod(t, C)
        if P == 0 or j > s[g * P + P - 1]:
            out[t], valid[t] = 0, 0
    for t in starts:  # the first row of a segment; the other rows' threads return at once
        g, i = divmod(t, P)
        j = s[t]
        if j >= C:
            continue
        end, slot = (g + 1) * P, g * C + j
        if not m[o[t]]:  # the masked rows' segment
            out[slot], valid[slot] = 0, 0
            continue
        n, acc = dt(0), [dt(0)] * (3 + A)
        r = t
        while r < end and s[r] == j:
            n = dt(n + dt(1))
            acc = [dt(a + v) for a, v in zip(acc, x[o[r]])]
            r += 1
        out[slot], valid[slot] = [dt(a / n) for a in acc], 1
    out = torch.as_tensor(out).reshape(G, C, 3 + A)
    return out[..., :3], out[..., 3:], torch.as_tensor(valid.reshape(G, C))


def _bit_equal(got, want, what):
    for name, a, b in zip(("centroids", "aux", "valid"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, (what, name, a.dtype, b.dtype)
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=f"{what} {name}")


def _planted(counts, P, seed, dtype=torch.float64, planted=()):
    """chip_smoke's scans in a voxel of 0.9 m with `planted` (group, slot,
    points) valid points put into the cell of hash 0xFFFFFFFF."""
    pts, aux, mask = chip_smoke.voxel_scan_inputs(counts, P, seed, dtype=dtype, shuffle=True)
    cell = torch.tensor(MASKED_KEY_CELL, dtype=torch.float64)
    for g, slot, n in planted:
        off = torch.linspace(0.1, 0.8, n, dtype=torch.float64)[:, None]
        pts[g, slot:slot + n] = ((cell + off) * 0.9).to(dtype)
        mask[g, slot:slot + n] = True
    return pts, aux, mask


# (valid points a group, raw slots, out_cap, dtype, planted masked-key points)
CASES = {
    "scans": ((60, 250, 0, 300), 300, 300, torch.float32, ()),
    "overflow": ((60, 250, 0, 300), 300, 40, torch.float32, ()),
    "masked_key": ((60, 250, 0, 300), 300, 300, torch.float32,
                   ((0, 5, 3), (1, 100, 1), (2, 290, 2), (3, 0, 4))),
    "masked_key_overflow": ((60, 250, 0, 300), 300, 40, torch.float32, ((0, 5, 3), (1, 0, 2))),
    "f64": ((60, 250, 0, 300), 300, 300, torch.float64, ((1, 100, 2),)),
    "empty_cap": ((60, 0), 50, 0, torch.float32, ()),
}


# ---- on the CPU ----


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_mirror_is_the_plain_version(case):
    counts, P, C, dtype, planted = CASES[case]
    pts, aux, mask = _planted(counts, P, seed=len(case), dtype=dtype, planted=planted)
    order, seg = pre.voxel_sort(pts, mask, 0.9)
    # the masked rows last, in a segment of their own, which the mirror
    # (as the kernel) tells by its first row
    sorted_mask = mask.reshape(-1)[order].reshape(mask.shape)
    n_valid = mask.sum(-1)
    for g in range(mask.shape[0]):
        nv = int(n_valid[g])
        assert bool(sorted_mask[g, :nv].all()) and not bool(sorted_mask[g, nv:].any())
        assert (seg[g, nv:] == seg[g, nv:nv + 1]).all()
        if 0 < nv < mask.shape[1]:
            assert seg[g, nv - 1] < seg[g, nv]
    want = pre.voxel_sums_plain(pts, aux, mask, order, seg, C)
    got = _kernel_mirror(pts, aux, mask, order, seg, C)
    _bit_equal(got, (want[0], want[1], want[2].to(torch.uint8)), case)
    for g, _, _ in planted:  # the 0xFFFFFFFF voxel, the last valid one, kept below out_cap
        j = int(seg[g, int(n_valid[g]) - 1])
        if j < C:
            assert bool(want[2][g, j]), (case, g)


def _stand_in(calls):
    """A CPU stand-in for `preprocess.voxel_sums_plain` that takes the
    kernel's path: the wrapper's contract checked, the mirror run, the
    launch counted on the wrapper as the wrapper counts it."""

    def sums(pts, aux, mask, order, seg, out_cap):
        G, P = mask.shape
        for t, shape in ((pts, (G, P, 3)), (aux, (G, P, aux.shape[-1])), (mask, (G, P)),
                         (order, (G * P,)), (seg, (G, P))):
            assert t.is_contiguous() and tuple(t.shape) == shape
        assert aux.dtype == pts.dtype and mask.dtype == torch.bool
        assert order.dtype == seg.dtype == torch.int64
        calls.append((G, P, out_cap))
        ops.count_launch(vs.voxel_sums, (G, P, out_cap))
        out, aux_out, valid = _kernel_mirror(pts, aux, mask, order, seg, out_cap)
        return out, aux_out, valid.bool()

    return sums


def _small_city():
    cfg = city_config(max_raw_points=256, max_points_per_scan=128, spline_capacity=96,
                      epoch_capacity=16, map_capacity=1 << 14, max_meas_points=384)
    seq = SyntheticSequence(
        duration=1.2, num_lidars=3, points_per_scan=256, seed=6,
        ext_t=np.asarray(cfg.extrinsic_T, np.float64).reshape(3, 3),
        ext_q_wxyz=np.asarray(cfg.extrinsic_R, np.float64).reshape(3, 4),
    ).generate()
    return cfg, assemble_groups(cfg, seq[0], seq[1])


def test_run_sequence_through_the_kernel_path_keeps_the_plain_bits(monkeypatch):
    """run_sequence in f32 on the CPU with the sums through a stand-in for
    the kernel: every output equals the plain run's, one launch a round at
    (3, 256, 128)."""
    cfg, groups = _small_city()
    want = runner.run_sequence(cfg, groups, dtype=torch.float32, device="cpu")
    calls = []
    monkeypatch.setattr(pre, "voxel_sums_plain", _stand_in(calls))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    ops.reset_launches()
    got = runner.run_sequence(cfg, groups, dtype=torch.float32, device="cpu")
    rounds = len(want["t"])
    assert rounds >= 5
    assert calls == [(3, 256, 128)] * rounds
    assert vs.voxel_sums.launches == rounds
    assert vs.voxel_sums.launches_by_shape == {(3, 256, 128): rounds}
    for k in ("t", "pos", "quat", "pose_cov", "iterations", "n_effective", "map_size",
              "nn_miss"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_a_launch_while_capturing_counts_as_captured(monkeypatch):
    """A launch recorded into a CUDA graph goes to `captured`, not to
    `launches`; each replay adds it (`ops.add_launches`)."""
    pts, aux, mask = _planted((100, 20), 128, seed=1, dtype=torch.float32)
    monkeypatch.setattr(pre, "voxel_sums_plain", _stand_in([]))
    ops.reset_launches()
    vs.voxel_sums.captured = {}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    before = ops.captured()
    pre.voxel_downsample(pts, aux, mask, 0.9, 64)
    after = ops.captured()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert vs.voxel_sums.launches == 0 and vs.voxel_sums.launches_by_shape == {}
    assert after["voxel_sums"] == {(2, 128, 64): 1} and before["voxel_sums"] == {}
    ops.add_launches({"voxel_sums": after["voxel_sums"]}, 7)
    assert vs.voxel_sums.launches == 7
    assert vs.voxel_sums.launches_by_shape == {(2, 128, 64): 7}
    vs.voxel_sums.captured = {}
    ops.reset_launches()


def test_wrappers_count_voxel_sums():
    assert ops.wrappers()["voxel_sums"] is vs.voxel_sums
    ops.reset_launches()
    ops.add_launches({"voxel_sums": {(3, 65536, 16384): 1}}, 5)
    assert vs.voxel_sums.launches == 5
    assert vs.voxel_sums.launches_by_shape == {(3, 65536, 16384): 5}
    ops.reset_launches()
    assert vs.voxel_sums.launches == 0 and vs.voxel_sums.launches_by_shape == {}


def _sorted_args(dev="cpu", dtype=torch.float32):
    pts, aux, mask = chip_smoke.voxel_scan_inputs((40, 10), 64, seed=2, dev=dev, dtype=dtype)
    order, seg = pre.voxel_sort(pts, mask, 0.5)
    return pts, aux, mask, order, seg


def _refusals(pts, aux, mask, order, seg):
    """Arguments the kernel does not take, each with the words of its
    refusal."""
    return [
        ((pts.half(), aux, mask, order, seg), "float32 or float64"),
        ((pts, aux.double() if pts.dtype == torch.float32 else aux.float(), mask, order, seg),
         "aux is"),
        ((pts, aux, mask.to(torch.uint8), order, seg), "mask is"),
        ((pts, aux, mask, order.int(), seg), "order is"),
        ((pts, aux, mask, order, seg[:, :-1]), "seg is"),
        ((pts[:, :-1], aux, mask, order, seg), "pts is"),
        ((pts.transpose(0, 1).contiguous().transpose(0, 1), aux, mask, order, seg),
         "not contiguous"),
        ((pts, aux, mask, order, seg.t().contiguous().t()), "not contiguous"),
    ]


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    args = _sorted_args()
    vs.voxel_sums.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        vs.voxel_sums(*args, 32)
    for bad, words in _refusals(*args):
        with pytest.raises(ValueError, match=words):
            vs.voxel_sums(*bad, 32)
    assert vs.voxel_sums.launches == 0


# ---- on the card ----


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _against_plain(pts, aux, mask, C, what):
    order, seg = pre.voxel_sort(pts, mask, chip_smoke.VOXEL_SIZE)
    before = vs.voxel_sums.launches
    got = vs.voxel_sums(pts, aux, mask, order, seg, C)
    assert vs.voxel_sums.launches == before + 1
    _bit_equal(got, pre.voxel_sums_plain(pts, aux, mask, order, seg, C), what)
    _bit_equal(vs.voxel_sums(pts, aux, mask, order, seg, C), got, f"{what}: a second launch")
    # the whole downsample goes through the kernel, not segment_reduce
    ds = pre.voxel_downsample(pts, aux, mask, chip_smoke.VOXEL_SIZE, C)
    assert vs.voxel_sums.launches == before + 3
    _bit_equal(ds, got, f"{what}: voxel_downsample")
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["voxel_sums_city", "voxel_sums_urbannav", "voxel_sums_fleet"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_kernel_is_the_plain_version_at_the_cells_widths(card, name, shuffle):
    counts, P, C = chip_smoke.VOXEL_SHAPES[name]
    pts, aux, mask = chip_smoke.voxel_scan_inputs(counts, P, seed=len(counts) + shuffle,
                                                  dev=card, shuffle=shuffle)
    got = _against_plain(pts, aux, mask, C, name)
    assert got[2].sum(-1).min() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_is_the_plain_version_on_the_edge_cases(card, case):
    counts, P, C, dtype, planted = CASES[case]
    pts, aux, mask = _planted(counts, P, seed=len(case), dtype=dtype, planted=planted)
    order, seg = pre.voxel_sort(pts, mask, 0.9)
    want = pre.voxel_sums_plain(pts, aux, mask, order, seg, C)
    pts, aux, mask, order, seg = (t.to(card) for t in (pts, aux, mask, order, seg))
    got = vs.voxel_sums(pts, aux, mask, order, seg, C)
    _bit_equal(tuple(t.cpu() for t in got), want, case)
    _bit_equal(vs.voxel_sums(pts, aux, mask, order, seg, C), got, f"{case}: a second launch")
    _bit_equal(got, pre.voxel_sums_plain(pts, aux, mask, order, seg, C), f"{case} on the card")


@pytest.mark.cuda
def test_wide_masked_key_and_overflow_at_city_width(card):
    """City's width with a valid point on the masked key in one group and
    a group whose voxels overflow out_cap (the dump non-empty)."""
    counts, P, C = chip_smoke.VOXEL_SHAPES["voxel_sums_city"]
    pts, aux, mask = chip_smoke.voxel_scan_inputs(counts, P, seed=9, dev=card)
    cell = torch.tensor(MASKED_KEY_CELL, dtype=torch.float64, device=card)
    pts[1, 6000:6003] = ((cell + 0.25) * chip_smoke.VOXEL_SIZE).float()
    mask[1, 6000:6003] = True
    # group 2: 60,000 points spread over 60,000 distinct voxels, 16,384 kept
    k = torch.arange(60000, device=card, dtype=torch.float32)
    pts[2, :60000] = torch.stack([k % 100, (k // 100) % 100, k // 10000], -1) * 0.5 + 0.25
    mask[2, :60000] = True
    got = _against_plain(pts, aux, mask, C, "masked key and overflow")
    assert bool(got[2][2].all())
    order, seg = pre.voxel_sort(pts, mask, chip_smoke.VOXEL_SIZE)
    j = int(seg[1, int(mask[1].sum()) - 1])  # the 0xFFFFFFFF voxel, group 1's last valid one
    assert bool(got[2][1, j]) and not bool(got[2][1, j + 1]) and int(seg[2, -1]) > C


@pytest.mark.cuda
def test_captured_city_rounds_through_the_kernel_equal_the_plain_eager_rounds(card, monkeypatch):
    """Four City rounds (full widths: 16,384 points in each LiDAR's 65,536
    raw slots, out_cap 16,384) through pipeline.step, the captured round with the kernel, against
    step_eager with the plain sums: bit-equal, one launch a round."""
    from malio_tpu_torch import batched, pipeline

    from malio_tpu_torch.config import FLAGSHIP_RANGE_MAX, FLAGSHIP_WORLD

    cfg = city_config()
    imu, rounds, traj = SyntheticSequence(
        duration=1.5, num_lidars=3, points_per_scan=16384, seed=0,
        ext_t=np.asarray(cfg.extrinsic_T, np.float64).reshape(3, 3),
        ext_q_wxyz=np.asarray(cfg.extrinsic_R, np.float64).reshape(3, 4),
        range_max=FLAGSHIP_RANGE_MAX, world_kwargs=FLAGSHIP_WORLD).generate()
    seqs = [(assemble_groups(cfg, imu, rounds), traj)]
    carry, chunks, _ = batched._prepare(cfg, seqs, torch.float32, 4, card)
    carry = tree.squeeze(carry)
    groups = tree.map_tensors(lambda t: t[:, 0], chunks[0][0])
    ops.reset_launches()
    c_k, c_p = carry, carry
    for k in range(4):
        c_k, o_k = pipeline.step(cfg, c_k, tree.index(groups, k), device=card)
        with monkeypatch.context() as m:
            m.setattr(pre, "voxel_sums", pre.voxel_sums_plain)
            c_p, o_p = pipeline.step_eager(cfg, c_p, tree.index(groups, k), device=card)
        for a, b in zip(tree.leaves((c_k, o_k)), tree.leaves((c_p, o_p))):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=f"round {k}")
    per_round = pipeline._compiled_round(cfg, tree.unsqueeze(carry), tree.map_tensors(
        lambda t: t[None], tree.index(groups, 0))).launches["voxel_sums"]
    assert per_round == {(3, cfg.max_raw_points, cfg.max_points_per_scan): 1}


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    args = _sorted_args(dev=card)
    before = vs.voxel_sums.launches
    for bad, words in _refusals(*args):
        with pytest.raises(ValueError, match=words):
            vs.voxel_sums(*bad, 32)
    pts, aux, mask, order, seg = args
    with pytest.raises(ValueError, match="CUDA"):
        vs.voxel_sums(pts, aux, mask.cpu(), order, seg, 32)
    assert vs.voxel_sums.launches == before
