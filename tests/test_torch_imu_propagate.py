"""The IMU mean propagation chain: the CUDA kernel (`csrc/imu_propagate.cu`,
one launch a propagation pass) and its plain version
(`propagate._mean_chain_plain`).

On the CPU: `_batch_propagate` runs the plain chain, bit-equal to it, and
launches nothing; the kernel's (B, K + 1, 10) states turned into the pre-
and post-step States (`ops.imu_propagate.states`) give the plain chain's
bits; a replay of run_sequence with the kernel path's plumbing (a CPU
stand-in for the kernel that packs the plain chain's states) gives the
plain run's bits; the wrapper raises on CPU tensors and is listed and
counted among `ops.wrappers()`.

On the card (the `cuda` marker; each test skips without a device): the
kernel against the plain chain run in f64 (the exact chain) within
chip_smoke.IMU_ATOL (pos 1e-4 m, rot 2e-6, vel 4e-5 m/s), which the f32
plain chain meets too (its worst on these inputs on the CPU: 3.8e-5 m,
6.4e-7, 1.1e-5 m/s; inputs from chip_smoke.imu_chain_inputs) at B = 1
and 16 and K = 15, 64, 127 and 255, forward and backward (negative dt),
with valid masks that are random, all-invalid, or have leading and
trailing gaps, and angles below and above so3's small-angle threshold;
two launches bit-equal; a City round through pipeline.step with the
kernel against the plain chain's eager round; the wrapper's refusals.
This file imports no JAX. On a machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_imu_propagate.py -q
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

from malio_tpu_torch import ops, propagate as prop, runner, state as st, tree
from malio_tpu_torch.config import city_config
from malio_tpu_torch.io.assemble import assemble_groups
from malio_tpu_torch.io.synthetic import SyntheticSequence
from malio_tpu_torch.ops import imu_propagate as imu

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the chains' inputs and limits)

torch.set_num_threads(1)


def _packed(x0, post):
    """The kernel's layout of a chain: (B, K + 1, 10) [pos, rot, vel]."""
    first = torch.cat([x0.pos, x0.rot, x0.vel], -1)[:, None]
    return torch.cat([first, torch.cat([post.pos, post.rot, post.vel], -1)], 1)


def _bit_equal(got, want, what):
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        assert a.shape == b.shape, what
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=str(what))


def _within(got, exact, what):
    err = chip_smoke.imu_chain_errors(got, exact)
    for f, atol in chip_smoke.IMU_ATOL.items():
        assert err[f] <= atol, f"{what} {f}: {err[f]} over {atol}"


# ---- on the CPU ----


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("backward", [False, True])
def test_batch_propagate_on_the_cpu_is_the_plain_chain(dtype, backward):
    x0, g, a, d, v = chip_smoke.imu_chain_inputs(3, 20, seed=1, backward=backward)
    x0, g, a, d = x0.map(lambda t: t.to(dtype)), g.to(dtype), a.to(dtype), d.to(dtype)
    n = st.dof(x0.num_lidars)
    A = torch.randn(3, n, n, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    P0 = A @ A.transpose(-1, -2) * 1e-3
    Q = (torch.eye(12, dtype=dtype) * 1e-3).repeat(3, 1, 1)
    ops.reset_launches()
    x, P, post, Ps = prop._batch_propagate(x0, P0, g, a, d, v, Q)
    assert ops.wrappers()["imu_propagate"].launches == 0
    assert ops.wrappers()["imu_propagate"].launches_by_shape == {}
    xw, _, postw = prop._mean_chain_plain(x0, g, a, d, v)
    _bit_equal((x, post), (xw, postw), "the plain chain")
    # the loop as _batch_propagate ran it before the kernel: step_mean a step
    xs, posts = x0, []
    for k in range(g.shape[1]):
        x2 = prop.dynamics.step_mean(xs, prop.dynamics.Input(acc=a[:, k], gyro=g[:, k]), d[:, k])
        xs = st.where_state(v[:, k], x2, xs)
        posts.append(xs)
    _bit_equal((x, post), (xs, tree.stack(posts, 1)), "step_mean a step")
    assert P.shape == P0.shape and Ps.shape == (3, 20, n, n)
    torch.testing.assert_close(P, Ps[:, -1], rtol=0, atol=0)


def test_kernel_states_are_the_plain_chains_states():
    """The kernel's (B, K + 1, 10) layout read back through `states`: the
    final, pre- and post-step States of the plain chain, bit for bit, with
    the constant fields x0's without a copy."""
    x0, g, a, d, v = chip_smoke.imu_chain_inputs(4, 17, seed=2, backward=False)
    x, pre, post = prop._mean_chain_plain(x0, g, a, d, v)
    s = _packed(x0, post)
    assert s.shape == (4, 18, imu.STATE_WIDTH)
    _bit_equal(imu.states(x0, s[:, -1]), x, "final")
    _bit_equal(imu.states(x0, s[:, :-1]), pre, "pre")
    _bit_equal(imu.states(x0, s[:, 1:]), post, "post")
    got = imu.states(x0, s[:, 1:])
    assert got.bg.data_ptr() == x0.bg.data_ptr() and got.bg.stride(1) == 0
    assert got.ext_r.shape == (4, 17, 2, 4) and got.ext_r.data_ptr() == x0.ext_r.data_ptr()


def _kernel_stand_in(calls):
    """A CPU stand-in for `imu.mean_chain`: the plain chain's states in the
    kernel's layout, after the checks the kernel's wrapper makes (on the
    CPU device)."""

    def mean_chain(x0, gyros, accs, dts, valids):
        B, K = dts.shape
        for t, w in ((x0.pos, 3), (x0.rot, 4), (x0.vel, 3), (x0.bg, 3), (x0.ba, 3), (x0.grav, 3)):
            assert t.is_contiguous() and t.dtype == torch.float32 and t.shape == (B, w)
        for t, shape in ((gyros, (B, K, 3)), (accs, (B, K, 3)), (dts, (B, K)), (valids, (B, K))):
            assert t.is_contiguous() and tuple(t.shape) == shape
        assert valids.dtype == torch.bool
        calls.append((B, K))
        return _packed(x0, prop._mean_chain_plain(x0, gyros, accs, dts, valids)[2])

    return mean_chain


def _small_city():
    """City's estimator at 256 points a LiDAR, its IMU slots (64), history
    (128) and continuation (16): the passes of K = 127, 64 and 15 steps."""
    cfg = city_config(max_raw_points=256, max_points_per_scan=256, spline_capacity=96,
                      epoch_capacity=16, map_capacity=1 << 14, max_meas_points=512)
    seq = SyntheticSequence(
        duration=1.2, num_lidars=3, points_per_scan=256, seed=4,
        ext_t=np.asarray(cfg.extrinsic_T, np.float64).reshape(3, 3),
        ext_q_wxyz=np.asarray(cfg.extrinsic_R, np.float64).reshape(3, 4),
    ).generate()
    return cfg, assemble_groups(cfg, seq[0], seq[1])


def test_run_sequence_through_the_kernel_path_keeps_the_plain_bits(monkeypatch):
    """run_sequence in f32 on the CPU with propagate taking the kernel's
    path (inputs made contiguous, states read back as views) through a
    stand-in that packs the plain chain: every output equals the plain
    run's, three passes a round."""
    cfg, groups = _small_city()
    want = runner.run_sequence(cfg, groups, dtype=torch.float32, device="cpu")
    calls = []
    monkeypatch.setattr(prop, "kernel_enabled", lambda flag, t: flag is None)
    monkeypatch.setattr(imu, "mean_chain", _kernel_stand_in(calls))
    got = runner.run_sequence(cfg, groups, dtype=torch.float32, device="cpu")
    rounds = len(want["t"])
    assert rounds >= 5
    assert sorted(set(calls)) == [(1, cfg.imu_cont_len - 1), (1, cfg.max_imu_per_group),
                                  (1, cfg.traj_capacity - 1)]
    assert len(calls) == 3 * rounds
    for k in ("t", "pos", "quat", "pose_cov", "iterations", "n_effective", "map_size",
              "nn_miss"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_wrapper_raises_on_cpu_tensors():
    x0, g, a, d, v = chip_smoke.imu_chain_inputs(2, 8, seed=3, backward=False)
    before = imu.mean_chain.launches
    with pytest.raises(ValueError, match="CUDA"):
        imu.mean_chain(x0, g, a, d, v)
    assert imu.mean_chain.launches == before


def test_wrappers_count_imu_propagate():
    assert ops.wrappers()["imu_propagate"] is imu.mean_chain
    ops.reset_launches()
    ops.add_launches({"imu_propagate": {(1, 127): 1, (1, 64): 1, (1, 15): 1}}, 5)
    fn = ops.wrappers()["imu_propagate"]
    assert fn.launches == 15
    assert fn.launches_by_shape == {(1, 127): 5, (1, 64): 5, (1, 15): 5}
    ops.reset_launches()
    assert fn.launches == 0 and fn.launches_by_shape == {}


# ---- on the card ----


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("K", [15, 64, 127, 255])
@pytest.mark.parametrize("B", [1, 16])
def test_kernel_matches_the_exact_chain(card, B, K, backward):
    x0, g, a, d, v = chip_smoke.imu_chain_inputs(B, K, seed=K + B + backward, backward=backward,
                                                 dev=card)
    before = imu.mean_chain.launches
    s = imu.mean_chain(x0, g, a, d, v)
    assert imu.mean_chain.launches == before + 1
    assert imu.mean_chain.launches_by_shape.get((B, K), 0) >= 1
    assert torch.equal(s, imu.mean_chain(x0, g, a, d, v)), "two launches differ"
    exact = prop._mean_chain_plain(x0.map(torch.Tensor.double), g.double(), a.double(),
                                   d.double(), v)
    plain = prop._mean_chain_plain(x0, g, a, d, v)
    got = (imu.states(x0, s[:, -1]), imu.states(x0, s[:, :-1]), imu.states(x0, s[:, 1:]))
    _within(got, exact, "kernel")
    _within(plain, exact, "f32 plain chain")
    # an invalid step keeps the state: its row repeats the one before it
    keep = ~v
    assert torch.equal(s[:, 1:][keep], s[:, :-1][keep])
    assert torch.equal(s[:, 0], torch.cat([x0.pos, x0.rot, x0.vel], -1))


@pytest.mark.cuda
def test_a_city_round_with_the_kernel_matches_the_plain_chain(card, monkeypatch):
    """Four City rounds (K = 127, 64, 15 a round) through pipeline.step,
    the captured round with the kernel, against step_eager with the plain
    chain: poses within the deskew kernel's class (2e-5), three launches a
    round."""
    from malio_tpu_torch import batched, pipeline
    from malio_tpu_torch.config import flagship_config

    cfg = flagship_config(points_per_lidar=256, map_slots=1 << 15, max_imu_per_group=64,
                          traj_capacity=128, spline_capacity=96)
    seqs = [chip_smoke.flagship_groups(cfg, 2.0, 0)]
    carry, chunks, _ = batched._prepare(cfg, seqs, torch.float32, 4, card)
    carry = tree.squeeze(carry)
    groups = tree.map_tensors(lambda t: t[:, 0], chunks[0][0])
    c_k, c_p = carry, carry
    ops.reset_launches()
    outs_k = []
    for k in range(4):
        c_k, o = pipeline.step(cfg, c_k, tree.index(groups, k), device=card)
        outs_k.append(o)
    per_round = pipeline._compiled_round(cfg, tree.unsqueeze(carry), tree.map_tensors(
        lambda t: t[None], tree.index(groups, 0))).launches["imu_propagate"]
    assert per_round == {(1, 127): 1, (1, 64): 1, (1, 15): 1}
    monkeypatch.setattr(prop, "_mean_chain", prop._mean_chain_plain)
    for k in range(4):
        c_p, o = pipeline.step_eager(cfg, c_p, tree.index(groups, k), device=card)
        for f in ("pos", "quat"):
            err = float((getattr(outs_k[k], f) - getattr(o, f)).abs().max())
            assert err <= 2e-5, f"round {k} {f}: {err}"


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    x0, g, a, d, v = chip_smoke.imu_chain_inputs(2, 8, seed=5, backward=False, dev=card)
    before = imu.mean_chain.launches
    bad = [
        (x0._replace(pos=x0.pos.double()), g, a, d, v),  # f64 state
        (x0, g.double(), a, d, v),
        (x0, g, a, d, v.to(torch.uint8)),  # the mask is bool
        (x0, g.transpose(0, 1).contiguous().transpose(0, 1), a, d, v),  # not contiguous
        (x0._replace(rot=torch.cat([x0.rot, x0.rot], 0)[::2]), g, a, d, v),  # not contiguous
        (x0, g[:, :-1].contiguous(), a, d, v),  # K differs
        (x0, g, a, d.cpu(), v),  # not on the card
    ]
    for i, args in enumerate(bad):
        with pytest.raises(ValueError):
            imu.mean_chain(*args)
    assert imu.mean_chain.launches == before
