"""The port's live path, checkpoint and carry-level operations against the
JAX package, on the golden replay configuration (1 LiDAR, 256 points, 1.4
s, seed 42) on the CPU:

  * OnlineEstimator pushed the sequence in arrival order equals the port's
    run_sequence bit for bit (f32 and f64), and the JAX OnlineEstimator at
    f64 (pos/quat atol 1e-8, same round count and counters);
  * the grouping counters (dropped scans, IMU regressions) and buffers
    equal the JAX estimator's on a stream that loses scans;
  * a checkpoint written by either package loads in the other, and both
    then step equal (atol 1e-8);
  * scan_steps equals K step calls exactly;
  * apply_world_correction equals the JAX function: state and P atol
    1e-10, history 1e-10, map tables equal with points atol 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from malio_tpu import checkpoint as jckpt
from malio_tpu import online as jonline
from malio_tpu import pipeline as jpipe
from malio_tpu import runner as jrunner
from malio_tpu.config import Config as JConfig

from malio_tpu_torch import checkpoint as tckpt
from malio_tpu_torch import interop, online as tonline, pipeline as tpipe
from malio_tpu_torch import propagate as tprop, runner as trunner
from malio_tpu_torch.io.assemble import assemble_groups
from malio_tpu_torch.io.synthetic import SyntheticSequence

from test_torch_pipeline import _golden_cfg, _jax_init, flat, port_config

torch.set_num_threads(1)


def _cfgs():
    kw = _golden_cfg()
    kw.update(max_raw_points=256, max_points_per_scan=256)
    j = JConfig(**kw)
    return j, port_config(j)


@pytest.fixture(scope="module")
def seq():
    jcfg, tcfg = _cfgs()
    s = SyntheticSequence(duration=1.4, num_lidars=1, points_per_scan=256,
                          ext_t=np.array([[0.2, 0.0, 0.0]]), seed=42)
    imu, rounds, _ = s.generate()
    return jcfg, tcfg, imu, rounds, assemble_groups(jcfg, imu, rounds)


def _push_events(est, imu, rounds, skip=None):
    """IMU samples and scans in arrival order (a scan arrives at its end
    time), as tests/test_online.py feeds them; `skip` withholds scans."""
    events = [("imu", row[0], row) for row in imu]
    for ri, rnd in enumerate(rounds):
        for l, s in enumerate(rnd):
            if skip and (ri, l) in skip:
                continue
            rel = s["pts"].copy()
            rel[:, 3] -= s["beg_t"]
            events.append(("scan", s["end_t"], (l, s["beg_t"], rel, s["end_t"] - s["beg_t"])))
    events.sort(key=lambda e: e[1])
    for kind, _, p in events:
        if kind == "imu":
            est.push_imu(p[0], p[1:4], p[4:7])
        else:
            est.push_scan(p[0], p[1], p[2], duration=p[3])


def _online(est, imu, rounds):
    _push_events(est, imu, rounds)
    est.flush()
    out = est.poll()
    return {k: np.asarray([o[k] for o in out]) for k in ("t", "pos", "quat", "map_size")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_online_equals_replay_exactly(seq, dtype):
    _, tcfg, imu, rounds, groups = seq
    ref = trunner.run_sequence(tcfg, groups, dtype=dtype, device="cpu")
    got = _online(tonline.OnlineEstimator(tcfg, dtype=dtype, device="cpu"), imu, rounds)
    assert len(got["t"]) == len(ref["t"]) > 5
    for k in ("t", "pos", "quat", "map_size"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_online_matches_jax_online_f64(seq):
    jcfg, tcfg, imu, rounds, _ = seq
    jest = jonline.OnlineEstimator(jcfg, dtype=jnp.float64)
    test = tonline.OnlineEstimator(tcfg, dtype=torch.float64, device="cpu")
    want, got = _online(jest, imu, rounds), _online(test, imu, rounds)
    assert len(got["t"]) == len(want["t"]) > 5
    np.testing.assert_allclose(got["t"], want["t"], atol=1e-9)
    np.testing.assert_allclose(got["pos"], want["pos"], atol=1e-8)
    np.testing.assert_allclose(got["quat"], want["quat"], atol=1e-8)
    np.testing.assert_array_equal(got["map_size"], want["map_size"])
    for c in ("n_rounds", "n_dropped_scans", "n_imu_regressions"):
        assert getattr(test, c) == getattr(jest, c), c


def test_grouping_counters_match_jax_on_a_lossy_stream():
    """Two LiDARs, a lost scan, a jumped-over scan and an IMU stamp out of
    order, with too few IMU samples to leave the init phase: the grouping
    alone, no fusion."""
    kw = _golden_cfg()
    kw.update(num_lidars=2, lid_type=(3, 3), n_scans=(64, 64), point_filter_num=(1, 1),
              extrinsic_T=(0.2, 0.0, 0.0, -0.3, 0.3, 0.1), extrinsic_R=(1.0, 0, 0, 0) * 2,
              max_raw_points=8, max_points_per_scan=8)
    jcfg = JConfig(**kw)
    ests = [jonline.OnlineEstimator(jcfg, dtype=jnp.float64),
            tonline.OnlineEstimator(port_config(jcfg), dtype=torch.float64, device="cpu")]
    pts = np.zeros((4, 4))
    g = np.array([0.0, 0.0, 9.8])
    for est in ests:
        est.push_imu(0.00, np.zeros(3), g)
        est.push_imu(0.01, np.zeros(3), g)
        est.push_imu(0.005, np.zeros(3), g)  # out of order
        est.push_scan(1, 0.00, pts, duration=0.05)  # jumped over
        est.push_scan(0, 0.10, pts, duration=0.05)
        est.push_scan(1, 0.10, pts, duration=0.05)
        for k in range(2, 45):
            est.push_imu(k * 0.01, np.zeros(3), g)
        est.push_scan(0, 0.30, pts, duration=0.05)  # its partner is lost
        est.push_scan(0, 0.40, pts, duration=0.05)
        est.push_scan(1, 0.40, pts, duration=0.05)  # no IMU lookahead: stays buffered
        est.flush()
    j, t = ests
    for c in ("n_rounds", "n_dropped_scans", "n_imu_regressions", "_n_init_groups", "_imu_cursor"):
        assert getattr(t, c) == getattr(j, c), c
    assert t.n_dropped_scans >= 2 and t.n_imu_regressions == 1 and t.n_rounds == 0
    assert [len(b) for b in t._scans] == [len(b) for b in j._scans]
    np.testing.assert_array_equal(np.asarray(t._imu), np.asarray(j._imu))


def _jax_carry_after(jcfg, groups, n):
    """The JAX replay's carry after n fused rounds, the index of the next
    group and its time base."""
    jc, start = _jax_init(jcfg, groups)
    chunk = groups[start : start + n]
    g, bases = jrunner._stack_chunk(chunk, np.float64, jrunner.group_base(groups[start]))
    for k in range(n):
        jc, _ = jpipe.step(jcfg, jc, jax.tree_util.tree_map(lambda a, k=k: a[k], g))
    return jc, start + n, float(bases[-1])


def _step_both(jcfg, tcfg, jc, tc, groups, nxt, base, n=2):
    g, _ = jrunner._stack_chunk(groups[nxt : nxt + n], np.float64, base)
    for k in range(n):
        jg = jax.tree_util.tree_map(lambda a, k=k: a[k], g)
        jc, jo = jpipe.step(jcfg, jc, jg)
        tc, to = tpipe.step(tcfg, tc, interop.group_from_numpy(flat(jg), "cpu"), device="cpu")
        np.testing.assert_allclose(to.pos.numpy(), np.asarray(jo.pos), atol=1e-8)
        np.testing.assert_allclose(to.quat.numpy(), np.asarray(jo.quat), atol=1e-8)
        assert int(to.map_size) == int(jo.map_size)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(seq, tmp_path, writer):
    jcfg, tcfg, _, _, groups = seq
    jc, nxt, base = _jax_carry_after(jcfg, groups, 4)
    path = tmp_path / "carry.npz"
    tc0 = interop.carry_from_numpy(flat(jc), "cpu")
    if writer == "jax":
        jckpt.save(path, jc)
        template = interop.carry_from_numpy(flat(jc), "cpu")._replace(
            map=tc0.map._replace(tab=torch.zeros_like(tc0.map.tab)))
        tc = tckpt.load(path, template)
        np.testing.assert_array_equal(tc.map.tab.numpy(), np.asarray(jc.map.tab))
    else:
        tckpt.save(path, tc0)
        jc = jckpt.load(path, jax.tree_util.tree_map(jnp.zeros_like, jc))
        tc = tc0
    assert sorted(np.load(path).files) == sorted(
        "/".join(str(p) for p in kp) for kp, _ in jax.tree_util.tree_flatten_with_path(jc)[0])
    _step_both(jcfg, tcfg, jc, tc, groups, nxt, base)


def test_checkpoint_load_refuses_a_shape_mismatch(seq, tmp_path):
    jcfg, _, _, _, groups = seq
    jc, _, _ = _jax_carry_after(jcfg, groups, 1)
    tc = interop.carry_from_numpy(flat(jc), "cpu")
    tckpt.save(tmp_path / "c.npz", tc)
    bad = tc._replace(P=torch.zeros(5, 5, dtype=torch.float64))
    with pytest.raises(ValueError, match="shape mismatch at .P"):
        tckpt.load(tmp_path / "c.npz", bad)


def test_scan_steps_equals_steps_exactly(seq):
    _, tcfg, _, _, groups = seq
    init = trunner.ImuInitializer()
    start, prev = None, np.zeros(7)
    for gi, g in enumerate(groups):
        m = np.asarray(g["imu_mask"])
        last = np.asarray(g["imu"], np.float64)[m.nonzero()[0][-1]] if m.any() else prev
        if gi > 0 and init.done:
            start = gi
            break
        init.update(np.asarray(g["imu"], np.float64), g["imu_mask"])
        prev = last
    base0 = trunner.group_base(groups[start])
    carry = trunner.seed_carry(tcfg, init, prev, base0, torch.float32, "cpu")
    gdev, _ = trunner._stack_chunk(groups[start : start + 3], np.float32, base0, "cpu")
    c_scan, stacked = tpipe.scan_steps(tcfg, carry, gdev, device="cpu")
    c = carry
    for k in range(3):
        c, out = tpipe.step(tcfg, c, tprop.MeasureGroup(*(a[k] for a in gdev)), device="cpu")
        for f in out._fields:
            a, b = getattr(stacked, f)[k], getattr(out, f)
            assert torch.equal(a, torch.as_tensor(b)), f
    for a, b in zip(interop.to_numpy(c_scan).values(), interop.to_numpy(c).values()):
        if isinstance(a, dict):
            for x, y in zip(a.values(), b.values()):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)


def test_apply_world_correction_matches_jax(seq):
    jcfg, tcfg, _, _, groups = seq
    jc, _, _ = _jax_carry_after(jcfg, groups, 4)
    tc = interop.carry_from_numpy(flat(jc), "cpu")
    dq = np.array([0.97, 0.05, -0.08, 0.2])
    dt = np.array([2.0, 1.0, -0.5])
    j2 = jpipe.apply_world_correction(jcfg, jc, jnp.asarray(dq), jnp.asarray(dt))
    t2 = tpipe.apply_world_correction(tcfg, tc, torch.as_tensor(dq), torch.as_tensor(dt))
    for f in ("pos", "rot", "vel", "grav", "ext_r", "ext_t", "bg", "ba"):
        np.testing.assert_allclose(getattr(t2.x, f).numpy(), np.asarray(getattr(j2.x, f)),
                                   rtol=0, atol=1e-10, err_msg=f)
    np.testing.assert_allclose(t2.P.numpy(), np.asarray(j2.P), rtol=0, atol=1e-10)
    for f in ("t", "q", "p", "cov", "inp", "n"):
        np.testing.assert_allclose(getattr(t2.hist, f).numpy(), np.asarray(getattr(j2.hist, f)),
                                   rtol=0, atol=1e-10, err_msg=f)
    jt, tt = np.asarray(j2.map.tab), t2.map.tab.numpy()
    np.testing.assert_array_equal(tt[..., 0], jt[..., 0])
    np.testing.assert_array_equal(tt[..., 4], jt[..., 4])
    np.testing.assert_allclose(tt[..., 1:4], jt[..., 1:4], rtol=0, atol=1e-12)
    for f in ("box_min", "box_max", "box_init", "Pi"):
        np.testing.assert_allclose(getattr(t2, f).numpy(), np.asarray(getattr(j2, f)), atol=1e-10)
    assert int((tt[..., 0] != 0).sum()) > 100
