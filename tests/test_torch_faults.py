"""Two faults of the port against the JAX reference, repaired, on the CPU:

  * runner.seed_carry moves the last IMU stamp onto the first round's time
    origin in f64 before the cast, as the JAX live path does
    (malio_tpu/online.py:266-267). An f32 cast first puts stamps near
    1.7e9 s on a 128 s grid: the f32 OnlineEstimators of both packages on
    the flagship configuration (3 LiDARs at 256 points, seed 0, 3 s) with
    stamps shifted by 1.7e9 s, and shifted so that the last IMU stamp and
    the round's time origin straddle a 128 s rounding boundary, stay within
    1e-5 m of each other (the cast-first seed was 2.27e-2 m and 1.99 m
    off);
  * batched._init_seq seeds a sequence whose IMU initialisation never
    completes from the unfinished statistics over all its groups, as the
    reference does (malio_tpu/batched.py:106-137); its carry equals the
    reference's (f64, 1e-12).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from malio_tpu import batched as jbatched
from malio_tpu import online as jonline

from malio_tpu_torch import batched as tbatched, interop
from malio_tpu_torch import online as tonline, runner as trunner
from malio_tpu_torch.config import FLAGSHIP_RANGE_MAX, FLAGSHIP_WORLD
from malio_tpu_torch.io.assemble import assemble_groups
from malio_tpu_torch.io.synthetic import SyntheticSequence

from test_torch_pipeline import flat, port_config

torch.set_num_threads(1)
F32_ULP_AT_1_7E9 = 128.0  # spacing of float32 values in [2^30, 2^31) s


@pytest.fixture(scope="module")
def flagship():
    jcfg = jbatched._flagship_config(256, 1 << 15, False)
    seq = SyntheticSequence(
        duration=3.0, num_lidars=3, points_per_scan=256, seed=0,
        ext_t=np.asarray(jcfg.extrinsic_T, np.float64).reshape(3, 3),
        ext_q_wxyz=np.asarray(jcfg.extrinsic_R, np.float64).reshape(3, 4),
        range_max=FLAGSHIP_RANGE_MAX, world_kwargs=FLAGSHIP_WORLD)
    imu, rounds, _ = seq.generate()
    return jcfg, port_config(jcfg), imu, rounds


def _seed_stamps(cfg, groups):
    """(last IMU stamp before the first fused round, that round's time
    origin), as run_sequence and OnlineEstimator find them."""
    init, prev = trunner.ImuInitializer(), np.zeros(7)
    for gi, g in enumerate(groups):
        m = np.asarray(g["imu_mask"])
        last = np.asarray(g["imu"], np.float64)[m.nonzero()[0][-1]] if m.any() else prev
        if gi > 0 and init.done:
            return prev[0], trunner.group_base(g)
        init.update(np.asarray(g["imu"], np.float64), g["imu_mask"])
        prev = last
    raise AssertionError("the sequence never initialised")


def _feed(est, imu, rounds, shift):
    events = [("imu", row[0] + shift, row) for row in imu]
    for rnd in rounds:
        for l, s in enumerate(rnd):
            rel = s["pts"].copy()
            rel[:, 3] -= s["beg_t"]
            events.append(("scan", s["end_t"] + shift, (l, s["beg_t"] + shift, rel,
                                                         s["end_t"] - s["beg_t"])))
    events.sort(key=lambda e: e[1])
    for kind, t, p in events:
        if kind == "imu":
            est.push_imu(t, p[1:4], p[4:7])
        else:
            est.push_scan(p[0], p[1], p[2], duration=p[3])
    est.flush()
    return np.asarray([r["pos"] for r in est.poll()])


def test_f32_online_seed_with_epoch_stamps_matches_jax(flagship):
    jcfg, tcfg, imu, rounds = flagship
    t_last, base0 = _seed_stamps(tcfg, assemble_groups(tcfg, imu, rounds))
    edge = np.round(1.7e9 / F32_ULP_AT_1_7E9) * F32_ULP_AT_1_7E9 + F32_ULP_AT_1_7E9 / 2
    shifts = {"1.7e9": 1.7e9, "straddle": edge - (t_last + base0) / 2}
    cast_first = {k: float(np.float32(S + t_last)) - float(np.float32(S + base0))
                  for k, S in shifts.items()}
    assert abs(cast_first["straddle"] - (t_last - base0)) > 60.0  # a 128 s step
    for name, S in shifts.items():
        want = _feed(jonline.OnlineEstimator(jcfg, dtype=jnp.float32), imu, rounds, S)
        got = _feed(tonline.OnlineEstimator(tcfg, dtype=torch.float32, device="cpu"),
                    imu, rounds, S)
        assert got.shape == want.shape and len(got) > 20, name
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=name)


def test_init_seq_of_a_sequence_that_never_initialises(flagship):
    jcfg, tcfg, imu, rounds = flagship
    groups = assemble_groups(tcfg, imu, rounds)[:3]
    for g, keep in zip(groups, (4, 0, 3)):  # 7 IMU samples: the initializer needs 11
        g["imu_mask"] = np.asarray(g["imu_mask"]).copy()
        g["imu_mask"][np.flatnonzero(g["imu_mask"])[keep:]] = False
    jc, jrest, jb0 = jbatched._init_seq(jcfg, groups, jnp.float64)
    tc, trest, tb0 = tbatched._init_seq(tcfg, groups, torch.float64, "cpu")
    assert len(trest) == len(jrest) == 3 and tb0 == jb0
    want, got = flat(jc), interop.to_numpy(tc)

    def same(a, b, path=""):
        if isinstance(b, dict):
            for k in b:
                same(a[k], b[k], f"{path}.{k}")
        else:
            np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                       atol=1e-12, rtol=0, err_msg=path)

    same(got, want)
    assert np.isfinite(got["x"]["grav"]).all() and got["last_imu"][0] != 0.0
