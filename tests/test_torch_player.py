"""The dataset entry points of the port against the JAX package on one
exported 2 s tree (City Ouster rig, 2048 points a scan, 256 after its
8x decimation, f64, on the CPU): the
port's DatasetPlayer (realtime=False) gives the JAX DatasetPlayer's
trajectory within 1e-8 m (the f64 online tolerance of
tests/test_torch_online.py); `python -m malio_tpu_torch.run_dataset`
writes a TUM trajectory equal to the JAX runner.run_sequence on the same
loaded sequence (to the file's 1e-6 m print precision) and a PCD map equal
to the final map; ReplayClock and read_data_stamp are the JAX ones; both
entry points run on the card unless the CPU is asked for."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from malio_tpu import config as jconfig, runner as jrunner
from malio_tpu.io import dataset as jds, player as jplayer
from malio_tpu.io.assemble import assemble_groups as jassemble
from malio_tpu.io.export import write_dataset
from malio_tpu.io.synthetic import SyntheticSequence

from malio_tpu_torch import run_dataset
from malio_tpu_torch.eval import ate as tate
from malio_tpu_torch.io import pcd as tpcd, player as tplayer

from test_torch_pipeline import port_config

torch.set_num_threads(1)
SIZES = dict(max_raw_points=2048, max_points_per_scan=2048, map_capacity=1 << 15)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    root = tmp_path_factory.mktemp("player_ds")
    seq = SyntheticSequence(duration=2.0, num_lidars=1, points_per_scan=2048,
                            ext_t=np.array([[0.215, 0.0, 0.018]]))
    imu, rounds, traj = seq.generate()
    write_dataset(root, imu, rounds, ["ouster"], traj=traj)
    return root


def test_player_matches_the_jax_player_f64(exported):
    jcfg = jconfig.city_ouster_config(**SIZES)
    jp = jplayer.DatasetPlayer(exported, jcfg, ["ouster"], dtype=jnp.float64, realtime=False)
    tp = tplayer.DatasetPlayer(exported, port_config(jcfg), ["ouster"], dtype=torch.float64,
                               realtime=False, device="cpu")
    try:
        want, got = jp.run(), tp.run()
    finally:
        jp.close(), tp.close()
    assert got["n_rounds"] == want["n_rounds"] >= 10
    assert got["n_dropped_scans"] == want["n_dropped_scans"] == 0
    np.testing.assert_allclose(got["t"], want["t"], atol=1e-9, rtol=0)
    np.testing.assert_allclose(got["pos"], want["pos"], atol=1e-8, rtol=0)
    np.testing.assert_allclose(got["quat"], want["quat"], atol=1e-8, rtol=0)
    assert tp.t0 == jp.t0 and tp.span == jp.span and tp.entries == jp.entries


def test_run_dataset_cli_matches_the_jax_replay(exported, tmp_path):
    out, pcd = tmp_path / "traj.txt", tmp_path / "map.pcd"
    s = run_dataset.main([str(exported), "--config", "city-ouster", "--cpu", "--f64",
                          "--max-points", "2048", "--map-capacity", str(1 << 15),
                          "--out", str(out), "--save-map", str(pcd)])
    jcfg = jconfig.city_ouster_config(**SIZES)
    imu, rounds = jds.load_sequence(exported, ["ouster"], list(jcfg.lid_type),
                                    list(jcfg.point_filter_num), list(jcfg.n_scans), jcfg.blind)
    ref = jrunner.run_sequence(jcfg, jassemble(jcfg, imu, rounds), dtype=jnp.float64)
    t, pos, quat = tate.read_tum(out)
    assert len(t) == len(ref["t"]) == s["rounds"] >= 10
    np.testing.assert_allclose(t, ref["t"], atol=1e-9, rtol=0)
    np.testing.assert_allclose(pos, ref["pos"], atol=1e-6, rtol=0)
    sign = lambda q: q * np.sign(q[:, :1])  # q and -q are one rotation
    np.testing.assert_allclose(sign(quat), sign(ref["quat"]), atol=2e-9, rtol=0)
    assert np.isfinite(s["ate_m"]) and s["ate_m"] < 0.1 and s["matched"] == len(t)
    back = tpcd.read_pcd(pcd)
    tab = s["res"]["carry"].map.tab.reshape(-1, 5).numpy()
    occ = tab[:, 0] != 0
    np.testing.assert_array_equal(back, tab[occ][:, 1:5].astype(np.float32))


def test_replay_clock_and_data_stamp_are_the_jax_ones(exported):
    class Clock:
        t = 100.0

    for mod in (tplayer, jplayer):
        Clock.t = 100.0
        c = mod.ReplayClock(rate=2.0, time_fn=lambda: Clock.t)
        Clock.t += 1.0
        a = c.now()
        c.pause()
        Clock.t += 5.0
        b = c.now()
        c.resume()
        c.set_rate(0.5)
        Clock.t += 2.0
        c.seek(10.0)
        Clock.t += 1.0
        assert (a, b, c.now()) == (2.0, 2.0, 10.5)
    path = exported / "sensor_data" / "data_stamp.csv"
    assert tplayer.read_data_stamp(path) == jplayer.read_data_stamp(path)


def test_player_and_cli_run_on_the_card_unless_the_cpu_is_asked(exported, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = port_config(jconfig.city_ouster_config(**SIZES))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tplayer.DatasetPlayer(exported, cfg, ["ouster"], realtime=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_dataset.main([str(exported), "--config", "city-ouster", "--out",
                          str(tmp_path / "t.txt")])
    p = tplayer.DatasetPlayer(exported, cfg, ["ouster"], realtime=False, device="cpu")
    p.close()
    assert p.est.device.type == "cpu" and p.dtype == torch.float32
