"""The port's replay entry points against the JAX package, on the CPU:

* `python -m malio_tpu_torch.run_batched` at batch 2 against
  malio_tpu.batched.synthetic_batched_benchmark, which scripts/run_batched.py
  calls: the same rounds, each sequence's aligned ATE within 1e-5 m (3e-7
  apart at these inputs). Both run in f32: the JAX function raises in f64 (ROADMAP
  §3), and the two packages' f32 round-off differs (in f64 the port's
  rounds agree with the JAX ones within 1e-8 m,
  tests/test_torch_pipeline.py).
* play's keys (space, +/-, f, 0-9, l, q) through a scripted keyboard on a
  stand-in player, and one headless CPU run of `python -m
  malio_tpu_torch.play` on an exported tree: its TUM file equals the
  DatasetPlayer trajectory written the same way.
"""
import numpy as np
import pytest
import torch

from malio_tpu import batched as jbatched
from malio_tpu.io.export import write_dataset
from malio_tpu.io.synthetic import SyntheticSequence as JSequence

from malio_tpu_torch import config as tconfig, play, run_batched
from malio_tpu_torch.eval import ate
from malio_tpu_torch.io import player as tplayer

torch.set_num_threads(1)


def test_run_batched_matches_the_jax_benchmark():
    kw = dict(batch=2, duration=2.5, points=256)
    want = jbatched.synthetic_batched_benchmark(**kw)
    got = run_batched.main(["--batch", "2", "--duration", "2.5", "--points", "256", "--cpu"])
    assert set(got) == set(want)
    assert got["rounds"] == want["rounds"] >= 16
    np.testing.assert_allclose(got["ates"], want["ates"], atol=1e-5, rtol=0)
    # 16 rounds are one chunk, in which the 8 warm-up rounds end: neither
    # times a window
    assert np.isnan(got["aggregate_scans_per_sec"]) and np.isnan(want["aggregate_scans_per_sec"])


class _Keys:
    """A scripted keyboard: poll() returns the next key, then None."""

    def __init__(self, keys):
        self.keys = list(keys)

    def poll(self):
        return self.keys.pop(0) if self.keys else None


class _Player:
    """What the keys act on: a replay clock, the loop flag, the scrub."""

    def __init__(self):
        self.now = [0.0]
        self.clock = tplayer.ReplayClock(rate=1.0, time_fn=lambda: self.now[0])
        self.loop = False
        self.span = 100.0
        self.seeks = []

    def seek_fraction(self, frac):
        self.seeks.append(frac)
        self.clock.seek(frac * self.span)


def test_play_keys():
    p = _Player()
    kb = _Keys([" ", "+", "=", "-", "f", "l", "7", None, "x", "q"])
    assert play.apply_key(p, kb.poll()) and not p.clock.playing  # pause
    assert play.apply_key(p, kb.poll()) and p.clock.rate == 2.0
    assert play.apply_key(p, kb.poll()) and p.clock.rate == 4.0
    assert play.apply_key(p, kb.poll()) and p.clock.rate == 2.0
    assert play.apply_key(p, kb.poll()) and p.clock.now() == pytest.approx(10.0)
    assert play.apply_key(p, kb.poll()) and p.loop
    assert play.apply_key(p, kb.poll()) and p.seeks == [0.7]
    assert p.clock.now() == pytest.approx(70.0)
    assert play.apply_key(p, kb.poll())  # no key
    assert play.apply_key(p, kb.poll())  # a key with no binding
    assert play.apply_key(p, kb.poll()) is False  # quit
    assert play.apply_key(p, kb.poll()) and not p.clock.playing and p.clock.rate == 2.0


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    root = tmp_path_factory.mktemp("play_ds")
    seq = JSequence(duration=2.0, num_lidars=1, points_per_scan=2048,
                    ext_t=np.array([[0.215, 0.0, 0.018]]))
    imu, rounds, traj = seq.generate()
    write_dataset(root, imu, rounds, ["ouster"], traj=traj)
    return root


def test_play_headless_writes_the_player_trajectory(exported, tmp_path):
    args = ["--max-points", "2048", "--map-capacity", str(1 << 15)]
    out = tmp_path / "play.txt"
    res = play.main([str(exported), "--config", "city-ouster", "--cpu", "--f64", "--headless",
                     "--out", str(out), *args])
    cfg = tconfig.city_ouster_config(max_raw_points=2048, max_points_per_scan=2048,
                                     map_capacity=1 << 15)
    p = tplayer.DatasetPlayer(exported, cfg, ["ouster"], dtype=torch.float64, realtime=False,
                              device="cpu")
    try:
        want = p.run()
    finally:
        p.close()
    ref = tmp_path / "player.txt"
    ate.write_tum(ref, want["t"], want["pos"], want["quat"])
    assert res["n_rounds"] == want["n_rounds"] >= 10
    assert out.read_text() == ref.read_text()
    assert np.isfinite(res["ate_m"])
