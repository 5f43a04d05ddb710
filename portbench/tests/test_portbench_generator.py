"""The frozen generator and assembly give the program's io/synthetic and
io/assemble arrays for the same seed, at one point count a LiDAR (the
shapes both cover)."""
from __future__ import annotations

import numpy as np
import pytest

from malio_tpu_torch.config import FLAGSHIP_RANGE_MAX, FLAGSHIP_WORLD, city_config
from malio_tpu_torch.io.assemble import assemble_groups
from malio_tpu_torch.io.synthetic import SyntheticSequence
from portbench.core import generator


@pytest.mark.parametrize("seed,imu_rate", [(0, 100.0), (4_294_967_311, 400.0)])
def test_frozen_generator_is_the_programs(seed, imu_rate):
    cfg = city_config(max_raw_points=320, max_points_per_scan=256, map_capacity=1 << 15,
                      max_imu_per_group=128)
    ext_t = np.asarray(cfg.extrinsic_T).reshape(3, 3)
    ext_q = np.asarray(cfg.extrinsic_R).reshape(3, 4)
    imu, rounds, _ = SyntheticSequence(
        duration=1.8, imu_rate=imu_rate, num_lidars=3, points_per_scan=300, seed=seed,
        ext_t=ext_t, ext_q_wxyz=ext_q, range_max=FLAGSHIP_RANGE_MAX,
        world_kwargs=FLAGSHIP_WORLD).generate()
    imu2, rounds2, _ = generator.generate(1.8, seed, [300] * 3, ext_t, ext_q, imu_rate=imu_rate,
                                          range_max=FLAGSHIP_RANGE_MAX,
                                          world_kwargs=FLAGSHIP_WORLD)
    assert np.array_equal(imu, imu2)
    assert len(rounds) == len(rounds2)
    for r1, r2 in zip(rounds, rounds2):
        for a, b in zip(r1, r2):
            assert a["beg_t"] == b["beg_t"] and a["end_t"] == b["end_t"]
            assert np.array_equal(a["pts"], b["pts"])
    g1 = assemble_groups(cfg, imu, rounds)
    g2 = generator.assemble_groups(3, cfg.max_raw_points, cfg.max_imu_per_group,
                                   cfg.imu_cont_len, cfg.sync_lookahead, imu2, rounds2)
    assert len(g1) == len(g2) > 0
    for a, b in zip(g1, g2):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def test_points_per_lidar():
    imu, rounds, _ = generator.generate(1.0, 3, [50, 20], np.zeros(6), [1, 0, 0, 0] * 2)
    assert [s["pts"].shape for s in rounds[0]] == [(50, 4), (20, 4)]
