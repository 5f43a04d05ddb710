"""The port's soak loop (`soak.run`) against the JAX soak loop of
scripts/soak_tpu.py:81-120 (test_torch_soak._jax_soak) at
tests/test_soak.py's `_soak_cfg`: one LiDAR of 256 points, a small
local-map box that slides and evicts within the first 48 rounds, and
supervoxel rows that fill (a displaced record, a dropped voxel), f64.
Positions within 1e-6 m; map size, map drops, evictions,
measurement-lane drops and nn_miss equal every round."""
import numpy as np
import torch

from malio_tpu_torch.io.assemble import assemble_groups
from malio_tpu_torch.io.synthetic import SyntheticSequence

import test_soak
import test_torch_pipeline as tp
import test_torch_soak as ts

torch.set_num_threads(1)


def test_soak_run_matches_jax_with_slides_and_evictions():
    jcfg = test_soak._soak_cfg()
    seq = SyntheticSequence(duration=5.5, num_lidars=1, points_per_scan=256,
                            ext_t=np.array([[0.2, 0.0, 0.0]]), seed=11)
    imu, rounds, _ = seq.generate()
    res = ts._check(jcfg, assemble_groups(tp.port_config(jcfg), imu, rounds), 48)
    assert (np.abs(np.diff(res["box_min"], axis=0)).sum(axis=1) > 1e-9).sum() >= 1
    assert int(res["carry"].map.n_evicted) > 0 and res["map_dropped"][-1] > 0
