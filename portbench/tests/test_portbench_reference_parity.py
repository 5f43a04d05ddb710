"""The reference round against an implementation that the program did
not write: the JAX package (malio_tpu, the system the program was ported
from), on the CPU in float64, over every round of a short drive of each
deployment at a tiny size. The reference is a frozen copy of the
program's eager round, so the benchmark's comparison alone cannot see a
fault that both share; this holds the copy to the original's semantics:
poses and pose covariances within round-off, the IEKF's iterations, the
effective measurements and the map's size exact. JAX is loaded by this
test only, never by a run; where it is missing (the card's machine) the
test skips."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench.core import bench
from portbench.reference import replay as reference
from portbench.tests import tiny

DURATION = 2.0
SEED = 4_000_000_777


@pytest.mark.parametrize("config", ["city3", "urbannav2"])
def test_reference_matches_the_jax_package(config):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from malio_tpu import runner as jrunner
    from malio_tpu.config import Config as JConfig

    torch.set_num_threads(2)
    cell = bench.Cell.load(f"{config}.replay", SEED, 1.0, False, time.perf_counter(), device="cpu")
    tiny.adjust(cell)
    imu, rounds, _ = cell.sequence(SEED, DURATION)
    groups = cell.groups(imu, rounds)
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cell.config["config"].items()}
    kw["pallas_knn"], kw["pallas_deskew"] = kw.pop("knn_kernel"), kw.pop("deskew_kernel")
    want = jrunner.run_sequence(JConfig(**kw), groups, dtype=jnp.float64)
    got = reference.replay(cell.reference_config(), [groups], len(groups), device="cpu",
                           dtype=torch.float64)
    R = len(want["t"])
    assert R >= 8 and got["pos"].shape[1] == R
    np.testing.assert_allclose(got["end_time"][0], want["t"], atol=1e-9)
    np.testing.assert_allclose(got["pos"][0], want["pos"], atol=1e-8)
    np.testing.assert_allclose(got["quat"][0], want["quat"], atol=1e-8)
    np.testing.assert_allclose(got["pose_cov"][0], want["pose_cov"], rtol=1e-7, atol=1e-12)
    np.testing.assert_array_equal(got["iterations"][0], want["iterations"])
    np.testing.assert_array_equal(got["n_effective"][0], want["n_effective"])
    np.testing.assert_array_equal(got["map_size"][0], want["map_size"])
