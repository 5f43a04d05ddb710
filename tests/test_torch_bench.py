"""Smoke test of bench_torch.py at a miniature shape on the CPU (3 LiDARs
at 256 points, 3 s, one timed pass), so the port's benchmark cannot break
silently: it returns bench.py's keys plus the card's name and power limit,
finite numbers, and the kernel times of its kernel_timer phase."""
import math

import numpy as np
import torch

import bench_torch

torch.set_num_threads(1)
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "config", "best", "passes", "ate_m",
              "ate_gate_m", "gated", "nn_miss_p50", "map_dropped", "meas_dropped", "insert_ms",
              "nn_ms", "iekf_ms")


def test_bench_torch_miniature_keys():
    out = bench_torch.run(points_per_lidar=256, duration=3.0, passes=1, chunk=4, warmup=2,
                          device="cpu", local_cpp=False)
    for k in BENCH_KEYS + ("gpu", "power_limit_w", "device"):
        assert k in out, k
    assert out["metric"] == "scans_per_sec" and out["unit"] == "scans/s"
    assert out["device"] == "cpu" and out["gpu"] is None and out["power_limit_w"] is None
    assert len(out["passes"]) == 1 and all(math.isfinite(v) for v in out["passes"])
    assert math.isfinite(out["ate_m"]) and out["ate_gate_m"] == bench_torch.ATE_GATE_M
    assert out["gated"] == (out["ate_m"] > bench_torch.ATE_GATE_M)
    if out["gated"]:
        assert out["value"] == out["best"] == 0.0
    assert all(out[k] > 0 for k in ("insert_ms", "nn_ms", "iekf_ms"))
    assert out["config"].startswith("city-flagship 3-lidar 768pt")


def test_bench_dummy_inputs_are_a_batch_of_one():
    cfg = bench_torch.bench_config(points_per_lidar=64, map_slots=1 << 12)
    carry, group = bench_torch.dummy_inputs(cfg, torch.float32, "cpu")
    assert carry.P.shape[0] == 1 and group.pts.shape == (1, 3, 64, 4)
    assert carry.map.tab.shape[0] == 1 and bool(group.imu_mask.all())
    np.testing.assert_allclose(carry.last_imu.numpy(), [[0, 0, 0, 0, 0, 0, 9.81]], rtol=1e-7)
