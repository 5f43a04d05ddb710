"""Smoke test of bench_torch.py at a miniature shape on the CPU (3 LiDARs
at 256 points, 3 s, one timed pass), so the port's benchmark cannot break
silently: it returns bench.py's keys plus the card's name and power limit,
finite numbers, and the kernel times of its kernel_timer phase; the local
C++ baseline is built on the host that runs it."""
import math
import os
import pathlib
import shutil

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


def test_local_cpp_baseline_builds_its_own_binary(tmp_path):
    """The C++ baseline runs a binary built on this host into the package's
    build directory, never the committed native/baseline/ref_hotloop, and
    a source newer than the build rebuilds it."""
    out = bench_torch._local_cpp_baseline(rounds=12)  # 10 warm-up rounds + 2 timed
    assert "local_cpp_error" not in out, out
    binp = pathlib.Path(out["local_cpp_binary"]).resolve()
    build = (pathlib.Path(bench_torch.__file__).resolve().parent / "malio_tpu_torch" / "_build")
    assert binp.parent == build and binp != bench_torch.CPP_SOURCE.with_suffix("")
    assert binp.stat().st_mtime > bench_torch.CPP_SOURCE.stat().st_mtime
    assert out["local_cpp_rounds_per_sec"] > 0

    src, target = tmp_path / "ref_hotloop.cpp", tmp_path / "bin" / "ref_hotloop"
    shutil.copyfile(bench_torch.CPP_SOURCE, src)
    assert bench_torch.build_cpp_baseline(src, target) == target
    built = target.stat().st_mtime_ns
    assert bench_torch.build_cpp_baseline(src, target) == target
    assert target.stat().st_mtime_ns == built  # up to date: no rebuild
    stale = src.stat().st_mtime - 10
    os.utime(target, (stale, stale))  # the source is now newer than the build
    bench_torch.build_cpp_baseline(src, target)
    assert target.stat().st_mtime > src.stat().st_mtime
