#!/usr/bin/env python3
"""Benchmark of the PyTorch port (malio_tpu_torch) on one NVIDIA card: the
counterpart of bench.py, which benchmarks the JAX package.

Prints ONE JSON line with bench.py's keys plus the card's name and power
limit:
  {"metric": "scans_per_sec", "value": N, "unit": "scans/s", "vs_baseline": R,
   ..., "gpu": "...", "power_limit_w": W}

Headline: batched.flagship_benchmark(batch=1, duration=8.0,
points_per_lidar=4096, passes=3): the City 3-LiDAR flagship shape (3 x 4096
points a round, a 2^21-slot map, City weighting laws and reference-reach
k-NN), one sequence replayed in chunks of 8 rounds through
pipeline.scan_steps. `value` is the median of 3 timed passes over the same
pre-stacked stream (warm-up rounds excluded per pass), `best` the fastest.
The value is reported as 0.0 when the ATE is not finite or exceeds
ATE_GATE_M: a change that breaks the estimator publishes no number.

Per-kernel fields: insert_ms (voxel_hash.insert, whose table write is the
merge kernel csrc/merge_rows.cu), nn_ms (voxel_hash.knn_cached through the
k-NN window kernel) and iekf_ms (the round's k-NN search and iterated
update) through metrics.kernel_timer at the flagship shape, on a dummy
carry and group of the port's own. The local C++ baseline fields are
kept as bench.py has them: native/baseline/ref_hotloop.cpp built on this
host into malio_tpu_torch/_build/ (native/Makefile's flags, rebuilt when
the source is newer) and run; `local_cpp_binary` names the binary.

    python3 bench_torch.py          # on the card
"""
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np

BASELINE_SCANS_PER_SEC = 20.0
ATE_GATE_M = 0.05  # the flagship synthetic sequence runs ~0.011 m; 0.05 = broken filter
CPP_SOURCE = ROOT / "native" / "baseline" / "ref_hotloop.cpp"
CPP_BINARY = ROOT / "malio_tpu_torch" / "_build" / "ref_hotloop"
# native/Makefile's `baseline` flags; -march=native makes the binary this host's
CPP_FLAGS = ["-O3", "-std=c++17", "-Wall", "-march=native", "-fopenmp"]


def build_cpp_baseline(src=CPP_SOURCE, out=CPP_BINARY):
    """Compile the C++ hot loop `src` into `out` on this host, unless `out`
    is newer than `src`. Returns `out`."""
    src, out = pathlib.Path(src), pathlib.Path(out)
    if out.exists() and out.stat().st_mtime > src.stat().st_mtime:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    subprocess.run([os.environ.get("CXX", "g++"), *CPP_FLAGS, "-o", str(tmp), str(src)],
                   check=True, capture_output=True, timeout=300)
    os.replace(tmp, out)
    return out


def _local_cpp_baseline(rounds=80):
    """Measured C++ hot-loop rate on this host (best-effort, as bench.py),
    from a binary built here (build_cpp_baseline), never the committed
    native/baseline/ref_hotloop. `rounds` counts the 10 warm-up rounds."""
    try:
        binp = build_cpp_baseline()
        out = subprocess.run([str(binp), str(rounds)], capture_output=True, timeout=600,
                             text=True)
        d = json.loads(out.stdout.strip().splitlines()[-1])
        return {"local_cpp_rounds_per_sec": d["rounds_per_sec"],
                "local_cpp_threads": d["threads"], "local_cpp_binary": str(binp)}
    except Exception as e:  # pragma: no cover
        return {"local_cpp_error": str(e)[:120]}


def bench_config(points_per_lidar=4096, map_slots=1 << 21):
    """bench.py's kernel-timing shape: the City config at the flagship
    capacities, with no measurement-lane cap."""
    from malio_tpu_torch.config import city_config

    return city_config(
        max_raw_points=points_per_lidar, max_points_per_scan=points_per_lidar,
        max_imu_per_group=16, traj_capacity=64, spline_capacity=64, epoch_capacity=32,
        map_capacity=map_slots,
    )


def dummy_inputs(cfg, dtype, device):
    """A carry and a measure group at cfg's shape, both with a batch of one:
    identity state, a resting IMU and uniform random points (seed 0), as the
    JAX package's __graft_entry__._dummy_inputs builds them."""
    import torch
    from malio_tpu_torch import pipeline, runner, state as st, tree
    from malio_tpu_torch import propagate as prop
    from malio_tpu_torch.filter import dynamics

    L, P, I, IC = cfg.num_lidars, cfg.max_raw_points, cfg.max_imu_per_group, cfg.imu_cont_len
    rng = np.random.default_rng(0)
    x = st.identity_state(L, dtype, device)
    P0 = runner.initial_covariance(cfg, dtype, device)
    Q = dynamics.process_noise_matrix(1e-4, 1e-4, 1e-5, 1e-5, dtype, device)
    kw = dict(dtype=dtype, device=device)
    carry = pipeline.init_carry(cfg, x, P0, Q, dtype, device)._replace(
        last_imu=torch.tensor([0.0, 0, 0, 0, 0, 0, 9.81], **kw),
        mean_acc_norm=torch.tensor(9.81, **kw),
    )
    imu_t = 0.1 + np.arange(I) * 0.01
    imu = np.concatenate([imu_t[:, None], np.zeros((I, 3)), np.tile([0, 0, 9.81], (I, 1))], 1)
    cont_t = imu_t[-1] + np.arange(IC) * 0.01
    cont = np.concatenate([cont_t[:, None], np.zeros((IC, 3)), np.tile([0, 0, 9.81], (IC, 1))], 1)
    pts = rng.uniform(-10, 10, size=(L, P, 4))
    pts[..., 3] = rng.uniform(0.1, 0.2, size=(L, P))
    on = dict(dtype=torch.bool, device=device)
    group = prop.MeasureGroup(
        pts=torch.tensor(pts, **kw), pts_mask=torch.ones((L, P), **on),
        beg_t=torch.full((L,), 0.1, **kw), end_t=torch.tensor(0.2 + 0.01 * np.arange(L), **kw),
        imu=torch.tensor(imu, **kw), imu_mask=torch.ones((I,), **on),
        imu_cont=torch.tensor(cont, **kw), imu_cont_mask=torch.ones((IC,), **on),
        t_shift=torch.tensor(0.0, **kw),
    )
    return tree.unsqueeze(carry), tree.unsqueeze(group)


def kernel_times(cfg, device="cuda", iters=5):
    """insert_ms, nn_ms and iekf_ms at cfg's shape through kernel_timer
    (milliseconds per call, each the mean of `iters` queued calls)."""
    import torch
    from malio_tpu_torch import measurement as meas, propagate as prop
    from malio_tpu_torch.device import resolve_device
    from malio_tpu_torch.filter import esekf
    from malio_tpu_torch.map import voxel_hash as vh
    from malio_tpu_torch.metrics import kernel_timer
    from malio_tpu_torch.ops import kernel_enabled

    dev = resolve_device(device)
    dtype = torch.float32
    carry, group = dummy_inputs(cfg, dtype, dev)
    rng = np.random.default_rng(0)
    M = cfg.num_lidars * cfg.max_points_per_scan
    pts = torch.tensor(rng.normal(size=(1, M, 3)) * 15, dtype=dtype, device=dev)
    covs = torch.full((1, M), 0.01, dtype=dtype, device=dev)
    mask = torch.ones((1, M), dtype=torch.bool, device=dev)
    t_ins, m2 = kernel_timer(lambda m, p: vh.insert(m, p, covs, mask), carry.map, pts, iters=iters)
    use_kernel = kernel_enabled(cfg.knn_kernel, pts)
    t_knn, _ = kernel_timer(
        lambda m, q: vh.knn_cached(m, q, radius=cfg.knn_radius, wide_radius=cfg.knn_wide_radius,
                                   wide_budget=cfg.knn_wide_budget, cache_k=meas.CAND_K,
                                   use_kernel=use_kernel),
        m2, pts, iters=iters)
    c = carry
    und = prop.undistort(cfg, c.x, c.P, c.hist, group, c.Q, c.last_in, c.last_imu,
                         c.last_end_t, c.mean_acc_norm)
    sd = meas.ScanData(
        pts_body=pts,
        pt_lidar=torch.arange(cfg.num_lidars, device=dev).repeat_interleave(
            cfg.max_points_per_scan)[None],
        pt_epoch=torch.zeros((1, M), dtype=torch.int64, device=dev), pt_mask=mask,
        tc_q=und.tc_q, tc_t=und.tc_t, base=und.base, unc_q=und.unc_q, unc_t=und.unc_t,
        unc_cov=und.unc_cov, epoch_count=und.epoch_count,
    )

    def upd(x, P, m, s):
        h, c0 = meas.make_h_share(cfg, m, s, x)
        return esekf.update_iterated(x, P, h, c0, max_iter=cfg.max_iteration)

    t_iekf, _ = kernel_timer(upd, carry.x, carry.P, m2, sd, iters=iters)
    return {"insert_ms": round(t_ins * 1000, 2), "nn_ms": round(t_knn * 1000, 2),
            "iekf_ms": round(t_iekf * 1000, 2)}


def gpu_name_and_power_limit():
    """The card's name (torch) and power limit in W (nvidia-smi)."""
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return torch.cuda.get_device_name(0), float(out.strip().splitlines()[0])


def run(points_per_lidar=4096, duration=8.0, passes=3, chunk=8, warmup=8, map_slots=None,
        device="cuda", local_cpp=True):
    """The benchmark record (bench.py's keys, plus gpu, power_limit_w and
    device). The defaults are the headline; smaller arguments give a
    miniature run for tests (device="cpu" reports no card)."""
    from malio_tpu_torch import batched
    from malio_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    res = batched.flagship_benchmark(batch=1, duration=duration, points_per_lidar=points_per_lidar,
                                     passes=passes, chunk=chunk, warmup=warmup,
                                     map_slots=map_slots, device=dev)
    value = float(res["median"])
    best = float(res["best"])
    ate = float(res["ates"][0])
    gated = not (np.isfinite(value) and np.isfinite(ate) and ate <= ATE_GATE_M)
    if gated:
        value = 0.0
        best = 0.0
    pts = 3 * points_per_lidar
    slots = res["map_slots"]
    out = {
        "metric": "scans_per_sec",
        "value": round(value, 3),
        "unit": "scans/s",
        "vs_baseline": round(value / BASELINE_SCANS_PER_SEC, 3),
        "config": f"city-flagship 3-lidar {pts}pt {slots}slot B=1 scan{chunk}",
        "best": round(best, 3),
        "passes": [round(v, 3) for v in res["values"]],
        "ate_m": round(ate, 4) if np.isfinite(ate) else float("nan"),
        "ate_gate_m": ATE_GATE_M,
        "gated": gated,
        "nn_miss_p50": res["stats"]["nn_miss_p50"],
        "map_dropped": res["stats"]["map_dropped_final"],
        "meas_dropped": res["stats"].get("meas_dropped_max", 0.0),
    }
    out.update(kernel_times(bench_config(points_per_lidar, slots), dev))
    if local_cpp:
        cpp = _local_cpp_baseline()
        out.update(cpp)
        if cpp.get("local_cpp_rounds_per_sec"):
            out["vs_local_cpp"] = round(value / cpp["local_cpp_rounds_per_sec"], 3)
    gpu, limit = gpu_name_and_power_limit() if dev.type == "cuda" else (None, None)
    out.update(gpu=gpu, power_limit_w=limit, device=dev.type)
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device available", file=sys.stderr)
        return 2
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
