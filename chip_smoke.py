#!/usr/bin/env python3
"""Smoke run of malio_tpu_torch on one NVIDIA card.

Builds the CUDA kernels from malio_tpu_torch/csrc/, holds each kernel
against its plain PyTorch version at the shapes of the main path, then
drives the City 3-LiDAR flagship through runner.run_sequence with both
kernels on, checks the trajectory against the synthetic ground truth,
re-runs the first rounds with the plain versions, and traces a few steady
rounds with torch.profiler to show where a round's time goes. Any failure
exits non-zero; the last line is the device summary.

    python3 chip_smoke.py

Writes per-round and build details to chiprun_out/chip_smoke.json.
"""
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
ATE_GATE_M = 0.05
PLAIN_ROUNDS = 20
PLAIN_TOL_M = 0.01
# f32 operations per point of csrc/deskew.cu, counted from its source:
# inside the spline window 3 SE(3) exps (~80 each), 3 pose compositions
# (~60 each), 2 quaternion-to-matrix conversions (~25 each), 4 frame maps
# (~15 each) and the basis weights; outside it only the interval test
DESKEW_OPS_PER_POINT = 560
DESKEW_OPS_OUTSIDE = 10


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=30, warm=3):
    """Median time of one call by CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def knn_inputs(Q, C, seed):
    """A candidate window with mixed validity, exact distance ties, sparse
    rows and all-invalid rows, masked exactly as the path masks it."""
    import numpy as np
    import torch
    from malio_tpu_torch.map import voxel_hash as vh

    rng = np.random.default_rng(seed)
    qs = rng.uniform(-5, 5, size=(Q, 3)).astype(np.float32)
    pts = rng.uniform(-6, 6, size=(Q, C, 3)).astype(np.float32)
    valid = rng.uniform(size=(Q, C)) < 0.7
    valid[::97] = False  # all-invalid rows
    valid[5::89, 10:] = False  # fewer valid lanes than K
    pts[2::31, 20] = pts[2::31, 4]  # exact duplicates: distance ties
    pts[3::37, 1::2] = pts[3::37, 0:1]  # many-way ties
    covs = rng.uniform(0.01, 0.5, size=(Q, C)).astype(np.float32)
    q = torch.as_tensor(qs).cuda()
    p = torch.as_tensor(pts).cuda()
    c = torch.as_tensor(covs).cuda()
    v = torch.as_tensor(valid).cuda()
    big = torch.finfo(torch.float32).max
    d2 = vh._sqdist(p, q[:, None, :])
    d2 = torch.where(v, d2, torch.full_like(d2, big)).contiguous()
    c = torch.where(v, c, torch.zeros_like(c)).contiguous()
    return d2, p.contiguous(), c


def knn_phase(shapes, K):
    import torch
    from malio_tpu_torch.ops import knn

    rows = []
    for name, Q, C in shapes:
        d2, p, c = knn_inputs(Q, C, seed=C)
        got = knn.topk_candidates(d2, p, c, K)
        want = knn.topk_candidates_plain(d2, p, c, K)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("pts", "covs", "d2")):
            if not torch.equal(g, w):
                bad = (g != w).sum().item()
                raise AssertionError(f"{name}: kernel {what} differs from plain at {bad} entries")
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ms = time_ms(lambda: knn.topk_candidates(d2, p, c, K))
        plain_ms = time_ms(lambda: knn.topk_candidates_plain(d2, p, c, K), reps=20)

        def library():
            v, i = torch.topk(d2, K, dim=-1, largest=False, sorted=True)
            return (torch.gather(p, 1, i[..., None].expand(Q, K, 3)), torch.gather(c, 1, i), v)

        lib_ms = time_ms(library)
        nbytes = Q * C * 20 + Q * K * 20
        nops = Q * C * K
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_OPS_PER_S * 1e3
        rows.append(dict(
            name=name, route="cuda", source="malio_tpu_torch/csrc/knn_select.cu",
            replaces="malio_tpu/ops/knn_pallas.py:88", shape=f"Q={Q} C={C} K={K}",
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=lib_ms,
        ))
        log(f"kernel {name} Q={Q} C={C} K={K}: bit-equal to plain; {ms:.4f} ms "
            f"(plain {plain_ms:.4f} ms, torch.topk+gather {lib_ms:.4f} ms, "
            f"bound {max(t_bytes, t_ops):.4f} ms by {'bytes' if t_bytes >= t_ops else 'operations'})")
    return rows


def deskew_inputs(L, N, C, seed):
    import numpy as np
    import torch
    from malio_tpu_torch import spline as spl
    from malio_tpu_torch.geometry import se3, so3

    rng = np.random.default_rng(seed)
    dev = "cuda"
    xi = torch.tensor([0.2, -0.1, 0.3, 1.0, 0.5, -0.2], dtype=torch.float32, device=dev)
    ts = torch.arange(C, dtype=torch.float32, device=dev) * 0.01
    Ts = se3.exp_se3(ts[:, None] * xi[None])
    sp = spl.feed_trajectory(ts, so3.mat_to_quat(Ts[:, :3, :3]), Ts[:, :3, 3].contiguous(),
                             torch.ones(C, dtype=torch.bool, device=dev), cap=C)
    pts = np.concatenate(
        [rng.normal(size=(L, N, 3)) * 10, rng.uniform(-0.05, 0.7, size=(L, N, 1))], -1
    ).astype(np.float32)
    small = lambda s: torch.as_tensor(rng.normal(size=(L, 3)) * s, dtype=torch.float32, device=dev)
    return (torch.as_tensor(pts, device=dev), sp, so3.exp_so3(small(0.2)), small(0.5),
            so3.exp_so3(small(0.1)), small(1.0))


def deskew_phase(L, N, C):
    import torch
    from malio_tpu_torch.ops import deskew

    args = deskew_inputs(L, N, C, seed=1)
    got = deskew.deskew_points(*args)
    want = deskew.deskew_points_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got[..., 3], want[..., 3]):
        raise AssertionError("deskew: ok flags differ from plain")
    err = float((got[..., :3] - want[..., :3]).abs().max())
    if not err <= 2e-5:
        raise AssertionError(f"deskew: max |kernel - plain| = {err} > 2e-5")
    ms = time_ms(lambda: deskew.deskew_points(*args))
    plain_ms = time_ms(lambda: deskew.deskew_points_plain(*args), reps=20)
    n_ok = int(want[..., 3].sum())
    nbytes = L * N * 32 + C * (16 + 6) * 4 + L * 14 * 4  # points in+out, spline, frames
    nops = n_ok * DESKEW_OPS_PER_POINT + (L * N - n_ok) * DESKEW_OPS_OUTSIDE
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    log(f"kernel deskew L={L} N={N} C={C}: max |kernel - plain| {err:.3g} (atol 2e-5), "
        f"ok flags equal ({n_ok}/{L * N} inside); {ms:.4f} ms (plain {plain_ms:.4f} ms, "
        f"bound {max(t_bytes, t_ops):.6f} ms)")
    return dict(
        name="deskew", route="cuda", source="malio_tpu_torch/csrc/deskew.cu",
        replaces="malio_tpu/ops/deskew_pallas.py:197", shape=f"L={L} N={N} C={C}",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None,
    )


def profile_phase(cfg, groups, n_init, round_ms, skip=8, active=5):
    """Where a steady round's time goes: `active` rounds after `skip`
    traced with torch.profiler (kernels on). Returns the device busy time
    per round (the sum of the kernels' and copies' device intervals, one
    stream), the device's idle share against `round_ms` (the steady round
    time measured without the profiler, which slows the host), launches
    per round and the kernels that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from malio_tpu_torch import runner

    stamps = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=skip - 1, warmup=1, active=active, repeat=1))

    def tick(carry, out, base):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        prof.step()

    with prof:
        runner.run_sequence(cfg, groups[: n_init + skip + active], dtype=torch.float32,
                            device="cuda", callback=tick)
    traced_ms = (stamps[skip + active - 1] - stamps[skip - 1]) * 1e3 / active
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith("ProfilerStep")
           and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / active
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / active
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    launches = sum(1 for e in events if e.name == "cudaLaunchKernel") / active
    out = dict(rounds=active, round_ms=round_ms, traced_round_ms=traced_ms,
               device_busy_ms_per_round=busy_ms if dev else None,
               device_idle_share=1.0 - busy_ms / round_ms if dev else None,
               launches_per_round=launches, device_ops_per_round=len(dev) / active,
               top_device_ms_per_round=top)
    if dev:
        log(f"profile, {active} steady rounds: device busy {busy_ms:.2f} ms/round of a "
            f"{round_ms:.1f} ms round (idle share {out['device_idle_share']:.3f}; "
            f"{traced_ms:.1f} ms/round while traced), {launches:.0f} kernel launches/round")
    else:
        log("profile: torch.profiler recorded no device time; device busy share not measured")
    for name, ms in top:
        log(f"  {ms:8.3f} ms/round  {name[:100]}")
    return out


def flagship_groups(cfg, duration, seed):
    import numpy as np
    from malio_tpu_torch.config import FLAGSHIP_RANGE_MAX, FLAGSHIP_WORLD
    from malio_tpu_torch.io.synthetic import SyntheticSequence
    from malio_tpu_torch.io.assemble import assemble_groups

    seq = SyntheticSequence(
        duration=duration, num_lidars=3, points_per_scan=cfg.max_raw_points, seed=seed,
        ext_t=np.asarray(cfg.extrinsic_T, np.float64).reshape(3, 3),
        ext_q_wxyz=np.asarray(cfg.extrinsic_R, np.float64).reshape(3, 4),
        range_max=FLAGSHIP_RANGE_MAX, world_kwargs=FLAGSHIP_WORLD,
    )
    imu, rounds, traj = seq.generate()
    return assemble_groups(cfg, imu, rounds), traj


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import numpy as np
    import malio_tpu_torch  # noqa: F401  (sets the matmul precision)
    from malio_tpu_torch import runner
    from malio_tpu_torch.config import flagship_config
    from malio_tpu_torch.eval.ate import ate_rmse
    from malio_tpu_torch.ops import _build, deskew, knn

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report = dict(gpu=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.build_all(["knn_select", "deskew"])
    build_s = time.perf_counter() - t0
    log(f"kernels built in {build_s:.1f} s (parallel nvcc, sm_90a)")
    report["build_s"] = build_s
    report["ptxas"] = {n: _build.ptxas_report(n) for n in ("knn_select", "deskew")}

    # ---- kernel phase, at the main path's shapes ----
    cfg = flagship_config()
    K = 16
    knn_rows = knn_phase(
        [("knn_select", cfg.max_meas_points, 8 * 32), ("knn_select_wide", cfg.knn_wide_budget, 208 * 32)],
        K,
    )
    desk_row = deskew_phase(cfg.num_lidars, cfg.max_raw_points, cfg.spline_capacity)

    # ---- main path: City 3-LiDAR flagship, both kernels on ----
    t0 = time.perf_counter()
    groups, traj = flagship_groups(cfg, duration=8.0, seed=0)
    log(f"flagship world + {len(groups)} measure groups generated in {time.perf_counter() - t0:.1f} s")
    stamps = []

    def tick(carry, out, base):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    knn.topk_candidates.launches = 0
    knn.topk_candidates.launches_by_width = {}
    deskew.deskew_points.launches = 0
    t0 = time.perf_counter()
    res = runner.run_sequence(cfg, groups, dtype=torch.float32, device="cuda", callback=tick)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_knn = knn.topk_candidates.launches
    by_width = dict(knn.topk_candidates.launches_by_width)
    n_desk = deskew.deskew_points.launches
    rounds = len(res["t"])
    if n_knn == 0 or n_desk == 0:
        raise AssertionError(f"main path skipped a kernel: knn {n_knn}, deskew {n_desk} launches")
    warm = 8
    steady = (rounds - warm) / (stamps[-1] - stamps[warm - 1])
    ate = ate_rmse(res["pos"], traj.pos(res["t"]))
    miss_p50 = float(np.median(res["nn_miss"]))
    log(f"main path: {rounds} rounds in {wall:.2f} s; steady {steady:.2f} scans/s "
        f"(rounds {warm}+), {smi}")
    log(f"ATE {ate:.4f} m (gate {ATE_GATE_M}), map_dropped {int(res['map_dropped'][-1])}, "
        f"meas_dropped max {int(res['n_meas_dropped'].max())}, nn_miss p50 {miss_p50}, "
        f"map_size {int(res['map_size'][-1])}, launches knn {n_knn} {by_width} deskew {n_desk}")
    if not (np.isfinite(ate) and ate <= ATE_GATE_M):
        raise AssertionError(f"ATE {ate} is not finite or exceeds {ATE_GATE_M} m")
    if not np.all(np.isfinite(res["pos"])) or res["pos"].shape != (rounds, 3):
        raise AssertionError("trajectory has non-finite values or a wrong shape")

    # ---- the same rounds through the plain versions on the card ----
    import dataclasses

    plain_cfg = dataclasses.replace(cfg, knn_kernel=False, deskew_kernel=False)
    n_init = len(groups) - rounds  # groups consumed by the IMU initialisation
    res_p = runner.run_sequence(plain_cfg, groups[: n_init + PLAIN_ROUNDS], dtype=torch.float32,
                                device="cuda")
    k = len(res_p["t"])
    dpos = float(np.abs(res_p["pos"] - res["pos"][:k]).max())
    log(f"plain versions, first {k} rounds: max |pos(kernels) - pos(plain)| = {dpos:.3g} m "
        f"(limit {PLAIN_TOL_M})")
    if not dpos <= PLAIN_TOL_M:
        raise AssertionError(f"kernel and plain trajectories differ by {dpos} m")

    # ---- where a steady round's time goes ----
    report["profile"] = profile_phase(cfg, groups, n_init, round_ms=1e3 / steady)

    knn_rows[0]["launches"] = by_width.get(8 * 32, 0)
    knn_rows[1]["launches"] = n_knn - knn_rows[0]["launches"]
    desk_row["launches"] = n_desk
    kernels = knn_rows + [desk_row]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    report.update(
        kernels=kernels, rounds=rounds, wall_s=wall, steady_scans_per_s=steady, ate_m=ate,
        map_dropped=res["map_dropped"].tolist(), nn_miss=res["nn_miss"].tolist(),
        meas_dropped=res["n_meas_dropped"].tolist(), iterations=res["iterations"].tolist(),
        map_size=res["map_size"].tolist(), round_s=np.diff(stamps).tolist(),
        plain_max_dpos_m=dpos,
    )
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": [{k2: r[k2] for k2 in keys} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
