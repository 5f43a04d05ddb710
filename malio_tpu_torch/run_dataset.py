"""Run the odometry on a City/UrbanNav-format dataset directory and write
the TUM trajectory (the reference's Log/trajectory.txt equivalent); the
port's counterpart of the JAX package's scripts/run_dataset.py. Runs on
the card unless --cpu is given.

Usage:
  python -m malio_tpu_torch.run_dataset /path/to/City01 --config city \\
      [--out trajectory.txt] [--cpu] [--f64] [--max-rounds N]
      [--checkpoint-every K --checkpoint-dir ckpts/] [--online]
      [--smoother] [--posegraph [--posegraph-feedback]]
      [--save-cloud-every N --cloud-dir PCD] [--save-map map.pcd]
      [--dashboard] [--metrics-jsonl FILE]

With a Groundtruth.txt in the dataset root it prints the aligned ATE, the
rotation ATE and the RPE against it. `main(argv)` returns a summary dict
(trajectory, rounds, wall time, ATE / RPE when ground truth exists).
"""
from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np
import torch

CONFIGS = {
    "city": dict(sensors=["ouster", "livox_avia", "livox_tele"], factory="city_config"),
    # single-LiDAR subset (BASELINE config 1)
    "city-ouster": dict(sensors=["ouster"], factory="city_ouster_config"),
    "urbannav": dict(sensors=["vlp_left", "vlp_right"], factory="urbannav_config"),
}


def arrival_events(imu, rounds):
    """IMU samples and scans in arrival order (a scan arrives at its end
    time, an IMU sample at its stamp), as OnlineEstimator takes them."""
    events = [("imu", row[0], row) for row in imu]
    for rnd in rounds:
        for l, s in enumerate(rnd):
            rel = s["pts"].copy()
            rel[:, 3] -= s["beg_t"]
            events.append(("scan", s["end_t"], (l, s["beg_t"], rel, s["end_t"] - s["beg_t"])))
    events.sort(key=lambda e: e[1])
    return events


def _run_online(cfg, imu, rounds, dtype, device):
    """Arrival-ordered replay through OnlineEstimator. Returns (res dict
    like run_sequence's, per-round push-to-pose latency ms array)."""
    from .online import OnlineEstimator

    est = OnlineEstimator(cfg, dtype=dtype, device=device)
    recs, lat = [], []
    for kind, _, payload in arrival_events(imu, rounds):
        if kind == "imu":
            est.push_imu(payload[0], payload[1:4], payload[4:7])
        else:
            l, beg, rel, dur = payload
            est.push_scan(l, beg, rel, duration=dur)
        if est._pending:
            t0 = time.perf_counter()
            recs.extend(est.poll())
            lat.append((time.perf_counter() - t0) * 1e3)
            if len(recs) % 50 == 1:
                r = recs[-1]
                print(f"round {len(recs)} t={r['t']:.2f} eff={r['n_effective']} "
                      f"map={r['map_size']} pos={r['pos'].round(2)}", flush=True)
    est.flush()
    recs.extend(est.poll())
    res = dict(
        t=np.asarray([r["t"] for r in recs]),
        pos=np.asarray([r["pos"] for r in recs]),
        quat=np.asarray([r["quat"] for r in recs]),
        carry=est.carry,
    )
    if est.n_dropped_scans or est.n_imu_regressions:
        print(f"dropped scans: {est.n_dropped_scans}, imu regressions: {est.n_imu_regressions}")
    return res, np.asarray(lat[4:] if len(lat) > 8 else lat)


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("--config", choices=CONFIGS, default="city")
    ap.add_argument("--out", default="trajectory.txt")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--max-rounds", type=int, default=0)
    ap.add_argument("--skip-rounds", type=int, default=0, help="seek: skip leading rounds")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default="ckpts")
    ap.add_argument("--max-points", type=int, default=0,
                    help="override max_raw_points/max_points_per_scan (smaller pads for "
                         "small machines or decimated exports)")
    ap.add_argument("--map-capacity", type=int, default=0,
                    help="override map hash capacity (slots)")
    ap.add_argument("--online", action="store_true",
                    help="feed the sequence through the push-style OnlineEstimator in arrival "
                         "order (the live-node execution shape) instead of batch replay; "
                         "reports per-round latency percentiles")
    ap.add_argument("--smoother", action="store_true",
                    help="run the sliding-window plane-BA smoother alongside the filter and "
                         "write <out>.smoothed")
    ap.add_argument("--posegraph", action="store_true",
                    help="run the keyframe pose-graph back-end (loop closure + global "
                         "relaxation) alongside the filter and write <out>.graph")
    ap.add_argument("--posegraph-feedback", action="store_true",
                    help="with --posegraph: feed loop-closure corrections back into the filter "
                         "carry (state/P/history/map re-anchored on the graph-optimized frame)")
    ap.add_argument("--save-cloud-every", type=int, default=0,
                    help="accumulate registered clouds and write PCD/scans_*.pcd every N rounds"
                         " (pcd_save, laserMapping.cpp:467-488)")
    ap.add_argument("--cloud-dir", default="PCD")
    ap.add_argument("--save-map", default="",
                    help="write the final live voxel map to this PCD file (intensity = stored "
                         "covariance) — the ikdtree.flatten dump analog")
    ap.add_argument("--dashboard", action="store_true",
                    help="live console dashboard (visualize_state analog); offline replay "
                         "mode only")
    ap.add_argument("--metrics-jsonl", default="",
                    help="append per-round structured metrics to this JSONL file")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)

    from . import checkpoint, config as cfg_mod, runner
    from .device import resolve_device
    from .eval import ate
    from .io import dataset as ds
    from .io.assemble import assemble_groups
    from .io.pcd import write_pcd

    device = resolve_device("cpu" if args.cpu else "cuda")
    spec = CONFIGS[args.config]
    overrides = {}
    if args.max_points:
        overrides["max_raw_points"] = args.max_points
        overrides["max_points_per_scan"] = args.max_points
    if args.map_capacity:
        overrides["map_capacity"] = args.map_capacity
    cfg = getattr(cfg_mod, spec["factory"])(**overrides)
    print(f"loading {args.root} ({args.config}, {cfg.num_lidars} LiDARs)...")
    imu, rounds = ds.load_sequence(
        args.root, spec["sensors"], list(cfg.lid_type), list(cfg.point_filter_num),
        list(cfg.n_scans), cfg.blind, timestamp_unit=cfg.timestamp_unit,
        time_offset_lidar_to_imu=cfg.time_offset_lidar_to_imu,
    )
    if args.skip_rounds:
        rounds = rounds[args.skip_rounds:]
    if args.max_rounds:
        rounds = rounds[: args.max_rounds]
    print(f"{len(rounds)} rounds, {len(imu)} imu samples")
    groups = assemble_groups(cfg, imu, rounds)

    dtype = torch.float64 if args.f64 else torch.float32
    t0 = time.time()
    k = [0]
    cloud_acc = []
    pcd_idx = [0]
    logger = None
    if args.dashboard or args.metrics_jsonl:
        from .metrics import MetricsLogger

        logger = MetricsLogger(jsonl_path=args.metrics_jsonl or None, dashboard=args.dashboard)

    def cb(carry, out, t_base=0.0):
        k[0] += 1
        if logger is not None:
            logger.update(carry, out, t_base)
        if args.checkpoint_every and k[0] % args.checkpoint_every == 0:
            checkpoint.save(pathlib.Path(args.checkpoint_dir) / f"round_{k[0]:06d}.npz", carry)
        if args.save_cloud_every:
            cloud_acc.append(out.world_pts[out.world_mask].cpu().numpy())
            if k[0] % args.save_cloud_every == 0:
                pcd_idx[0] += 1
                write_pcd(pathlib.Path(args.cloud_dir) / f"scans_{pcd_idx[0]:04d}.pcd",
                          np.concatenate(cloud_acc))
                cloud_acc.clear()
        if k[0] % 50 == 1 and not args.dashboard:
            print(f"round {k[0]} t={float(out.end_time):.2f} eff={int(out.n_effective)} "
                  f"map={int(out.map_size)} pos={out.pos.cpu().numpy().round(2)}", flush=True)

    smoother = None
    if args.smoother:
        from .smoother import WindowSmoother

        smoother = WindowSmoother(dtype=dtype, device=device)
    graph = None
    if args.posegraph:
        from .posegraph import PoseGraphBackend

        graph = PoseGraphBackend(dtype=dtype, feedback=args.posegraph_feedback, device=device)
    summary = {}
    if args.online:
        res, lat = _run_online(cfg, imu, rounds, dtype, device)
        if lat.size:
            summary["latency_ms"] = dict(p50=float(np.percentile(lat, 50)),
                                         p90=float(np.percentile(lat, 90)),
                                         p99=float(np.percentile(lat, 99)))
            print(f"online push->pose latency ms: p50 {summary['latency_ms']['p50']:.1f} "
                  f"p90 {summary['latency_ms']['p90']:.1f} p99 {summary['latency_ms']['p99']:.1f}")
        res["smoothed"] = None
        res["graph"] = None
    else:
        res = runner.run_sequence(cfg, groups, dtype=dtype, device=device, callback=cb,
                                  smoother=smoother, posegraph=graph)
    dt = time.time() - t0
    n = len(res["t"])
    print(f"{n} rounds in {dt:.1f}s ({n / dt:.2f} scans/s)")
    summary.update(res=res, rounds=n, wall_s=dt, scans_per_s=n / dt)
    if logger is not None:
        logger.close()
    ate.write_tum(args.out, res["t"], res["pos"], res["quat"])
    print(f"trajectory written to {args.out}")
    if args.save_map and res.get("carry") is not None:
        from .map import voxel_hash as vh

        mpts, mcovs = vh.extract_points(res["carry"].map)
        write_pcd(args.save_map, mpts, intensity=mcovs)
        summary["map_points"] = int(mpts.shape[0])
        print(f"live map ({mpts.shape[0]} voxels) written to {args.save_map}")
    if smoother is not None and res["smoothed"] is not None:
        ts, ps, qs = res["smoothed"]
        if len(ts):
            ate.write_tum(args.out + ".smoothed", ts, ps, qs)
            print(f"smoothed keyframe trajectory written to {args.out}.smoothed")
    if graph is not None and res.get("graph") is not None:
        ts, ps, qs = res["graph"]
        if len(ts):
            ate.write_tum(args.out + ".graph", ts, ps, qs)
            print(f"pose-graph trajectory ({graph.n_loop_edges} loop edges) written to "
                  f"{args.out}.graph")

    gt_file = pathlib.Path(args.root) / "Groundtruth.txt"
    if gt_file.exists():
        tg, pg, qg = ate.read_tum(gt_file)
        ia, ib = ate.associate(res["t"], tg - tg[0])
        if len(ia) > 10:
            err = ate.ate_rmse(res["pos"][ia], pg[ib], align=True)
            rot_err = ate.rot_ate_rmse(res["quat"][ia], qg[ib], res["pos"][ia], pg[ib], align=True)
            print(f"ATE RMSE (aligned) vs groundtruth: {err:.4f} m / {np.degrees(rot_err):.3f} deg")
            rpe = ate.se3_rpe(res["pos"][ia], res["quat"][ia], pg[ib], qg[ib])
            print(f"RPE RMSE (delta=10 frames) vs groundtruth: {rpe['trans_rmse']:.4f} m / "
                  f"{np.degrees(rpe['rot_rmse']):.3f} deg")
            summary.update(ate_m=err, rot_ate_rad=rot_err, rpe_m=rpe["trans_rmse"],
                           rpe_rad=rpe["rot_rmse"], matched=len(ia))
    return summary


if __name__ == "__main__":
    main()
