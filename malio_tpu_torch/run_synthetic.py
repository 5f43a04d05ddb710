"""End-to-end run on a synthetic sequence (counterpart of the JAX package's
scripts/run_synthetic.py): the script's config, `runner.run_sequence`,
the aligned and raw ATE against the ground truth. Runs on the card unless
--cpu is given.

Usage:
  python -m malio_tpu_torch.run_synthetic [--lidars N] [--duration S]
      [--points P] [--cpu] [--f64] [--quiet]

`main(argv)` returns the aligned ATE (m).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _config(L, points):
    from .config import Config

    return Config(
        num_lidars=L,
        lid_type=tuple([3] * L),
        n_scans=tuple([64] * L),
        point_filter_num=tuple([1] * L),
        extrinsic_T=tuple(
            np.array([[0.2, 0.0, 0.0], [-0.3, 0.3, 0.1], [-0.3, -0.3, 0.1]])[:L]
            .reshape(-1)
            .tolist()
        ),
        extrinsic_R=tuple(np.tile([1.0, 0, 0, 0], (L, 1)).reshape(-1).tolist()),
        max_raw_points=points,
        max_points_per_scan=points,
        max_imu_per_group=32,
        traj_capacity=64,
        spline_capacity=64,
        epoch_capacity=32,
        map_capacity=1 << 17,
        filter_size_surf=0.4,
        filter_size_map=0.4,
        cube_len=300.0,
        det_range=60.0,
        plane_th=0.1,
        cov_threshold=30.0,
    )


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lidars", type=int, default=1)
    ap.add_argument("--duration", type=float, default=8.0)
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--quiet", action="store_true",
                    help="no per-round prints: runs the chunked path (pipeline.scan_steps, "
                         "16 rounds a call) instead of a step and a host read each round")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)

    from . import runner
    from .device import resolve_device
    from .eval import ate
    from .io.assemble import assemble_groups
    from .io.synthetic import SyntheticSequence

    device = resolve_device("cpu" if args.cpu else "cuda")
    L = args.lidars
    cfg = _config(L, args.points)
    seq = SyntheticSequence(duration=args.duration, num_lidars=L, points_per_scan=args.points)
    imu, rounds, traj = seq.generate()
    groups = assemble_groups(cfg, imu, rounds)
    print(f"{len(groups)} groups, {len(imu)} imu samples")

    t0 = time.time()
    diag_rows = []

    def cb(carry, out, t_base=0.0):
        diag_rows.append((t_base + float(out.end_time), int(out.iterations),
                          int(out.n_effective), int(out.map_size)))
        if len(diag_rows) % 10 == 1:
            e, i, n, m = diag_rows[-1]
            print(f"t={e:6.2f} iters={i} eff={n:5d} map={m:6d} pos={out.pos.cpu().numpy()}")

    res = runner.run_sequence(
        cfg, groups, dtype=torch.float64 if args.f64 else torch.float32, device=device,
        callback=None if args.quiet else cb,
    )
    dt = time.time() - t0
    n_rounds = len(res["t"])
    print(f"ran {n_rounds} rounds in {dt:.1f}s ({n_rounds / dt:.2f} scans/s)")

    gt = traj.pos(res["t"])
    err = ate.ate_rmse(res["pos"], gt, align=True)
    err_raw = ate.ate_rmse(res["pos"], gt, align=False)
    print(f"ATE RMSE aligned={err:.4f} m  raw={err_raw:.4f} m")
    print("final pos est", res["pos"][-1], "gt", gt[-1])
    return err


if __name__ == "__main__":
    main()
