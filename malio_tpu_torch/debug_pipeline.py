"""Step the pipeline by hand and print its intermediates (counterpart of
the JAX package's scripts/debug_pipeline.py): the one-LiDAR synthetic
sequence of the script, IMU initialisation, then two rounds. Round 1
prints the undistortion (history, base LiDAR, state, epochs, a deskewed
and a raw point) and builds the map through `pipeline.step`; round 2
downsamples the deskewed scan, maps it to the world with the undistorted
state, searches its 5 nearest map points (`voxel_hash.knn`), fits their
planes (`measurement._esti_plane`) and counts what passes each gate.

Runs on the card unless --cpu is given; --f64 runs in f64 (the JAX script
always runs on the CPU in f64).

Usage:
  python -m malio_tpu_torch.debug_pipeline [--cpu] [--f64]

`main(argv)` returns the printed counts as a dict.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def _config():
    from .config import Config

    return Config(
        num_lidars=1, lid_type=(3,), n_scans=(64,), point_filter_num=(1,),
        extrinsic_T=(0.2, 0.0, 0.0), extrinsic_R=(1.0, 0, 0, 0),
        max_raw_points=1024, max_points_per_scan=1024, max_imu_per_group=32,
        traj_capacity=64, spline_capacity=64, epoch_capacity=32,
        map_capacity=1 << 17, filter_size_surf=0.4, filter_size_map=0.4,
        cube_len=300.0, det_range=60.0, plane_th=0.1,
    )


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--f64", action="store_true")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)

    from . import measurement as meas, pipeline, propagate as prop, runner, tree
    from . import preprocess as pre
    from .device import resolve_device
    from .geometry import so3
    from .io.assemble import assemble_groups
    from .io.synthetic import SyntheticSequence
    from .map import voxel_hash as vh

    dev = resolve_device("cpu" if args.cpu else "cuda")
    dtype = torch.float64 if args.f64 else torch.float32
    counts = {}
    cfg = _config()
    seq = SyntheticSequence(duration=3.0, num_lidars=1, points_per_scan=1024,
                            ext_t=np.array([[0.2, 0.0, 0.0]]))
    imu, rounds, traj = seq.generate()
    groups = assemble_groups(cfg, imu, rounds)
    counts["groups"] = len(groups)
    print(len(groups), "groups")

    # the first group is skipped into the IMU statistics, then groups until
    # they are done; no last IMU sample is seeded (the script's carry)
    init = runner.ImuInitializer()
    init.update(np.asarray(groups[0]["imu"], np.float64), groups[0]["imu_mask"])
    gi = 1
    while not init.done:
        init.update(np.asarray(groups[gi]["imu"], np.float64), groups[gi]["imu_mask"])
        gi += 1
    counts.update(init_group=gi, init_n=init.n)
    print("init done at group", gi, "mean_acc", init.mean_acc, "n", init.n)

    x0 = runner.initial_state(cfg, init, dtype, dev)
    P0 = runner.initial_covariance(cfg, dtype, dev)
    Q = torch.as_tensor(np.diag(np.concatenate([
        init.cov_gyr, init.cov_acc, np.full(3, cfg.b_gyr_cov), np.full(3, cfg.b_acc_cov)])),
        dtype=dtype, device=dev)
    carry = pipeline.init_carry(cfg, x0, P0, Q, dtype, dev)
    carry = carry._replace(mean_acc_norm=torch.tensor(np.linalg.norm(init.mean_acc), dtype=dtype,
                                                      device=dev))

    def to_group(g):
        def t(key, dt=dtype):
            return torch.as_tensor(np.asarray(g[key]), dtype=dt, device=dev)

        return prop.MeasureGroup(
            pts=t("pts"), pts_mask=t("pts_mask", torch.bool), beg_t=t("beg_t"),
            end_t=t("end_t"), imu=t("imu"), imu_mask=t("imu_mask", torch.bool),
            imu_cont=t("imu_cont"), imu_cont_mask=t("imu_cont_mask", torch.bool),
            t_shift=torch.zeros((), dtype=dtype, device=dev))

    def undistort(c, g):
        """propagate.undistort of one sequence (the batch of one)."""
        c, g = tree.unsqueeze((c, g))
        return tree.squeeze(prop.undistort(cfg, c.x, c.P, c.hist, g, c.Q, c.last_in, c.last_imu,
                                           c.last_end_t, c.mean_acc_norm))

    # ---- round 1: map build ----
    g = to_group(groups[gi])
    und = undistort(carry, g)
    print("=== undistort round 1 ===")
    print("hist n", und.hist.n, "base", und.base)
    print("x pos", und.x.pos, "vel", und.x.vel)
    t_gt = float(g.end_t[0])
    print("gt pos delta from init-time:", traj.pos(t_gt) - traj.pos(float(g.beg_t[0])))
    print("epoch_count", und.epoch_count)
    print("deskewed pts sample", und.pts_deskewed[0, :3])
    print("raw pts sample", g.pts[0, :3, :3])

    carry, out = pipeline.step(cfg, carry, g, device=dev)
    counts.update(map_size=int(out.map_size), n_effective=int(out.n_effective))
    print("after step1: map", counts["map_size"], "eff", counts["n_effective"])

    # ---- round 2: should match against the map ----
    g2 = to_group(groups[gi + 1])
    und2 = undistort(carry, g2)
    ds_pts, ds_aux, ds_mask = pre.voxel_downsample(
        und2.pts_deskewed[0], und2.pt_epoch[0][:, None].to(dtype), g2.pts_mask[0],
        cfg.filter_size_surf, cfg.max_points_per_scan)
    counts["ds_valid"] = int(ds_mask.sum())
    print("=== round 2 ===")
    print("ds valid:", counts["ds_valid"])
    # world transform with the undistorted state
    x = und2.x
    p_imu = so3.quat_rotate(x.ext_r[0][None], ds_pts) + x.ext_t[0][None]
    p_world = so3.quat_rotate(x.rot[None], p_imu) + x.pos[None]
    nn_pts, nn_covs, nn_d2, nn_cnt, _ = vh.knn(carry.map, p_world, k=5, radius=1)
    valid = ds_mask.cpu().numpy()
    cnt, d2 = nn_cnt.cpu().numpy(), nn_d2.cpu().numpy()
    counts["nn_cnt_hist"] = np.bincount(cnt[valid], minlength=6).tolist()
    print("nn_cnt histogram (valid pts):", np.asarray(counts["nn_cnt_hist"]))
    print("d2[4] stats:", np.percentile(d2[valid, 4], [10, 50, 90]))
    sel = valid & (cnt >= 5) & (d2[:, 4] <= 5)
    counts["selected"] = int(sel.sum())
    print("selected after nn:", counts["selected"])

    # plane fit (batched over the rows)
    normal, d, pv, _ = meas._esti_plane(nn_pts, nn_covs, cfg.plane_th, cfg.cov_threshold)
    pv = pv.cpu().numpy()
    counts["plane_valid"] = int((pv & sel).sum())
    print("plane_valid among sel:", counts["plane_valid"])
    pd2 = (torch.sum(normal * p_world, dim=-1) + d).cpu().numpy()
    norm = np.linalg.norm(ds_pts.cpu().numpy(), axis=-1)
    score = 1 - 0.9 * np.abs(pd2) / np.sqrt(np.maximum(norm, 1e-9))
    counts["score_ok"] = int(((score > 0.1) & pv & sel).sum())
    print("score>0.1 among sel&pv:", counts["score_ok"])
    print("pd2 stats among sel:",
          np.percentile(np.abs(pd2[sel]), [50, 90, 99]) if sel.sum() else "none")
    return counts


if __name__ == "__main__":
    main()
