"""City01-length soak (counterpart of the JAX package's scripts/soak_tpu.py).

~13k continuous fusion rounds (City01 is 1309 s at 10 Hz) through the
chunked replay path, `pipeline.scan_steps`, on a circular revisiting
trajectory, so the sliding local map and its eviction run the whole time.
Points are soak-sized (1024 a LiDAR); the host's memory bounds the
synthetic stream, not the card. It looks for what a short run cannot
see: NaN creep, covariance growth, map-slot leaks, throughput drift.

The summary (one JSON line, the last of standard output) holds the JAX
script's keys: a finite trajectory and P, cumulative map drops, evictions
and measurement-cap drops, nn_miss p50 / p99, the throughput of the first
against the last quartile of chunks, and the ATE against the synthetic
ground truth. Earlier lines give what only the card shows: its name and
power limit, its memory at the end of each quartile, and the kernel
launches a round in the first and the last quartile. The per-round
trajectory and diagnostics go to an npz (`--out`).

Usage:
  python -m malio_tpu_torch.soak [--duration 1309] [--points 1024]
      [--chunk 8] [--out soak_traj.npz] [--cpu]

Runs on the card unless --cpu is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

MAP_SLOTS = 1 << 19
# circular revisit: radius speed / yaw_rate ~ 13 m, a lap every ~42 s, so
# ~30 map revisits over City01's length
WORLD = dict(n_planes=96, extent=40.0, patch=10.0, grid=0.3)
RANGE_MAX = 35.0
KERNELS = ("knn_window", "deskew", "merge_rows")


def soak_sequence(duration, points, seed=0):
    """The soak's config and stream: the City 3-LiDAR flagship shape at
    `points` raw points a LiDAR and a 2^19-slot map, with no
    measurement-lane cap (the 13/16 cap is sized for the 4096-point
    flagship; at soak point counts the downsample keeps more and the cap
    would clip live points every round). Returns (cfg, measure groups,
    ground-truth trajectory)."""
    from .batched import _flagship_config
    from .io.assemble import assemble_groups
    from .io.synthetic import SyntheticSequence

    cfg = dataclasses.replace(_flagship_config(points, MAP_SLOTS, False), max_meas_points=None)
    seq = SyntheticSequence(
        duration=duration, num_lidars=3, points_per_scan=points,
        ext_t=np.asarray(cfg.extrinsic_T, np.float64).reshape(3, 3),
        ext_q_wxyz=np.asarray(cfg.extrinsic_R, np.float64).reshape(3, 4),
        range_max=RANGE_MAX, seed=seed, world_kwargs=WORLD,
    )
    imu, rounds, traj = seq.generate()
    return cfg, assemble_groups(cfg, imu, rounds), traj


def _launch_counts():
    from . import ops

    return {name: dict(fn.launches_by_shape) for name, fn in ops.wrappers().items()}


def _launch_delta(before, after):
    return {name: {sh: n - before[name].get(sh, 0) for sh, n in after[name].items()
                   if n != before[name].get(sh, 0)} for name in after}


# the per-round diagnostics `run` keeps: its name -> StepOutput field
ROUND_FIELDS = dict(nn_miss="nn_miss", map_dropped="map_dropped", meas_dropped="n_meas_dropped",
                    map_size="map_size", map_load="map_load", n_insert="n_insert",
                    w_loc="w_loc", iters="iterations", n_eff="n_effective",
                    med_ny="med_normal_y")


def run(cfg, groups, dtype=torch.float32, device="cuda", chunk=8):
    """IMU-initialise the sequence and replay its whole chunks of `chunk`
    rounds through `pipeline.scan_steps`, each fenced by a host copy of its
    positions. Returns a dict: per round `pos`, `t` (absolute, f64),
    `p_tr` (the trace of the pose covariance) and the ROUND_FIELDS; per
    chunk `chunk_s` (host seconds of the step and its fence), `box_min`
    (the local-map box after it) and `launches` (kernel -> shape ->
    launches in it); `memory`, the card's allocated and reserved bytes at
    the end of each quartile of chunks (empty off the card); `carry`, the
    carry after the last round; `rounds`, `chunk` and `wall_s`."""
    from . import pipeline, runner
    from .batched import _init_seq
    from .device import resolve_device

    dev = resolve_device(device)
    carry, stream, prev_base = _init_seq(cfg, groups, dtype, dev)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    n_chunks = len(stream) // chunk
    quartile_end = {quartile_chunks(n_chunks, k).stop - 1: k + 1 for k in range(4)}
    cols = {k: [] for k in ("pos", "t", "p_tr", *ROUND_FIELDS)}
    chunk_s, box_min, launches, memory = [], [], [], []
    t0 = time.time()
    for c in range(n_chunks):
        gdev, bases = runner._stack_chunk(stream[c * chunk : (c + 1) * chunk], np_dtype,
                                          prev_base, dev)
        prev_base = float(bases[-1])
        before = _launch_counts()
        t_a = time.perf_counter()
        carry, st = pipeline.scan_steps(cfg, carry, gdev, device=dev)
        cols["pos"].append(st.pos.cpu().numpy())  # the host copy fences the chunk
        chunk_s.append(time.perf_counter() - t_a)
        launches.append(_launch_delta(before, _launch_counts()))
        cols["t"].append(st.end_time.cpu().numpy().astype(np.float64) + bases)
        cols["p_tr"].append(np.einsum("kii->k", st.pose_cov.cpu().numpy()))
        for k, f in ROUND_FIELDS.items():
            cols[k].append(getattr(st, f).cpu().numpy())
        box_min.append(carry.box_min.cpu().numpy())
        if dev.type == "cuda" and c in quartile_end:
            memory.append(dict(quartile=quartile_end[c], chunk=c,
                               allocated=torch.cuda.memory_allocated(dev),
                               reserved=torch.cuda.memory_reserved(dev)))
        if c % 100 == 0:
            print(f"round {c * chunk}/{n_chunks * chunk} map={int(cols['map_size'][-1][-1])} "
                  f"chunk={chunk_s[-1] * 1e3:.0f}ms", file=sys.stderr, flush=True)
    res = {k: np.concatenate(v) for k, v in cols.items()}
    res.update(chunk_s=np.asarray(chunk_s), box_min=np.asarray(box_min), launches=launches,
               memory=memory, carry=carry, rounds=n_chunks * chunk, chunk=chunk,
               wall_s=time.time() - t0)
    return res


def quartile_chunks(n_chunks, k):
    """The chunks of quartile k (0-3) of n_chunks. With q a quarter of
    them (rounded down, at least one), quartile k < 3 is chunks [k q,
    (k + 1) q) and the last quartile the last q chunks, as the summary's
    first- and last-quartile throughputs count them."""
    q = max(1, n_chunks // 4)
    return slice(k * q, (k + 1) * q) if k < 3 else slice(n_chunks - q, n_chunks)


def launches_per_round(res, k):
    """Kernel -> shape -> launches a round over quartile k of the run."""
    sl = quartile_chunks(len(res["launches"]), k)
    rounds = (sl.stop - sl.start) * res["chunk"]
    out = {}
    for chunk in res["launches"][sl]:
        for name, by_shape in chunk.items():
            for sh, n in by_shape.items():
                key = ",".join(map(str, sh))
                out.setdefault(name, {})[key] = out.get(name, {}).get(key, 0) + n
    return {name: {sh: n / rounds for sh, n in d.items()} for name, d in out.items()}


def summary(res, traj):
    """The JAX script's summary keys (scripts/soak_tpu.py:152-169), from a
    `run` result and the ground-truth trajectory, unrounded."""
    from .eval import ate as ate_mod

    pos, times, chunk = res["pos"], res["chunk_s"], res["chunk"]
    n = res["rounds"]
    q = len(times) // 4 or 1
    P = res["carry"].P.cpu().numpy()
    ok = np.isfinite(pos).all(axis=-1)
    gt = traj.pos(res["t"])
    if ok.all():
        ate_v = float(ate_mod.ate_rmse(pos, gt, align=True))
    elif ok.any():  # no alignment through non-finite rows: the raw error of the rest
        ate_v = float(np.sqrt(np.mean(np.sum((pos[ok] - gt[ok]) ** 2, -1))))
    else:
        ate_v = float("nan")
    miss = res["nn_miss"]
    return dict(
        rounds=int(n),
        wall_s=float(res["wall_s"]),
        scans_per_sec=float(n / times.sum()),
        thr_first_quartile=float(chunk * q / times[:q].sum()),
        thr_last_quartile=float(chunk * q / times[-q:].sum()),
        finite=bool(ok.all() and np.isfinite(P).all()),
        n_nonfinite_rounds=int((~ok).sum()),
        P_max=float(np.abs(P).max()),
        ate_m=ate_v,
        map_size_final=int(res["map_size"][-1]),
        map_dropped_final=int(res["map_dropped"][-1]),
        n_evicted_final=int(res["carry"].map.n_evicted),
        meas_dropped_total=int(res["meas_dropped"].sum()),
        nn_miss_p50=float(np.median(miss)),
        nn_miss_p99=float(np.percentile(miss, 99)),
    )


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--duration", type=float, default=1309.0,
                    help="simulated seconds (City01's length by default; 10 rounds a second)")
    ap.add_argument("--points", type=int, default=1024, help="raw points a LiDAR")
    ap.add_argument("--chunk", type=int, default=8, help="rounds a scan_steps call")
    ap.add_argument("--out", default="soak_traj.npz",
                    help="npz of the per-round trajectory and diagnostics")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)

    from . import ops
    from .device import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    if dev.type == "cuda":
        from .ops import _build

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
        _build.build_all(KERNELS)  # before the loop, so the first quartile times no build
    t_gen0 = time.time()
    cfg, groups, traj = soak_sequence(args.duration, args.points, seed=0)
    print(f"generated {len(groups)} rounds in {time.time() - t_gen0:.0f}s", file=sys.stderr)
    ops.reset_launches()
    res = run(cfg, groups, torch.float32, dev, args.chunk)
    np.savez_compressed(args.out, **{k: res[k] for k in (
        "pos", "t", "p_tr", "iters", "n_eff", "med_ny", "w_loc", "map_size")})
    for m in res["memory"]:
        print(f"device memory at the end of quartile {m['quartile']} (chunk {m['chunk']}): "
              f"allocated {m['allocated']} B, reserved {m['reserved']} B")
    for k, name in ((0, "first"), (3, "last")):
        print(f"launches a round, {name} quartile: {json.dumps(launches_per_round(res, k))}")
    out = summary(res, traj)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
