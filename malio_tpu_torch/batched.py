"""Batched multi-sequence replay (counterpart of malio_tpu/batched.py;
BASELINE config 5): B independent sequences stepped in lockstep through
one batched fusion round, `pipeline.step` with a leading batch axis (the
semantics of jax.vmap(pipeline.step)). The round's kernel launches and
host reads serve all B sequences at once, so a batch fills the card that
one sequence leaves idle.

Two benchmark entry points, with the JAX module's defaults and return
keys:

  * ``synthetic_batched_benchmark`` — the light configuration (1 LiDAR,
    2048 points, a 1<<17-slot map).
  * ``flagship_benchmark`` — the City config-3 working point: 3 LiDARs
    with the City rig extrinsics, ~12k downsampled points per fusion round,
    a 1<<21-slot map per sequence, City weighting laws and
    reference-reach k-NN. Reports the median across timed passes and the
    best.

Both run on the card unless the caller passes `device="cpu"`. A timed
window is fenced by `torch.cuda.synchronize()` and a host copy of the
round's positions, as the reference fences with host fetches.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import pipeline, runner, tree
from . import propagate as prop
from .device import resolve_device


def _light_config(points, single_search):
    from .config import Config

    return Config(
        num_lidars=1,
        lid_type=(3,),
        n_scans=(64,),
        point_filter_num=(1,),
        extrinsic_T=(0.2, 0.0, 0.0),
        extrinsic_R=(1.0, 0, 0, 0),
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
        single_search=single_search,
    )


def _flagship_config(points_per_lidar, map_slots, single_search):
    """City config-3 shape with benchmark-sized rolling capacities (the
    City estimator parameters, config.flagship_config)."""
    from .config import flagship_config

    return flagship_config(points_per_lidar, map_slots, single_search)


def _flagship_world(cfg):
    """SyntheticSequence arguments of the flagship: the City rig's
    extrinsics in the dense urban-like world (config.FLAGSHIP_WORLD, ~100k
    plane anchors) seen out to 35 m."""
    from .config import FLAGSHIP_RANGE_MAX, FLAGSHIP_WORLD

    return dict(
        ext_t=np.asarray(cfg.extrinsic_T, np.float64).reshape(3, 3),
        ext_q_wxyz=np.asarray(cfg.extrinsic_R, np.float64).reshape(3, 4),
        range_max=FLAGSHIP_RANGE_MAX, world_kwargs=FLAGSHIP_WORLD,
    )


def _build_sequences(cfg, batch, duration, points_per_scan, seq_kwargs):
    """Generate B synthetic sequences (seeds 0 .. B-1) and assemble their
    measure groups: [(groups, trajectory)]."""
    from .io.assemble import assemble_groups
    from .io.synthetic import SyntheticSequence

    seqs = []
    for b in range(batch):
        seq = SyntheticSequence(
            duration=duration,
            num_lidars=cfg.num_lidars,
            points_per_scan=points_per_scan,
            seed=b,
            **seq_kwargs,
        )
        imu, rounds, traj = seq.generate()
        seqs.append((assemble_groups(cfg, imu, rounds), traj))
    return seqs


def _init_seq(cfg, groups, dtype, device):
    """IMU-initialize one sequence; returns (carry, post-init groups, base).
    A sequence whose initialisation never completes is seeded, as the
    reference seeds it, from the unfinished statistics over all its groups
    (start 0, the last IMU sample of its last group)."""
    init = runner.ImuInitializer()
    start = 0
    prev_last = np.zeros(7)
    for gi, g in enumerate(groups):
        m = np.asarray(g["imu_mask"])
        last = np.asarray(g["imu"], np.float64)[m.nonzero()[0][-1]] if m.any() else prev_last
        if gi > 0 and init.done:
            start = gi
            break
        init.update(np.asarray(g["imu"], np.float64), g["imu_mask"])
        prev_last = last
    b0 = runner.group_base(groups[start])
    return runner.seed_carry(cfg, init, prev_last, b0, dtype, device), groups[start:], b0


def _stack_batched_chunks(streams, bases, n_rounds, chunk, np_dtype, device):
    """Pre-stack every (chunk, B) device group so timed passes measure the
    rounds, not host marshalling: each sequence's chunk is rebased on its
    own time origins, the B sequences are stacked on axis 1 and moved to
    the device in one transfer per field. Returns [(group, bases (K, B))]."""
    chunks = []
    prev_bases = list(bases)
    for c0 in range(0, n_rounds, chunk):
        per_seq = []
        for b, stream in enumerate(streams):
            arrays, bs = runner._chunk_arrays(stream[c0 : c0 + chunk], np_dtype, prev_bases[b])
            prev_bases[b] = float(bs[-1])
            per_seq.append((arrays, bs))
        group = prop.MeasureGroup(**{
            k: torch.as_tensor(np.stack([a[k] for a, _ in per_seq], axis=1)).to(device)
            for k in prop.MeasureGroup._fields
        })
        chunks.append((group, np.stack([bs for _, bs in per_seq], axis=1)))
    return chunks


def _fence(out):
    """Wait for the round's results: synchronise the card, then copy the
    positions to the host (a materialised host value cannot run ahead)."""
    if out.pos.device.type == "cuda":
        torch.cuda.synchronize(out.pos.device)
    return out.pos.cpu()


def _timed_pass(vscan, carry0, chunks, warmup, chunk):
    """One replay of all chunks from the initial carry. Times rounds after
    the first `warmup` rounds; returns (scans/s aggregate, stacked outs)."""
    outs = []
    t_mark = None
    n_warm = 0
    n_done = 0
    carry = carry0
    for gb, bs in chunks:
        carry, stacked = vscan(carry, gb)
        outs.append((stacked, bs))
        n_done += chunk
        if t_mark is None and n_done >= warmup:
            _fence(stacked)
            t_mark = time.perf_counter()
            n_warm = n_done
    _fence(outs[-1][0])
    t_end = time.perf_counter()
    B = outs[-1][0].pos.shape[1]
    # n_done == n_warm: the warmup ended on the final chunk and nothing was
    # timed, so report no measurement rather than a zero
    agg = (
        (n_done - n_warm) * B / (t_end - t_mark)
        if t_mark is not None and n_done > n_warm
        else float("nan")
    )
    return agg, outs


def _trajectories(outs):
    """Per-sequence positions (B, rounds, 3) and absolute end times
    (B, rounds) of a pass's stacked outputs."""
    pos = np.concatenate([o.pos.cpu().numpy() for o, _ in outs])  # (rounds, B, 3)
    ts = np.concatenate([o.end_time.cpu().numpy().astype(np.float64) + bs for o, bs in outs])
    return pos.transpose(1, 0, 2), ts.T


def _ates_from_outs(outs, seqs):
    from .eval import ate

    pos, ts = _trajectories(outs)
    return [ate.ate_rmse(pos[b], seqs[b][1].pos(ts[b])) for b in range(len(seqs))]


def _prepare(cfg, seqs, dtype, chunk, device):
    """Initial batched carry (the B IMU-initialised carries stacked), the
    pre-stacked (chunk, B) groups, and the rounds replayed (the shortest
    stream, full chunks only)."""
    carries, streams, bases = [], [], []
    for groups, _ in seqs:
        c, stream, b0 = _init_seq(cfg, groups, dtype, device)
        carries.append(c)
        streams.append(stream)
        bases.append(b0)
    n_rounds = min(len(s) for s in streams)
    n_rounds -= n_rounds % chunk
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    chunks = _stack_batched_chunks(streams, bases, n_rounds, chunk, np_dtype, device)
    return tree.stack(carries), chunks, n_rounds


def _run_benchmark(cfg, seqs, dtype, chunk, warmup, passes, device="cuda", sink=None):
    """Shared runner: init carries, pre-stack chunks, run `passes` timed
    replays of the identical stream, compute ATE from the last pass. A
    dict `sink` receives the last pass's per-sequence positions, times and
    measurement-lane drops (`pos` (B, rounds, 3), `t` and
    `n_meas_dropped` (B, rounds))."""
    dev = resolve_device(device)
    carry0, chunks, n_rounds = _prepare(cfg, seqs, dtype, chunk, dev)

    def vscan(c, gs):
        return pipeline.scan_steps(cfg, c, gs, device=dev)

    values = []
    outs = None
    for _ in range(max(1, passes)):
        agg, outs = _timed_pass(vscan, carry0, chunks, warmup, chunk)
        if np.isfinite(agg):
            values.append(float(agg))
    ates = _ates_from_outs(outs, seqs)
    if sink is not None:
        sink["pos"], sink["t"] = _trajectories(outs)
        sink["n_meas_dropped"] = np.concatenate(
            [o.n_meas_dropped.cpu().numpy() for o, _ in outs]).T

    def cat(field):
        return np.concatenate([getattr(o, field).cpu().numpy().reshape(-1) for o, _ in outs])

    miss, drops, mdrop = cat("nn_miss"), cat("map_dropped"), cat("n_meas_dropped")
    stats = dict(
        nn_miss_p50=float(np.median(miss)) if miss.size else 0.0,
        nn_miss_p99=float(np.percentile(miss, 99)) if miss.size else 0.0,
        nn_miss_max=float(miss.max()) if miss.size else 0.0,
        map_dropped_final=float(drops.max()) if drops.size else 0.0,
        # live lanes clipped by the measurement-compaction cap: nonzero
        # means the cap is undersized for this world
        meas_dropped_max=float(mdrop.max()) if mdrop.size else 0.0,
    )
    return values, ates, n_rounds, stats


def synthetic_batched_benchmark(
    batch=16, duration=6.0, points=2048, dtype=None, chunk=16, warmup=8,
    single_search=False, device="cuda",
):
    """Run B synthetic sequences through the batched step; returns a dict
    with aggregate scans/s and per-sequence aligned ATE. One timed pass."""
    resolve_device(device)
    if dtype is None:
        dtype = torch.float32
    cfg = _light_config(points, single_search)
    seqs = _build_sequences(
        cfg, batch, duration, points, dict(ext_t=np.array([[0.2, 0.0, 0.0]]))
    )
    values, ates, n_rounds, _stats = _run_benchmark(cfg, seqs, dtype, chunk, warmup, 1, device)
    agg = values[0] if values else float("nan")
    return dict(
        aggregate_scans_per_sec=agg, per_seq=agg / batch, ates=ates,
        rounds=n_rounds,
    )


def flagship_benchmark(
    batch=16, duration=6.0, points_per_lidar=4096, passes=3, chunk=8,
    warmup=8, map_slots=None, single_search=False, dtype=None, device="cuda",
    sink=None,
):
    """City config-3 flagship-shape benchmark: 3 LiDARs (City extrinsics),
    3*points_per_lidar downsampled points per fusion round, a 1<<21-slot
    map per sequence at full scale, City weighting laws + reference-reach
    k-NN, B sequences (seeds 0 .. B-1) of the flagship world.

    Runs `passes` timed replays of the same pre-stacked stream (warmup
    rounds inside each pass are excluded) and reports the per-pass
    throughputs plus their median and best. `sink`: see _run_benchmark."""
    resolve_device(device)
    if dtype is None:
        dtype = torch.float32
    if map_slots is None:
        # full scale gets the City map; miniature smoke shapes scale down
        map_slots = (1 << 21) if points_per_lidar >= 2048 else (1 << 15)
    cfg = _flagship_config(points_per_lidar, map_slots, single_search)
    seqs = _build_sequences(cfg, batch, duration, points_per_lidar, _flagship_world(cfg))
    values, ates, n_rounds, stats = _run_benchmark(
        cfg, seqs, dtype, chunk, warmup, passes, device, sink
    )
    return dict(
        stats=stats,
        values=values,
        median=float(np.median(values)) if values else float("nan"),
        best=float(np.max(values)) if values else float("nan"),
        per_seq_median=(float(np.median(values)) / batch) if values else float("nan"),
        ates=ates,
        rounds=n_rounds,
        points_per_round=cfg.num_lidars * points_per_lidar,
        map_slots=map_slots,
        batch=batch,
    )
