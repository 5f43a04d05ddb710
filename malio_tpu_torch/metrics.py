"""Observability: per-round metrics, the console dashboard and structured
JSONL logging (counterpart of malio_tpu/metrics.py; the replacement for
visualize_state, laserMapping.cpp:762-829). The port's stage stamps, host
spans and counters are trace.py's."""
from __future__ import annotations

import json
import resource
import sys
import time

import numpy as np
import torch


def ros_pose_covariance(pose_cov):
    """Permute a [translation(0:3); rotation(3:6)]-ordered 6x6 pose
    covariance into the layout the reference publishes on /Odometry
    (publish_odometry, laserMapping.cpp:510-520): rotation block first,
    i.e. out[i, j] = P[k(i), k(j)] with k swapping the 3-blocks. Accepts
    a single (6,6) or a batch (..., 6, 6)."""
    perm = np.array([3, 4, 5, 0, 1, 2])
    pose_cov = np.asarray(pose_cov)
    return pose_cov[..., perm[:, None], perm[None, :]]


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class MetricsLogger:
    """Collects per-round diagnostics from a `pipeline.StepOutput` and the
    carry; renders a live dashboard and/or appends JSONL records."""

    def __init__(self, jsonl_path=None, dashboard=False, every=10):
        self.jsonl = open(jsonl_path, "a") if jsonl_path else None
        self.dashboard = dashboard
        self.every = every
        self.t_start = time.time()
        self.n = 0
        self.total_compute = 0.0
        self.total_distance = 0.0
        self.prev_pos = None
        self._last = time.time()

    def update(self, carry, out, t_base=0.0):
        now = time.time()
        dt = now - self._last
        self._last = now
        self.n += 1
        self.total_compute += dt
        pos = _host(out.pos)
        if self.prev_pos is not None:
            self.total_distance += float(np.linalg.norm(pos - self.prev_pos))
        self.prev_pos = pos

        rec = {
            "round": self.n,
            "t": t_base + float(out.end_time),
            "pos": pos.tolist(),
            "quat": _host(out.quat).tolist(),
            "iterations": int(out.iterations),
            "n_effective": int(out.n_effective),
            "map_size": int(out.map_size),
            "map_load": round(float(out.map_load), 4),
            "map_dropped": int(out.map_dropped),
            "n_insert": int(out.n_insert),
            "compute_ms": round(dt * 1000, 2),
            "distance_m": round(self.total_distance, 3),
        }
        if self.jsonl:
            self.jsonl.write(json.dumps(rec) + "\n")
        if self.dashboard and self.n % self.every == 0:
            self._render(rec, carry)
        return rec

    def _render(self, rec, carry=None):
        rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
        avg_ms = self.total_compute / max(self.n, 1) * 1000
        lines = [
            "**** malio_tpu_torch — Multi-LiDAR Inertial Odometry ****",
            f"[Timestamp]          {rec['t']:.3f} s   (round {rec['round']})",
            f"[Position]           x={rec['pos'][0]:+.3f}  y={rec['pos'][1]:+.3f}  "
            f"z={rec['pos'][2]:+.3f} m",
            f"[Orientation wxyz]   {np.round(rec['quat'], 4).tolist()}",
            f"[Effective points]   {rec['n_effective']}   [IEKF iterations] {rec['iterations']}",
            f"[Map voxels]         {rec['map_size']}   (+{rec['n_insert']} offered, "
            f"load {rec['map_load']:.2f}, dropped {rec['map_dropped']})",
            f"[Total distance]     {rec['distance_m']:.2f} m",
            f"[Compute]            {rec['compute_ms']:.1f} ms  (avg {avg_ms:.1f} ms)",
            f"[RSS]                {rss_mb:.0f} MB",
        ]
        if carry is not None:
            # per-LiDAR extrinsic state + velocity, matching the reference
            # dashboard (visualize_state, laserMapping.cpp:796-820)
            vel = _host(carry.x.vel)
            lines.insert(
                4,
                f"[Velocity]           x={vel[0]:+.3f}  y={vel[1]:+.3f}  z={vel[2]:+.3f} m/s",
            )
            ext_t = _host(carry.x.ext_t)
            ext_r = _host(carry.x.ext_r)
            for l in range(ext_t.shape[0]):
                lines.append(
                    f"[LiDAR-IMU ext {l}]    t={np.round(ext_t[l], 4).tolist()} "
                    f"q(wxyz)={np.round(ext_r[l], 5).tolist()}"
                )
        sys.stdout.write("\x1b[2J\x1b[H" + "\n".join(lines) + "\n")
        sys.stdout.flush()

    def close(self):
        if self.jsonl:
            self.jsonl.close()
