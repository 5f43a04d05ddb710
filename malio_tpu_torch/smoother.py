"""Sliding-window BA smoother riding alongside the filter odometry
(counterpart of malio_tpu/smoother.py).

Every `keyframe_every` rounds the filter pose and the base LiDAR's
body-frame points become a keyframe; every `optimize_every` keyframes the
full window is refined by the plane BA (ba.optimize_window). The refined
poses form a smoothed trajectory; the filter itself is not touched.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import ba
from .device import resolve_device


@dataclasses.dataclass
class WindowSmoother:
    window_size: int = 8
    keyframe_every: int = 5  # rounds between keyframes
    optimize_every: int = 2  # keyframes between BA solves
    max_points: int = 2048
    cell_size: float = 1.0
    num_cells: int = 16384
    min_pts: int = 6
    iters: int = 6
    dtype: object = torch.float32
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.win = ba.empty_window(self.window_size, self.max_points, self.dtype, self.device)
        self._round = 0
        self._kf_count = 0
        self._kf_times = []
        self.refined = {}  # time -> (q, t)

    def observe(self, out, t_base=0.0):
        """Once per fusion round with its StepOutput; t_base restores the
        absolute time of the group-relative end_time."""
        self._round += 1
        if self._round % self.keyframe_every:
            return
        kw = dict(dtype=self.dtype, device=self.device)
        pts = torch.as_tensor(out.kf_pts).to(**kw)[: self.max_points]
        mask = torch.as_tensor(out.kf_mask).to(self.device)[: self.max_points]
        if pts.shape[0] < self.max_points:
            pad = self.max_points - pts.shape[0]
            pts = torch.cat([pts, torch.zeros((pad, 3), **kw)])
            mask = torch.cat([mask, torch.zeros((pad,), dtype=torch.bool, device=self.device)])
        self.win = ba.push_keyframe(self.win, torch.as_tensor(out.quat).to(**kw),
                                    torch.as_tensor(out.pos).to(**kw), pts, mask)
        self._kf_times = (self._kf_times + [float(out.end_time) + t_base])[-self.window_size:]
        self._kf_count += 1
        # a host read of the window's fill (the reference reads it too)
        if self._kf_count % self.optimize_every == 0 and bool(self.win.valid.all()):
            win_opt, _, _ = ba.optimize_window(
                self.win, cell_size=self.cell_size, num_cells=self.num_cells,
                min_pts=self.min_pts, iters=self.iters,
            )
            self.win = win_opt
            q, t = win_opt.q.cpu().numpy(), win_opt.t.cpu().numpy()
            for i, ti in enumerate(self._kf_times):
                self.refined[ti] = (q[i], t[i])

    def trajectory(self):
        """Refined keyframe trajectory (t, pos, quat) sorted by time."""
        if not self.refined:
            return np.zeros(0), np.zeros((0, 3)), np.zeros((0, 4))
        ts = np.asarray(sorted(self.refined))
        qs = np.stack([self.refined[t][0] for t in ts])
        ps = np.stack([self.refined[t][1] for t in ts])
        return ts, ps, qs
