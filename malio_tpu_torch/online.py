"""Online (live-feed) estimator: the push-style counterpart of
runner.run_sequence (counterpart of malio_tpu/online.py).

The reference is a live ROS node: sensor callbacks buffer messages
(laserMapping.cpp:226-282) and the main loop fuses whenever sync_packages
(laserMapping.cpp:310-396) can assemble one scan per LiDAR with IMU
coverage. Callers push IMU samples and scans in arrival order and poll
fused poses out, with the init, grouping, gating and time rebasing of the
replay path, so the trajectories of the two are the same bits on the same
data.

push_* queue work on the device and return; poll() is the only host sync.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from . import pipeline
from . import propagate as prop
from . import runner
from .device import resolve_device

_POLLED = ("end_time", "pos", "quat", "pose_cov", "iterations", "n_effective", "map_size")


class OnlineEstimator:
    """Push-style multi-LiDAR inertial odometry.

    push_imu(t, gyr, acc)          one IMU sample (absolute seconds).
    push_scan(lidar, beg_t, pts)   one scan: pts (N, 4), column 3 the
                                   per-point time in seconds since beg_t.
    flush()                        end of stream: fuse what is buffered.
    poll()                         drain fused rounds (host sync).

    Grouping is ApproximateTime (laserMapping.cpp:902-913): the pivot is
    the latest stream head; each stream contributes its buffered scan
    closest to the pivot, and scans jumped over are dropped (counted in
    n_dropped_scans). A round fuses once every stream has a scan at or past
    the pivot and the IMU stream reaches sync_lookahead past the round end
    (laserMapping.cpp:313). Runs on the card unless device="cpu".
    """

    def __init__(self, cfg, dtype=torch.float32, device="cuda"):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self._np_dtype = np.float32 if dtype == torch.float32 else np.float64
        self._scans = [collections.deque() for _ in range(cfg.num_lidars)]
        self._imu = []  # (7,) float64 rows, strictly increasing t
        self._imu_cursor = 0  # first IMU row not yet handed to a round
        self._init = runner.ImuInitializer()
        self._carry = None
        self._n_init_groups = 0
        self._prev_last_imu = np.zeros(7)
        self._last_group_imu = np.zeros(7)
        self._prev_base = None
        self._pending = []  # (StepOutput on the device, base) awaiting poll
        self.n_rounds = 0
        self.n_dropped_scans = 0
        self.n_imu_regressions = 0

    # ---- ingestion ----
    def push_imu(self, t, gyr, acc):
        """One IMU sample. A stamp not after the last is dropped ("imu loop
        back", laserMapping.cpp:258-262) and counted."""
        if self._imu and t <= self._imu[-1][0]:
            self.n_imu_regressions += 1
            return
        row = np.empty(7)
        row[0] = t
        row[1:4] = gyr
        row[4:7] = acc
        self._imu.append(row)
        self._try_fuse()

    def push_scan(self, lidar, beg_t, pts, duration=None):
        """One scan of LiDAR slot `lidar`; duration defaults to the largest
        point offset (lidar_end_time, laserMapping.cpp:334)."""
        pts = np.asarray(pts, np.float64)
        if duration is None:
            duration = float(pts[:, 3].max()) if pts.shape[0] else 0.0
        p_abs = pts.copy()
        p_abs[:, 3] += beg_t
        self._scans[lidar].append(
            dict(beg_t=float(beg_t), end_t=float(beg_t) + duration, pts=p_abs)
        )
        self._try_fuse()

    def flush(self):
        """End of stream: the wait for a scan at or past the pivot is
        dropped; the IMU lookahead gate still holds, so trailing rounds
        without IMU coverage stay unfused, as in replay."""
        self._try_fuse(final=True)

    # ---- results ----
    def poll(self):
        """Drain fused rounds: a list of dicts t (absolute end time), pos,
        quat, pose_cov, iterations, n_effective, map_size. On the card
        every device-to-host copy is started (into pinned buffers) before
        one synchronise."""
        staged = []
        copied = False
        for o, base in self._pending:
            rec = {}
            for f in _POLLED:
                a = getattr(o, f)
                if torch.is_tensor(a) and a.device.type == "cuda":
                    buf = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                    buf.copy_(a, non_blocking=True)
                    a, copied = buf, True
                rec[f] = a
            staged.append((rec, base))
        if copied:
            torch.cuda.synchronize(self.device)
        out = []
        for rec, base in staged:
            h = {f: (a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)) for f, a in rec.items()}
            out.append(dict(
                t=float(h["end_time"]) + base, pos=h["pos"], quat=h["quat"],
                pose_cov=h["pose_cov"], iterations=int(h["iterations"]),
                n_effective=int(h["n_effective"]), map_size=int(h["map_size"]),
            ))
        self._pending.clear()
        return out

    @property
    def carry(self):
        return self._carry

    # ---- internals ----
    def _try_fuse(self, final=False):
        cfg = self.cfg
        while True:
            if any(len(b) == 0 for b in self._scans):
                return
            pivot = max(b[0]["end_t"] for b in self._scans)
            # the closest-to-pivot choice is final only once every stream
            # has reached the pivot; flush() drops the wait
            if not final and not all(b[-1]["end_t"] >= pivot for b in self._scans):
                return
            sel = []
            for b in self._scans:
                while len(b) > 1 and abs(b[1]["end_t"] - pivot) <= abs(b[0]["end_t"] - pivot):
                    b.popleft()
                    self.n_dropped_scans += 1
                sel.append(b[0])
            lidar_end = max(s["end_t"] for s in sel)
            if not self._imu or self._imu[-1][0] - lidar_end < cfg.sync_lookahead:
                return  # wait for the IMU lookahead
            group = self._pad_group(sel)
            for b in self._scans:
                b.popleft()
            self._process(group)

    def _pad_group(self, sel):
        """io/assemble.py's padding for one round, with a persistent IMU
        cursor over the live buffer."""
        cfg = self.cfg
        L, P, I, IC = cfg.num_lidars, cfg.max_raw_points, cfg.max_imu_per_group, cfg.imu_cont_len
        imu_arr = np.asarray(self._imu)
        lidar_end = max(s["end_t"] for s in sel)
        hi = int(np.searchsorted(imu_arr[:, 0], lidar_end, side="right"))
        n_imu = hi - self._imu_cursor
        if n_imu > I:
            raise ValueError(f"imu window {n_imu} exceeds capacity {I}")
        imu = np.zeros((I, 7))
        imu_mask = np.zeros((I,), bool)
        imu[:n_imu] = imu_arr[self._imu_cursor : hi]
        imu_mask[:n_imu] = True

        cont = np.zeros((IC, 7))
        cont_mask = np.zeros((IC,), bool)
        cont_src = [imu_arr[hi - 1]] if n_imu > 0 else []
        cont_src.extend(imu_arr[hi : hi + IC - 1])
        nc = min(len(cont_src), IC)
        if nc:
            cont[:nc] = np.stack(cont_src[:nc])
            cont_mask[:nc] = True

        pts = np.zeros((L, P, 4))
        pts_mask = np.zeros((L, P), bool)
        beg = np.zeros((L,))
        end = np.zeros((L,))
        for l, s in enumerate(sel):
            n = min(s["pts"].shape[0], P)
            pts[l, :n] = s["pts"][:n]
            pts_mask[l, :n] = True
            beg[l] = s["beg_t"]
            end[l] = s["end_t"]

        self._imu_cursor = hi
        # trim the consumed IMU prefix, keeping one sample for the next
        # continuation window's "last drained" row
        if self._imu_cursor > 4096:
            keep = self._imu_cursor - 1
            del self._imu[:keep]
            self._imu_cursor -= keep
        return dict(pts=pts, pts_mask=pts_mask, beg_t=beg, end_t=end, imu=imu,
                    imu_mask=imu_mask, imu_cont=cont, imu_cont_mask=cont_mask)

    def _process(self, g):
        cfg = self.cfg
        m = np.asarray(g["imu_mask"])
        last = np.asarray(g["imu"], np.float64)[m.nonzero()[0][-1]] if m.any() else self._last_group_imu
        if self._carry is None:
            # init phase: first-scan shortcut + IMU statistics
            # (laserMapping.cpp:945-951, IMU_Processing.hpp:147)
            if self._n_init_groups > 0 and self._init.done:
                base0 = runner.group_base(g)
                self._carry = runner.seed_carry(cfg, self._init, self._prev_last_imu, base0,
                                                self.dtype, self.device)
                self._prev_base = base0
                # fall through: this group is the first fused round
            else:
                self._init.update(np.asarray(g["imu"], np.float64), g["imu_mask"])
                self._prev_last_imu = last
                self._last_group_imu = last
                self._n_init_groups += 1
                return
        self._prev_last_imu = last
        self._last_group_imu = last
        gdev, bases = runner._stack_chunk([g], self._np_dtype, self._prev_base, self.device)
        self._prev_base = float(bases[0])
        group = prop.MeasureGroup(*(a[0] for a in gdev))
        self._carry, out = pipeline.step(cfg, self._carry, group, device=self.device)
        self._pending.append((out, float(bases[0])))
        self.n_rounds += 1
