"""The benchmark's inputs: a frozen copy of the program's synthetic
sequence generator (malio_tpu_torch/io/synthetic.py) and of its measure
group assembly (io/assemble.py), taken once and never imported from the
program.

Two changes, neither of which alters a value: each LiDAR may have a
point count of its own (`points` is one number a LiDAR), and the work is
vectorised where the random stream allows it: the IMU samples in one
call, the visible-anchor distances over all of a LiDAR's rounds in
blocks, the padded group arrays as one allocation a field. The random
draws keep the original's order (the IMU noise, then round by round and
LiDAR by LiDAR: times, anchor choice, point noise), so at one point
count a LiDAR the arrays are the original's
(portbench/tests/test_portbench_generator.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np

GRAVITY_W = np.array([0.0, 0.0, -9.81])
_DIST_BLOCK = 1 << 22  # anchor distances computed at once (rounds x LiDARs x anchors)


@dataclasses.dataclass
class Trajectory:
    """Planar arc with a gentle vertical bob, starting at rest with a
    smooth speed ramp; closed-form derivatives through the arc-length warp
    tau(t) = t^2 / (2 T) for t < T, else t - T / 2."""

    speed: float = 2.0
    yaw_rate: float = 0.15
    bob_amp: float = 0.05
    bob_freq: float = 1.3
    ramp: float = 2.0

    def _tau(self, t):
        t = np.asarray(t, np.float64)
        T = self.ramp
        return np.where(t < T, t * t / (2 * T), t - T / 2)

    def _dtau(self, t):
        t = np.asarray(t, np.float64)
        return np.clip(t / self.ramp, 0.0, 1.0)

    def _ddtau(self, t):
        t = np.asarray(t, np.float64)
        return np.where(t < self.ramp, 1.0 / self.ramp, 0.0)

    def _F(self, tau):
        w = self.yaw_rate
        r = self.speed / max(w, 1e-9)
        return np.stack([r * np.sin(w * tau), r * (1.0 - np.cos(w * tau)),
                         self.bob_amp * np.sin(self.bob_freq * tau)], axis=-1)

    def _dF(self, tau):
        w = self.yaw_rate
        r = self.speed / max(w, 1e-9)
        return np.stack([r * w * np.cos(w * tau), r * w * np.sin(w * tau),
                         self.bob_amp * self.bob_freq * np.cos(self.bob_freq * tau)], axis=-1)

    def _ddF(self, tau):
        w = self.yaw_rate
        r = self.speed / max(w, 1e-9)
        return np.stack([-r * w * w * np.sin(w * tau), r * w * w * np.cos(w * tau),
                         -self.bob_amp * self.bob_freq**2 * np.sin(self.bob_freq * tau)], axis=-1)

    def pos(self, t):
        return self._F(self._tau(t))

    def vel(self, t):
        return self._dF(self._tau(t)) * self._dtau(t)[..., None]

    def acc(self, t):
        dt_ = self._dtau(t)
        return (self._ddF(self._tau(t)) * (dt_ * dt_)[..., None]
                + self._dF(self._tau(t)) * self._ddtau(t)[..., None])

    def imu_samples(self, ts):
        """(gyro, acc) in the body frame at the times ts (N,): the
        original's imu_sample at each time, R^T (a - g) with R = Rz(yaw)."""
        ts = np.asarray(ts, np.float64)
        yaw = self.yaw_rate * self._tau(ts)
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.zeros((ts.size, 3, 3))
        R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1], R[:, 2, 2] = c, -s, s, c, 1.0
        a = self.acc(ts) - GRAVITY_W
        acc = np.stack([R[i].T @ a[i] for i in range(ts.size)]) if ts.size else np.zeros((0, 3))
        gyro = np.zeros((ts.size, 3))
        gyro[:, 2] = self.yaw_rate * self._dtau(ts)
        return gyro, acc


def make_world(n_planes=30, extent=25.0, patch=7.0, grid=0.35, seed=0):
    """Planar patches with anchor-point grids, normals in all directions,
    and a floor: (anchors (A, 3), normals (A, 3))."""
    rng = np.random.default_rng(seed)
    anchors, normals = [], []
    g = np.arange(-patch / 2, patch / 2 + 1e-9, grid)
    uu, vv = np.meshgrid(g, g, indexing="ij")
    base = np.stack([uu.ravel(), vv.ravel(), np.zeros(uu.size)], axis=-1)
    for _ in range(n_planes):
        c = rng.uniform(-extent, extent, size=3)
        c[2] = rng.uniform(-2.0, 6.0)
        n = rng.normal(size=3)
        n /= np.linalg.norm(n)
        a = np.cross(n, [0, 0, 1.0])
        if np.linalg.norm(a) < 1e-6:
            a = np.cross(n, [1.0, 0, 0])
        a /= np.linalg.norm(a)
        b = np.cross(n, a)
        R = np.stack([a, b, n], axis=-1)
        pts = base @ R.T + c
        anchors.append(pts)
        normals.append(np.tile(n, (pts.shape[0], 1)))
    gf = np.arange(-extent, extent, 0.45)
    fu, fv = np.meshgrid(gf, gf, indexing="ij")
    floor = np.stack([fu.ravel(), fv.ravel(), np.full(fu.size, -1.5)], axis=-1)
    anchors.append(floor)
    normals.append(np.tile([0.0, 0, 1.0], (floor.shape[0], 1)))
    return np.concatenate(anchors), np.concatenate(normals)


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def generate(duration, seed, points, ext_t, ext_q_wxyz, phase=None, imu_rate=100.0,
             scan_rate=10.0, range_max=18.0, noise=0.01, imu_noise_gyr=1e-3,
             imu_noise_acc=1e-2, traj_kwargs=None, world_kwargs=None):
    """(imu (N, 7), rounds, trajectory) as SyntheticSequence.generate gives
    them: rounds is a list over scan rounds of a list over LiDARs of
    dicts beg_t, end_t, pts (P_l, 4) with the absolute point time in
    column 3 and xyz in the LiDAR frame at that time. `points` holds each
    LiDAR's points a scan."""
    L = len(points)
    ext_t = np.asarray(ext_t, np.float64).reshape(L, 3)
    ext_q = np.asarray(ext_q_wxyz, np.float64).reshape(L, 4)
    phase = np.linspace(0.0, 0.04, L) if phase is None else np.asarray(phase, np.float64)
    rng = np.random.default_rng(seed)
    traj = Trajectory(**(traj_kwargs or {}))
    anchors, _ = make_world(seed=seed, **(world_kwargs or {}))

    imu_t = np.arange(0.0, duration, 1.0 / imu_rate)
    gyro, acc = traj.imu_samples(imu_t)
    # one draw of all the noise: the original draws 3 + 3 a sample, in order
    nz = rng.normal(size=(imu_t.size, 2, 3))
    imu = np.concatenate([imu_t[:, None], gyro + nz[:, 0] * imu_noise_gyr,
                          acc + nz[:, 1] * imu_noise_acc], axis=1)

    scan_period = 1.0 / scan_rate
    scan_dur = scan_period * 0.95
    n_rounds = int((duration - 0.5) / scan_period)
    ext_R = [_quat_to_mat(q) for q in ext_q]
    # visible anchors of every (round, LiDAR), distances in blocks of rounds
    k = np.arange(n_rounds)
    beg = k[:, None] * scan_period + phase[None, :]  # (R, L)
    mids = traj.pos(((beg + (beg + scan_dur)) / 2).reshape(-1)).reshape(n_rounds, L, 3)
    vis_w = [[None] * L for _ in range(n_rounds)]
    per = max(1, _DIST_BLOCK // max(1, anchors.shape[0] * L))
    for r0 in range(0, n_rounds, per):
        m = mids[r0 : r0 + per]
        # |anchor - mid| summed as np.linalg.norm sums it: (x^2 + y^2) + z^2
        dx, dy, dz = (ax[None, None] - m[:, :, None, i] for i, ax in enumerate(anchors.T))
        d = np.sqrt((dx * dx + dy * dy) + dz * dz)
        for i in range(m.shape[0]):
            for l in range(L):
                di = d[i, l]
                vis = np.where((di < range_max) & (di > 1.0))[0]
                w = 1.0 / np.square(di[vis])
                vis_w[r0 + i][l] = (vis, w / w.sum())

    rounds = []
    for r in range(n_rounds):
        per_lidar = []
        for l in range(L):
            P = int(points[l])
            b = r * scan_period + phase[l]
            e = b + scan_dur
            ts = np.sort(rng.uniform(b, e, size=P))
            vis, w = vis_w[r][l]
            sel = rng.choice(vis, size=P, replace=True, p=w)
            world = anchors[sel]
            yaws = traj.yaw_rate * traj._tau(ts)
            c, s = np.cos(yaws), np.sin(yaws)
            d = world - traj.pos(ts)
            in_imu = np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1], d[:, 2]],
                              axis=-1)
            in_lidar = (in_imu - ext_t[l]) @ ext_R[l]
            pts = np.concatenate([in_lidar + rng.normal(size=in_lidar.shape) * noise,
                                  ts[:, None]], axis=1)
            per_lidar.append(dict(beg_t=b, end_t=e, pts=pts))
        rounds.append(per_lidar)
    return imu, rounds, traj


def assemble_groups(num_lidars, max_raw_points, max_imu_per_group, imu_cont_len,
                    sync_lookahead, imu_records, rounds, dtype=np.float64):
    """The measure groups of io/assemble.assemble_groups (the padded arrays
    of propagate.MeasureGroup a round), as views into one array a field.
    A round is emitted only while the IMU reaches `sync_lookahead` past its
    end; the IMU is drained up to the round's latest scan end and the
    continuation window takes the last drained sample and the next
    `imu_cont_len - 1`."""
    L, P, I, IC = num_lidars, max_raw_points, max_imu_per_group, imu_cont_len
    if imu_records.shape[0] > 1:
        keep = np.concatenate([[True], np.diff(imu_records[:, 0]) > 0])
        imu_records = imu_records[keep]
    imu_t = imu_records[:, 0]
    n = 0
    for rnd in rounds:
        if imu_t[-1] - max(s["end_t"] for s in rnd) < sync_lookahead:
            break
        n += 1
    pts = np.zeros((n, L, P, 4), dtype)
    pts_mask = np.zeros((n, L, P), bool)
    beg = np.zeros((n, L), dtype)
    end = np.zeros((n, L), dtype)
    imu = np.zeros((n, I, 7), dtype)
    imu_mask = np.zeros((n, I), bool)
    cont = np.zeros((n, IC, 7), dtype)
    cont_mask = np.zeros((n, IC), bool)
    out = []
    cursor = 0
    for k, rnd in enumerate(rounds[:n]):
        assert len(rnd) == L
        lidar_end = max(s["end_t"] for s in rnd)
        hi = int(np.searchsorted(imu_t, lidar_end, side="right"))
        n_imu = hi - cursor
        if n_imu > I:
            raise ValueError(f"imu window {n_imu} exceeds capacity {I}")
        imu[k, :n_imu] = imu_records[cursor:hi]
        imu_mask[k, :n_imu] = True
        src = ([imu_records[hi - 1]] if n_imu > 0 else []) + list(imu_records[hi : hi + IC - 1])
        nc = min(len(src), IC)
        if nc:
            cont[k, :nc] = np.stack(src[:nc])
            cont_mask[k, :nc] = True
        for l, s in enumerate(rnd):
            m = min(s["pts"].shape[0], P)
            pts[k, l, :m] = s["pts"][:m]
            pts_mask[k, l, :m] = True
            beg[k, l] = s["beg_t"]
            end[k, l] = s["end_t"]
        cursor = hi
        out.append(dict(pts=pts[k], pts_mask=pts_mask[k], beg_t=beg[k], end_t=end[k], imu=imu[k],
                        imu_mask=imu_mask[k], imu_cont=cont[k], imu_cont_mask=cont_mask[k]))
    return out
