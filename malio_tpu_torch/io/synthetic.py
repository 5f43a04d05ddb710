"""Synthetic multi-LiDAR + IMU sequence generator (host-side, NumPy; the
port's copy of the JAX package's io/synthetic.py).

Ground-truth oracle for integration tests and benchmarks: an analytic
smooth trajectory, analytic IMU (accel includes gravity reaction, gyro =
body rates), and LiDAR scans sampled from a field of planar patches with
per-point timestamps spread across the scan — the same data shape the real
dataset readers produce, so the full pipeline (deskew included) is
exercised end-to-end with a known trajectory.
"""
from __future__ import annotations

import dataclasses

import numpy as np

GRAVITY_W = np.array([0.0, 0.0, -9.81])


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


@dataclasses.dataclass
class Trajectory:
    """Planar arc with gentle vertical bob, starting at rest with a smooth
    speed ramp (real platforms and the reference's IMU init assume a
    stationary start). Closed-form derivatives via the arc-length warp
    tau(t) = t^2/(2 T) for t < T, else t - T/2."""

    speed: float = 2.0
    yaw_rate: float = 0.15
    bob_amp: float = 0.05
    bob_freq: float = 1.3
    ramp: float = 2.0  # seconds to reach full speed

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
        return np.stack(
            [
                r * np.sin(w * tau),
                r * (1.0 - np.cos(w * tau)),
                self.bob_amp * np.sin(self.bob_freq * tau),
            ],
            axis=-1,
        )

    def _dF(self, tau):
        w = self.yaw_rate
        r = self.speed / max(w, 1e-9)
        return np.stack(
            [
                r * w * np.cos(w * tau),
                r * w * np.sin(w * tau),
                self.bob_amp * self.bob_freq * np.cos(self.bob_freq * tau),
            ],
            axis=-1,
        )

    def _ddF(self, tau):
        w = self.yaw_rate
        r = self.speed / max(w, 1e-9)
        return np.stack(
            [
                -r * w * w * np.sin(w * tau),
                r * w * w * np.cos(w * tau),
                -self.bob_amp * self.bob_freq**2 * np.sin(self.bob_freq * tau),
            ],
            axis=-1,
        )

    def pos(self, t):
        return self._F(self._tau(t))

    def vel(self, t):
        return self._dF(self._tau(t)) * self._dtau(t)[..., None]

    def acc(self, t):
        dt_ = self._dtau(t)
        return (
            self._ddF(self._tau(t)) * (dt_ * dt_)[..., None]
            + self._dF(self._tau(t)) * self._ddtau(t)[..., None]
        )

    def rot(self, t):
        return _rz(self.yaw_rate * self._tau(t))

    def gyro_body(self, t):
        return np.array([0.0, 0.0, self.yaw_rate * self._dtau(t)])

    def imu_sample(self, t):
        R = self.rot(t)
        acc_body = R.T @ (self.acc(t) - GRAVITY_W)
        return self.gyro_body(t), acc_body


def make_tunnel_world(length=60.0, half_width=4.0, height=5.0, grid=0.35,
                      jitter=0.0, seed=0):
    """Degenerate corridor world — City02's 400 m tunnel regime
    (reference README.md:216-221): two walls, floor and ceiling running
    along +x with NO x-facing surfaces, so translation along the tunnel
    axis is unobservable from point-to-plane constraints and the
    localization weighting law (laserMapping.cpp:744-759) must engage.
    `jitter` perturbs anchor positions along the surface (NOT along the
    normal) so the degeneracy is exact. Returns (anchors, normals)."""
    rng = np.random.default_rng(seed)
    xs = np.arange(-8.0, length, grid)
    zs = np.arange(-1.5, height, grid)
    ys = np.arange(-half_width, half_width, grid)
    anchors, normals = [], []
    for ysign in (-1.0, 1.0):
        xx, zz = np.meshgrid(xs, zs, indexing="ij")
        wall = np.stack(
            [xx.ravel(), np.full(xx.size, ysign * half_width), zz.ravel()],
            axis=-1,
        )
        anchors.append(wall)
        normals.append(np.tile([0.0, -ysign, 0.0], (wall.shape[0], 1)))
    for z, zsign in ((-1.5, 1.0), (height, -1.0)):
        xx, yy = np.meshgrid(xs, ys, indexing="ij")
        slab = np.stack(
            [xx.ravel(), yy.ravel(), np.full(xx.size, z)], axis=-1
        )
        anchors.append(slab)
        normals.append(np.tile([0.0, 0.0, zsign], (slab.shape[0], 1)))
    anchors = np.concatenate(anchors)
    normals = np.concatenate(normals)
    if jitter:
        # in-surface jitter only: project random offsets off the normal
        off = rng.normal(size=anchors.shape) * jitter
        off -= normals * np.sum(off * normals, axis=-1, keepdims=True)
        anchors = anchors + off
    return anchors, normals


def make_world(n_planes=30, extent=25.0, patch=7.0, grid=0.35, seed=0,
               tunnel=None):
    """Planar patches with anchor-point grids; normals in all directions so
    every DOF is constrained. Returns (anchors (A,3), normals (A,3)).

    tunnel: optional dict of make_tunnel_world kwargs — when given, the
    world is the degenerate corridor instead (SyntheticSequence passes
    world_kwargs straight here, so scenarios opt in via
    world_kwargs=dict(tunnel={...}))."""
    if tunnel is not None:
        return make_tunnel_world(seed=seed, **tunnel)
    rng = np.random.default_rng(seed)
    anchors = []
    normals = []
    g = np.arange(-patch / 2, patch / 2 + 1e-9, grid)
    uu, vv = np.meshgrid(g, g, indexing="ij")
    base = np.stack([uu.ravel(), vv.ravel(), np.zeros(uu.size)], axis=-1)
    for _ in range(n_planes):
        c = rng.uniform(-extent, extent, size=3)
        c[2] = rng.uniform(-2.0, 6.0)
        n = rng.normal(size=3)
        n /= np.linalg.norm(n)
        # basis of the plane
        a = np.cross(n, [0, 0, 1.0])
        if np.linalg.norm(a) < 1e-6:
            a = np.cross(n, [1.0, 0, 0])
        a /= np.linalg.norm(a)
        b = np.cross(n, a)
        R = np.stack([a, b, n], axis=-1)
        pts = base @ R.T + c
        anchors.append(pts)
        normals.append(np.tile(n, (pts.shape[0], 1)))
    # plus a big floor
    gf = np.arange(-extent, extent, 0.45)
    fu, fv = np.meshgrid(gf, gf, indexing="ij")
    floor = np.stack([fu.ravel(), fv.ravel(), np.full(fu.size, -1.5)], axis=-1)
    anchors.append(floor)
    normals.append(np.tile([0.0, 0, 1.0], (floor.shape[0], 1)))
    return np.concatenate(anchors), np.concatenate(normals)


@dataclasses.dataclass
class SyntheticSequence:
    duration: float = 20.0
    imu_rate: float = 100.0
    scan_rate: float = 10.0
    num_lidars: int = 1
    points_per_scan: int = 2048
    range_max: float = 18.0
    noise: float = 0.01
    imu_noise_gyr: float = 1e-3
    imu_noise_acc: float = 1e-2
    # per-LiDAR extrinsics (lidar->imu) and scan phase offsets
    ext_t: np.ndarray = None
    ext_q_wxyz: np.ndarray = None
    phase: np.ndarray = None  # scan start offsets in seconds
    seed: int = 0
    # overrides for the analytic trajectory / plane world, e.g.
    # dict(yaw_rate=0.5) closes the planar arc into a revisiting circle
    # (radius speed/yaw_rate, period 2*pi/yaw_rate + ramp/2) for
    # loop-closure tests
    traj_kwargs: dict = None
    world_kwargs: dict = None

    def __post_init__(self):
        L = self.num_lidars
        if self.ext_t is None:
            self.ext_t = np.zeros((L, 3))
            if L > 1:
                self.ext_t = np.array(
                    [[0.2, 0.0, 0.0], [-0.3, 0.3, 0.1], [-0.3, -0.3, 0.1]]
                )[:L]
        if self.ext_q_wxyz is None:
            self.ext_q_wxyz = np.tile([1.0, 0, 0, 0], (L, 1))
        if self.phase is None:
            # asynchronous scan ends (the whole point of MA-LIO)
            self.phase = np.linspace(0.0, 0.04, L)

    def generate(self):
        """Returns (imu_records (N,7), scans, traj_fn).

        scans: list over scan rounds of list over lidars of dict with
        keys beg_t, end_t, pts (P,4 with absolute per-point time in col 3,
        xyz in the LiDAR frame at each point's own timestamp)."""
        rng = np.random.default_rng(self.seed)
        traj = Trajectory(**(self.traj_kwargs or {}))
        anchors, _ = make_world(seed=self.seed, **(self.world_kwargs or {}))

        imu_t = np.arange(0.0, self.duration, 1.0 / self.imu_rate)
        imu = np.zeros((imu_t.size, 7))
        for i, t in enumerate(imu_t):
            g, a = traj.imu_sample(t)
            imu[i] = [
                t,
                *(g + rng.normal(size=3) * self.imu_noise_gyr),
                *(a + rng.normal(size=3) * self.imu_noise_acc),
            ]

        scan_period = 1.0 / self.scan_rate
        scan_dur = scan_period * 0.95
        n_rounds = int((self.duration - 0.5) / scan_period)
        ext_R = [self._quat_to_mat(q) for q in self.ext_q_wxyz]

        rounds = []
        for k in range(n_rounds):
            per_lidar = []
            for l in range(self.num_lidars):
                beg = k * scan_period + self.phase[l]
                end = beg + scan_dur
                ts = np.sort(rng.uniform(beg, end, size=self.points_per_scan))
                # sensor position at mid-scan to select visible anchors
                pos_mid = traj.pos((beg + end) / 2)
                d = np.linalg.norm(anchors - pos_mid[None], axis=-1)
                vis = np.where((d < self.range_max) & (d > 1.0))[0]
                # bias sampling toward nearby surfaces (real LiDARs sample
                # close regions densely) so map coverage accumulates fast
                w = 1.0 / np.square(d[vis])
                w /= w.sum()
                sel = rng.choice(vis, size=self.points_per_scan, replace=True, p=w)
                world = anchors[sel]
                # vectorized: per-point pose from the analytic trajectory
                yaws = self.rot_angles(traj, ts)
                c, s = np.cos(yaws), np.sin(yaws)
                pos_t = traj.pos(ts)  # (P, 3)
                d = world - pos_t
                # R(t)^T d with R = Rz(yaw)
                in_imu = np.stack(
                    [c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1], d[:, 2]],
                    axis=-1,
                )
                in_lidar = (in_imu - self.ext_t[l]) @ ext_R[l]
                pts = np.concatenate(
                    [
                        in_lidar + rng.normal(size=in_lidar.shape) * self.noise,
                        ts[:, None],
                    ],
                    axis=1,
                )
                per_lidar.append(dict(beg_t=beg, end_t=end, pts=pts))
            rounds.append(per_lidar)
        return imu, rounds, traj

    @staticmethod
    def rot_angles(traj, ts):
        """Vectorized yaw angles of the trajectory (Rz-only rotation)."""
        return traj.yaw_rate * traj._tau(np.asarray(ts, np.float64))

    @staticmethod
    def _quat_to_mat(q):
        w, x, y, z = q
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
