"""Interactive dataset replay: the file_player analog (counterpart of the
JAX package's io/player.py, driving the port's OnlineEstimator).

The reference replays a dataset through a Qt GUI (MainWindow) driving
ROSThread: a 10 kHz timer advances the playhead `processed_stamp_` by
wall_dt * play_rate_ while playing (ROSThread.cpp:572-584);
DataStampThread walks the stamp-ordered `data_stamp.csv` multimap and
dispatches each entry to its sensor worker once the playhead passes it
(ROSThread.cpp:393-488); the GUI offers play/pause, a speed spinbox,
loop, skip-stop, and a scrub slider that calls ResetProcessStamp
(ROSThread.cpp:1040-1047, mainwindow.cpp:20-53).

This module re-derives that control surface without ROS/Qt:

- ReplayClock  — the playhead (rate, pause, seek), unit-testable with an
  injected time source.
- DatasetPlayer — walks data_stamp.csv, decodes IMU rows and scan files
  on the fly (with a one-file-ahead prefetch per stream, the DataThread
  worker analog, datathread.h:9-54), and pushes them into an
  OnlineEstimator (the live-node ingestion path, online.py).

Divergences, both deliberate:
- skip-stop: the reference gates on a `stop_period_` map that this fork
  never populates (the checkbox is inert); here `skip_gap` seconds of
  idle data time ahead of the playhead are skipped functionally.
- loop: the reference re-publishes from the start into a still-running
  node (which then trips its "imu loop back" buffer clear and produces
  an undefined trajectory); here each lap restarts a fresh estimator.

The Qt GUI itself stays a non-goal.
"""
from __future__ import annotations

import collections
import concurrent.futures
import pathlib
import time as _time

import numpy as np
import torch

from . import dataset as ds
from .. import online
from ..device import resolve_device


class ReplayClock:
    """The replay playhead in data-relative seconds.

    Mirrors ROSThread::TimerCallback (ROSThread.cpp:572-584): while
    playing, the playhead advances by (wall time delta) * rate; pausing
    freezes it; seek() moves it anywhere. `time_fn` is injectable for
    deterministic tests."""

    def __init__(self, rate=1.0, time_fn=_time.monotonic):
        self.rate = float(rate)
        self.playing = True
        self._time_fn = time_fn
        self._t = 0.0
        self._wall = time_fn()

    def now(self):
        w = self._time_fn()
        if self.playing:
            self._t += (w - self._wall) * self.rate
        self._wall = w
        return self._t

    def pause(self):
        self.now()
        self.playing = False

    def resume(self):
        self._wall = self._time_fn()
        self.playing = True

    def toggle(self):
        if self.playing:
            self.pause()
        else:
            self.resume()

    def set_rate(self, rate):
        self.now()  # settle elapsed time at the old rate first
        self.rate = float(rate)

    def seek(self, t):
        self.now()
        self._t = float(t)


def _norm_name(name):
    return name.strip().lower()


def read_data_stamp(path):
    """data_stamp.csv -> list of (stamp_ns, normalized sensor name)
    in stamp order (ROSThread.cpp:179-187 builds the same multimap)."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) != 2:
                continue
            rows.append((int(parts[0]), _norm_name(parts[1])))
    rows.sort()
    return rows


class DatasetPlayer:
    """Replay a City/UrbanNav dataset tree through an OnlineEstimator at
    a controllable rate.

    sensors: sensor keys (ds.SENSOR_DIRS) in physical LiDAR-slot order.
    The estimator runs in `dtype` (float32 by default) on `device` (the
    card unless "cpu" is asked for).
    realtime=False dispatches as fast as possible (still in stamp order);
    otherwise a ReplayClock paces dispatch at `rate` x real time.
    skip_gap: skip idle stretches longer than this many data seconds.
    loop: on end of data, restart a fresh estimator for another lap.

    Sensor names in data_stamp.csv are matched case-insensitively against
    both the sensor key ("livox_avia" — the reference's dispatch name,
    ROSThread.cpp:440-456) and the on-disk directory name ("Livox_avia").
    """

    def __init__(
        self,
        root,
        cfg,
        sensors,
        dtype=torch.float32,
        device="cuda",
        realtime=True,
        rate=1.0,
        loop=False,
        skip_gap=None,
        time_fn=_time.monotonic,
        sleep_fn=_time.sleep,
    ):
        self.root = pathlib.Path(root)
        self.cfg = cfg
        self.sensors = list(sensors)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.loop = loop
        self.skip_gap = skip_gap
        self.realtime = realtime
        self.clock = ReplayClock(rate=rate, time_fn=time_fn) if realtime else None
        self._sleep = sleep_fn

        sd = self.root / "sensor_data"
        self.entries = read_data_stamp(sd / "data_stamp.csv")
        if not self.entries:
            raise FileNotFoundError(f"empty or missing {sd/'data_stamp.csv'}")

        # sensor-name -> LiDAR slot (accept key and dirname spellings)
        self._slot = {}
        for l, key in enumerate(self.sensors):
            dirname, _ = ds.SENSOR_DIRS[key]
            self._slot[_norm_name(key)] = l
            self._slot[_norm_name(dirname)] = l

        # IMU rows matched by stamp (ROSThread.cpp:246-363 keyed map).
        # read_imu_csv returns f64 seconds; at ~1.6e9 s epoch magnitude
        # the ns round-trip is lossy (doubles are ~256 ns apart there),
        # so exact integer keys silently miss — match the nearest row
        # within 1 us instead.
        imu = np.asarray(ds.read_imu_csv(sd / "xsens_imu.csv"))
        self._imu = imu
        self._imu_t = imu[:, 0] if imu.size else np.zeros((0,))

        # per-slot ordered scan files (dispatch pops these in stamp order,
        # like each sensor worker walking its directory listing)
        self._files = {}
        for l, key in enumerate(self.sensors):
            fl = ds.list_scan_files(self.root, key)
            self._files[l] = collections.deque(
                (int(f.stem), f) for f in sorted(fl, key=lambda q: int(q.stem))
            )

        # sequence origin: same rebasing as ds.load_sequence so the
        # trajectory timeline matches the offline replay path
        first_scan = min(
            (q[0][0] for q in self._files.values() if q), default=None
        )
        if first_scan is None:
            raise FileNotFoundError("no scan files for any configured sensor")
        t_imu0 = imu[0, 0] - cfg.time_offset_lidar_to_imu if imu.size else np.inf
        self.t0 = float(min(t_imu0, first_scan * 1e-9))
        self.span = self.entries[-1][0] * 1e-9 - self.t0

        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._prefetch = {}  # slot -> (stamp_ns, future)
        self._reset_lap()

        # counters / results
        self.laps = []
        self.n_laps = 0
        self.status_extra = ""

    # ------------------------------------------------------------------
    def _reset_lap(self):
        self.est = online.OnlineEstimator(self.cfg, dtype=self.dtype, device=self.device)
        self.recs = []
        self._lap_files = {l: collections.deque(q) for l, q in self._files.items()}
        self._prefetch = {}

    def _decode(self, slot, path):
        cfg = self.cfg
        unit = ds.TIME_UNIT_SCALE[int(cfg.timestamp_unit)]
        lt = cfg.lid_type[slot]
        if lt == ds.OUST64:
            return ds.decode_ouster(
                path, cfg.point_filter_num[slot], cfg.blind, unit
            )
        if lt == ds.AVIA:
            return ds.decode_livox(
                path, cfg.point_filter_num[slot], cfg.n_scans[slot], cfg.blind
            )
        return ds.decode_velodyne(
            path, cfg.point_filter_num[slot], cfg.blind, unit
        )

    def _pop_scan(self, slot, stamp_ns):
        """Fetch the decoded scan for (slot, stamp): from the prefetch if
        it matches, else decode inline; then prefetch the next file."""
        q = self._lap_files[slot]
        while q and q[0][0] < stamp_ns:
            q.popleft()  # stale listing entry (file skipped in data_stamp)
        if not q or q[0][0] != stamp_ns:
            return None  # stamp without a file: drop, like a missed find()
        q.popleft()
        pf = self._prefetch.pop(slot, None)
        if pf is not None and pf[0] == stamp_ns:
            pts, dur = pf[1].result()
        else:
            path = self.root / "sensor_data" / ds.SENSOR_DIRS[self.sensors[slot]][0]
            pts, dur = self._decode(slot, path / f"{stamp_ns}.bin")
        if q:
            nxt_stamp, nxt_path = q[0]
            self._prefetch[slot] = (
                nxt_stamp,
                self._pool.submit(self._decode, slot, nxt_path),
            )
        return pts, dur

    def _imu_row(self, stamp_ns):
        t = stamp_ns * 1e-9
        i = int(np.searchsorted(self._imu_t, t))
        best = None
        for j in (i - 1, i):
            if 0 <= j < self._imu_t.shape[0]:
                d = abs(self._imu_t[j] - t)
                if d < 1e-6 and (best is None or d < best[0]):
                    best = (d, j)
        return None if best is None else self._imu[best[1]]

    def _dispatch(self, stamp_ns, name):
        est = self.est
        if name == "imu":
            row = self._imu_row(stamp_ns)
            if row is not None:
                t = row[0] - self.cfg.time_offset_lidar_to_imu - self.t0
                est.push_imu(t, row[1:4], row[4:7])
            return
        slot = self._slot.get(name)
        if slot is None:
            return  # gps / unmodeled stream: ignored (gps_pub_ is
            # commented out in the reference too, ROSThread.cpp:106)
        got = self._pop_scan(slot, stamp_ns)
        if got is None:
            return
        pts, dur = got
        est.push_scan(slot, stamp_ns * 1e-9 - self.t0, pts, duration=dur)

    # ------------------------------------------------------------------
    def status(self):
        return dict(
            playhead=self.clock.now() if self.clock else float("nan"),
            span=self.span,
            playing=self.clock.playing if self.clock else True,
            rate=self.clock.rate if self.clock else float("inf"),
            rounds=len(self.recs),
            lap=self.n_laps,
            dropped_scans=self.est.n_dropped_scans,
        )

    def seek_fraction(self, frac):
        """Scrub-slider seek (ResetProcessStamp, ROSThread.cpp:1040-1047:
        position/10000 of the data span). Forward seeks burst-dispatch the
        skipped span at full speed; the estimator just processes faster."""
        if self.clock:
            self.clock.seek(max(0.0, min(1.0, frac)) * self.span)

    def run(self, control=None, on_round=None, max_laps=None):
        """Replay. `control(player)` is polled between dispatches — return
        False to stop. `on_round(rec)` fires per fused round. Returns
        {t, pos, quat, laps, ...} (first-lap trajectory arrays)."""
        alive = True
        while alive:
            alive = self._run_lap(control, on_round)
            self.laps.append(self._lap_result())
            self.n_laps += 1
            if not self.loop or (max_laps is not None and self.n_laps >= max_laps):
                break
            if alive:
                self._reset_lap()
                if self.clock:
                    self.clock.seek(0.0)
        out = dict(self.laps[0])
        out["laps"] = self.laps
        out["n_laps"] = self.n_laps
        return out

    def _run_lap(self, control, on_round):
        for stamp_ns, name in self.entries:
            t_rel = stamp_ns * 1e-9 - self.t0
            if self.clock is not None:
                while self.clock.now() < t_rel:
                    if (
                        self.skip_gap
                        and self.clock.playing
                        and t_rel - self.clock.now() > self.skip_gap
                    ):
                        # skip-stop analog (ROSThread.cpp:427-434)
                        self.clock.seek(t_rel)
                        break
                    if control is not None and control(self) is False:
                        return False
                    wait = t_rel - self.clock.now()
                    self._sleep(min(2e-3, max(wait / self.clock.rate, 1e-4)))
            if control is not None and control(self) is False:
                return False
            self._dispatch(stamp_ns, name)
            if self.est._pending:
                new = self.est.poll()
                self.recs.extend(new)
                if on_round is not None:
                    for r in new:
                        on_round(r)
        self.est.flush()
        tail = self.est.poll()
        self.recs.extend(tail)
        if on_round is not None:
            for r in tail:
                on_round(r)
        return True

    def _lap_result(self):
        recs = self.recs
        return dict(
            t=np.asarray([r["t"] for r in recs]),
            pos=np.asarray([r["pos"] for r in recs]),
            quat=np.asarray([r["quat"] for r in recs]),
            n_rounds=len(recs),
            n_dropped_scans=self.est.n_dropped_scans,
            n_imu_regressions=self.est.n_imu_regressions,
        )

    def close(self):
        self._pool.shutdown(wait=False)
