"""The port's copies of the JAX package's dataset I/O and trajectory
evaluation against their originals on the same files (as
tests/test_torch_io.py holds the other copies): io/export.write_dataset
writes byte-identical trees; io/dataset reads them (IMU csv, the three
record decoders, file listing, time grouping, load_sequence) into equal
arrays; io/pcd writes identical files and reads them back equal;
eval/ate's TUM I/O, association, ATE, rotation ATE, RPE and quaternion
helpers agree to f64 round-off (1e-12); the native decoder binding equals
the numpy decoders where the shared library loads."""
import filecmp

import numpy as np
import pytest

from malio_tpu.eval import ate as jate
from malio_tpu.io import dataset as jds, export as jexport, native as jnative, pcd as jpcd
from malio_tpu.io import synthetic as jsyn

from malio_tpu_torch.eval import ate as tate
from malio_tpu_torch.io import dataset as tds, export as texport, native as tnative, pcd as tpcd

SENSORS = ["ouster", "livox_avia", "vlp_left"]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One synthetic 3-LiDAR sequence (one of each record format) written by
    both exporters, with ground truth."""
    seq = jsyn.SyntheticSequence(duration=1.5, num_lidars=3, points_per_scan=300, seed=7)
    imu, rounds, traj = seq.generate()
    roots = {}
    for name, mod in (("jax", jexport), ("port", texport)):
        roots[name] = tmp_path_factory.mktemp(f"ds_{name}")
        mod.write_dataset(roots[name], imu, rounds, SENSORS, n_scans=[128, 8, 16], traj=traj)
    return roots


def _files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def test_write_dataset_trees_are_identical(trees):
    names = _files(trees["jax"])
    assert names == _files(trees["port"]) and len(names) > 30
    for n in names:
        assert filecmp.cmp(trees["jax"] / n, trees["port"] / n, shallow=False), n
    assert tds.SENSOR_DIRS == jds.SENSOR_DIRS
    assert tds.TIME_UNIT_SCALE == jds.TIME_UNIT_SCALE
    assert (tds.AVIA, tds.VELO16, tds.OUST64) == (jds.AVIA, jds.VELO16, jds.OUST64)


def test_readers_and_decoders_match(trees):
    root = trees["port"]
    csv = root / "sensor_data" / "xsens_imu.csv"
    np.testing.assert_array_equal(tds.read_imu_csv(csv), jds.read_imu_csv(csv))
    decoders = {"ouster": "decode_ouster", "livox_avia": "decode_livox",
                "vlp_left": "decode_velodyne"}
    for sensor, fn in decoders.items():
        files = tds.list_scan_files(root, sensor)
        assert files == jds.list_scan_files(root, sensor) and len(files) >= 8
        for f in files[:3]:
            for pfn in (1, 3):
                got = getattr(tds, fn)(f, pfn)
                want = getattr(jds, fn)(f, pfn)
                np.testing.assert_array_equal(got[0], want[0])
                assert got[1] == want[1]
    rng = np.random.default_rng(3)
    stamps = [np.sort(rng.uniform(0, 5, 40)), np.sort(rng.uniform(0, 5, 38)),
              np.sort(rng.uniform(0, 5, 45))]
    assert tds.group_rounds_by_time(stamps) == jds.group_rounds_by_time(stamps)
    assert (tds.group_rounds_by_time(stamps, period=0.2)
            == jds.group_rounds_by_time(stamps, period=0.2))


def test_load_sequence_matches(trees):
    args = (SENSORS, [3, 1, 2], [2, 3, 1], [128, 8, 16])
    for kw in (dict(), dict(blind=0.5, timestamp_unit=0, time_offset_lidar_to_imu=0.01)):
        ti, tr = tds.load_sequence(trees["port"], *args, **kw)
        ji, jr = jds.load_sequence(trees["port"], *args, **kw)
        np.testing.assert_array_equal(ti, ji)
        assert len(tr) == len(jr) >= 8
        for a, b in zip(tr, jr):
            for sa, sb in zip(a, b):
                assert sa["beg_t"] == sb["beg_t"] and sa["end_t"] == sb["end_t"]
                np.testing.assert_array_equal(sa["pts"], sb["pts"])


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("intensity", [True, False])
def test_pcd_write_and_read_match(tmp_path, binary, intensity):
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(257, 3)) * 20
    inten = rng.uniform(size=257) if intensity else None
    tpcd.write_pcd(tmp_path / "t.pcd", pts, inten, binary=binary)
    jpcd.write_pcd(tmp_path / "j.pcd", pts, inten, binary=binary)
    assert filecmp.cmp(tmp_path / "t.pcd", tmp_path / "j.pcd", shallow=False)
    got = tpcd.read_pcd(tmp_path / "j.pcd")
    np.testing.assert_array_equal(got, jpcd.read_pcd(tmp_path / "t.pcd"))
    assert got.shape == (257, 4 if intensity else 3)
    if binary:
        np.testing.assert_array_equal(got[:, :3], pts.astype(np.float32))


def _trajectories(n=80, seed=5):
    rng = np.random.default_rng(seed)
    t = np.arange(n) * 0.1
    gt_pos = np.cumsum(rng.normal(size=(n, 3)), 0)
    yaw = np.cumsum(rng.normal(size=n) * 0.05)
    gt_q = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], -1)
    R = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    est_pos = gt_pos @ R.T + 2.0 + rng.normal(size=(n, 3)) * 0.02
    est_q = gt_q + rng.normal(size=(n, 4)) * 0.01
    est_q /= np.linalg.norm(est_q, axis=1, keepdims=True)
    return t, est_pos, est_q, gt_pos, gt_q


def test_trajectory_evaluation_matches(tmp_path):
    t, ep, eq, gp, gq = _trajectories()
    tate.write_tum(tmp_path / "t.txt", t + 1.6e9, ep, eq)
    jate.write_tum(tmp_path / "j.txt", t + 1.6e9, ep, eq)
    assert filecmp.cmp(tmp_path / "t.txt", tmp_path / "j.txt", shallow=False)
    for a, b in zip(tate.read_tum(tmp_path / "j.txt"), jate.read_tum(tmp_path / "t.txt")):
        np.testing.assert_array_equal(a, b)
    tb = t[::2] + np.random.default_rng(6).uniform(-0.015, 0.015, size=t[::2].shape)
    for a, b in zip(tate.associate(t, tb), jate.associate(t, tb)):
        np.testing.assert_array_equal(a, b)
    close = dict(abs=1e-12, rel=0)
    for align in (True, False):
        assert tate.ate_rmse(ep, gp, align) == pytest.approx(jate.ate_rmse(ep, gp, align), **close)
        assert tate.rot_ate_rmse(eq, gq, ep, gp, align) == pytest.approx(
            jate.rot_ate_rmse(eq, gq, ep, gp, align), **close)
    for delta in (1, 10, 200):
        got, want = tate.se3_rpe(ep, eq, gp, gq, delta), jate.se3_rpe(ep, eq, gp, gq, delta)
        for k in ("trans_rmse", "rot_rmse"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-12, rtol=0)
        for k in ("trans_errors", "rot_errors"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-12, rtol=0)
        np.testing.assert_allclose(tate.rpe_rmse(ep, gp, delta), jate.rpe_rmse(ep, gp, delta),
                                   atol=1e-12, rtol=0)
        np.testing.assert_allclose(tate.rpe_rmse(ep, gp, delta, eq, gq),
                                   jate.rpe_rmse(ep, gp, delta, eq, gq), atol=1e-12, rtol=0)
    np.testing.assert_allclose(tate.quat_angle(eq), jate.quat_angle(eq), atol=1e-12, rtol=0)
    np.testing.assert_allclose(tate._quat_mul(eq, gq), jate._quat_mul(eq, gq), atol=1e-12, rtol=0)
    np.testing.assert_allclose(tate._quat_rot(eq, ep), jate._quat_rot(eq, ep), atol=1e-12, rtol=0)
    Rs = np.stack([np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
                   np.diag([-1.0, -1, 1]), tate.umeyama_se3(ep, gp)[0]])
    np.testing.assert_allclose(tate._mat_to_quat(Rs), jate._mat_to_quat(Rs), atol=1e-12, rtol=0)


def test_native_decoder_binding_matches_numpy(trees):
    assert tnative.available() == jnative.available()
    if not tnative.available():
        pytest.skip("native/libmalio_native.so does not load on this host")
    root = trees["port"]
    for sensor, kind, fn in (("ouster", "ouster", tds.decode_ouster),
                             ("livox_avia", "livox", tds.decode_livox),
                             ("vlp_left", "velodyne", tds.decode_velodyne)):
        files = tds.list_scan_files(root, sensor)[:4]
        out, counts, durs = tnative.batch_decode(files, kind, point_filter_num=2, cap=1000)
        for k, f in enumerate(files):
            pts, dur = fn(f, 2)
            assert counts[k] == pts.shape[0]
            np.testing.assert_allclose(out[k, : counts[k]], pts, atol=1e-12, rtol=0)
            np.testing.assert_allclose(durs[k], dur, atol=1e-6, rtol=0)
