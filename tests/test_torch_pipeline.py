"""Parity of the port's fusion step and replay with the JAX package.

Three rounds of `pipeline.step` from one carry, carried across through
malio_tpu_torch.interop, on a 3-LiDAR City-shaped config in f64 on the CPU
(pos/quat atol 1e-8, P atol 1e-10, map size and effective-point counts
exact, the map table after the first insert exact); and the port's
`run_sequence` against the recorded golden trajectory.
"""
import dataclasses
import pathlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from malio_tpu import pipeline as jpipe
from malio_tpu import runner as jrunner
from malio_tpu.config import Config as JConfig, city_config as jcity

import malio_tpu_torch  # noqa: F401
from malio_tpu_torch import batched as tbatched, checkpoint as tckpt, online as tonline
from malio_tpu_torch import posegraph as tpg
from malio_tpu_torch import interop, pipeline as tpipe, propagate as tprop, runner as trunner
from malio_tpu_torch import smoother as tsm, state as tst
from malio_tpu_torch import debug_pipeline, play, run_batched, run_synthetic, soak as tsoak
from malio_tpu_torch.filter import dynamics as tdyn
from malio_tpu_torch.map import voxel_hash as tvh
from malio_tpu_torch.config import Config as TConfig
from malio_tpu_torch.io.assemble import assemble_groups
from malio_tpu_torch.io.synthetic import SyntheticSequence

torch.set_num_threads(1)
GOLDEN = pathlib.Path(__file__).parent / "golden" / "pipeline_v1.npz"


def flat(obj):
    """A JAX pytree (NamedTuples / dataclasses of arrays) as nested dicts
    of numpy arrays."""
    if hasattr(obj, "_fields"):
        return {f: flat(getattr(obj, f)) for f in obj._fields}
    if dataclasses.is_dataclass(obj):
        return {f.name: flat(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return np.asarray(obj)


def port_config(jcfg):
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    d["knn_kernel"] = d.pop("pallas_knn")
    d["deskew_kernel"] = d.pop("pallas_deskew")
    return TConfig(**d)


def _city_small():
    # __graft_entry__._dryrun_cfg capacities at 256 points per LiDAR
    return jcity(
        max_raw_points=256, max_points_per_scan=256, max_imu_per_group=16,
        imu_cont_len=8, traj_capacity=32, spline_capacity=32, epoch_capacity=16,
        map_capacity=1 << 19, knn_wide_budget=256,
    )


def _groups(cfg, n_pts=256, duration=1.6, seed=3):
    seq = SyntheticSequence(
        duration=duration, num_lidars=3, points_per_scan=n_pts, seed=seed,
        ext_t=np.asarray(cfg.extrinsic_T).reshape(3, 3),
        ext_q_wxyz=np.asarray(cfg.extrinsic_R).reshape(3, 4),
    )
    imu, rounds, _ = seq.generate()
    return assemble_groups(cfg, imu, rounds)


def _jax_init(cfg, groups):
    """The JAX runner's init phase: (carry, first fused group index)."""
    init = jrunner.ImuInitializer()
    prev = np.zeros(7)
    for gi, g in enumerate(groups):
        m = np.asarray(g["imu_mask"])
        last = np.asarray(g["imu"], np.float64)[m.nonzero()[0][-1]] if m.any() else prev
        if gi > 0 and init.done:
            dt = jnp.float64
            c = jpipe.init_carry(
                cfg, jrunner.initial_state(cfg, init, dt),
                jrunner.initial_covariance(cfg, dt), jrunner.process_noise(cfg, init, dt), dt,
            )
            b0 = jrunner.group_base(groups[gi])
            c = c._replace(
                mean_acc_norm=jnp.asarray(np.linalg.norm(init.mean_acc), dt),
                last_imu=jnp.asarray(prev, dt).at[0].add(-b0),
            )
            return c, gi
        init.update(np.asarray(g["imu"], np.float64), g["imu_mask"])
        prev = last
    raise AssertionError("IMU init never completed")


def test_three_city_rounds_match_jax():
    cfg = _city_small()
    tcfg = port_config(cfg)
    groups = _groups(cfg)
    jc, start = _jax_init(cfg, groups)
    chunk = groups[start : start + 3]
    gdev, _ = jrunner._stack_chunk(chunk, np.float64, jrunner.group_base(groups[start]))
    tc = interop.carry_from_numpy(flat(jc), "cpu")
    for k in range(3):
        jg = jax.tree_util.tree_map(lambda a: a[k], gdev)
        tg = interop.group_from_numpy(flat(jg), "cpu")
        jc, jo = jpipe.step(cfg, jc, jg)
        tc, to = tpipe.step(tcfg, tc, tg, device="cpu")
        np.testing.assert_allclose(to.pos.numpy(), np.asarray(jo.pos), atol=1e-8, err_msg=f"round {k}")
        np.testing.assert_allclose(to.quat.numpy(), np.asarray(jo.quat), atol=1e-8)
        np.testing.assert_allclose(tc.P.numpy(), np.asarray(jc.P), atol=1e-10)
        assert int(to.map_size) == int(jo.map_size), k
        assert int(to.n_effective) == int(jo.n_effective), k
        assert int(to.iterations) == int(jo.iterations), k
        assert int(to.nn_miss) == int(jo.nn_miss), k
        if k == 0:
            # first round: every candidate carries cov 0.001, so the
            # insert's voxel ties are broken by batch order alone: the same
            # record must land in the same slot (the world coordinates agree
            # to f64 round-off of the pose arithmetic)
            t_tab, j_tab = tc.map.tab.numpy(), np.asarray(jc.map.tab)
            np.testing.assert_array_equal(t_tab[..., 0], j_tab[..., 0])
            np.testing.assert_array_equal(t_tab[..., 4], j_tab[..., 4])
            np.testing.assert_allclose(t_tab[..., 1:4], j_tab[..., 1:4], atol=1e-12)
    back = interop.carry_to_numpy(tc)
    np.testing.assert_allclose(back["x"]["pos"], np.asarray(jc.x.pos), atol=1e-8)
    np.testing.assert_allclose(back["hist"]["t"], np.asarray(jc.hist.t), atol=1e-9)


_MAP = dict(tab=np.zeros((1, 32, 5), np.float32), voxel_size=np.float32(0.5),
            n_dropped=np.int32(0), n_evicted=np.int32(0))


def _load_map(**kw):
    """checkpoint.load into a template made as a caller makes it: the
    state lands on the template's device."""
    with tempfile.TemporaryDirectory() as d:
        path = pathlib.Path(d) / "map.npz"
        tckpt.save(path, interop.map_from_numpy(_MAP, device="cpu"))
        return tckpt.load(path, interop.map_from_numpy(_MAP, **kw))


def _cli(main, *argv):
    """A command-line entry point called as fn(device=...): --cpu for the CPU."""
    return lambda device="cuda": main([*argv, *(["--cpu"] if device == "cpu" else [])])


# entry points and public constructors, each called as fn(**kw) with the
# device left at its default, and a tensor (or the device) of what it
# returns; None where running it on the CPU is a test of its own
_ON_THE_CARD = {
    "run_sequence": (lambda **kw: trunner.run_sequence(port_config(_city_small()), [], **kw),
                     None),
    "initial_covariance": (lambda **kw: trunner.initial_covariance(port_config(_city_small()),
                                                                   **kw), lambda r: r),
    "map_from_numpy": (lambda **kw: interop.map_from_numpy(_MAP, **kw), lambda r: r.tab),
    "voxel_hash.create": (lambda **kw: tvh.create(1 << 8, 0.5, **kw), lambda r: r.tab),
    "propagate.empty_history": (lambda **kw: tprop.empty_history(8, **kw), lambda r: r.q),
    "state.identity_state": (lambda **kw: tst.identity_state(3, **kw), lambda r: r.ext_r),
    "dynamics.process_noise_matrix": (
        lambda **kw: tdyn.process_noise_matrix(0.1, 0.2, 0.3, 0.4, **kw), lambda r: r),
    "pipeline.scan_steps": (lambda **kw: tpipe.scan_steps(None, None, None, **kw), None),
    "OnlineEstimator": (lambda **kw: tonline.OnlineEstimator(port_config(_city_small()), **kw),
                        lambda r: r.device),
    "WindowSmoother": (lambda **kw: tsm.WindowSmoother(max_points=8, num_cells=64, **kw),
                       lambda r: r.win.q),
    "PoseGraphBackend": (lambda **kw: tpg.PoseGraphBackend(capacity=4, cloud_points=8, **kw),
                         lambda r: r._edge_sets()[0].zq),
    "checkpoint.load": (_load_map, lambda r: r.tab),
    "batched.flagship_benchmark": (lambda **kw: tbatched.flagship_benchmark(batch=1, **kw), None),
    "batched.synthetic_batched_benchmark": (
        lambda **kw: tbatched.synthetic_batched_benchmark(batch=1, **kw), None),
    "soak.run": (lambda **kw: tsoak.run(None, [], **kw), None),
    "soak": (_cli(tsoak.main, "--duration", "1"), None),
    "run_synthetic": (_cli(run_synthetic.main, "--duration", "1"), None),
    "run_batched": (_cli(run_batched.main, "--batch", "1"), None),
    "play": (_cli(play.main, "no_such_tree"), None),
    "debug_pipeline": (_cli(debug_pipeline.main), None),
}


@pytest.mark.parametrize("name", list(_ON_THE_CARD))
def test_entry_points_require_a_card_unless_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fn, tensor_of = _ON_THE_CARD[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()  # the card by default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(device="cuda")
    if tensor_of is not None:
        out = tensor_of(fn(device="cpu"))
        assert (out if isinstance(out, torch.device) else out.device).type == "cpu"


def _golden_cfg():
    return dict(
        num_lidars=1, lid_type=(3,), n_scans=(64,), point_filter_num=(1,),
        extrinsic_T=(0.2, 0.0, 0.0), extrinsic_R=(1.0, 0, 0, 0),
        max_raw_points=1024, max_points_per_scan=1024, max_imu_per_group=32,
        traj_capacity=64, spline_capacity=64, epoch_capacity=32,
        map_capacity=1 << 16, filter_size_surf=0.4, filter_size_map=0.4,
        cube_len=300.0, det_range=60.0, plane_th=0.1, cov_threshold=30.0,
    )


@pytest.mark.slow
def test_run_sequence_matches_golden():
    cfg = TConfig(**_golden_cfg())
    seq = SyntheticSequence(duration=3.0, num_lidars=1, points_per_scan=1024,
                            ext_t=np.array([[0.2, 0.0, 0.0]]), seed=42)
    imu, rounds, _ = seq.generate()
    res = trunner.run_sequence(cfg, assemble_groups(cfg, imu, rounds),
                               dtype=torch.float64, device="cpu")
    g = np.load(GOLDEN)
    np.testing.assert_allclose(res["t"], g["t"], atol=1e-9)
    np.testing.assert_allclose(res["pos"], g["pos"], atol=1e-6)
    np.testing.assert_allclose(res["quat"], g["quat"], atol=1e-6)
    np.testing.assert_array_equal(res["map_size"], g["map_size"])
    np.testing.assert_array_equal(res["n_effective"], g["n_effective"])


def test_run_sequence_first_rounds_match_jax():
    """Short replay (golden config, 1.4 s) through both runners."""
    kw = _golden_cfg()
    seq = SyntheticSequence(duration=1.4, num_lidars=1, points_per_scan=256,
                            ext_t=np.array([[0.2, 0.0, 0.0]]), seed=42)
    imu, rounds, _ = seq.generate()
    kw.update(max_raw_points=256, max_points_per_scan=256)
    jcfg = JConfig(**kw)
    groups = assemble_groups(jcfg, imu, rounds)
    jres = jrunner.run_sequence(jcfg, groups, dtype=jnp.float64, prefetch_chunk=64)
    tres = trunner.run_sequence(port_config(jcfg), groups, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(tres["t"], jres["t"], atol=1e-9)
    np.testing.assert_allclose(tres["pos"], jres["pos"], atol=1e-8)
    np.testing.assert_allclose(tres["quat"], jres["quat"], atol=1e-8)
    np.testing.assert_array_equal(tres["map_size"], jres["map_size"])
    np.testing.assert_array_equal(tres["n_effective"], jres["n_effective"])
