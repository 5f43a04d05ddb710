"""The port's script entry points against the JAX package's scripts/, on
the CPU (tests/test_torch_scripts_replay.py holds run_batched and play):

* `python -m malio_tpu_torch.run_synthetic` against scripts/run_synthetic.py's
  `main()`, loaded with importlib and run in-process with the same argv
  (`--f64 --quiet --duration 2 --points 256`): the same round count, the
  aligned ATE within 1e-6 m;
* `debug_pipeline.main(["--cpu", "--f64"])`'s counts against the JAX
  package's: the lines scripts/debug_pipeline.py prints, run in a
  subprocess. That script stops after its IMU-initialisation line: it calls
  malio_tpu.propagate.undistort without the `last_imu` argument the
  function has since taken (a TypeError; scripts/ is the reference and
  stays as it is). Its later counts come from the script's own steps run
  in the test with `carry.last_imu` passed, which is what the port does.
"""
import contextlib
import importlib.util
import io
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from malio_tpu import measurement as jmeas, pipeline as jpipe, propagate as jprop
from malio_tpu import preprocess as jpre, runner as jrunner
from malio_tpu.config import Config as JConfig
from malio_tpu.geometry import so3 as jso3
from malio_tpu.io.assemble import assemble_groups as jassemble
from malio_tpu.io.synthetic import SyntheticSequence as JSequence
from malio_tpu.map import voxel_hash as jvh

from malio_tpu_torch import debug_pipeline, run_synthetic

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _jax_config_kept():
    """The JAX scripts call malio_tpu.cache.enable(), which sets process-wide
    JAX options: put them back for the tests that run after."""
    keys = ("jax_compilation_cache_dir", "jax_default_matmul_precision", "jax_enable_x64")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        yield
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def _rounds(text):
    return int(re.search(r"ran (\d+) rounds", text).group(1))


def test_run_synthetic_matches_the_jax_script(monkeypatch):
    argv = ["--f64", "--quiet", "--duration", "2", "--points", "256"]
    out = io.StringIO()
    with _jax_config_kept(), contextlib.redirect_stdout(out):
        monkeypatch.setattr(sys, "argv", ["run_synthetic.py", *argv])
        want = _load_script("run_synthetic").main()
    want_rounds = _rounds(out.getvalue())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = run_synthetic.main([*argv, "--cpu"])
    assert _rounds(out.getvalue()) == want_rounds >= 10
    assert abs(got - want) <= 1e-6, (got, want)


# count -> the line of scripts/debug_pipeline.py that prints it
_PRINTED = {
    "groups": r"^(\d+) groups$",
    "init_group": r"^init done at group (\d+) ",
    "init_n": r"^init done at group .* n (\d+)$",
    "map_size": r"^after step1: map (\d+) ",
    "n_effective": r"^after step1: .* eff (\d+)$",
    "ds_valid": r"^ds valid: (\d+)$",
    "selected": r"^selected after nn: (\d+)$",
    "plane_valid": r"^plane_valid among sel: (\d+)$",
    "score_ok": r"^score>0.1 among sel&pv: (\d+)$",
}


def _jax_counts():
    """scripts/debug_pipeline.py's steps in f64, with the round-2 undistort
    call given `carry.last_imu`: the counts it prints (round 1's undistort
    only prints)."""
    cfg = JConfig(
        num_lidars=1, lid_type=(3,), n_scans=(64,), point_filter_num=(1,),
        extrinsic_T=(0.2, 0.0, 0.0), extrinsic_R=(1.0, 0, 0, 0),
        max_raw_points=1024, max_points_per_scan=1024, max_imu_per_group=32,
        traj_capacity=64, spline_capacity=64, epoch_capacity=32,
        map_capacity=1 << 17, filter_size_surf=0.4, filter_size_map=0.4,
        cube_len=300.0, det_range=60.0, plane_th=0.1,
    )
    seq = JSequence(duration=3.0, num_lidars=1, points_per_scan=1024,
                    ext_t=np.array([[0.2, 0.0, 0.0]]))
    imu, rounds, _ = seq.generate()
    groups = jassemble(cfg, imu, rounds)
    init = jrunner.ImuInitializer()
    init.update(np.asarray(groups[0]["imu"], np.float64), groups[0]["imu_mask"])
    gi = 1
    while not init.done:
        init.update(np.asarray(groups[gi]["imu"], np.float64), groups[gi]["imu_mask"])
        gi += 1
    dtype = jnp.float64
    x0 = jrunner.initial_state(cfg, init, dtype)
    P0 = jrunner.initial_covariance(cfg, dtype)
    Q = jnp.asarray(np.diag(np.concatenate([init.cov_gyr, init.cov_acc,
                                            np.full(3, cfg.b_gyr_cov),
                                            np.full(3, cfg.b_acc_cov)])), dtype)
    carry = jpipe.init_carry(cfg, x0, P0, Q, dtype)
    carry = carry._replace(mean_acc_norm=jnp.asarray(np.linalg.norm(init.mean_acc), dtype))

    def to_group(g):
        return jprop.MeasureGroup(
            t_shift=jnp.asarray(0.0, dtype),
            pts=jnp.asarray(g["pts"], dtype), pts_mask=jnp.asarray(g["pts_mask"]),
            beg_t=jnp.asarray(g["beg_t"], dtype), end_t=jnp.asarray(g["end_t"], dtype),
            imu=jnp.asarray(g["imu"], dtype), imu_mask=jnp.asarray(g["imu_mask"]),
            imu_cont=jnp.asarray(g["imu_cont"], dtype),
            imu_cont_mask=jnp.asarray(g["imu_cont_mask"]))

    counts = dict(groups=len(groups), init_group=gi, init_n=init.n)
    carry, out = jpipe.step(cfg, carry, to_group(groups[gi]))
    counts.update(map_size=int(out.map_size), n_effective=int(out.n_effective))
    g2 = to_group(groups[gi + 1])
    # jitted: op by op it takes a minute on one CPU thread
    und2 = jax.jit(jprop.undistort, static_argnums=0)(
        cfg, carry.x, carry.P, carry.hist, g2, carry.Q, carry.last_in, carry.last_imu,
        carry.last_end_t, carry.mean_acc_norm)
    ds_pts, _, ds_mask = jpre.voxel_downsample(
        und2.pts_deskewed[0], und2.pt_epoch[0][:, None].astype(dtype), g2.pts_mask[0],
        cfg.filter_size_surf, cfg.max_points_per_scan)
    counts["ds_valid"] = int(ds_mask.sum())
    x = und2.x
    p_imu = jso3.quat_rotate(x.ext_r[0][None], ds_pts) + x.ext_t[0][None]
    p_world = jso3.quat_rotate(x.rot[None], p_imu) + x.pos[None]
    nn_pts, nn_covs, nn_d2, nn_cnt, _ = jvh.knn(carry.map, p_world, k=5, radius=1)
    valid, cnt, d2 = np.asarray(ds_mask), np.asarray(nn_cnt), np.asarray(nn_d2)
    counts["nn_cnt_hist"] = np.bincount(cnt[valid], minlength=6).tolist()
    sel = valid & (cnt >= 5) & (d2[:, 4] <= 5)
    counts["selected"] = int(sel.sum())
    normal, d, pv, _ = jax.vmap(jmeas._esti_plane, in_axes=(0, 0, None, None))(
        nn_pts, nn_covs, jnp.asarray(cfg.plane_th, dtype), jnp.asarray(cfg.cov_threshold, dtype))
    pv = np.asarray(pv)
    counts["plane_valid"] = int((pv & sel).sum())
    pd2 = np.asarray(jnp.sum(normal * p_world, axis=-1) + d)
    score = 1 - 0.9 * np.abs(pd2) / np.sqrt(np.maximum(np.linalg.norm(np.asarray(ds_pts), axis=-1),
                                                       1e-9))
    counts["score_ok"] = int(((score > 0.1) & pv & sel).sum())
    return counts


def test_debug_pipeline_counts_match_the_jax_script():
    got = debug_pipeline.main(["--cpu", "--f64"])
    res = subprocess.run([sys.executable, "scripts/debug_pipeline.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    lines = res.stdout.splitlines()
    printed = {}
    for key, pat in _PRINTED.items():
        hits = [m.group(1) for m in map(re.compile(pat).match, lines) if m]
        if hits:
            printed[key] = int(hits[0])
    if res.returncode != 0:  # stopped at the undistort call
        assert "undistort() missing 1 required positional argument" in res.stderr, res.stderr
    assert {"groups", "init_group", "init_n"} <= set(printed), res.stdout
    want = _jax_counts()
    for key, v in printed.items():
        assert want[key] == v, (key, want[key], v)
    assert got == want
    assert got["selected"] > 0 and got["score_ok"] > 0
