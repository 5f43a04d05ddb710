"""Parity of the port's own copies of the framework-free modules and of its
voxel downsample with the JAX package: the configuration (one kwargs dict
builds both, the flagship capacities agree), the synthetic sequence and the
measure-group assembly (equal arrays), the ATE (equal to f64 round-off)
and `voxel_downsample` (f32 and f64, equal to round-off of the segment sums:
atol 1e-6 in f32 on coordinates of a few metres, 1e-12 in f64)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from malio_tpu import batched as jbatched
from malio_tpu import config as jconfig
from malio_tpu import preprocess as jpre
from malio_tpu.eval import ate as jate
from malio_tpu.io import assemble as jassemble, synthetic as jsyn

from malio_tpu_torch import config as tconfig
from malio_tpu_torch import preprocess as tpre
from malio_tpu_torch.eval import ate as tate
from malio_tpu_torch.io import assemble as tassemble, synthetic as tsyn

torch.set_num_threads(1)
RENAMED = {"pallas_knn": "knn_kernel", "pallas_deskew": "deskew_kernel"}


def _fields(cfg, rename=False):
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if rename:
        d = {RENAMED.get(k, k): v for k, v in d.items()}
    return d


def test_config_fields_and_flagship_capacities_match():
    assert _fields(tconfig.Config()) == _fields(jconfig.Config(), rename=True)
    assert _fields(tconfig.city_config()) == _fields(jconfig.city_config(), rename=True)
    for pts in (256, 4096):
        want = jbatched._flagship_config(pts, 1 << 21, False)
        got = tconfig.flagship_config(points_per_lidar=pts, map_slots=1 << 21)
        assert _fields(got) == _fields(want, rename=True)
    assert tconfig.flagship_config().max_meas_points == 9984


def test_synthetic_sequence_and_assembly_match():
    cfg_kw = dict(max_raw_points=192, max_points_per_scan=192, max_imu_per_group=16,
                  traj_capacity=32, spline_capacity=32, epoch_capacity=16)
    jcfg = jconfig.city_config(**cfg_kw)
    tcfg = tconfig.city_config(**cfg_kw)
    kw = dict(duration=0.9, num_lidars=3, points_per_scan=192, seed=4,
              ext_t=np.asarray(jcfg.extrinsic_T).reshape(3, 3),
              ext_q_wxyz=np.asarray(jcfg.extrinsic_R).reshape(3, 4),
              range_max=tconfig.FLAGSHIP_RANGE_MAX, world_kwargs=tconfig.FLAGSHIP_WORLD)
    jimu, jrounds, jtraj = jsyn.SyntheticSequence(**kw).generate()
    timu, trounds, ttraj = tsyn.SyntheticSequence(**kw).generate()
    np.testing.assert_array_equal(timu, jimu)
    assert len(trounds) == len(jrounds)
    jg = jassemble.assemble_groups(jcfg, jimu, jrounds)
    tg = tassemble.assemble_groups(tcfg, timu, trounds)
    assert len(tg) == len(jg) > 3
    for a, b in zip(tg, jg):
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    t = np.linspace(0.0, 0.9, 7)
    np.testing.assert_array_equal(ttraj.pos(t), jtraj.pos(t))


def test_ate_matches():
    rng = np.random.default_rng(9)
    gt = np.cumsum(rng.normal(size=(50, 3)), 0)
    est = gt @ np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]]).T + 3.0 + rng.normal(size=(50, 3)) * 0.01
    for align in (True, False):
        assert tate.ate_rmse(est, gt, align=align) == pytest.approx(
            jate.ate_rmse(est, gt, align=align), abs=1e-12)


@pytest.mark.parametrize("dtype,atol,cap", [
    (np.float32, 1e-6, 1024), (np.float64, 1e-12, 1024),
    (np.float32, 1e-6, 256),  # more occupied cells than the capacity
])
def test_voxel_downsample_matches_jax(dtype, atol, cap):
    rng = np.random.default_rng(10)
    P = 900
    pts = (rng.normal(size=(P, 3)) * 3).astype(dtype)
    pts[:100] = -np.abs(pts[:100])  # negative cell keys
    pts[100:160] = pts[:60] + 0.01  # shared cells
    aux = rng.integers(0, 6, size=(P, 1)).astype(dtype)
    mask = rng.uniform(size=P) < 0.85
    want = jpre.voxel_downsample(jnp.asarray(pts), jnp.asarray(aux), jnp.asarray(mask), 0.5, cap)
    got = tpre.voxel_downsample(torch.as_tensor(pts), torch.as_tensor(aux),
                                torch.as_tensor(mask), 0.5, cap)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=0)
    assert 0 < int(got[2].sum()) <= cap
