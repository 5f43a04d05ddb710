"""Parity of the port's filter with the JAX package, in f64 at atol 1e-9:
the process model and covariance propagation, the floored Cholesky on a
near-indefinite operand, the SPD inverse, the measurement model and the
iterated update on the oracle's planar-cluster scenario
(tests/test_oracle_parity.py, the inputs of the ref_esekf.py parity)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from malio_tpu import state as jst
from malio_tpu.filter import dynamics as jdyn, esekf as jesekf

from malio_tpu_torch import state as tst, interop
from malio_tpu_torch import measurement as tmeas
from malio_tpu_torch.config import Config as TConfig
from malio_tpu_torch.filter import dynamics as tdyn, esekf as tesekf

torch.set_num_threads(1)
ATOL = 1e-9
L = 3


def _flat(obj):
    if hasattr(obj, "_fields"):
        return {f: _flat(getattr(obj, f)) for f in obj._fields}
    if dataclasses.is_dataclass(obj):
        return {f.name: _flat(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return np.asarray(obj)


def _port_cfg(jcfg):
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    d["knn_kernel"] = d.pop("pallas_knn")
    d["deskew_kernel"] = d.pop("pallas_deskew")
    return TConfig(**d)


def _state_pair(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(L + 1, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    g = rng.normal(size=3)
    kw = dict(pos=rng.normal(size=3), rot=q[0], ext_r=q[1:], ext_t=rng.normal(size=(L, 3)),
              vel=rng.normal(size=3), bg=rng.normal(size=3) * 0.01, ba=rng.normal(size=3) * 0.1,
              grav=g / np.linalg.norm(g) * jst.S2_LENGTH)
    return (jst.State(**{k: jnp.asarray(v) for k, v in kw.items()}),
            tst.State(**{k: torch.as_tensor(v) for k, v in kw.items()}))


def _close(t, j, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol, rtol=0, err_msg=msg)


def _same_state(t, j, atol=ATOL):
    for f in dataclasses.fields(j):
        _close(getattr(t, f.name).numpy(), getattr(j, f.name), atol, f.name)


def test_transition_and_predict_match_jax():
    jx, tx = _state_pair(1)
    rng = np.random.default_rng(2)
    acc, gyro = rng.normal(size=3) + [0, 0, 9.8], rng.normal(size=3) * 0.3
    n = jst.dof(L)
    A = rng.normal(size=(n, n)) * 0.1
    P = A @ A.T + np.eye(n) * 1e-3
    Q = np.diag(rng.uniform(1e-4, 1e-2, 12))
    ju = jdyn.Input(acc=jnp.asarray(acc), gyro=jnp.asarray(gyro))
    tu = tdyn.Input(acc=torch.as_tensor(acc), gyro=torch.as_tensor(gyro))
    jx2, jF, jFw = jdyn.transition(jx, ju, 0.01)
    tx2, tF, tFw = tdyn.transition(tx, tu, torch.tensor(0.01, dtype=torch.float64))
    _same_state(tx2, jx2)
    _close(tF.numpy(), jF)
    _close(tFw.numpy(), jFw)
    jx3, jP = jdyn.predict(jx, jnp.asarray(P), ju, -0.007, jnp.asarray(Q))
    tx3, tP = tdyn.predict(tx, torch.as_tensor(P), tu, torch.tensor(-0.007, dtype=torch.float64),
                           torch.as_tensor(Q))
    _same_state(tx3, jx3)
    _close(tP.numpy(), jP)
    _close(tdyn.step_mean(tx, tu, torch.tensor(0.01, dtype=torch.float64)).pos.numpy(),
           jdyn.step_mean(jx, ju, 0.01).pos)
    _close(tdyn.process_noise_matrix(0.1, 0.2, 0.3, 0.4, torch.float64, "cpu").numpy(),
           jdyn.process_noise_matrix(0.1, 0.2, 0.3, 0.4, jnp.float64))


@pytest.mark.parametrize("N", [1, 5, 16, 63])
def test_parallel_covariance_matches_jax(N):
    rng = np.random.default_rng(N)
    n = jst.dof(L)
    Fs = np.eye(n)[None] + rng.normal(size=(N, n, n)) * 0.05
    B = rng.normal(size=(N, n, n)) * 0.01
    Qs = B @ np.swapaxes(B, -1, -2)
    A = rng.normal(size=(n, n)) * 0.1
    P0 = A @ A.T + np.eye(n)
    want = jdyn.parallel_covariance(jnp.asarray(Fs), jnp.asarray(Qs), jnp.asarray(P0))
    got = tdyn.parallel_covariance(torch.as_tensor(Fs), torch.as_tensor(Qs), torch.as_tensor(P0))
    _close(got.numpy(), want)


def test_chol_unrolled_near_indefinite_matches_jax():
    rng = np.random.default_rng(5)
    n = jst.dof(L)
    V, _ = np.linalg.qr(rng.normal(size=(n, n)))
    ev = np.geomspace(1.0, 1e-9, n)
    ev[-3:] = [1e-13, -1e-12, -3e-11]  # slightly indefinite: pivots hit the floor
    A = V @ np.diag(ev) @ V.T
    d = 1.0 / np.sqrt(np.abs(np.diag(A)))
    A = A * d[:, None] * d[None, :]
    for floor in (1e-10, 1e-5):
        want = jesekf._chol_unrolled(jnp.asarray(A), floor)
        got = tesekf._chol_unrolled(torch.as_tensor(A), floor)
        assert np.all(np.isfinite(got.numpy()))
        _close(got.numpy(), want, msg=f"floor {floor}")


def test_spd_inverse_and_small_inverses_match_jax():
    rng = np.random.default_rng(6)
    n = jst.dof(L)
    A = rng.normal(size=(n, n))
    S = A @ A.T + np.diag(np.geomspace(1e3, 1e-3, n))
    _close(tesekf._spd_inverse(torch.as_tensor(S)).numpy(), jesekf._spd_inverse(jnp.asarray(S)))
    B3 = rng.normal(size=(3, 3))
    _close(tesekf._inv3(torch.as_tensor(B3)).numpy(), jesekf._inv3(jnp.asarray(B3)))
    B2 = rng.normal(size=(2, 2))
    _close(tesekf._inv2(torch.as_tensor(B2)).numpy(), jesekf._inv2(jnp.asarray(B2)))
    jx, tx = _state_pair(7)
    dx = rng.normal(size=n) * 0.1
    jJ, jJi = jesekf._tangent_transport(jx, jnp.asarray(dx), jx, with_inverse=True)
    tJ, tJi = tesekf._tangent_transport(tx, torch.as_tensor(dx), tx, with_inverse=True)
    _close(tJ.numpy(), jJ)
    _close(tJi.numpy(), jJi)


def _port_scenario(sc):
    tcfg = _port_cfg(sc["cfg"])
    tmap = interop.map_from_numpy(_flat(sc["m"]), "cpu")
    d = _flat(sc["sd"])
    for k in ("pt_lidar", "pt_epoch", "base"):
        d[k] = d[k].astype(np.int64)
    tsd = tmeas.ScanData(**{k: torch.as_tensor(v) for k, v in d.items()})
    tx = interop.state_from_numpy(_flat(sc["x"]), "cpu")
    return tcfg, tmap, tsd, tx


@pytest.fixture(scope="module")
def scenario():
    import test_oracle_parity as top

    return top._h_share_scenario(M=72, seed=13, spread=2.0)


def test_h_share_matches_jax(scenario):
    sc = scenario
    tcfg, tmap, tsd, tx = _port_scenario(sc)
    t_h, t_cache0 = tmeas.make_h_share(tcfg, tmap, tsd, tx)
    for name in ("nn_cnt", "cand_valid", "searched", "n_miss"):
        np.testing.assert_array_equal(getattr(t_cache0, name).numpy(),
                                      np.asarray(getattr(sc["cache0"], name)), err_msg=name)
    _close(t_cache0.cand_pts.numpy(), sc["cache0"].cand_pts)
    for search in (True, False):
        jres, jc = sc["h_share"](sc["x"], jnp.asarray(search), sc["cache0"])
        tres, tc = t_h(tx, search, t_cache0)
        assert bool(tres.valid) == bool(jres.valid)
        np.testing.assert_array_equal(tres.mask.numpy(), np.asarray(jres.mask))
        for name in ("h", "H", "R"):
            _close(getattr(tres, name).numpy(), getattr(jres, name), msg=name)
        _close(tc.normal_y.numpy(), jc.normal_y)
        _close(tc.w_loc.numpy(), jc.w_loc)


def test_update_iterated_matches_jax(scenario):
    sc = scenario
    tcfg, tmap, tsd, tx = _port_scenario(sc)
    n = jst.dof(L)
    dx0 = np.zeros(n)
    dx0[:3] = [0.04, -0.03, 0.02]
    dx0[3:6] = [2e-4, -1.5e-4, 1e-4]
    dx0[6 + 6 * L : 9 + 6 * L] = [0.02, 0.01, -0.02]
    rng = np.random.default_rng(29)
    A = rng.normal(size=(n, n)) * 0.01
    P0 = A @ A.T + np.eye(n) * 5e-3
    cfg = sc["cfg"]
    jres = jesekf.update_iterated(
        jst.boxplus(sc["x"], jnp.asarray(dx0)), jnp.asarray(P0), sc["h_share"], sc["cache0"],
        max_iter=cfg.max_iteration, limit=cfg.converge_limit,
    )
    t_h, t_cache0 = tmeas.make_h_share(tcfg, tmap, tsd, tx)
    tres = tesekf.update_iterated(
        tst.boxplus(tx, torch.as_tensor(dx0)), torch.as_tensor(P0), t_h, t_cache0,
        max_iter=cfg.max_iteration, limit=cfg.converge_limit,
    )
    assert bool(jres.valid) and tres.valid
    assert tres.iterations == int(jres.iterations)
    _same_state(tres.x, jres.x)
    _close(tres.P.numpy(), jres.P)
    _close(tres.Pi.numpy(), jres.Pi)
    # warm start: a second update from the previous inverse takes the
    # Newton-Schulz path on both sides and lands on the same posterior
    jres2 = jesekf.update_iterated(jres.x, jres.P, sc["h_share"], sc["cache0"],
                                   max_iter=cfg.max_iteration, Pi0=jres.Pi)
    tres2 = tesekf.update_iterated(tres.x, tres.P, t_h, t_cache0,
                                   max_iter=cfg.max_iteration, Pi0=tres.Pi)
    assert tres2.iterations == int(jres2.iterations)
    _same_state(tres2.x, jres2.x)
    _close(tres2.P.numpy(), jres2.P)
