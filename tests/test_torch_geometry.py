"""Parity of the port's SO(3) / SE(3) / S2 primitives and state manifold
operations with the JAX package, in f64 at atol 1e-12, on random inputs
and the degenerate ones the small-angle guards exist for (zero vectors,
angles near pi, antipodal and coincident S2 points)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from malio_tpu import state as jst
from malio_tpu.geometry import s2 as js2, se3 as jse3, so3 as jso3

from malio_tpu_torch import state as tst
from malio_tpu_torch.geometry import s2 as ts2, se3 as tse3, so3 as tso3

torch.set_num_threads(1)
ATOL = 1e-12


def _rng(seed):
    return np.random.default_rng(seed)


def quats(seed, n=24):
    q = _rng(seed).normal(size=(n, 4))
    if n < 4:
        return q / np.linalg.norm(q, axis=-1, keepdims=True)
    q[0] = [1, 0, 0, 0]
    q[1] = [0, 1, 0, 0]  # rotation by pi
    q[2] = [1e-9, 0, 0, 1]  # near pi, w ~ 0
    q[3] = [-1, 0, 0, 0]
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def vecs(seed, n=24, scale=1.0):
    v = _rng(seed).normal(size=(n, 3)) * scale
    v[0] = 0.0  # zero vector
    v[1] = [1e-9, -2e-9, 5e-10]  # below the Taylor switch
    v[2] = [0.0, 0.0, np.pi - 1e-7]  # near pi
    v[3] = [3e-6, 0, 0]  # just above the switch
    return v


def sphere(seed, n=24):
    g = _rng(seed).normal(size=(n, 3))
    g = g / np.linalg.norm(g, axis=-1, keepdims=True) * js2.DEFAULT_LENGTH
    if n < 3:
        return g
    g[0] = [0, 0, -js2.DEFAULT_LENGTH]
    g[1] = [-js2.DEFAULT_LENGTH, 0, 0]  # antipode of the chart pole
    g[2] = [js2.DEFAULT_LENGTH, 0, 0]
    return g


def mats(seed, n=24):
    return np.asarray(jso3.quat_to_mat(jnp.asarray(quats(seed, n))))


def twists(seed, n=24):
    t = _rng(seed).normal(size=(n, 6))
    t[0] = 0.0
    t[1, :3] = 1e-9
    t[2, :3] = [0.0, np.pi - 1e-6, 0.0]
    return t


def transforms(seed, n=24):
    return np.asarray(jse3.exp_se3(jnp.asarray(twists(seed, n) * 0.5)))


CASES = {
    "hat": (jso3.hat, tso3.hat, lambda: (vecs(1),)),
    "quat_mul": (jso3.quat_mul, tso3.quat_mul, lambda: (quats(2), quats(3))),
    "quat_conj": (jso3.quat_conj, tso3.quat_conj, lambda: (quats(4),)),
    "quat_rotate": (jso3.quat_rotate, tso3.quat_rotate, lambda: (quats(5), vecs(6, scale=10))),
    "quat_rotate_inv": (jso3.quat_rotate_inv, tso3.quat_rotate_inv, lambda: (quats(7), vecs(8))),
    "exp_so3": (jso3.exp_so3, tso3.exp_so3, lambda: (vecs(9),)),
    "log_so3": (jso3.log_so3, tso3.log_so3, lambda: (quats(10),)),
    "quat_to_mat": (jso3.quat_to_mat, tso3.quat_to_mat, lambda: (quats(11),)),
    "mat_to_quat": (jso3.mat_to_quat, tso3.mat_to_quat, lambda: (mats(12),)),
    "A_matrix": (jso3.A_matrix, tso3.A_matrix, lambda: (vecs(13),)),
    "exp_so3_mat": (jso3.exp_so3_mat, tso3.exp_so3_mat, lambda: (vecs(14),)),
    "so3_boxplus": (jso3.boxplus, tso3.boxplus, lambda: (quats(15), vecs(16, scale=0.3))),
    "so3_boxminus": (jso3.boxminus, tso3.boxminus, lambda: (quats(17), quats(18))),
    "exp_se3": (jse3.exp_se3, tse3.exp_se3, lambda: (twists(19),)),
    "log_se3": (jse3.log_se3, tse3.log_se3, lambda: (transforms(20),)),
    "inv_se3": (jse3.inv_se3, tse3.inv_se3, lambda: (transforms(21),)),
    "make_se3": (jse3.make_se3, tse3.make_se3, lambda: (quats(22), vecs(23))),
    "adjoint": (jse3.adjoint, tse3.adjoint, lambda: (transforms(24),)),
    "s2_bx": (js2.s2_bx, ts2.s2_bx, lambda: (sphere(25),)),
    "s2_boxplus": (js2.s2_boxplus, ts2.s2_boxplus,
                   lambda: (sphere(26), _rng(27).normal(size=(24, 2)) * 0.3)),
    "s2_boxminus": (js2.s2_boxminus, ts2.s2_boxminus, lambda: (sphere(28), sphere(29))),
    "s2_boxminus_coincident": (js2.s2_boxminus, ts2.s2_boxminus,
                               lambda: (sphere(30), sphere(30))),
    "s2_boxminus_antipodal": (js2.s2_boxminus, ts2.s2_boxminus,
                              lambda: (sphere(31), -sphere(31))),
    "s2_mx": (js2.s2_mx, ts2.s2_mx, lambda: (sphere(32), _rng(33).normal(size=(24, 2)) * 0.2)),
    "s2_mx_zero": (js2.s2_mx, ts2.s2_mx, lambda: (sphere(34), np.zeros((24, 2)))),
    "s2_nx_yy": (js2.s2_nx_yy, ts2.s2_nx_yy, lambda: (sphere(35),)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_primitive_matches_jax(name):
    jfn, tfn, make = CASES[name]
    args = make()
    want = np.asarray(jfn(*(jnp.asarray(a) for a in args)))
    got = tfn(*(torch.as_tensor(a) for a in args)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _states(seed, L=3):
    rng = _rng(seed)
    kw = dict(
        pos=rng.normal(size=3), rot=quats(seed, 1)[0], ext_r=quats(seed + 1, L),
        ext_t=rng.normal(size=(L, 3)), vel=rng.normal(size=3), bg=rng.normal(size=3) * 0.01,
        ba=rng.normal(size=3) * 0.1, grav=sphere(seed + 2, 1)[0],
    )
    j = jst.State(**{k: jnp.asarray(v) for k, v in kw.items()})
    t = tst.State(**{k: torch.as_tensor(v) for k, v in kw.items()})
    return j, t


def _same_state(t, j):
    for f in dataclasses.fields(j):
        np.testing.assert_allclose(getattr(t, f.name).numpy(), np.asarray(getattr(j, f.name)),
                                   atol=ATOL, rtol=0, err_msg=f.name)


@pytest.mark.parametrize("scale", [0.0, 1e-9, 0.3])
def test_state_boxplus_boxminus_match_jax(scale):
    j, t = _states(40)
    n = jst.dof(3)
    dx = _rng(41).normal(size=n) * scale
    j2 = jst.boxplus(j, jnp.asarray(dx))
    t2 = tst.boxplus(t, torch.as_tensor(dx))
    _same_state(t2, j2)
    np.testing.assert_allclose(tst.boxminus(t2, t).numpy(), np.asarray(jst.boxminus(j2, j)),
                               atol=ATOL, rtol=0)


def test_state_oplus_and_indices_match_jax():
    j, t = _states(42)
    L = 3
    f = _rng(43).normal(size=18 + 6 * L)
    _same_state(tst.oplus(t, torch.as_tensor(f), 0.01), jst.oplus(j, jnp.asarray(f), 0.01))
    for name in ("idx_pos", "idx_rot", "idx_vel", "idx_bg", "idx_ba", "idx_grav", "dof",
                 "so3_block_starts"):
        assert getattr(tst, name)(L) == getattr(jst, name)(L), name
    assert [tst.idx_ext_r(L, l) for l in range(L)] == [jst.idx_ext_r(L, l) for l in range(L)]
    assert [tst.idx_ext_t(L, l) for l in range(L)] == [jst.idx_ext_t(L, l) for l in range(L)]
