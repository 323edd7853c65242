"""Port parity: ops/qp.py (the PDIP, kernel B4's plain version) and
wbc/wbc.py against the JAX package on the CPU.

``solve_qp_plain`` runs on the WBC's own QP data (``wbc_qp`` of B=3
perturbed standing and walking states) against the JAX ``solve_qp`` under
``vmap``: cold (18 iterations), warm from a primal (10 iterations, margin
1, the WBC's default) and warm with duals (margin 1e-2).  float64: x within
1e-8 and both duals within 1e-6 of their own scale; iterations exactly.
float32 (both sides in float32): x within 1e-3 and the duals within 1e-2 of
their scale (measured ~1e-5 and ~1e-4: the WBC's barrier weights lam/s
reach ~1e6, so float32 rounding in the factorizations shows in the duals).
A QP whose Hbar is not SPD gives NaN on both sides, in the same rows.

``wbc_update`` at B=3 (walking in three contact modes, stance mode, and the
last-solution fallback of tests/test_solver_wbc.py) against the JAX
``wbc_update`` under ``vmap`` in float64: x and the new state within 1e-8
of their scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunter_bipedal_control_tpu.models.centroidal import q_v_to_rbd_state
from hunter_bipedal_control_tpu.models.robot import load_model as jload
from hunter_bipedal_control_tpu.ocp.problem import weight_compensating_input
from hunter_bipedal_control_tpu.ops.qp import solve_qp as jsolve_qp
from hunter_bipedal_control_tpu.wbc import wbc as jwbc
from hunter_bipedal_control_tpu_torch import convert
from hunter_bipedal_control_tpu_torch.ops import qp as tqp
from hunter_bipedal_control_tpu_torch.wbc import wbc as twbc

F64 = torch.float64
DJ = np.array([0.10, 0., 0.40, 0.93, 0.53, -0.10, 0., -0.40, 0.93, -0.53])
QNOM = np.concatenate([[0., 0., 0.63], np.zeros(3), DJ])
FLAGS = np.array([[1., 0., 1., 0.], [0., 1., 0., 1.], [1., 1., 1., 1.]])
B = 3


def scaled_err(got, ref):
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


@pytest.fixture(scope="module")
def setup():
    jm = jload(dtype=jnp.float64)
    tm = convert.from_numpy(jax.tree.map(np.asarray, jm), "cpu", F64)
    rng = np.random.default_rng(20)
    q = QNOM + np.concatenate([0.01 * rng.standard_normal((B, 6)),
                               0.05 * rng.standard_normal((B, 10))], axis=1)
    v = 0.1 * rng.standard_normal((B, 16))
    rbd = np.asarray(jax.vmap(lambda a, b: q_v_to_rbd_state(jm, a, b))(q, v))
    x_des = np.concatenate([0.05 * rng.standard_normal((B, 6)), np.tile(QNOM, (B, 1))
                            + 0.02 * rng.standard_normal((B, 16))], axis=1)
    u_des = np.asarray(jax.vmap(lambda f: weight_compensating_input(jm, f, 22, jnp.float64))(
        FLAGS)) + np.concatenate([rng.standard_normal((B, 12)),
                                  0.2 * rng.standard_normal((B, 10))], axis=1)
    return jm, tm, rbd, x_des, u_des


def _qp_data(setup, stance=False):
    jm, tm, rbd, x_des, u_des = setup
    tp = twbc.default_wbc_params("cpu", F64)
    args = [torch.tensor(a) for a in (x_des, u_des, rbd, FLAGS)]
    return twbc.wbc_qp(tm, tp, *args, torch.full((B,), stance))


QP_CASES = {
    "cold": dict(n_iters=18),
    "warm_primal": dict(n_iters=10, x0="prev", warm_margin=1.0, lam0="ones", nu0="zeros"),
    "warm_duals": dict(n_iters=10, x0="prev", lam0="prev", nu0="prev", warm_margin=1e-2),
}


def _qp_case(name, prev):
    """The keyword arguments of one case, from the cold solution ``prev`` (numpy)."""
    kw = dict(QP_CASES[name])
    rng = np.random.default_rng(21)
    if kw.get("x0") == "prev":
        kw["x0"] = prev[0] + 1e-3 * rng.standard_normal(prev[0].shape)
    if kw.get("lam0") == "ones":
        kw["lam0"] = np.ones_like(prev[2])
    elif kw.get("lam0") == "prev":
        kw["lam0"] = prev[2]
    if kw.get("nu0") == "zeros":
        kw["nu0"] = np.zeros_like(prev[1])
    elif kw.get("nu0") == "prev":
        kw["nu0"] = prev[1]
    return kw


def _jax_qp(data, kw, dtype):
    arrays = {k: v for k, v in kw.items() if isinstance(v, np.ndarray)}
    static = {k: v for k, v in kw.items() if k not in arrays}

    def one(d, a):
        return jsolve_qp(*d, **static, **a)

    return jax.jit(jax.vmap(one))([jnp.asarray(np.asarray(d), dtype) for d in data],
                                  {k: jnp.asarray(v, dtype) for k, v in arrays.items()})


def _port_qp(data, kw, dtype):
    t = {k: (torch.tensor(v, dtype=dtype) if isinstance(v, np.ndarray) else v)
         for k, v in kw.items()}
    return tqp.solve_qp(*[d.to(dtype) for d in data], **t)


@pytest.fixture(scope="module")
def cold_solution(setup):
    data = _qp_data(setup)
    ref = _jax_qp(data, QP_CASES["cold"], jnp.float64)
    return data, [np.asarray(a) for a in ref]


@pytest.mark.parametrize("case", list(QP_CASES))
def test_solve_qp_plain_matches_jax_f64(cold_solution, case):
    data, prev = cold_solution
    kw = _qp_case(case, prev)
    ref = _jax_qp(data, kw, jnp.float64)
    got = _port_qp(data, kw, F64)
    assert scaled_err(got.x, ref.x) < 1e-8
    assert scaled_err(got.eq_dual, ref.eq_dual) < 1e-6
    assert scaled_err(got.ineq_dual, ref.ineq_dual) < 1e-6
    assert scaled_err(got.primal_residual, ref.primal_residual) < 1e-8
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))


@pytest.mark.parametrize("case", ["cold", "warm_primal"])
def test_solve_qp_plain_matches_jax_f32(cold_solution, case):
    data, prev = cold_solution
    kw = _qp_case(case, prev)
    ref = _jax_qp(data, kw, jnp.float32)
    got = _port_qp(data, kw, torch.float32)
    assert got.x.dtype == torch.float32
    assert scaled_err(got.x, ref.x) < 1e-3
    assert scaled_err(got.eq_dual, ref.eq_dual) < 1e-2
    assert scaled_err(got.ineq_dual, ref.ineq_dual) < 1e-2


def test_solve_qp_plain_not_spd_gives_nan(cold_solution):
    """Hbar not SPD in row 1: jnp.linalg.cholesky gives NaN (it does not
    raise), so x, the duals and the residual are NaN there and only there."""
    data, _ = cold_solution
    H = data[0].clone()
    H[1] = -1e3 * torch.eye(H.shape[-1], dtype=F64)
    data = (H, *data[1:])
    ref = _jax_qp(data, QP_CASES["cold"], jnp.float64)
    got = _port_qp(data, QP_CASES["cold"], F64)
    for name in ("x", "eq_dual", "ineq_dual"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        np.testing.assert_array_equal(np.isnan(a).any(-1), np.isnan(b).any(-1))
        np.testing.assert_array_equal(np.isnan(a).any(-1), [False, True, False])
        assert scaled_err(a[[0, 2]], b[[0, 2]]) < 1e-6
    assert np.isnan(got.primal_residual[1].item()) and np.isnan(float(ref.primal_residual[1]))
    # the port's NaN factor on its own: the lower triangle, zeros above
    L = tqp.cholesky_nan(-torch.eye(3, dtype=F64)[None])[0]
    lower = torch.tril_indices(3, 3)
    assert torch.isnan(L[lower[0], lower[1]]).all() and (L.triu(1) == 0).all()


def _jax_wbc(setup, params, state, stance, rbd=None):
    jm, _, rbd0, x_des, u_des = setup
    rbd = rbd0 if rbd is None else rbd

    def one(st, xd, ud, r, f, s):
        return jwbc.wbc_update(jm, params, st, xd, ud, r, f, s)

    return jax.jit(jax.vmap(one))(state, x_des, u_des, rbd, FLAGS, jnp.full((B,), stance))


def _port_wbc(setup, params, state, stance, rbd=None):
    _, tm, rbd0, x_des, u_des = setup
    rbd = rbd0 if rbd is None else rbd
    args = [torch.tensor(a) for a in (x_des, u_des, rbd, FLAGS)]
    return twbc.wbc_update(tm, params, state, *args, torch.full((B,), stance))


def _jax_init():
    st = jwbc.init_wbc_state(jnp.float64)
    return jax.tree.map(lambda a: jnp.broadcast_to(a, (B, *jnp.shape(a))), st)


def _check_wbc(got, ref):
    (x, st), (jx, jst) = got, ref
    assert scaled_err(x, jx) < 1e-8
    for a, b in zip(st, jst):
        if a.dtype == torch.bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            assert scaled_err(a, b) < 1e-8


@pytest.mark.parametrize("stance", [False, True])
def test_wbc_update_matches_jax(setup, stance):
    """Two chained updates: the first from the cold state (10 iterations
    from x = 0), the second warm from the first's solution, the measured
    state moved by 1e-3."""
    jparams = jwbc.default_wbc_params(jnp.float64)
    tparams = convert.from_numpy(jax.tree.map(np.asarray, jparams), "cpu", F64)
    ref1 = _jax_wbc(setup, jparams, _jax_init(), stance)
    got1 = _port_wbc(setup, tparams, twbc.init_wbc_state(B, "cpu", F64), stance)
    _check_wbc(got1, ref1)
    rbd2 = setup[2] + 1e-3
    ref2 = _jax_wbc(setup, jparams, ref1[1], stance, rbd2)
    got2 = _port_wbc(setup, tparams, got1[1], stance, rbd2)
    _check_wbc(got2, ref2)
    assert np.abs(np.asarray(ref2[0]) - np.asarray(ref1[0])).max() > 1e-6
    if stance:  # the stance task holds the base acceleration near zero
        assert float(got1[0][:, 0:6].abs().max()) < 0.5


def test_wbc_update_fallback_matches_jax(setup):
    """The acceptance test rejects every QP (qp_accept_tol = 0): the last
    solution comes back verbatim; a NaN measurement gives a NaN QP and the
    same fallback; with no last solution the fallback is zero."""
    jparams = jwbc.default_wbc_params(jnp.float64)
    tparams = convert.from_numpy(jax.tree.map(np.asarray, jparams), "cpu", F64)
    ref1 = _jax_wbc(setup, jparams, _jax_init(), False)
    got1 = _port_wbc(setup, tparams, twbc.init_wbc_state(B, "cpu", F64), False)
    _check_wbc(got1, ref1)

    reject_j, reject_t = jparams._replace(qp_accept_tol=0.0), tparams._replace(qp_accept_tol=0.0)
    ref2 = _jax_wbc(setup, reject_j, ref1[1], False)
    got2 = _port_wbc(setup, reject_t, got1[1], False)
    _check_wbc(got2, ref2)
    np.testing.assert_array_equal(got2[0].numpy(), got1[0].numpy())

    rbd_bad = setup[2].copy()
    rbd_bad[:, 16] = np.nan
    got_x, _, accepted = twbc.wbc_solve(
        setup[1], tparams, got1[1],
        *[torch.tensor(a) for a in (setup[3], setup[4], rbd_bad, FLAGS)],
        torch.zeros(B, dtype=torch.bool))
    assert not accepted.any()
    np.testing.assert_array_equal(got_x.numpy(), got1[0].numpy())
    ref3 = _jax_wbc(setup, jparams, ref1[1], False, rbd_bad)
    got3 = _port_wbc(setup, tparams, got1[1], False, rbd_bad)
    np.testing.assert_array_equal(np.asarray(ref3[0]), np.asarray(ref1[0]))
    _check_wbc(got3, ref3)

    ref4 = _jax_wbc(setup, jparams, _jax_init(), False, rbd_bad)
    got4 = _port_wbc(setup, tparams, twbc.init_wbc_state(B, "cpu", F64), False, rbd_bad)
    np.testing.assert_array_equal(got4[0].numpy(), np.zeros((B, 38)))
    np.testing.assert_array_equal(np.asarray(ref4[0]), np.zeros((B, 38)))


def test_coulomb_friction_compensation():
    qd = torch.tensor([[0.5, -0.5, 0.0005, -2.0]], dtype=F64)
    tau = torch.ones_like(qd)
    ref = jwbc.coulomb_friction_compensation(qd.numpy(), tau.numpy())
    np.testing.assert_array_equal(twbc.coulomb_friction_compensation(qd, tau).numpy(),
                                  np.asarray(ref))
