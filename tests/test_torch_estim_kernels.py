"""Port parity for the estimator kernels' plain versions and wrappers, on
the CPU in float64: B10 (``estim/contact.py::momentum_observer_update``,
``csrc/momentum_observer.cu``) and B12 (``estim/kalman.py::kalman_update``,
``csrc/kalman_update.cu``).

- The identity B10 computes the observer's C(q, v)' v - g(q) by:
  sum_k dJ_k' h_k - g, with h_k = (m_k c_dot_k, I_k w_k) link k's momentum
  at its CoM, dJ_k the time derivative of its CoM Jacobian along v and
  g_i = 9.81 sum_k m_k (J_lin,k)_z,i, formed here from the port's
  ``link_com_jacobians`` and ``torch.func.jvp``, held to JAX's
  ``coriolis_matrix(q, v)' v - gravity_vector(q)`` within 1e-9 of its scale
  on moving states (|v| ~ 1); and the kernel's p = sum_k J_k' h_k to JAX's
  ``mass_matrix(q) v``.
- ``momentum_observer_plain`` and ``kalman_update_plain`` against the JAX
  updates under ``vmap`` over three chained updates on walking states
  (``entry.estimator_batch``: fractional contact flags, moving joints),
  each output and carried state within 1e-9 of its own scale; the filter
  also from a loop's first tick (P = 100 I) and with every foot in swing or
  in stance.
- On CPU tensors the wrappers are the plain versions bit for bit and launch
  no kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp

from hunter_bipedal_control_tpu.estim import contact as jcon, kalman as jkf
from hunter_bipedal_control_tpu.models.dynamics import (coriolis_matrix as jcoriolis,
                                                        gravity_vector as jgravity,
                                                        mass_matrix as jmass)
from hunter_bipedal_control_tpu.models.robot import load_model as jload
from hunter_bipedal_control_tpu_torch import convert
from hunter_bipedal_control_tpu_torch.entry import WALK_FLAGS, estimator_batch
from hunter_bipedal_control_tpu_torch.estim import contact as tcon, kalman as tkf
from hunter_bipedal_control_tpu_torch.models.centroidal import rbd_to_q_v
from hunter_bipedal_control_tpu_torch.models.kinematics import fk, link_com_jacobians
from hunter_bipedal_control_tpu_torch.ops import linalg as tlinalg

F64 = torch.float64
B = 3
DT = 0.002
TOL = 1e-9


def scaled_err(got, ref):
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def np_state(st):
    return type(st)(*(t.numpy() for t in st))


@pytest.fixture(scope="module")
def models():
    jm = jload(dtype=jnp.float64)
    return jm, convert.from_numpy(to_np(jm), "cpu", F64)


def momentum_route(model, q, v):
    """(sum_k dJ_k' h_k - g, sum_k J_k' h_k) as B10 forms them."""
    kin = fk(model, q)
    J = link_com_jacobians(model, kin)                                 # (B, L, 6, 16)
    dJ = jvp(lambda q_: link_com_jacobians(model, fk(model, q_)), (q,), (v,))[1]
    Jv = (J @ v[:, None, :, None])[..., 0]                             # (B, L, 6): c_dot, w
    Iw = kin.R @ model.link_inertia @ kin.R.transpose(-1, -2)
    h = torch.cat([model.link_mass[:, None] * Jv[..., 0:3],
                   (Iw @ Jv[..., 3:6, None])[..., 0]], dim=-1)
    g = 9.81 * torch.einsum("k,bkv->bv", model.link_mass, J[:, :, 2, :])
    return torch.einsum("bkiv,bki->bv", dJ, h) - g, torch.einsum("bkiv,bki->bv", J, h)


@pytest.mark.parametrize("seed", [0, 1])
def test_coriolis_identity_matches_jax(models, seed):
    jm, tm = models
    eb = estimator_batch(B, "cpu", F64, seed=seed)
    q, v = rbd_to_q_v(eb.rbd)
    assert v.abs().max() > 1.0
    cv_g, p = momentum_route(tm, q, v)
    qn, vn = q.numpy(), v.numpy()
    ref = jax.vmap(lambda a, b: jcoriolis(jm, a, b).T @ b - jgravity(jm, a))(qn, vn)
    p_ref = jax.vmap(lambda a, b: jmass(jm, a) @ b)(qn, vn)
    assert scaled_err(cv_g, ref) < TOL
    assert scaled_err(p, p_ref) < TOL
    # the Coriolis term is not negligible on these states
    g = jax.vmap(lambda a: jgravity(jm, a))(qn)
    assert np.abs(np.asarray(ref) + np.asarray(g)).max() > 1.0


def test_momentum_observer_plain_matches_jax(models):
    jm, tm = models
    jp = jcon.default_contact_params(jnp.float64)
    tp = convert.from_numpy(to_np(jp), "cpu", F64)
    ts = estimator_batch(B, "cpu", F64, seed=10).observer
    js = jcon.ContactObserverState(*np_state(ts))
    step = jax.jit(jax.vmap(lambda st, r, tau: jcon.momentum_observer_update(jm, jp, st, r, tau,
                                                                             DT)))
    for k in range(3):
        eb = estimator_batch(B, "cpu", F64, seed=11 + k)
        js, jdist = step(js, eb.rbd.numpy(), eb.cmd_torque.numpy())
        ts, tdist = tcon.momentum_observer_plain(tm, tp, ts, eb.rbd, eb.cmd_torque, DT)
        for a, b in zip((*ts, tdist), (*js, jdist)):
            assert scaled_err(a, b) < TOL


@pytest.fixture(scope="module")
def kalman_step(models):
    """JAX's update under vmap, jitted once for every case (B scenarios)."""
    jm, _ = models
    jp = jkf.default_kalman_params(jnp.float64)
    return jp, jax.jit(jax.vmap(lambda st, s: jkf.kalman_update(jm, jp, st, **s, dt=DT)))


@pytest.mark.parametrize("case", ["walking", "first_tick", "swing", "stance"])
def test_kalman_update_plain_matches_jax(models, kalman_step, case):
    """Three chained updates on ``entry.estimator_batch``'s walking inputs,
    from a loop's first tick (``init_kalman_state``: P = 100 I), and with
    every foot in swing (flags 0) or in stance (flags 1)."""
    _, tm = models
    jp, step = kalman_step
    tp = convert.from_numpy(to_np(jp), "cpu", F64)
    ts = (tkf.init_kalman_state(B, "cpu", F64) if case == "first_tick"
          else estimator_batch(B, "cpu", F64, seed=20).kalman)
    js = jkf.KalmanState(*np_state(ts))
    fractional = False
    for k in range(3):
        sensors = estimator_batch(B, "cpu", F64, seed=21 + k).sensors
        if case in ("swing", "stance"):
            flags = sensors["contact_flags"]
            sensors["contact_flags"] = (torch.zeros_like if case == "swing"
                                        else torch.ones_like)(flags)
        flags = sensors["contact_flags"]
        fractional |= bool(((flags > 0) & (flags < 1)).any())
        js, jpos, jvel = step(js, {n: t.numpy() for n, t in sensors.items()})
        ts, tpos, tvel = tkf.kalman_update_plain(tm, tp, ts, **sensors, dt=DT)
        for a, b in zip((*ts, tpos, tvel), (*js, jpos, jvel)):
            assert scaled_err(a, b) < TOL
    assert fractional == (case in ("walking", "first_tick"))


@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("which", ["observer", "kalman"])
def test_cpu_wrappers_are_plain_and_launch_nothing(which, dtype):
    eb = estimator_batch(4, "cpu", dtype, seed=30)
    counters = (tcon.momentum_observer_update, tkf.kalman_update, tlinalg.gj_inverse)
    before = [c.launches for c in counters]
    if which == "observer":
        args = (eb.model, eb.observer_params, eb.observer, eb.rbd, eb.cmd_torque, DT)
        got = tcon.momentum_observer_update(*args)
        ref = tcon.momentum_observer_plain(*args)
        got, ref = (*got[0], got[1]), (*ref[0], ref[1])
    else:
        args = (eb.model, eb.kalman_params, eb.kalman)
        got = tkf.kalman_update(*args, **eb.sensors, dt=DT)
        ref = tkf.kalman_update_plain(*args, **eb.sensors, dt=DT)
        got, ref = (*got[0], *got[1:]), (*ref[0], *ref[1:])
    for a, b in zip(got, ref):
        assert a.dtype == dtype and torch.equal(a, b)
    assert [c.launches for c in counters] == before == [0, 0, 0]


def test_params_buffers():
    kp = tkf.default_kalman_params()
    np.testing.assert_array_equal(tkf.params_buffer(kp).numpy(),
                                  np.array([float(t) for t in kp], np.float32))
    op = tcon.default_contact_params(dtype=F64)
    buf = tcon.params_buffer(op)
    assert buf.dtype == torch.float32 and buf.tolist() == [250.0]
    with pytest.raises(ValueError):
        tkf.params_buffer(kp._replace(foot_radius=torch.zeros(2)))
    with pytest.raises(ValueError):
        tcon.params_buffer(op._replace(cutoff_frequency=torch.zeros(1)))


def test_estimator_batch_covers_the_kernels_cases():
    """The seeded batch mixes walking and fractional contact flags, and the
    filter's xy conditioning goes both ways on it."""
    eb = estimator_batch(64, "cpu", F64, seed=0)
    flags = eb.sensors["contact_flags"]
    walk = torch.tensor(WALK_FLAGS, dtype=F64)
    is_walk = (flags[:, None, :] == walk[None]).all(-1).any(-1)
    assert is_walk.any() and (~is_walk).any()
    assert eb.rbd.shape == (64, 32) and eb.cmd_torque.shape == (64, 10)
    assert eb.kalman.P.shape == (64, 18, 18)
    assert torch.linalg.eigvalsh(eb.kalman.P).min() > 0
    st, _, _ = tkf.kalman_update(eb.model, eb.kalman_params, eb.kalman, **eb.sensors, dt=DT)
    conditioned = (st.P[:, 0:2, 2:] == 0).all(-1).all(-1)
    assert conditioned.any() and (~conditioned).any()
