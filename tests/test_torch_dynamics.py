"""Port parity: the control tick's model functions (models/dynamics.py, the
Jacobian time derivatives, the base kinematics of the desired state, the
rbd conversions and the tick's spatial helpers) against the JAX package in
float64 on the CPU, rtol 1e-9 (atol 1e-9 x the array's scale, for entries
that cancel to ~0), on seeded random states."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunter_bipedal_control_tpu.models import centroidal as jc, dynamics as jd
from hunter_bipedal_control_tpu.models import kinematics as jk, spatial as jsp
from hunter_bipedal_control_tpu.models.robot import load_model as jload
from hunter_bipedal_control_tpu_torch import convert
from hunter_bipedal_control_tpu_torch.models import centroidal as tc, dynamics as td
from hunter_bipedal_control_tpu_torch.models import kinematics as tk, spatial as tsp

F64 = torch.float64
DJ = np.array([0.10, 0., 0.40, 0.93, 0.53, -0.10, 0., -0.40, 0.93, -0.53])
RTOL = 1e-9
NB = 3


def close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(1.0, np.abs(ref).max()))


@pytest.fixture(scope="module")
def models():
    jm = jload(dtype=jnp.float64)
    tm = convert.from_numpy(jax.tree.map(np.asarray, jm), "cpu", F64)
    return jm, tm


def _rand_qv(rng, n):
    q = np.concatenate([0.1 * rng.standard_normal((n, 3)) + [0, 0, 0.63],
                        0.3 * rng.standard_normal((n, 3)),
                        DJ + 0.3 * rng.standard_normal((n, 10))], axis=1)
    return q, rng.standard_normal((n, 16))


def test_spatial_tick_helpers():
    rng = np.random.default_rng(10)
    zyx, w = rng.uniform(-1.2, 1.2, (5, 3)), rng.standard_normal((5, 3))
    tz, tw = torch.tensor(zyx), torch.tensor(w)
    close(tsp.global_angular_velocity_from_euler_rates(tz, tw),
          jax.vmap(jsp.global_angular_velocity_from_euler_rates)(zyx, w))
    close(tsp.euler_rates_from_global_angular_velocity(tz, tw),
          jax.vmap(jsp.euler_rates_from_global_angular_velocity)(zyx, w))
    quat = jax.vmap(jsp.zyx_to_quat)(zyx)
    close(tsp.quat_to_zyx(torch.tensor(np.asarray(quat))), jax.vmap(jsp.quat_to_zyx)(quat))
    Ra = jax.vmap(jsp.rotation_zyx)(zyx)
    Rb = jax.vmap(jsp.rotation_zyx)(zyx + 0.2 * rng.standard_normal((5, 3)))
    close(tsp.rotation_error_in_world(torch.tensor(np.asarray(Ra)), torch.tensor(np.asarray(Rb))),
          jax.vmap(jsp.rotation_error_in_world)(Ra, Rb))


def test_mass_matrix_nle_gravity_coriolis(models):
    jm, tm = models
    q, v = _rand_qv(np.random.default_rng(11), NB)
    tq, tv = torch.tensor(q), torch.tensor(v)
    close(td.mass_matrix(tm, tq), jax.vmap(lambda a: jd.mass_matrix(jm, a))(q))
    close(td.gravity_vector(tm, tq), jax.vmap(lambda a: jd.gravity_vector(jm, a))(q))
    close(td.nle(tm, tq, tv), jax.jit(jax.vmap(lambda a, b: jd.nle(jm, a, b)))(q, v))
    C = td.coriolis_matrix(tm, tq, tv)
    close(C, jax.jit(jax.vmap(lambda a, b: jd.coriolis_matrix(jm, a, b)))(q, v))
    close(td.kinetic_energy(tm, tq, tv), jax.vmap(lambda a, b: jd.kinetic_energy(jm, a, b))(q, v))
    close(td.potential_energy(tm, tq), jax.vmap(lambda a: jd.potential_energy(jm, a))(q))
    # the Christoffel property the momentum observer relies on: Mdot = C + C^T
    Mdot = torch.func.jvp(lambda a: td.mass_matrix(tm, a), (tq,), (tv,))[1]
    close(C + C.transpose(-1, -2), Mdot.numpy())


def test_inverse_and_forward_dynamics(models):
    jm, tm = models
    rng = np.random.default_rng(12)
    q, v = _rand_qv(rng, NB)
    a = rng.standard_normal((NB, 16))
    tau = np.asarray(jax.jit(jax.vmap(lambda x, y, z: jd.inverse_dynamics(jm, x, y, z)))(q, v, a))
    close(td.inverse_dynamics(tm, torch.tensor(q), torch.tensor(v), torch.tensor(a)), tau)
    close(td.forward_dynamics(tm, torch.tensor(q), torch.tensor(v), torch.tensor(tau)),
          jax.jit(jax.vmap(lambda x, y, z: jd.forward_dynamics(jm, x, y, z)))(q, v, tau))


def test_jacobian_time_derivatives(models):
    jm, tm = models
    q, v = _rand_qv(np.random.default_rng(13), NB)
    tq, tv = torch.tensor(q), torch.tensor(v)
    close(tk.contact_jacobians_dot(tm, tq, tv),
          jax.jit(jax.vmap(lambda a, b: jk.contact_jacobians_dot(jm, a, b)))(q, v))
    close(tk.base_jacobian_dot(tm, tq, tv),
          jax.jit(jax.vmap(lambda a, b: jk.base_jacobian_dot(jm, a, b)))(q, v))
    close(tk.base_jacobian(tm, tk.fk(tm, tq)),
          jax.vmap(lambda a: jk.base_jacobian(jm, jk.fk(jm, a)))(q))
    close(tk.contact_velocities(tm, tq, tv),
          jax.vmap(lambda a, b: jk.contact_velocities(jm, a, b))(q, v))


def test_base_kinematics_and_rbd_conversions(models):
    jm, tm = models
    rng = np.random.default_rng(14)
    q, v = _rand_qv(rng, NB)
    x = np.concatenate([0.3 * rng.standard_normal((NB, 6)), q], axis=1)
    u = rng.standard_normal((NB, 22)) * np.r_[np.full(12, 30.0), np.full(10, 2.0)]
    tx, tu = torch.tensor(x), torch.tensor(u)
    got = tc.base_kinematics_from_centroidal(tm, tx, tu)
    ref = jax.jit(jax.vmap(lambda a, b: jc.base_kinematics_from_centroidal(jm, a, b)))(x, u)
    for a, b in zip(got, ref):
        close(a, b)
    close(tc.state_input_to_v(tm, tx, tu), jax.vmap(lambda a, b: jc.state_input_to_v(jm, a, b))(x, u))
    rbd = jax.vmap(lambda a, b: jc.q_v_to_rbd_state(jm, a, b))(q, v)
    trbd = tc.q_v_to_rbd_state(tm, torch.tensor(q), torch.tensor(v))
    close(trbd, rbd)
    close(tc.rbd_state_to_centroidal(tm, trbd),
          jax.vmap(lambda a: jc.rbd_state_to_centroidal(jm, a))(rbd))
