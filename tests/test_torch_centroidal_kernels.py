"""Port parity for the loops' sensing, plant and state conversion: the plain
versions and the CPU side of the wrappers of kernels B13a (``synth_imu``,
``csrc/sensing.cu``), B13b (``rbd_state_to_centroidal``, same file), B14a
(``dummy_step``, ``csrc/centroidal_flow.cu``) and B14b
(``state_input_to_v``, same file), on the CPU in float64.

- The identity B13b computes h = A(q) v by: the links' momenta about the
  whole-body CoM, h_lin = sum_k m_k c_dot_k and h_ang = sum_k I_k w_k +
  (c_k - p_com) x m_k c_dot_k, with each link's CoM velocity and angular
  velocity formed here by differentiating the port's ``fk`` along v (no
  CMM), held to JAX's ``rbd_state_to_centroidal`` within 1e-10 of its
  scale on moving states (|v| ~ 1).
- ``rbd_state_to_centroidal_plain``, ``state_input_to_v_plain`` and
  ``dummy_step_plain`` against their JAX functions under ``vmap`` within
  1e-10, ``synth_imu_plain`` within 1e-12 (as
  test_torch_fullorder.py::test_synth_imu_matches_jax holds it), on the
  seeded walking batch ``entry.centroidal_batch``.
- On CPU tensors each wrapper is its plain version bit for bit, the extra
  outputs the loops take (the IMU's world angular velocity, the tick's rbd
  state) included, and launches no kernel.
- The plain WBC pipeline (which chip_smoke runs in float64 on the card)
  takes ``state_input_to_v_plain``, never the kernel wrapper.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp

from hunter_bipedal_control_tpu.backends import dummy as jdummy, fullorder as jfo
from hunter_bipedal_control_tpu.models import centroidal as jc
from hunter_bipedal_control_tpu.models.robot import load_model as jload
from hunter_bipedal_control_tpu.models.spatial import (
    global_angular_velocity_from_euler_rates as jomega)
from hunter_bipedal_control_tpu_torch import convert
from hunter_bipedal_control_tpu_torch.backends import dummy as tdummy, fullorder as tfo
from hunter_bipedal_control_tpu_torch.entry import WALK_FLAGS, centroidal_batch
from hunter_bipedal_control_tpu_torch.models import centroidal as tc
from hunter_bipedal_control_tpu_torch.models.kinematics import fk
from hunter_bipedal_control_tpu_torch.models.spatial import global_angular_velocity_from_euler_rates
from hunter_bipedal_control_tpu_torch.wbc import wbc as twbc

F64 = torch.float64
B = 4
DT = 0.002
TOL = 1e-10
KERNELS = ("synth_imu", "rbd_to_centroidal", "dummy_step", "state_input_to_v")


def scaled_err(got, ref):
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


@pytest.fixture(scope="module")
def models():
    jm = jload(dtype=jnp.float64)
    return jm, convert.from_numpy(jax.tree.map(np.asarray, jm), "cpu", F64)


def counters():
    return (tfo.synth_imu, tc.rbd_state_to_centroidal, tdummy.dummy_step, tc.state_input_to_v)


def momenta_about_com(model, q, v):
    """x = [h / m, q] with h the links' momenta about the CoM, each link's
    CoM velocity and angular velocity (from dR/dt R') by differentiating
    ``fk`` along v."""
    def pose(q_):
        kin = fk(model, q_)
        return kin.com_w, kin.R

    (com, R), (cdot, Rdot) = jvp(pose, (q,), (v,))
    W = Rdot @ R.transpose(-1, -2)                                   # skew(w_k)
    w = torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)
    m_k = model.link_mass
    m = m_k.sum()
    p_com = (m_k[:, None] * com).sum(-2) / m
    Iw = R @ model.link_inertia @ R.transpose(-1, -2)
    h_lin = (m_k[:, None] * cdot).sum(-2)
    h_ang = ((Iw @ w[..., None])[..., 0]
             + torch.linalg.cross(com - p_com[..., None, :], m_k[:, None] * cdot, dim=-1)).sum(-2)
    return torch.cat([h_lin / m, h_ang / m, q], dim=-1)


@pytest.mark.parametrize("seed", [0, 1])
def test_momentum_identity_matches_jax(models, seed):
    jm, tm = models
    cb = centroidal_batch(B, "cpu", F64, seed=seed)
    q, v = tc.rbd_to_q_v(cb.rbd)
    assert v.abs().max() > 1.0
    got = momenta_about_com(tm, q, v)
    ref = np.asarray(jax.vmap(lambda r: jc.rbd_state_to_centroidal(jm, r))(cb.rbd.numpy()))
    assert scaled_err(got, ref) < TOL
    # the angular momentum is not negligible on these states
    assert np.abs(ref[:, 3:6]).max() > 1e-2


def _jax_plant(plant):
    """The JAX SimState of a batch of plant states (for vmap)."""
    f = lambda t: jnp.asarray(t.numpy())
    return jfo.SimState(q=f(plant.q), v=f(plant.v), t=f(plant.t), base_acc=f(plant.base_acc),
                        contact_forces=f(plant.contact_forces), cmd_buffer=f(plant.cmd_buffer),
                        buf_head=jnp.asarray(plant.buf_head.numpy(), jnp.int32))


@pytest.mark.parametrize("name", KERNELS)
def test_plain_matches_jax(models, name):
    jm, tm = models
    cb = centroidal_batch(B, "cpu", F64, seed=40)
    x, u = cb.x.numpy(), cb.u.numpy()
    if name == "synth_imu":
        got = tfo.synth_imu_plain(tm, cb.plant, with_omega_world=True)
        ref = jax.vmap(lambda st: jfo.synth_imu(jm, st))(_jax_plant(cb.plant))
        ref = (*ref, jax.vmap(jomega)(cb.plant.q[:, 3:6].numpy(), cb.plant.v[:, 3:6].numpy()))
        tol = 1e-12
    elif name == "rbd_to_centroidal":
        got = (tc.rbd_state_to_centroidal_plain(tm, cb.rbd),)
        ref = (jax.vmap(lambda r: jc.rbd_state_to_centroidal(jm, r))(cb.rbd.numpy()),)
        tol = TOL
    elif name == "dummy_step":
        st = tdummy.dummy_step_plain(tm, tdummy.init_dummy_plant(cb.x, 0.1), cb.u, DT)
        jst = jax.vmap(lambda a, b: jdummy.dummy_step(jm, jdummy.init_dummy_plant(a, 0.1), b,
                                                      DT))(x, u)
        got, ref, tol = (st.x, st.t), (jst.x, jst.t), TOL
    else:
        got = (tc.state_input_to_v_plain(tm, cb.x, cb.u),)
        ref = (jax.vmap(lambda a, b: jc.state_input_to_v(jm, a, b))(x, u),)
        tol = TOL
    for a, b in zip(got, ref):
        assert scaled_err(a, b) < tol


@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", KERNELS)
def test_cpu_wrappers_are_plain_and_launch_nothing(name, dtype):
    cb = centroidal_batch(B, "cpu", dtype, seed=41)
    m = cb.model
    before = [c.launches for c in counters()]
    if name == "synth_imu":
        got = tfo.synth_imu(m, cb.plant, with_omega_world=True)
        ref = tfo.synth_imu_plain(m, cb.plant)
        # the world angular velocity the noiseless loop feeds the filter
        ref = (*ref, global_angular_velocity_from_euler_rates(cb.plant.q[:, 3:6],
                                                              cb.plant.v[:, 3:6]))
        assert all(torch.equal(a, b) for a, b in zip(tfo.synth_imu(m, cb.plant), ref[:3]))
    elif name == "rbd_to_centroidal":
        got = (tc.rbd_state_to_centroidal(m, cb.rbd),)
        ref = (tc.rbd_state_to_centroidal_plain(m, cb.rbd),)
    elif name == "dummy_step":
        st = tdummy.init_dummy_plant(cb.x, 0.1)
        got = tdummy.dummy_step(m, st, cb.u, DT)
        ref = tdummy.dummy_step_plain(m, st, cb.u, DT)
    else:
        v, rbd = tc.state_input_to_v(m, cb.x, cb.u, with_rbd=True)
        got = (tc.state_input_to_v(m, cb.x, cb.u), v, rbd)
        v_ref = tc.state_input_to_v_plain(m, cb.x, cb.u)
        # the tick's measured state of the dummy loop
        ref = (v_ref, v_ref, tc.q_v_to_rbd_state(m, tc.state_to_q(cb.x), v_ref))
    for a, b in zip(got, ref):
        assert a.dtype == dtype and torch.equal(a, b)
    assert [c.launches for c in counters()] == before == [0, 0, 0, 0]


def test_plain_wbc_pipeline_takes_the_plain_conversion(monkeypatch):
    """The plain WBC's desired pipeline runs on the card in float64 as a
    yardstick, where the kernel wrapper would refuse it: it calls
    ``state_input_to_v_plain``."""
    assert not hasattr(twbc, "state_input_to_v")
    cb = centroidal_batch(B, "cpu", F64, seed=42)
    calls = []

    def spy(*a):
        calls.append(a)
        return tc.state_input_to_v_plain(*a)

    monkeypatch.setattr(twbc, "state_input_to_v_plain", spy)
    _, v_des, *_ = twbc._desired_pipeline(cb.model, cb.x, cb.u)
    assert len(calls) == 1
    assert torch.equal(v_des, tc.state_input_to_v_plain(cb.model, cb.x, cb.u))


def test_centroidal_batch_covers_the_kernels_cases():
    """Walking robots: stance and swing feet, some in flight, |v| ~ 1, a
    base acceleration, and centroidal states of the same robots."""
    cb = centroidal_batch(64, "cpu", F64, seed=0)
    fz = cb.u[:, 0:12].reshape(64, 4, 3)[..., 2]
    stance = fz != 0
    assert (stance.any(-1) & ~stance.all(-1)).any() and (~stance.any(-1)).any()
    flags = torch.tensor(WALK_FLAGS, dtype=F64)
    assert (stance.double()[:, None, :] == flags[None]).all(-1).any(-1).all()
    assert cb.plant.v.abs().max() > 1.0 and cb.plant.base_acc.abs().max() > 1.0
    q, _ = tc.rbd_to_q_v(cb.rbd)
    assert torch.equal(cb.x[:, 6:], q) and torch.equal(cb.plant.q, q)
    assert cb.x.shape == cb.u.shape == (64, 22)
