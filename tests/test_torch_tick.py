"""Port parity: the 500 Hz control tick as a whole, on the CPU in float64.

A policy from the JAX ``mpc_step`` (``__graft_entry__._build(8, 0.24,
lin_backend='dense')``, B=2 scenarios whose initial states differ by 1e-3,
the trot template tiled in float64 as tests/test_torch_mpc.py does) is
carried across with ``convert.from_numpy``.  Then five chained ticks of
Kalman update -> momentum observer -> ``control_tick``, with the standing
sensor readings of bench.py's tick chain, run in both packages: the JAX one
under ``vmap`` and ``lax.scan``, the port's through ``entry.tick_chain`` on
``build_controller(device="cpu")``.  Every tick's joint command, optimized
state and input, WBC solution and e-stop flag, and the carried Kalman,
observer and WBC states, within 1e-8 of their own scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build
from hunter_bipedal_control_tpu.estim import contact as jcon, kalman as jkf
from hunter_bipedal_control_tpu.gait import mode_schedule as jms
from hunter_bipedal_control_tpu.models.spatial import zyx_to_quat
from hunter_bipedal_control_tpu.runtime import controller as jctrl
from hunter_bipedal_control_tpu.solver import mpc as jmpc
from hunter_bipedal_control_tpu.wbc import wbc as jwbc
from hunter_bipedal_control_tpu_torch import convert
from hunter_bipedal_control_tpu_torch.entry import (TICK_BASE_Z, build_controller,
                                                    build_wbc_batch, tick_chain, wbc_chain)
from hunter_bipedal_control_tpu_torch.estim import contact as tcon, kalman as tkf
from hunter_bipedal_control_tpu_torch.ops import linalg as tlinalg, qp as tqp
from hunter_bipedal_control_tpu_torch.runtime import controller as tctrl

F64 = torch.float64
B, N, HORIZON, K, DT = 2, 8, 0.24, 5, 0.002
TOL = 1e-8


def scaled_err(got, ref):
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


@pytest.fixture(scope="module")
def jax_run():
    m, settings, params, pcfg, dj, x0, _, target = _build(N, HORIZON, jnp.float64,
                                                          lin_backend="dense")
    sched = jms.tile_template(jms.make_template(["L", "R"], [0.0, 0.3, 0.6], jnp.float64),
                              -HORIZON, 4 * HORIZON)
    xs = jnp.tile(x0[None], (B, 1)) + 0.001 * jnp.arange(B, dtype=x0.dtype)[:, None]

    def step(x):
        return jmpc.mpc_step(m, settings, params, pcfg, jmpc.init_mpc_state(m, settings), sched,
                             target, 0.0, x, jnp.zeros(6, x.dtype), dj)[0]

    policy = jax.jit(jax.vmap(step))(xs)

    f64 = jnp.float64
    kfp, obp = jkf.default_kalman_params(f64), jcon.default_contact_params(f64)
    wbcp, gains = jwbc.default_wbc_params(f64), jctrl.default_gains(f64)
    q0 = jnp.concatenate([jnp.asarray([0., 0., TICK_BASE_Z], f64), jnp.zeros(3, f64), dj])
    quat0 = zyx_to_quat(q0[3:6])

    def chain(pol):
        def body(c, i):
            kf, obs, wst, last_tau = c
            t = DT * i.astype(f64)
            kf, pos, vel = jkf.kalman_update(m, kfp, kf, q0[3:6], q0[6:], jnp.zeros(10, f64),
                                             jnp.zeros(3, f64), quat0,
                                             jnp.asarray([0., 0., 9.81], f64), jnp.ones(4, f64),
                                             DT)
            rbd = jnp.concatenate([q0[3:6], pos, q0[6:], jnp.zeros(3, f64), vel,
                                   jnp.zeros(10, f64)])
            obs, _ = jcon.momentum_observer_update(m, obp, obs, rbd, last_tau, DT)
            out, wst = jctrl.control_tick(m, wbcp, gains, wst, pol, sched, t,
                                          jnp.concatenate([jnp.zeros(6, f64), q0]), rbd, dj,
                                          jnp.asarray(True), jnp.asarray(False), DT)
            return (kf, obs, wst, out.command.tau_ff), out

        init = (jkf.init_kalman_state(f64), jcon.init_contact_observer(f64),
                jwbc.init_wbc_state(f64), jnp.zeros(10, f64))
        (kf, obs, wst, _), outs = jax.lax.scan(body, init, jnp.arange(K))
        return outs, (kf, obs, wst)

    outs, states = jax.jit(jax.vmap(chain))(policy)
    return dict(m=m, policy=policy, sched=sched, params=(kfp, obp, wbcp, gains), outs=outs,
                states=states)


def port_inputs(run):
    """The JAX policy and schedule, carried across."""
    policy = convert.from_numpy(jax.tree.map(np.asarray, run["policy"]), "cpu", F64)
    return policy, convert.from_numpy(jax.tree.map(np.asarray, run["sched"]), "cpu", F64)


def test_build_controller_defaults_match_jax(jax_run):
    kfp, obp, wbcp, gains = jax_run["params"]
    setup = build_controller(B, "cpu", F64)
    ctrl = setup.controller
    for port, ref in ((setup.kalman_params, kfp), (setup.observer_params, obp),
                      (ctrl.wbc_params, wbcp), (ctrl.gains, gains)):
        conv = convert.from_numpy(jax.tree.map(np.asarray, ref), "cpu", F64)
        for name in port._fields:
            a, b = getattr(port, name), getattr(conv, name)
            if torch.is_tensor(a):
                np.testing.assert_array_equal(a.numpy(), b.numpy())
            else:
                assert a == b and type(a) is type(b), name
    assert not setup.wbc.has_last.any() and setup.kalman.P.shape == (B, 18, 18)


def test_tick_chain_matches_jax(jax_run):
    jouts, jstates = jax_run["outs"], jax_run["states"]
    policy, schedule = port_inputs(jax_run)
    setup = build_controller(B, "cpu", F64)
    outs, states = tick_chain(setup, policy, schedule, K)
    for a, b in zip(outs.command, jouts.command):
        assert scaled_err(a, b) < TOL
    for name in ("optimized_state", "optimized_input", "wbc_solution"):
        assert scaled_err(getattr(outs, name), getattr(jouts, name)) < TOL, name
    np.testing.assert_array_equal(outs.emergency_stop.numpy(), np.asarray(jouts.emergency_stop))
    assert outs.wbc_accepted.all()
    for port, ref in zip(states, jstates):
        for a, b in zip(port, ref):
            if a.dtype == torch.bool:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                assert scaled_err(a, b) < TOL
    # the tick walks: commanded torques change from tick to tick
    assert float((outs.command.tau_ff[:, -1] - outs.command.tau_ff[:, 0]).abs().max()) > 1e-6


def test_control_tick_stance_override_and_estop(jax_run):
    """One tick before walking is switched on (stance override) and one with
    a joint beyond its limit (damping-only command), against the JAX tick."""
    m, jsched = jax_run["m"], jax_run["sched"]
    _, _, wbcp, gains = jax_run["params"]
    setup = build_controller(B, "cpu", F64)
    ctrl = setup.controller
    policy, schedule = port_inputs(jax_run)
    q0 = setup.q0.numpy()
    x_est = np.concatenate([np.zeros(6), q0])
    rbd = np.concatenate([q0[3:6], q0[0:3], q0[6:], np.zeros(16)])
    rbd = np.stack([rbd, rbd])
    rbd[1, 6] = 3.0                             # beyond the first joint's upper limit
    set_walk = np.array([False, True])

    def one(pol, r, w):
        return jctrl.control_tick(m, wbcp, gains, jwbc.init_wbc_state(jnp.float64), pol, jsched,
                                  0.01, x_est, r, q0[6:], w, jnp.asarray(False), DT)

    jout, _ = jax.jit(jax.vmap(one))(jax_run["policy"], rbd, set_walk)
    out, _ = ctrl(setup.wbc, policy, schedule, 0.01, torch.tensor(x_est).expand(B, -1),
                  torch.tensor(rbd), setup.default_joints, torch.tensor(set_walk),
                  torch.zeros(B, dtype=torch.bool), DT)
    for a, b in zip(out.command, jout.command):
        assert scaled_err(a, b) < TOL
    np.testing.assert_array_equal(out.emergency_stop.numpy(), [False, True])
    np.testing.assert_array_equal(out.command.kd[1].numpy(), np.ones(10))
    assert scaled_err(out.optimized_state, jout.optimized_state) < TOL


def test_reconfigure_gains():
    g = tctrl.default_gains("cpu", F64)
    g2 = tctrl.reconfigure_gains(g, kp_big_stance=500.0, kd_feet=-3.0)
    assert float(g2.kp_big_stance) == 100.0 and float(g2.kd_feet) == 0.0
    assert float(g2.kp_small_swing) == float(g.kp_small_swing)
    with pytest.raises(ValueError):
        tctrl.reconfigure_gains(g, kp_nope=1.0)


@pytest.mark.parametrize("lead_forces", [True, False])
def test_control_tick_leads_match_jax(jax_run, lead_forces):
    """policy_lead and swing_lead (the swing legs' joint references led
    further), with the force feedforward led or kept at t."""
    m, jsched = jax_run["m"], jax_run["sched"]
    _, _, wbcp, gains = jax_run["params"]
    setup = build_controller(B, "cpu", F64)
    policy, schedule = port_inputs(jax_run)
    q0 = setup.q0.numpy()
    x_est = np.concatenate([np.zeros(6), q0])
    rbd = np.concatenate([q0[3:6], q0[0:3], q0[6:], np.zeros(16)])
    lead = dict(policy_lead=0.012, swing_lead=0.02, lead_forces=lead_forces)

    def one(pol):
        return jctrl.control_tick(m, wbcp, gains, jwbc.init_wbc_state(jnp.float64), pol, jsched,
                                  0.05, x_est, rbd, q0[6:], jnp.asarray(True),
                                  jnp.asarray(False), DT, **lead)

    jout, _ = jax.jit(jax.vmap(one))(jax_run["policy"])
    out, _ = setup.controller(setup.wbc, policy, schedule, 0.05,
                              torch.tensor(x_est).expand(B, -1),
                              torch.tensor(rbd).expand(B, -1), setup.default_joints,
                              torch.ones(B, dtype=torch.bool), torch.zeros(B, dtype=torch.bool),
                              DT, **lead)
    for name in ("optimized_state", "optimized_input", "wbc_solution"):
        assert scaled_err(getattr(out, name), getattr(jout, name)) < TOL, name
    for a, b in zip(out.command, jout.command):
        assert scaled_err(a, b) < TOL


def test_tick_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: device=None is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_controller(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_wbc_batch(8)


def test_cpu_tick_and_wbc_launch_no_kernel(jax_run):
    policy, schedule = port_inputs(jax_run)
    counters = (tlinalg.gj_inverse, tqp.solve_qp, tcon.momentum_observer_update,
                tkf.kalman_update)
    before = tuple(c.launches for c in counters)
    tick_chain(build_controller(B, "cpu", F64), policy, schedule, 2)
    xs, accepted, _ = wbc_chain(build_wbc_batch(4, "cpu"), 2)
    assert tuple(c.launches for c in counters) == before == (0, 0, 0, 0)
    assert xs.shape == (4, 2, 38) and accepted.all()
