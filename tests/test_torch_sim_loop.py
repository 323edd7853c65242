"""The port's full-order closed loop (``runtime/sim_loop.py``: plant,
sensing, Kalman filter and momentum observer in the loop, MPC, WBC) on the
CPU.

- Against the JAX package's ``run_sim_loop``, float64, 3 periods of the
  benchmark's real-time scenario at a small horizon (8 knots over 0.24 s,
  ``lin_backend='dense'``: the SoA HLO compiles for minutes on the CPU):
  every telemetry key and the final state within 1e-8 on its own scale,
  flags and gait levels equal.  JAX's float32 gait template is cast to
  float64 with the rest of its initial state (its scan needs one dtype).
- ``convert.from_numpy`` carries the JAX cold loop state across;
  ``build_sim_loop`` and ``sim_step_batch`` refuse to run without CUDA
  unless given ``device="cpu"``.
- The port's float32 loop in the real-time configuration
  (``entry.build_sim_loop()``: 53 knots over 0.8 s, 'soa', the plain
  versions) over the 40 periods of ``entry.rt_commands`` holds
  tests/test_sim_loop.py:66-73's bands (base z in (0.58, 0.68), |Euler| <
  0.15, no e-stop, mean total normal force within 15% of m g) and the
  golden trace tests/golden/sim_stance_walk_40p.npz with tests/test_golden.py's
  checks: gait levels equal, base z within 5e-3, base planar velocity
  within 2e-2, joints within 3e-2, median violation at most twice the
  golden's.  The golden was recorded from the JAX package's loop in float32
  on the CPU by ``python tests/golden/regen_sim.py``; the JAX package's own
  float32 run sits 2.9e-4 (q) and 2.3e-3 (v) from its float64 run over
  these 40 periods.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunter_bipedal_control_tpu.backends.fullorder import default_sim_params
from hunter_bipedal_control_tpu.estim.contact import default_contact_params
from hunter_bipedal_control_tpu.estim.kalman import default_kalman_params
from hunter_bipedal_control_tpu.models.robot import load_model as jload
from hunter_bipedal_control_tpu.ocp import problem as jocp
from hunter_bipedal_control_tpu.refs import swing_planner as jswp, targets as jtg
from hunter_bipedal_control_tpu.runtime import loop as jloop, sim_loop as jsim
from hunter_bipedal_control_tpu.runtime.controller import default_gains
from hunter_bipedal_control_tpu.solver import sqp as jsqp
from hunter_bipedal_control_tpu.wbc.wbc import default_wbc_params
from hunter_bipedal_control_tpu_torch import convert
from hunter_bipedal_control_tpu_torch.entry import build_sim_loop, rt_commands, run_sim_loop
from hunter_bipedal_control_tpu_torch.runtime import sim_loop as tsim

F64 = torch.float64
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "sim_stance_walk_40p.npz")
DJ = [0.10, 0., 0.40, 0.93, 0.53, -0.10, 0., -0.40, 0.93, -0.53]
SMALL = {"n_intervals": 8, "horizon": 0.24, "lin_backend": "dense"}
PERIODS = 3
TOTAL_MASS = 12.5869


def own_scale(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _jax_setup():
    """JAX's loop pieces at the small horizon, float64, and its cold state."""
    dt = jnp.float64
    m = jload(dtype=dt)
    settings = jsqp.SqpSettings(**SMALL)
    dj = jnp.asarray(DJ, dt)
    qnom = jnp.concatenate([jnp.array([0., 0., 0.63], dt), jnp.zeros(3, dt), dj])
    params = jocp.make_input_cost(m, jocp.default_ocp_params(m, dt), qnom)
    q0 = jnp.concatenate([jnp.array([0., 0., 0.624], dt), jnp.zeros(3, dt), dj])
    st = jsim.init_sim_loop_state(m, settings, q0)
    st = jax.tree.map(lambda a: a.astype(dt) if jnp.issubdtype(a.dtype, jnp.floating) else a, st)
    return m, settings, params, dj, st


@pytest.fixture(scope="module")
def jax_run():
    m, settings, params, dj, st = _jax_setup()
    dt = jnp.float64
    cmds = jnp.asarray(rt_commands(PERIODS).numpy())
    fin, telem = jax.jit(lambda s, c: jsim.run_sim_loop(
        m, settings, params, jswp.default_swing_config(dt), default_wbc_params(dt),
        default_gains(dt), jtg.default_cmd_vel_config(dtype=dt), default_kalman_params(dt),
        default_contact_params(dt), default_sim_params(dt), jloop.LoopConfig(), s, c, PERIODS,
        dj))(st, cmds)
    return fin, {k: np.asarray(v) for k, v in telem.items()}


@pytest.fixture(scope="module")
def port_run():
    setup = build_sim_loop("cpu", F64, **SMALL)
    return run_sim_loop(setup, rt_commands(PERIODS))


def test_telemetry_matches_jax_f64(jax_run, port_run):
    _, jt = jax_run
    _, tt = port_run
    assert sorted(tt) == sorted(jt) == sorted(tsim.TELEMETRY)
    for k, ref in jt.items():
        got = tt[k][:, 0].numpy()
        assert got.shape == ref.shape, k
        if ref.dtype == np.bool_ or k == "gait_level":
            np.testing.assert_array_equal(got, ref, err_msg=k)
        else:
            assert own_scale(got, ref) <= 1e-8, (k, own_scale(got, ref))


def test_final_state_matches_jax_f64(jax_run, port_run):
    jfin, _ = jax_run
    tfin, _ = port_run
    pairs = {"plant": (tfin.plant, jfin.plant), "kalman": (tfin.kalman, jfin.kalman),
             "observer": (tfin.observer, jfin.observer), "wbc": (tfin.wbc_state, jfin.wbc_state),
             "policy": (tfin.policy, jfin.policy)}
    for name, (t, j) in pairs.items():
        for f in t._fields:
            a, b = getattr(t, f), np.asarray(getattr(j, f))
            if not a.is_floating_point():
                np.testing.assert_array_equal(a[0].numpy(), b, err_msg=f"{name}.{f}")
            elif np.abs(b).max() > 0:
                assert own_scale(a[0].numpy(), b) <= 1e-8, (name, f)
    for f in ("last_cmd_vel", "last_torque"):
        assert own_scale(getattr(tfin, f)[0].numpy(), np.asarray(getattr(jfin, f))) <= 1e-8, f
    assert not bool(tfin.emergency_stop[0]) and not bool(jfin.emergency_stop)


def test_sim_loop_state_from_jax():
    """The JAX cold state (float64), batched to 1, equals the port's own."""
    *_, jst = _jax_setup()
    conv = convert.from_numpy(jax.tree.map(lambda a: np.asarray(a)[None], jst), "cpu", F64)
    own = build_sim_loop("cpu", F64, **SMALL).state
    assert isinstance(conv, tsim.SimLoopState) and conv.noise is None

    def leaves(tup, out):
        for v in tup:
            if hasattr(v, "_fields"):
                leaves(v, out)
            elif v is not None:
                out.append(v)
        return out

    flat_c, flat_o = leaves(conv, []), leaves(own, [])
    assert len(flat_c) == len(flat_o)
    for a, b in zip(flat_c, flat_o):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.allclose(a.double(), b.double(), rtol=1e-15, atol=1e-15)


@pytest.fixture(scope="module")
def rt_run():
    ref = np.load(GOLDEN)
    fin, telem = run_sim_loop(build_sim_loop("cpu", torch.float32), ref["cmds"])
    return ref, fin, telem


def test_rt_loop_holds_jax_bands(rt_run):
    """tests/test_sim_loop.py:66-73's bands over the 40 periods."""
    _, fin, telem = rt_run
    z = telem["base_z"][:, 0].numpy()
    q = telem["q"][:, 0].numpy()
    assert np.isfinite(q).all()
    assert z.min() > 0.58 and z.max() < 0.68, (z.min(), z.max())
    assert np.abs(q[:, 3:6]).max() < 0.15
    assert not bool(fin.emergency_stop.any())
    fz = telem["contact_fz"][:, 0].numpy().sum(-1)
    np.testing.assert_allclose(fz[5:].mean(), TOTAL_MASS * 9.81, rtol=0.15)


def test_rt_loop_holds_golden_trace(rt_run):
    ref, _, telem = rt_run
    q = telem["q"][:, 0].numpy()
    v = telem["v"][:, 0].numpy()
    assert q.shape == ref["q"].shape
    np.testing.assert_array_equal(telem["gait_level"][:, 0].numpy(), ref["gait_level"])
    np.testing.assert_allclose(q[:, 2], ref["q"][:, 2], atol=5e-3)
    np.testing.assert_allclose(v[:, 0:2], ref["v"][:, 0:2], atol=2e-2)
    np.testing.assert_allclose(q[:, 6:], ref["q"][:, 6:], atol=3e-2)
    assert np.median(telem["violation"].numpy()) <= 2 * max(np.median(ref["violation"]), 1e-4)


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: device=None is valid here")
    from hunter_bipedal_control_tpu_torch.entry import sim_step_batch

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_sim_loop()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sim_step_batch(4)
