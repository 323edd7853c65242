"""Record the golden trace of the full-order closed loop (see
tests/test_torch_sim_loop.py and chip_smoke.py): the JAX package's
``runtime/sim_loop.py::run_sim_loop`` on the CPU in float32, in the
configuration of bench.py's rt_factor demonstration (53 knots over 0.8 s,
the robot at z = 0.624 on the nominal joints, default plant, estimator and
controller parameters), 10 standing periods then 0.3 m/s forward, 40
periods.  ``lin_backend='dense'`` keeps the compile short (the SoA and dense
backends agree to ~1e-12 in float64).  With ``--distance`` it also runs the
same loop in float64 and prints the float32 run's distance to it.

    python tests/golden/regen_sim.py [--distance]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

GOLDEN = os.path.join(os.path.dirname(__file__), "sim_stance_walk_40p.npz")
PERIODS = 40
KEYS = ("q", "v", "base_z", "gait_level", "violation", "cost", "contact_fz")


def run(dtype, cmds):
    from hunter_bipedal_control_tpu.backends.fullorder import default_sim_params
    from hunter_bipedal_control_tpu.estim.contact import default_contact_params
    from hunter_bipedal_control_tpu.estim.kalman import default_kalman_params
    from hunter_bipedal_control_tpu.models.robot import load_model
    from hunter_bipedal_control_tpu.ocp import problem as ocp
    from hunter_bipedal_control_tpu.refs import swing_planner as swp, targets as tg
    from hunter_bipedal_control_tpu.runtime import loop as rloop, sim_loop
    from hunter_bipedal_control_tpu.runtime.controller import default_gains
    from hunter_bipedal_control_tpu.solver import sqp
    from hunter_bipedal_control_tpu.wbc.wbc import default_wbc_params

    m = load_model(dtype=dtype)
    settings = sqp.SqpSettings(n_intervals=53, horizon=0.8, lin_backend="dense")
    dj = jnp.array([0.10, 0., 0.40, 0.93, 0.53, -0.10, 0., -0.40, 0.93, -0.53], dtype)
    qnom = jnp.concatenate([jnp.array([0., 0., 0.63], dtype), jnp.zeros(3, dtype), dj])
    params = ocp.make_input_cost(m, ocp.default_ocp_params(m, dtype), qnom)
    q0 = jnp.concatenate([jnp.array([0., 0., 0.624], dtype), jnp.zeros(3, dtype), dj])
    st = sim_loop.init_sim_loop_state(m, settings, q0)
    # one dtype through the scan carry (the gait template is float32)
    st = jax.tree.map(lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a,
                      st)
    _, telem = jax.jit(lambda s, c: sim_loop.run_sim_loop(
        m, settings, params, swp.default_swing_config(dtype), default_wbc_params(dtype),
        default_gains(dtype), tg.default_cmd_vel_config(dtype=dtype),
        default_kalman_params(dtype), default_contact_params(dtype), default_sim_params(dtype),
        rloop.LoopConfig(), s, c, PERIODS, dj))(st, jnp.asarray(cmds, dtype))
    return {k: np.asarray(telem[k]) for k in KEYS}


def main():
    cmds = np.zeros((PERIODS, 4), np.float32)
    cmds[10:, 0] = 0.3
    t32 = run(jnp.float32, cmds)
    np.savez_compressed(GOLDEN, cmds=cmds, **t32)
    print(f"recorded {GOLDEN}: z in [{t32['base_z'].min():.4f}, {t32['base_z'].max():.4f}], "
          f"median violation {np.median(t32['violation']):.2e}")
    if "--distance" in sys.argv:
        t64 = run(jnp.float64, cmds)
        for k in KEYS:
            print(k, float(np.abs(t32[k].astype(np.float64) - t64[k]).max()))


if __name__ == "__main__":
    main()
