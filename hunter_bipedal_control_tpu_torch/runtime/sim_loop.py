"""Closed loop against the full-order physics backend, with the Kalman
filter and the momentum observer in the loop.

Port of ``hunter_bipedal_control_tpu/runtime/sim_loop.py``, the
sim-in-the-loop operation of the reference's MuJoCo/Gazebo setups: sensing
(optionally corrupted), estimation, the MPC, the WBC, PD motors and contact
physics.  The JAX package's two scans are Python loops over MPC periods and
their ticks; the order of every update is the JAX package's: a period
starts with its own Kalman update, and its ticks start again from that
filter state.  Batched over B scenarios.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..backends import sensor_noise as sn
from ..backends.fullorder import SimParams, SimState, init_sim_state, sim_step, synth_imu
from ..estim.contact import (ContactObserverParams, ContactObserverState, contact_class,
                             init_contact_observer, momentum_observer_update)
from ..estim.kalman import KalmanParams, KalmanState, init_kalman_state, kalman_update
from ..gait import adaptive
from ..gait.mode_schedule import mode_at_time, mode_contacts
from ..models.centroidal import rbd_state_to_centroidal
from ..models.kinematics import contact_positions, fk
from ..models.robot import RobotModel
from ..models.spatial import quat_to_zyx, rotation_zyx
from ..ocp import problem as ocp
from ..refs import swing_planner as swp
from ..refs import targets as tg
from ..solver import mpc as mpc_mod
from ..solver import sqp as sqp_mod
from ..wbc.wbc import WbcParams, WbcState, init_wbc_state
from .controller import GainConfig, control_tick
from .loop import LoopConfig, _empty_policy

NJ = 10


class SimLoopState(NamedTuple):
    plant: SimState
    kalman: KalmanState
    observer: ContactObserverState
    mpc_state: mpc_mod.MpcState
    wbc_state: WbcState
    gait: adaptive.GaitRunState
    policy: sqp_mod.SqpSolution
    emergency_stop: torch.Tensor  # (B,) bool
    last_cmd_vel: torch.Tensor    # (B, 4)
    last_torque: torch.Tensor     # (B, 10) applied torques, for the observer
    # sensor-noise state (backends.sensor_noise.NoiseState) or None:
    # noise-free sensing (what the reference's Gazebo plugin feeds)
    noise: object = None


def init_sim_loop_state(model: RobotModel, settings: sqp_mod.SqpSettings, q0, v0=None,
                        t0=0.0, noise_params=None, noise_seed=0) -> SimLoopState:
    """Cold loop state for B scenarios at q0 (B, 16); the filter starts at
    the true base position and feet, so there is no start-up transient."""
    dtype, dev = q0.dtype, q0.device
    Bn = q0.shape[0]
    nx = nu = 12 + model.nj
    noise = (None if noise_params is None
             else sn.init_noise_state(noise_params, noise_seed, Bn, dev, dtype))
    kf = init_kalman_state(Bn, dev, dtype)
    feet = contact_positions(model, fk(model, q0))
    x_hat = kf.x_hat.clone()
    x_hat[:, 0:3] = q0[:, 0:3]
    x_hat[:, 6:18] = feet.reshape(Bn, -1)
    P = 0.1 * torch.eye(18, dtype=dtype, device=dev).expand(Bn, 18, 18).clone()
    return SimLoopState(
        plant=init_sim_state(q0, v0, t0),
        kalman=kf._replace(x_hat=x_hat, P=P),
        observer=init_contact_observer(Bn, dev, dtype),
        mpc_state=mpc_mod.init_mpc_state(model, settings, Bn, nx, dev, dtype),
        wbc_state=init_wbc_state(Bn, dev, dtype),
        gait=adaptive.init_gait_run_state(Bn, dev, dtype, t0),
        policy=_empty_policy(settings, Bn, nx, nu, dev, dtype),
        emergency_stop=torch.zeros(Bn, dtype=torch.bool, device=dev),
        last_cmd_vel=torch.zeros((Bn, 4), dtype=dtype, device=dev),
        last_torque=torch.zeros((Bn, NJ), dtype=dtype, device=dev),
        noise=noise)


def _sense_and_estimate(model, kf_params, plant: SimState, kalman: KalmanState, nstate,
                        schedule, t, dt, noise_params=None):
    """LeggedController::updateStateEstimation: read the plant's sensors
    (corrupted when ``noise_params`` is given), run the Kalman filter and
    assemble the rbd state and the centroidal estimate (on the card: kernels
    B13a for the IMU, B12 for the filter, B13b for the conversion).
    Returns (kalman, rbd (B, 32), x_est (B, 22), commanded contacts (B, 4),
    noise state)."""
    quat, omega_local, accel_local, omega_world = synth_imu(model, plant, with_omega_world=True)
    qj, vj = plant.q[:, 6:], plant.v[:, 6:]
    if noise_params is not None:
        nstate, quat, omega_local, accel_local, qj, vj = sn.corrupt(
            noise_params, nstate, quat, omega_local, accel_local, qj, vj, dt)
        # as the reference does, the orientation comes from the noisy IMU quaternion
        zyx = quat_to_zyx(quat)
        omega_world = (rotation_zyx(zyx) @ omega_local[..., None])[..., 0]
    else:
        # noiseless: the IMU's own E(zyx) theta_dot
        zyx = plant.q[:, 3:6]
    dtype = plant.q.dtype
    mode = mode_at_time(schedule, t.to(schedule.event_times.dtype)[:, None])[:, 0]
    cmd_contact = mode_contacts(dtype, plant.q.device)[mode]
    kalman, pos, vel = kalman_update(model, kf_params, kalman, zyx, qj, vj, omega_world, quat,
                                     accel_local, cmd_contact, dt)
    rbd = torch.cat([zyx, pos, qj, omega_world, vel, vj], dim=-1)
    return kalman, rbd, rbd_state_to_centroidal(model, rbd), cmd_contact, nstate


TELEMETRY = ("t", "base_z", "vx_est", "est_pos_err", "q", "v", "cost", "violation",
             "gait_level", "contact_fz", "est_force_norm", "est_contact", "early_contact",
             "late_contact")


def run_sim_loop(model: RobotModel, settings: sqp_mod.SqpSettings, params: ocp.OcpParams,
                 planner_cfg: swp.SwingConfig, wbc_params: WbcParams, gains: GainConfig,
                 cmd_cfg: tg.CmdVelConfig, kf_params: KalmanParams,
                 obs_params: ContactObserverParams, sim_params: SimParams, cfg: LoopConfig,
                 state: SimLoopState, cmd_vel_seq, n_mpc_steps: int, default_joints,
                 noise_params=None):
    """Run ``n_mpc_steps`` MPC periods of physics-in-the-loop simulation.

    cmd_vel_seq: (n_mpc_steps, 4) commands shared by the scenarios, or
    (n_mpc_steps, B, 4).  ``noise_params`` (``SensorNoiseParams``) needs
    ``state.noise``.  Returns (final SimLoopState, telemetry of per-period tensors stacked to
    (n_mpc_steps, B, ...), the keys of ``TELEMETRY``)."""
    dtype, dev = state.plant.q.dtype, state.plant.q.device
    Bn = state.plant.q.shape[0]
    dt = cfg.control_dt
    cmds = torch.as_tensor(cmd_vel_seq, dtype=dtype, device=dev)
    walk = torch.ones(Bn, dtype=torch.bool, device=dev)
    zeros2 = torch.zeros((Bn, 2), dtype=dtype, device=dev)
    telem = {k: [] for k in TELEMETRY}
    st = state
    for k in range(n_mpc_steps):
        t = st.plant.t
        # the estimate the solver starts from
        kf0, _, x_est, _, nst0 = _sense_and_estimate(model, kf_params, st.plant, st.kalman,
                                                     st.noise, st.gait.schedule, t, dt,
                                                     noise_params)

        cmd_vel = tg.filter_cmd_vel(cmds[k].expand(Bn, 4), st.last_cmd_vel, cmd_cfg)
        target = tg.cmd_vel_to_target(cmd_vel, x_est, t, settings.horizon, cmd_cfg)
        gait, vel_avg = adaptive.vel_abs_update(st.gait, cmd_vel, target.states[:, 0])
        gait = adaptive.walk_gait_switch(gait, vel_avg, t, t + 10.0)
        gait = adaptive.extend_schedule(gait, t, t + 2 * settings.horizon)

        body_cmd6 = torch.cat([cmd_vel[:, 0:3], zeros2, cmd_vel[:, 3:4]], dim=-1)
        sol, mpc_state, _ = mpc_mod.mpc_step(model, settings, params, planner_cfg,
                                             st.mpc_state, gait.schedule, target, t, x_est,
                                             body_cmd6, default_joints)

        plant, kf, obs, nst = st.plant, kf0, st.observer, nst0
        wbc_state, estop, last_tau = st.wbc_state, st.emergency_stop, st.last_torque
        for _ in range(cfg.ticks_per_mpc):
            tt = plant.t
            kf, rbd, x_now, cmd_contact, nst = _sense_and_estimate(
                model, kf_params, plant, kf, nst, gait.schedule, tt, dt, noise_params)
            obs, _ = momentum_observer_update(model, obs_params, obs, rbd, last_tau, dt)
            # the contact classification in the period's swing windows
            # (StartStopTime4Legs, LeggedController.cpp:306-308): kernel B16
            est_contact, early, late = contact_class(obs_params, obs.est_forces, cmd_contact,
                                                     gait.schedule, t, tt, settings.horizon)
            out, wbc_state = control_tick(model, wbc_params, gains, wbc_state, sol,
                                          gait.schedule, tt, x_now, rbd, default_joints, walk,
                                          estop, dt, policy_lead=cfg.policy_lead)
            estop = out.emergency_stop
            c = out.command
            plant = sim_step(model, sim_params, plant, c)
            # the torque the motors applied, for the observer's next tick
            last_tau = c.tau_ff + c.kp * (c.pos_des - plant.q[:, 6:]) + c.kd * (
                c.vel_des - plant.v[:, 6:])

        st = SimLoopState(plant=plant, kalman=kf, observer=obs, mpc_state=mpc_state,
                          wbc_state=wbc_state, gait=gait, policy=sol, emergency_stop=estop,
                          last_cmd_vel=cmd_vel, last_torque=last_tau, noise=nst)
        row = {"t": t, "base_z": plant.q[:, 2], "vx_est": x_now[:, 0],
               "est_pos_err": torch.linalg.vector_norm(kf.x_hat[:, 0:3] - plant.q[:, 0:3],
                                                       dim=-1),
               "q": plant.q, "v": plant.v, "cost": sol.cost,
               "violation": sol.constraint_violation, "gait_level": gait.gait_level,
               "contact_fz": plant.contact_forces[..., 2],
               "est_force_norm": obs.est_forces[:, 12:14], "est_contact": est_contact,
               "early_contact": early, "late_contact": late}
        for key in TELEMETRY:
            telem[key].append(row[key])
    return st, {key: torch.stack(v) for key, v in telem.items()}
