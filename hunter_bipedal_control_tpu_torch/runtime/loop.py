"""Deterministic co-simulation scheduler: 100 Hz MPC / 500 Hz control.

Port of ``hunter_bipedal_control_tpu/runtime/loop.py``'s dummy loop: the MPC
thread (LeggedController.cpp:396-421) and the hardware loop
(LeggedHWLoop.cpp:53-79) become a Python loop over MPC periods with
``ticks_per_mpc`` control ticks each, against the dummy plant.  The policy
solved at the start of a period is the one its ticks evaluate (a solve that
completes within its period).  Batched over B scenarios.  On the card each
tick's state conversion is kernel B14b and the plant's step kernel B14a.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..backends.dummy import DummyPlantState, dummy_step, init_dummy_plant
from ..gait import adaptive
from ..models.centroidal import state_input_to_v
from ..models.robot import RobotModel
from ..ocp import problem as ocp
from ..refs import swing_planner as swp
from ..refs import targets as tg
from ..solver import mpc as mpc_mod
from ..solver import sqp as sqp_mod
from ..wbc.wbc import WbcParams, WbcState, init_wbc_state
from .controller import GainConfig, control_tick


class LoopConfig(NamedTuple):
    """Timing configuration (hunter.yaml 500 Hz loop, task.info 100 Hz MPC)."""

    control_dt: float = 0.002     # 500 Hz
    ticks_per_mpc: int = 5        # -> 100 Hz MPC
    use_wbc: bool = True          # the dummy loop can bypass the WBC (pure MRT test)
    # the dummy loop integrates the solver's own dynamics, so 0.0 keeps it an
    # exact MRT dummy-loop test (see control_tick's policy_lead)
    policy_lead: float = 0.0


class LoopState(NamedTuple):
    plant: DummyPlantState
    mpc_state: mpc_mod.MpcState
    wbc_state: WbcState
    gait: adaptive.GaitRunState
    policy: sqp_mod.SqpSolution
    emergency_stop: torch.Tensor  # (B,) bool
    last_cmd_vel: torch.Tensor    # (B, 4) slew-limited command memory


def _empty_policy(settings: sqp_mod.SqpSettings, batch: int, nx: int, nu: int, device,
                  dtype) -> sqp_mod.SqpSolution:
    N = settings.n_intervals

    def z(*shape):
        return torch.zeros((batch, *shape), dtype=dtype, device=device)

    return sqp_mod.SqpSolution(times=z(N + 1), states=z(N + 1, nx), inputs=z(N + 1, nu),
                               cost=z(), constraint_violation=z(), step_size=z())


def init_loop_state(model: RobotModel, settings: sqp_mod.SqpSettings, x0, t0=0.0) -> LoopState:
    """Cold loop state for B scenarios starting at x0 (B, nx)."""
    dtype, dev = x0.dtype, x0.device
    Bn, nx = x0.shape
    nu = 12 + model.nj
    return LoopState(
        plant=init_dummy_plant(x0, t0),
        mpc_state=mpc_mod.init_mpc_state(model, settings, Bn, nx, dev, dtype),
        wbc_state=init_wbc_state(Bn, dev, dtype),
        gait=adaptive.init_gait_run_state(Bn, dev, dtype, t0),
        policy=_empty_policy(settings, Bn, nx, nu, dev, dtype),
        emergency_stop=torch.zeros(Bn, dtype=torch.bool, device=dev),
        last_cmd_vel=torch.zeros((Bn, 4), dtype=dtype, device=dev),
    )


def run_dummy_loop(model: RobotModel, settings: sqp_mod.SqpSettings,
                   params: ocp.OcpParams, planner_cfg: swp.SwingConfig,
                   wbc_params: WbcParams, gains: GainConfig,
                   cmd_cfg: tg.CmdVelConfig, cfg: LoopConfig,
                   state: LoopState, cmd_vel_seq, n_mpc_steps: int,
                   default_joints):
    """Run ``n_mpc_steps`` MPC periods of closed loop against the dummy plant.

    cmd_vel_seq: (n_mpc_steps, 4) commands shared by the scenarios, or
    (n_mpc_steps, B, 4).  Returns (final LoopState, telemetry dict of
    per-period tensors stacked to (n_mpc_steps, B, ...)): t, base_z, cost,
    violation, alpha, gait_level, x."""
    dtype, dev = state.plant.x.dtype, state.plant.x.device
    Bn = state.plant.x.shape[0]
    cmds = torch.as_tensor(cmd_vel_seq, dtype=dtype, device=dev)
    walk = torch.ones(Bn, dtype=torch.bool, device=dev)
    zeros2 = torch.zeros((Bn, 2), dtype=dtype, device=dev)
    telem = {k: [] for k in ("t", "base_z", "cost", "violation", "alpha", "gait_level", "x")}
    st = state
    for k in range(n_mpc_steps):
        t = st.plant.t
        x_est = st.plant.x

        # command shaping (TargetTrajectoriesPublisher parity)
        cmd_vel = tg.filter_cmd_vel(cmds[k].expand(Bn, 4), st.last_cmd_vel, cmd_cfg)
        target = tg.cmd_vel_to_target(cmd_vel, x_est, t, settings.horizon, cmd_cfg)

        # velocity-adaptive gait + schedule upkeep
        gait, vel_avg = adaptive.vel_abs_update(st.gait, cmd_vel, target.states[:, 0])
        gait = adaptive.walk_gait_switch(gait, vel_avg, t, t + 10.0)
        gait = adaptive.extend_schedule(gait, t, t + 2 * settings.horizon)

        # the MPC solve; its policy drives this period's ticks
        body_cmd6 = torch.cat([cmd_vel[:, 0:3], zeros2, cmd_vel[:, 3:4]], dim=-1)
        sol, mpc_state, _ = mpc_mod.mpc_step(model, settings, params, planner_cfg,
                                             st.mpc_state, gait.schedule, target, t, x_est,
                                             body_cmd6, default_joints)

        plant, wbc_state, estop = st.plant, st.wbc_state, st.emergency_stop
        for _ in range(cfg.ticks_per_mpc):
            tt, x_now = plant.t, plant.x
            # dummy backend: the "measured" rbd state from the plant's own
            # centroidal state and the policy input (cheater estimator,
            # FromTopicEstimate parity)
            u_opt = mpc_mod.evaluate_policy(sol, tt[:, None])[1][:, 0]
            _, rbd = state_input_to_v(model, x_now, u_opt, with_rbd=True)
            if cfg.use_wbc:
                out, wbc_state = control_tick(model, wbc_params, gains, wbc_state, sol,
                                              gait.schedule, tt, x_now, rbd, default_joints,
                                              walk, estop, cfg.control_dt,
                                              policy_lead=cfg.policy_lead)
                estop = out.emergency_stop
            # the plant evolves under the policy input (MRT dummy rollout)
            z_now = x_now[:, 8]
            plant = dummy_step(model, plant, u_opt, cfg.control_dt)

        st = LoopState(plant=plant, mpc_state=mpc_state, wbc_state=wbc_state, gait=gait,
                       policy=sol, emergency_stop=estop, last_cmd_vel=cmd_vel)
        for key, v in (("t", t), ("base_z", z_now), ("cost", sol.cost),
                       ("violation", sol.constraint_violation), ("alpha", sol.step_size),
                       ("gait_level", gait.gait_level), ("x", plant.x)):
            telem[key].append(v)
    return st, {key: torch.stack(v) for key, v in telem.items()}
