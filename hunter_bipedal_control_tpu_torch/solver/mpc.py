"""MPC orchestration: reference preparation + warm start + SQP solve.

Port of ``hunter_bipedal_control_tpu/solver/mpc.py``: ``mpc_step`` runs a
batch of B scenarios.  ``x_init`` (B, nx) sets B; the schedule, target,
command, default joints and init time may be shared (no batch dim) or per
scenario, and shared ones are broadcast.  ``Mpc`` wraps the step as an
``nn.Module`` whose buffers hold the model, the OCP weights and the swing
configuration.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from ..gait.mode_schedule import ModeSchedule
from ..models.robot import RobotModel
from ..ocp import problem as ocp
from ..refs import ik as ik_mod
from ..refs import swing_planner as swp
from ..refs import targets as tg
from ..tuple_module import TupleModule
from . import sqp
from .reference_prep import knot_refs, knot_refs_plain, swing_plan, swing_plan_plain

JOINT_REF_STEP = 0.15  # calculateJointRef sampling (SwitchedModelReferenceManager.cpp:262)


class MpcState(NamedTuple):
    """Carried across solves, per scenario."""

    planner: swp.PlannerState
    xs_ws: torch.Tensor     # (B, N+1, nx)
    us_ws: torch.Tensor     # (B, N, nu)
    ws_times: torch.Tensor  # (B, N+1)
    has_ws: torch.Tensor    # (B,) bool


def init_mpc_state(model: RobotModel, settings: sqp.SqpSettings, batch: int = 1, nx=None,
                   device=None, dtype=torch.float32) -> MpcState:
    dev = resolve_device(device)
    nx = nx or (12 + model.nj)
    nu = 12 + model.nj
    N = settings.n_intervals
    return MpcState(
        planner=swp.init_planner_state(batch, dev, dtype),
        xs_ws=torch.zeros((batch, N + 1, nx), dtype=dtype, device=dev),
        us_ws=torch.zeros((batch, N, nu), dtype=dtype, device=dev),
        ws_times=torch.zeros((batch, N + 1), dtype=dtype, device=dev),
        has_ws=torch.zeros(batch, dtype=torch.bool, device=dev),
    )


def prepare_references(model: RobotModel, settings: sqp.SqpSettings,
                       planner_cfg: swp.SwingConfig, planner_state: swp.PlannerState,
                       schedule: ModeSchedule, target: tg.TargetTrajectories,
                       init_time, x_init, body_vel_cmd, default_joints):
    """modifyReferences parity: swing planner update + joint refs + per-knot
    reference bundle.  All arguments batched (B, ...).  A CPU tensor takes
    the plain versions (``swing_plan_plain``, the IK's two passes,
    ``knot_refs_plain``); a CUDA tensor three launches, kernels B8b1, B8a
    and B8b2 (``swing_plan``, ``ik.leg_ik``, ``knot_refs``), or an error.
    Returns (ReferenceBundle, SwingRefs, the IK-modified target, new
    PlannerState)."""
    N, H = settings.n_intervals, settings.horizon
    n_samples = int(H / JOINT_REF_STEP) + 1
    if x_init.device.type == "cpu":
        plan = swing_plan_plain(model, planner_cfg, planner_state, schedule, target, init_time,
                                x_init, body_vel_cmd, default_joints, H, n_samples)
    else:
        plan = swing_plan(model, planner_cfg, planner_state, schedule, target, init_time, x_init,
                          body_vel_cmd, default_joints, H, n_samples)
    _, joint_refs = ik_mod.joint_reference_ik(
        model, plan.poses.contiguous(), plan.warm.contiguous(), plan.des.contiguous(),
        plan.R_des.contiguous(), trans_it=3, rot_it=2)
    knots = knot_refs_plain if x_init.device.type == "cpu" else knot_refs
    bundle, mod_target = knots(schedule, plan, init_time, H, N, joint_refs)
    return bundle, plan.refs, mod_target, plan.planner


def _warm_start(model, settings, refs_bundle: sqp.ReferenceBundle, state: MpcState, x_init):
    """Interpolate the previous solution onto the new grid where a scenario
    has one (the JAX ``lax.cond`` on has_ws, per scenario), else the
    initializer trajectories."""
    xs0, us0 = sqp.initializer_trajectories(model, settings, refs_bundle, x_init)
    xs = tg.interp_state(tg.TargetTrajectories(state.ws_times, state.xs_ws, state.xs_ws),
                         refs_bundle.times)
    xs = torch.cat([x_init[:, None], xs[:, 1:]], dim=1)
    us = tg.interp_state(tg.TargetTrajectories(state.ws_times[:, :-1], state.us_ws,
                                               state.us_ws), refs_bundle.times[:, :-1])
    has = state.has_ws[:, None, None]
    return torch.where(has, xs, xs0), torch.where(has, us, us0)


def _batched(a, Bn: int, ndim: int):
    """Broadcast a shared (un-batched) argument of ``ndim`` dims to (B, ...)."""
    a = torch.as_tensor(a)
    return a.expand(Bn, *a.shape) if a.ndim == ndim else a


def mpc_step(model: RobotModel, settings: sqp.SqpSettings, params: ocp.OcpParams,
             planner_cfg: swp.SwingConfig, state: MpcState,
             schedule: ModeSchedule, target: tg.TargetTrajectories,
             init_time, x_init, body_vel_cmd, default_joints):
    """Full MPC advance for B scenarios (x_init (B, nx)).

    Returns (SqpSolution, new MpcState, ReferenceBundle)."""
    Bn = x_init.shape[0]
    dtype, dev = x_init.dtype, x_init.device
    # event times promote to the state dtype (the JAX package's float32
    # templates meet float64 query times the same way)
    schedule = ModeSchedule(_batched(schedule.event_times.to(dtype), Bn, 1),
                            _batched(schedule.modes, Bn, 1))
    target = tg.TargetTrajectories(*(_batched(a, Bn, n) for a, n in
                                     zip(target, (1, 2, 2))))
    init_time = _batched(torch.as_tensor(init_time, dtype=dtype, device=dev), Bn, 0)
    body_vel_cmd = _batched(body_vel_cmd, Bn, 1)
    default_joints = _batched(default_joints, Bn, 1)

    bundle, _, _, planner_state = prepare_references(
        model, settings, planner_cfg, state.planner, schedule, target,
        init_time, x_init, body_vel_cmd, default_joints)
    xs_ws, us_ws = _warm_start(model, settings, bundle, state, x_init)
    sol = sqp.solve(model, settings, params, bundle, x_init, xs_ws, us_ws)
    new_state = MpcState(
        planner=planner_state,
        xs_ws=sol.states,
        us_ws=sol.inputs[:, :-1],
        ws_times=sol.times,
        has_ws=torch.ones(Bn, dtype=torch.bool, device=dev),
    )
    return sol, new_state, bundle


def evaluate_policy(sol: sqp.SqpSolution, t):
    """Linear interpolation of the latest primal solution at times t (B, K):
    returns (x* (B, K, nx), u* (B, K, nu))."""
    tt_x = tg.TargetTrajectories(sol.times, sol.states, sol.states)
    tt_u = tg.TargetTrajectories(sol.times, sol.inputs, sol.inputs)
    return tg.interp_state(tt_x, t), tg.interp_state(tt_u, t)


class Mpc(TupleModule):
    """The MPC step as a module: model, OCP weights and swing configuration
    are buffers, so ``.to(device)`` moves them together; ``forward`` is
    ``mpc_step``."""

    def __init__(self, model: RobotModel, settings: sqp.SqpSettings, params: ocp.OcpParams,
                 planner_cfg: swp.SwingConfig):
        super().__init__()
        self.settings = settings
        self.hold("model", model)
        self.hold("params", params)
        self.hold("swing", planner_cfg)

    @property
    def model(self) -> RobotModel:
        return self.held("model")

    @property
    def params(self) -> ocp.OcpParams:
        return self.held("params")

    @property
    def planner_cfg(self) -> swp.SwingConfig:
        return self.held("swing")

    def forward(self, state: MpcState, schedule: ModeSchedule, target: tg.TargetTrajectories,
                init_time, x_init, body_vel_cmd, default_joints):
        return mpc_step(self.model, self.settings, self.params, self.planner_cfg, state,
                        schedule, target, init_time, x_init, body_vel_cmd, default_joints)
