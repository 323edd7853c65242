"""The 500 Hz control tick: policy evaluation -> WBC -> hybrid joint command.

Port of ``hunter_bipedal_control_tpu/runtime/controller.py``: stance
override before walking, WBC update, desired position and velocity
forward-integrated with the WBC joint accelerations, per-joint-group gain
schedule, position-limit emergency stop, and the hybrid joint command
(pos, vel, kp, kd, feedforward).  Batched over B scenarios; ``Controller``
is the tick as an ``nn.Module``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..gait.mode_schedule import ModeSchedule, mode_at_time, mode_contacts
from ..models.robot import RobotModel
from ..solver.mpc import evaluate_policy
from ..solver.sqp import SqpSolution
from ..tuple_module import TupleModule
from ..wbc.wbc import WbcParams, WbcState, wbc_solve

NJ = 10


class GainConfig(NamedTuple):
    """PD gains per joint group (0-d tensors).  ``kp_feet_*`` = -1 makes the
    ankles follow the small group's kp, as the reference couples them."""

    kp_position: torch.Tensor
    kd_position: torch.Tensor
    kp_big_stance: torch.Tensor
    kp_big_swing: torch.Tensor
    kd_big: torch.Tensor
    kp_small_stance: torch.Tensor
    kp_small_swing: torch.Tensor
    kd_small: torch.Tensor
    kd_feet: torch.Tensor
    kp_feet_stance: torch.Tensor
    kp_feet_swing: torch.Tensor


def default_gains(device=None, dtype=torch.float32) -> GainConfig:
    def t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    return GainConfig(kp_position=t(10.0), kd_position=t(3.0), kp_big_stance=t(40.0),
                      kp_big_swing=t(30.0), kd_big=t(2.0), kp_small_stance=t(30.0),
                      kp_small_swing=t(20.0), kd_small=t(2.0), kd_feet=t(0.01),
                      kp_feet_stance=t(-1.0), kp_feet_swing=t(-1.0))


# slider ranges of the reference's dynamic-reconfigure config (name -> (min, max))
GAIN_LIMITS = {
    "kp_position": (0.0, 300.0),
    "kd_position": (0.0, 100.0),
    "kp_big_stance": (0.0, 100.0),
    "kp_big_swing": (0.0, 100.0),
    "kd_big": (0.0, 20.0),
    "kp_small_stance": (0.0, 100.0),
    "kp_small_swing": (0.0, 100.0),
    "kd_small": (0.0, 20.0),
    "kd_feet": (0.0, 20.0),
    "kp_feet_stance": (-1.0, 100.0),
    "kp_feet_swing": (-1.0, 100.0),
}


def reconfigure_gains(gains: GainConfig, **updates) -> GainConfig:
    """Live PD-gain reconfiguration, each value clipped to its slider range."""
    bad = set(updates) - set(GAIN_LIMITS)
    if bad:
        raise ValueError(f"unknown gain fields: {sorted(bad)}")
    new = {}
    for name, value in updates.items():
        lo, hi = GAIN_LIMITS[name]
        ref = getattr(gains, name)
        new[name] = torch.clamp(torch.as_tensor(value, dtype=ref.dtype, device=ref.device), lo, hi)
    return gains._replace(**new)


class JointCommand(NamedTuple):
    """The hybrid joint 5-tuple, each (B, 10)."""

    pos_des: torch.Tensor
    vel_des: torch.Tensor
    kp: torch.Tensor
    kd: torch.Tensor
    tau_ff: torch.Tensor


class TickOutput(NamedTuple):
    command: JointCommand
    optimized_state: torch.Tensor  # (B, 22)
    optimized_input: torch.Tensor  # (B, 22)
    wbc_solution: torch.Tensor     # (B, 38)
    emergency_stop: torch.Tensor   # (B,) bool
    wbc_accepted: torch.Tensor     # (B,) bool: False where the last solution was reused


# joint groups: hips roll/yaw (0, 1, 5, 6) small; (2, 3, 7, 8) big; ankles (4, 9)
_SMALL = [1.0, 1.0, 0, 0, 0, 1.0, 1.0, 0, 0, 0]
_BIG = [0, 0, 1.0, 1.0, 0, 0, 0, 1.0, 1.0, 0]
_FEET = [0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0]


def _at(policy: SqpSolution, t):
    x, u = evaluate_policy(policy, t[:, None])
    return x[:, 0], u[:, 0]


def control_tick(model: RobotModel, wbc_params: WbcParams, gains: GainConfig,
                 wbc_state: WbcState, policy: SqpSolution, schedule: ModeSchedule,
                 t, x_est, rbd_measured, default_joints, set_walk,
                 emergency_stop, loop_dt, policy_lead=0.0, swing_lead=0.0,
                 lead_forces=True):
    """One controller update for B scenarios.  Returns (TickOutput, new WbcState).

    policy: (B, N+1, ...) solution; schedule (B, ...) or shared; t a float or
    (B,); x_est (B, 22); rbd_measured (B, 32); default_joints (10,) or
    (B, 10); set_walk, emergency_stop (B,) bool; loop_dt, policy_lead,
    swing_lead floats.  ``policy_lead`` evaluates the policy that far ahead
    of t; ``swing_lead`` leads the swing legs' joint references further;
    ``lead_forces=False`` keeps the force feedforward at t."""
    dtype, dev = x_est.dtype, x_est.device
    Bn = x_est.shape[0]
    t = torch.as_tensor(t, dtype=dtype, device=dev).expand(Bn)
    schedule = ModeSchedule(*(a.expand(Bn, *a.shape) if a.ndim == 1 else a for a in schedule))
    x_opt, u_opt = _at(policy, t + policy_lead)
    mode = mode_at_time(schedule, t.to(schedule.event_times.dtype)[:, None])[:, 0]
    contact_flags = mode_contacts(dtype, dev)[mode]
    if policy_lead and not lead_forces:
        _, u_now = _at(policy, t)
        u_opt = torch.cat([u_now[:, 0:12], u_opt[:, 12:]], dim=-1)
    if swing_lead:
        x_led, u_led = _at(policy, t + policy_lead + swing_lead)
        # the toe-contact flag of leg j // 5 gates each joint
        leg_sw = contact_flags[:, 0:2].repeat_interleave(5, dim=-1) > 0.5
        x_opt = torch.cat([x_opt[:, :12], torch.where(leg_sw, x_opt[:, 12:22], x_led[:, 12:22])],
                          dim=-1)
        u_opt = torch.cat([u_opt[:, :12], torch.where(leg_sw, u_opt[:, 12:22], u_led[:, 12:22])],
                          dim=-1)

    # stance override until walking is switched on
    x_stance = torch.cat([torch.zeros((Bn, 6), dtype=dtype, device=dev), x_est[:, 6:12],
                          default_joints.expand(Bn, NJ)], dim=-1)
    walk = set_walk[:, None]
    x_opt = torch.where(walk, x_opt, x_stance)
    u_opt = torch.where(walk, u_opt, torch.zeros_like(u_opt))
    contact_flags = torch.where(walk, contact_flags, torch.ones_like(contact_flags))

    wbc_x, wbc_state, accepted = wbc_solve(model, wbc_params, wbc_state, x_opt, u_opt,
                                           rbd_measured, contact_flags, ~set_walk)
    tau_wbc = wbc_x[:, 16 + 12:]
    joint_acc = wbc_x[:, 6:16]
    pos_des = x_opt[:, 12:22] + 0.5 * joint_acc * loop_dt * loop_dt
    vel_des = u_opt[:, 12:22] + joint_acc * loop_dt

    # per-leg stance flag: the toe contact of leg j // 5
    stance = contact_flags[:, 0:2].repeat_interleave(5, dim=-1) > 0.5
    kp_fs = torch.where(gains.kp_feet_stance < 0.0, gains.kp_small_stance, gains.kp_feet_stance)
    kp_fw = torch.where(gains.kp_feet_swing < 0.0, gains.kp_small_swing, gains.kp_feet_swing)
    small, big, feet = (torch.tensor(v, dtype=dtype, device=dev) for v in (_SMALL, _BIG, _FEET))
    kp = (small * torch.where(stance, gains.kp_small_stance, gains.kp_small_swing)
          + big * torch.where(stance, gains.kp_big_stance, gains.kp_big_swing)
          + feet * torch.where(stance, kp_fs, kp_fw))
    kd = (small * gains.kd_small + big * gains.kd_big + feet * gains.kd_feet).expand(Bn, NJ)

    # position-limit trip (0.02 rad beyond the URDF limits)
    jpos = rbd_measured[:, 6:16]
    tripped = ((jpos > model.joint_upper + 0.02) | (jpos < model.joint_lower - 0.02)).any(-1)
    emergency_stop = emergency_stop | tripped

    # e-stop: damping-only command
    stop = emergency_stop[:, None]
    zero = torch.zeros_like(pos_des)
    cmd = JointCommand(pos_des=torch.where(stop, zero, pos_des),
                       vel_des=torch.where(stop, zero, vel_des),
                       kp=torch.where(stop, zero, kp),
                       kd=torch.where(stop, torch.ones_like(kd), kd),
                       tau_ff=torch.where(stop, zero, tau_wbc))
    out = TickOutput(command=cmd, optimized_state=x_opt, optimized_input=u_opt,
                     wbc_solution=wbc_x, emergency_stop=emergency_stop, wbc_accepted=accepted)
    return out, wbc_state


class Controller(TupleModule):
    """The control tick as a module: model, WBC parameters and gains are
    buffers; ``forward`` is ``control_tick``."""

    def __init__(self, model: RobotModel, wbc_params: WbcParams, gains: GainConfig):
        super().__init__()
        self.hold("model", model)
        self.hold("wbc", wbc_params)
        self.hold("gains", gains)

    @property
    def model(self) -> RobotModel:
        return self.held("model")

    @property
    def wbc_params(self) -> WbcParams:
        return self.held("wbc")

    @property
    def gains(self) -> GainConfig:
        return self.held("gains")

    def forward(self, wbc_state: WbcState, policy: SqpSolution, schedule: ModeSchedule, t,
                x_est, rbd_measured, default_joints, set_walk, emergency_stop, loop_dt,
                policy_lead=0.0, swing_lead=0.0, lead_forces=True):
        return control_tick(self.model, self.wbc_params, self.gains, wbc_state, policy,
                            schedule, t, x_est, rbd_measured, default_joints, set_walk,
                            emergency_stop, loop_dt, policy_lead, swing_lead, lead_forces)
