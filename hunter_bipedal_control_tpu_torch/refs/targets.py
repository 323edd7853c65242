"""Target trajectories + command shaping.

Port of ``hunter_bipedal_control_tpu/refs/targets.py`` (the parts on the
MPC step's path).  A trajectory carries leading batch dims:
times (..., T), states (..., T, nx), inputs (..., T, nu); queries are
(..., K) times and return (..., K, n).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from ..models.spatial import rotation_zyx

T_NODES = 8


class TargetTrajectories(NamedTuple):
    times: torch.Tensor
    states: torch.Tensor
    inputs: torch.Tensor


def interp_state(tt: TargetTrajectories, t) -> torch.Tensor:
    return _interp(tt.times, tt.states, t)


def interp_input(tt: TargetTrajectories, t) -> torch.Tensor:
    return _interp(tt.times, tt.inputs, t)


def _interp(times, vals, t):
    """Linear interpolation (clamped) of vals (..., T, n) at t (..., K)."""
    n = times.shape[-1]
    i = torch.searchsorted(times.contiguous(), t.contiguous(), right=True) - 1
    i = torch.clamp(i, 0, n - 2)
    t0 = torch.gather(times, -1, i)
    t1 = torch.gather(times, -1, i + 1)
    w = torch.clamp((t - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)[..., None]
    idx = i[..., None].expand(*i.shape, vals.shape[-1])
    v0 = torch.gather(vals, -2, idx)
    v1 = torch.gather(vals, -2, idx + 1)
    return (1.0 - w) * v0 + w * v1


class CmdVelConfig(NamedTuple):
    """reference.info values + publisher-side shaping constants."""

    com_height: torch.Tensor
    default_joints: torch.Tensor
    target_displacement_velocity: torch.Tensor
    target_rotation_velocity: torch.Tensor
    change_limit: torch.Tensor
    deadband: torch.Tensor
    span_scale: torch.Tensor = 1.0


def default_cmd_vel_config(nj=10, device=None, dtype=torch.float32) -> CmdVelConfig:
    dev = resolve_device(device)

    def c(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    return CmdVelConfig(
        com_height=c(0.63),
        default_joints=c([0.10, 0.00, 0.40, 0.93, 0.53, -0.10, 0.00, -0.40, 0.93, -0.53]),
        target_displacement_velocity=c(0.5),
        target_rotation_velocity=c(1.57),
        change_limit=c(0.05),
        deadband=c(0.05),
        span_scale=c(1.0),
    )


def cmd_vel_to_target(cmd_vel, observation_state, t_now, horizon,
                      cfg: CmdVelConfig, nu=22) -> TargetTrajectories:
    """cmdVelToTargetTrajectories (.cpp:102-130) for one observation:
    cmd_vel = (vx, vy, vz, yaw_rate) in base frame -> a 2-point trajectory
    padded to T_NODES."""
    dtype, dev = observation_state.dtype, observation_state.device
    zyx = observation_state[9:12]
    R = rotation_zyx(zyx)
    v_world = R @ cmd_vel[0:3]

    current_pose = observation_state[6:12]
    span = cfg.span_scale * horizon
    zero = torch.zeros((), dtype=dtype, device=dev)
    target_pose = torch.stack([
        current_pose[0] + span * v_world[0],
        current_pose[1] + span * v_world[1],
        cfg.com_height.to(dtype),
        current_pose[3] + span * cmd_vel[3],
        zero,
        zero,
    ])

    nx = observation_state.shape[0]
    s0 = torch.zeros(nx, dtype=dtype, device=dev)
    s0[0:3] = v_world
    s0[6:12] = torch.cat([current_pose[0:2], cfg.com_height.reshape(1).to(dtype),
                          torch.stack([current_pose[3], zero, zero])])
    s0[12:] = cfg.default_joints
    s1 = s0.clone()
    s1[6:12] = target_pose

    times = torch.full((T_NODES,), 0.0, dtype=dtype, device=dev) + (t_now + span)
    times[0] = t_now
    states = s1[None].repeat(T_NODES, 1)
    states[0] = s0
    inputs = torch.zeros((T_NODES, nu), dtype=dtype, device=dev)
    return TargetTrajectories(times=times, states=states, inputs=inputs)
