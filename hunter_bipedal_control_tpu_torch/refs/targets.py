"""Target trajectories + command shaping.

Port of ``hunter_bipedal_control_tpu/refs/targets.py`` (the cmd_vel
target and its command filter).  A trajectory carries leading batch dims:
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


def filter_cmd_vel(cmd_vel, last_cmd_vel, cfg: CmdVelConfig):
    """Slew-rate limit + deadband (TargetTrajectoriesPublisher cmdVelCallback),
    elementwise over (..., 4)."""
    delta = torch.clamp(cmd_vel - last_cmd_vel, -cfg.change_limit, cfg.change_limit)
    out = last_cmd_vel + delta
    return torch.where(out.abs() < cfg.deadband, 0.0, out)


def cmd_vel_to_target(cmd_vel, observation_state, t_now, horizon,
                      cfg: CmdVelConfig, nu=22) -> TargetTrajectories:
    """cmdVelToTargetTrajectories (.cpp:102-130): cmd_vel (..., 4) =
    (vx, vy, vz, yaw_rate) in base frame, observation (..., nx), t_now a
    number or (...) -> a 2-point trajectory padded to T_NODES, times (..., T),
    states (..., T, nx), inputs (..., T, nu)."""
    dtype, dev = observation_state.dtype, observation_state.device
    lead = observation_state.shape[:-1]
    R = rotation_zyx(observation_state[..., 9:12])
    v_world = (R @ cmd_vel[..., 0:3, None])[..., 0]

    pose = observation_state[..., 6:12]
    span = cfg.span_scale * horizon
    zero = torch.zeros(lead, dtype=dtype, device=dev)
    com = cfg.com_height.to(dtype).expand(lead)
    target_pose = torch.stack([
        pose[..., 0] + span * v_world[..., 0],
        pose[..., 1] + span * v_world[..., 1],
        com,
        pose[..., 3] + span * cmd_vel[..., 3],
        zero,
        zero,
    ], dim=-1)

    nx = observation_state.shape[-1]
    s0 = torch.zeros((*lead, nx), dtype=dtype, device=dev)
    s0[..., 0:3] = v_world
    s0[..., 6:12] = torch.stack([pose[..., 0], pose[..., 1], com, pose[..., 3], zero, zero],
                                dim=-1)
    s0[..., 12:] = cfg.default_joints
    s1 = s0.clone()
    s1[..., 6:12] = target_pose

    t = torch.as_tensor(t_now, dtype=dtype, device=dev)
    times = torch.broadcast_to((t + span)[..., None], (*lead, T_NODES)).clone()
    times[..., 0] = t
    states = s1[..., None, :].repeat(*([1] * len(lead)), T_NODES, 1)
    states[..., 0, :] = s0
    inputs = torch.zeros((*lead, T_NODES, nu), dtype=dtype, device=dev)
    return TargetTrajectories(times=times, states=states, inputs=inputs)
