"""Swing-foot trajectory planner.

Port of ``hunter_bipedal_control_tpu/refs/swing_planner.py``: per-leg,
per-phase X/Y/Z piecewise cubics from the Raibert-style foothold rule.  The
JAX package's per-leg / per-phase ``vmap``s are the (4, P1) trailing dims
here, and its associative max scans are ``torch.cummax``.  Every argument
carries the scenario batch dims (...).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from ..gait.mode_schedule import (
    BIG_TIME,
    MAX_PHASES,
    ModeSchedule,
    contact_flags_at_time,
    phase_index_at_time,
    swing_windows,
)
from ..models.spatial import rotation_zyx
from .splines import PiecewiseCubic, eval_piecewise
from .targets import TargetTrajectories, interp_state

NUM_FEET = 4
N_NODES = 4
P1 = MAX_PHASES + 1


class SwingConfig(NamedTuple):
    """swing_trajectory_config of task.info:21-34 (see the JAX package)."""

    lift_off_velocity: torch.Tensor
    touch_down_velocity: torch.Tensor
    swing_height: torch.Tensor
    swing_time_scale: torch.Tensor
    feet_bias: torch.Tensor       # (4, 3)
    next_position_z: torch.Tensor
    foothold_yaw_lead: torch.Tensor = 0.0
    foothold_vel_fb: torch.Tensor = 0.0


def default_swing_config(device=None, dtype=torch.float32) -> SwingConfig:
    dev = resolve_device(device)
    x1, x2, y, z = 0.034, -0.056, 0.11, -0.63

    def c(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    return SwingConfig(
        lift_off_velocity=c(0.05),
        touch_down_velocity=c(0.0),
        swing_height=c(0.04),
        swing_time_scale=c(0.15),
        feet_bias=c([[x1, y, z], [x1, -y, z], [x2, y, z], [x2, -y, z]]),
        next_position_z=c(0.02),
        foothold_yaw_lead=c(0.0),
        foothold_vel_fb=c(0.0),
    )


class SwingRefs(NamedTuple):
    """Planned foot references for one schedule window."""

    node_times: torch.Tensor    # (..., 4, P1, 3, N_NODES)
    node_pos: torch.Tensor
    node_vel: torch.Tensor
    event_times: torch.Tensor   # (..., MAX_PHASES)
    window_start: torch.Tensor  # (..., 4, P1)
    window_stop: torch.Tensor
    contact_seq: torch.Tensor


class PlannerState(NamedTuple):
    latest_stance_position: torch.Tensor  # (..., 4, 3)


def init_planner_state(batch=(), device=None, dtype=torch.float32) -> PlannerState:
    dev = resolve_device(device)
    batch = (batch,) if isinstance(batch, int) else tuple(batch)
    return PlannerState(latest_stance_position=torch.zeros(
        (*batch, NUM_FEET, 3), dtype=dtype, device=dev))


def _set_z(p, z):
    return torch.cat([p[..., 0:2], z.expand(p[..., 2:3].shape)], dim=-1)


def _raibert_foothold(cfg: SwingConfig, current_time, stop_time, next_middle_time,
                      next_middle_body_pose, current_body_pose, current_body_vel, vel_cmd):
    """calNextFootPos (SwingTrajectoryPlanner.cpp:289-312) for every (leg, phase).

    Times (..., 4, P1); next_middle_body_pose (..., 4, P1, 6); the current
    pose/velocity/command carry only the scenario dims (...)."""
    bias = cfg.feet_bias[:, None, :, None]                                    # (4,1,3,1)
    roted_bias = (rotation_zyx(next_middle_body_pose[..., 3:6]) @ bias)[..., 0]
    R_cur = rotation_zyx(current_body_pose[..., 3:6])
    vel_cmd_linear = (R_cur @ vel_cmd[..., 0:3, None])[..., 0]
    vel_cmd_angular = (R_cur @ vel_cmd[..., 3:6, None])[..., 0]
    vel_linear = torch.cat([current_body_vel[..., 0:2],
                            torch.zeros_like(current_body_vel[..., 2:3])], dim=-1)

    def lp(v):  # scenario vector -> broadcast over (leg, phase)
        return v[..., None, None, :]

    k = 0.03
    p_shoulder = (stop_time - current_time[..., None, None])[..., None] * lp(
        0.5 * vel_linear + 0.5 * vel_cmd_linear) + roted_bias
    p_symmetry = (next_middle_time - stop_time)[..., None] * lp(vel_linear) + lp(
        k * (vel_linear - vel_cmd_linear))
    p_centrifugal = 0.5 * torch.sqrt(torch.abs(current_body_pose[..., 2]) / 9.81)[..., None] \
        * torch.linalg.cross(vel_linear, vel_cmd_angular, dim=-1)
    p = lp(current_body_pose[..., 0:3]) + p_shoulder + p_symmetry + lp(p_centrifugal)
    return _set_z(p, cfg.next_position_z)


# genSwingTrajs' tuned shape (csrc/reference_prep.cu repeats it): the XY
# middle node's time and position fractions and velocity gain; the Z
# nodes' time fractions, position fractions and velocity gains
XY_SHAPE = (0.417, 0.650, 1.770)                        # a1, l1, k1
Z_SHAPE = (0.251, 0.749, 1.338, 0.630, 0.570, 1.633, 0.000)  # a1, l1, k1, a2, l2, k2, k3


def _swing_nodes(cfg: SwingConfig, start_time, stop_time, start_pos, stop_pos):
    """genSwingTrajs (SwingTrajectoryPlanner.cpp:314-358): tuned 3-node XY /
    4-node Z Hermite shapes, (..., 3 axes, 4 nodes); XY pads node 3 by
    duplicating the final node."""
    dt = stop_time - start_time
    zero = torch.zeros_like(dt)

    xy_a1, xy_l1, xy_k1 = XY_SHAPE
    t_mid = (1 - xy_a1) * start_time + xy_a1 * stop_time

    def xy_axis(p0, p1):
        times = torch.stack([start_time, t_mid, stop_time, stop_time], dim=-1)
        pos = torch.stack([p0, (1 - xy_l1) * p0 + xy_l1 * p1, p1, p1], dim=-1)
        vel = torch.stack(
            [zero, xy_k1 * (p1 - p0) / torch.clamp(dt, min=1e-6), zero, zero], dim=-1)
        return times, pos, vel

    tx, px, vx = xy_axis(start_pos[..., 0], stop_pos[..., 0])
    ty, py, vy = xy_axis(start_pos[..., 1], stop_pos[..., 1])

    scaling = torch.clamp(dt / cfg.swing_time_scale, max=1.0)
    max_z = torch.maximum(start_pos[..., 2], stop_pos[..., 2]) + scaling * cfg.swing_height
    z_a1, z_l1, z_k1, z_a2, z_l2, z_k2, z_k3 = Z_SHAPE
    tz = torch.stack([
        start_time,
        (1 - z_a1) * start_time + z_a1 * stop_time,
        (1 - z_a2) * start_time + z_a2 * stop_time,
        stop_time,
    ], dim=-1)
    pz = torch.stack([
        start_pos[..., 2],
        z_l1 * max_z,
        z_l2 * max_z + (1 - z_l2) * stop_pos[..., 2],
        stop_pos[..., 2],
    ], dim=-1)
    vz = torch.stack([
        zero,
        z_k1 * (z_l1 * (max_z - start_pos[..., 2])) / torch.clamp(z_a1 * dt, min=1e-6),
        z_k2 * z_l2 * (stop_pos[..., 2] - max_z) / torch.clamp((1 - z_a2) * dt, min=1e-6),
        z_k3 * z_l2 * (stop_pos[..., 2] - max_z) / torch.clamp((1 - z_a2) * dt, min=1e-6),
    ], dim=-1)
    return (torch.stack([tx, ty, tz], dim=-2), torch.stack([px, py, pz], dim=-2),
            torch.stack([vx, vy, vz], dim=-2))


def _stance_nodes(start_time, stop_time, pos):
    """Constant splines for stance phases (SwingTrajectoryPlanner.cpp:261-276)."""
    t = torch.stack([start_time, (2 * start_time + stop_time) / 3,
                     (start_time + 2 * stop_time) / 3, stop_time], dim=-1)
    shape = (*pos.shape, N_NODES)
    times = t[..., None, :].expand(shape)
    p = pos[..., :, None].expand(shape)
    return times, p, torch.zeros(shape, dtype=pos.dtype, device=pos.device)


def update_planner(
    cfg: SwingConfig,
    state: PlannerState,
    schedule: ModeSchedule,
    target: TargetTrajectories,
    init_time,
    final_time,
    body_vel_cmd,
    current_feet_position,
    body_vel_meas=None,
    decisions=None,
):
    """SwingTrajectoryPlanner::update (:164-286).  init_time/final_time (...),
    body_vel_cmd (..., 6), current_feet_position (..., 4, 3).  ``decisions``,
    a dict, receives the discrete choices (the commanded contacts' phase,
    and per (leg, phase) the next window's phase, the tail test, the
    target's segment at the next middle time, the fresh-window test).

    Returns (SwingRefs, new PlannerState)."""
    dtype = current_feet_position.dtype
    horizon = final_time - init_time
    h_start = init_time - horizon
    h_end = final_time + horizon
    ev = schedule.event_times

    cmd_contact = contact_flags_at_time(schedule, (init_time + 0.001)[..., None], dtype)[..., 0, :]
    latest = torch.where(cmd_contact[..., None] > 0.5, current_feet_position,
                         state.latest_stance_position)
    latest = _set_z(latest, cfg.next_position_z)

    starts, stops, cs = swing_windows(schedule, h_start, h_end)      # (..., 4, P1)

    next_phase_idx = torch.searchsorted(
        ev.contiguous(), (stops + 1e-6).reshape(*stops.shape[:-2], -1), right=True
    ).reshape(stops.shape).clamp(0, P1 - 1)
    next_window_stop = torch.gather(stops, -1, next_phase_idx)
    last_real_event = torch.where(ev < BIG_TIME / 2, ev,
                                  torch.full_like(ev, -BIG_TIME)).amax(-1)
    is_tail = stops >= last_real_event[..., None, None] - 1e-9
    next_middle_times = torch.where(is_tail, stops, 0.5 * (stops + next_window_stop))

    current = interp_state(target, init_time[..., None])[..., 0, :]
    current_body_pose = current[..., 6:12]
    current_body_vel = current[..., 0:3]
    if body_vel_meas is not None:
        current_body_vel = current_body_vel + cfg.foothold_vel_fb * (
            body_vel_meas - current_body_vel)

    # ---- parallel stance propagation over phases (see the JAX package) ----
    ps = torch.arange(P1, device=ev.device).expand(stops.shape)
    is_swing = cs < 0.5
    s, e = starts, stops

    q_t = (next_middle_times + cfg.foothold_yaw_lead).reshape(*stops.shape[:-2], -1)
    next_mid_pose = interp_state(target, q_t)[..., 6:12].reshape(*stops.shape, 6)
    cand = _raibert_foothold(cfg, init_time, e, next_middle_times, next_mid_pose,
                             current_body_pose, current_body_vel, body_vel_cmd)  # (...,4,P1,3)

    elig = is_swing & (init_time[..., None, None] < e)
    e_el = torch.where(elig, e, torch.full_like(e, -BIG_TIME))
    m_incl = torch.cummax(e_el, dim=-1).values
    m_prev = torch.cat([torch.full_like(e[..., :1], -BIG_TIME), m_incl[..., :-1]], dim=-1)
    fresh = elig & (e > m_prev + 1e-9)

    marks = torch.where(fresh, ps, -1)
    idx1 = torch.cummax(marks, dim=-1).values
    idx1_prev = torch.cat([torch.full_like(idx1[..., :1], -1), idx1[..., :-1]], dim=-1)
    idx2 = torch.where(idx1 >= 0, torch.gather(idx1_prev, -1, idx1.clamp(0, P1 - 1)), -1)

    def pick(idx):
        gi = idx.clamp(0, P1 - 1)[..., None].expand(*idx.shape, 3)
        val = torch.gather(cand, -2, gi)
        return torch.where((idx >= 0)[..., None], val, latest[..., :, None, :])

    next_stance = pick(idx1)
    last_stance = pick(idx2)

    sw_t, sw_p, sw_v = _swing_nodes(cfg, s, e, last_stance, next_stance)
    st_t, st_p, st_v = _stance_nodes(s, e, next_stance)
    if decisions is not None:
        n_t = target.times.shape[-1]
        seg = torch.searchsorted(target.times.contiguous(), q_t.contiguous(), right=True) - 1
        decisions.update(
            cmd_phase=phase_index_at_time(schedule, (init_time + 0.001)[..., None])[..., 0],
            next_phase=next_phase_idx, tail=is_tail,
            mid_seg=seg.clamp(0, n_t - 2).reshape(stops.shape), fresh=fresh)

    sw = is_swing[..., None, None]
    refs = SwingRefs(
        node_times=torch.where(sw, sw_t, st_t),
        node_pos=torch.where(sw, sw_p, st_p),
        node_vel=torch.where(sw, sw_v, st_v),
        event_times=ev,
        window_start=starts,
        window_stop=stops,
        contact_seq=cs,
    )
    return refs, PlannerState(latest_stance_position=latest)


def foot_reference(refs: SwingRefs, leg, t):
    """(pos, vel, acc) of the planned foot trajectories at times t (..., K).

    ``leg`` is one leg index (outputs (..., K, 3)) or a list of them
    (outputs (..., K, len(leg), 3))."""
    legs = [leg] if isinstance(leg, int) else list(leg)
    p = torch.searchsorted(refs.event_times.contiguous(), t.contiguous(), right=True)
    p = p.clamp(0, P1 - 1)                                           # (..., K)
    K, L = t.shape[-1], len(legs)

    def at_phase(a):
        a = a[..., legs, :, :, :]                                    # (..., L, P1, 3, N)
        a = a[..., None, :, :, :, :].expand(*a.shape[:-4], K, *a.shape[-4:])
        idx = p[..., :, None, None, None, None].expand(*p.shape, L, 1, 3, N_NODES)
        return torch.gather(a, -3, idx)[..., 0, :, :]                # (..., K, L, 3, N)

    sp = PiecewiseCubic(times=at_phase(refs.node_times), pos=at_phase(refs.node_pos),
                        vel=at_phase(refs.node_vel))
    pos, vel, acc = eval_piecewise(sp, t[..., :, None, None])
    if isinstance(leg, int):
        return pos[..., 0, :], vel[..., 0, :], acc[..., 0, :]
    return pos, vel, acc


def spline_segments(refs: SwingRefs, legs, t):
    """The segment ``foot_reference`` evaluates at times t (..., K), per leg
    of ``legs`` and axis: (..., K, len(legs), 3), as ``eval_piecewise``
    searches the phase's node times."""
    p = torch.searchsorted(refs.event_times.contiguous(), t.contiguous(), right=True)
    p = p.clamp(0, P1 - 1)
    nt = refs.node_times[..., list(legs), :, :, :]                   # (..., L, P1, 3, N)
    K, L = t.shape[-1], len(legs)
    nt = nt[..., None, :, :, :, :].expand(*nt.shape[:-4], K, *nt.shape[-4:])
    idx = p[..., :, None, None, None, None].expand(*p.shape, L, 1, 3, N_NODES)
    times = torch.gather(nt, -3, idx)[..., 0, :, :]                  # (..., K, L, 3, N)
    q = t[..., :, None, None, None].expand(*times.shape[:-1], 1)
    seg = torch.searchsorted(times.contiguous(), q.contiguous(), right=True)[..., 0] - 1
    return seg.clamp(0, N_NODES - 2)
