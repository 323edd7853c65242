"""Kernel B8b: the MPC step's reference prep around its IK, and its plain
versions.

``swing_plan`` (B8b1, ``csrc/reference_prep.cu::hk_swing_plan``) is
everything of ``prepare_references`` before the IK: the current feet's FK,
the swing planner update and the IK's sample inputs; ``knot_refs`` (B8b2,
``hk_knot_refs``) everything after it: the IK-modified target and the
per-knot reference bundle.  ``swing_plan_plain`` and ``knot_refs_plain``
are the same functions in plain torch (CPU tensors take them; the card's
float64 yardsticks too).  Each kernel takes float32 CUDA tensors, launches
once on the current stream, counts ``.launches`` and raises on a bad input
or a failed launch; its decisions (phases, segments, the windows' tests)
equal the float32 plain version's on the card bit for bit (torch there
divides by a Python number as a product with its float32 reciprocal, and
so do the kernels; on the CPU torch divides exactly).  ``solver/mpc.py::
prepare_references`` dispatches between the two.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from ..gait.mode_schedule import ModeSchedule, mode_at_time, mode_contacts, phase_index_at_time
from ..kernels import _build
from ..models.kinematics import contact_positions, fk
from ..models.robot import RobotModel
from ..models.spatial import rotation_zyx
from ..ocp import soa_kernel
from ..refs import swing_planner as swp
from ..refs import targets as tg
from . import sqp


def _linspace(start, stop, num: int):
    """jnp.linspace's arithmetic, batched: start*(1-s) + stop*s, s = i/(num-1),
    with the end point exact.  start/stop (B,) -> (B, num)."""
    div = num - 1
    step = (torch.arange(div, dtype=start.dtype, device=start.device) / div)
    out = start[:, None] * (1 - step) + stop[:, None] * step
    return torch.cat([out, stop[:, None]], dim=-1)


class SwingPlan(NamedTuple):
    """B8b1's outputs, per scenario: the swing planner's refs and new state,
    and the IK's inputs, as ``ik.joint_reference_ik`` takes them."""

    refs: swp.SwingRefs
    planner: swp.PlannerState
    times: torch.Tensor    # (B, S) sample times
    states: torch.Tensor   # (B, S, nx) the target's states there
    inputs: torch.Tensor   # (B, S, nu) and inputs
    poses: torch.Tensor    # (B, S, 6) base poses, states[..., 6:12]
    des: torch.Tensor      # (B, S, 2, 3) toe targets of legs 0 and 1
    R_des: torch.Tensor    # (B, 3, 3) toe rotation target
    warm: torch.Tensor     # (B, nj) the first IK pass's start


def _current_feet(model: RobotModel, x_init):
    return contact_positions(model, fk(model, x_init[..., 6:]))


def _segment(times, t):
    """``targets._interp``'s segment of times (B, T) at t (B, K)."""
    i = torch.searchsorted(times.contiguous(), t.contiguous(), right=True) - 1
    return i.clamp(0, times.shape[-1] - 2)


def swing_plan_plain(model: RobotModel, cfg: swp.SwingConfig, planner_state: swp.PlannerState,
                     schedule: ModeSchedule, target: tg.TargetTrajectories, init_time, x_init,
                     body_vel_cmd, default_joints, horizon: float, n_samples: int,
                     decisions=None) -> SwingPlan:
    """Kernel B8b1's plain version: the reference prep before the IK
    (modifyReferences: the current feet's FK, the swing planner update, and
    calculateJointRef's sampling, SwitchedModelReferenceManager.cpp:251-300).
    All arguments batched (B, ...).  ``decisions``, a dict, receives the
    discrete choices (``update_planner``'s, and per sample the target's
    segment, the phase and the toe splines' segments)."""
    final_time = init_time + horizon
    refs, planner = swp.update_planner(
        cfg, planner_state, schedule, target, init_time, final_time, body_vel_cmd,
        _current_feet(model, x_init), body_vel_meas=x_init[:, 0:3], decisions=decisions)
    Ts = _linspace(init_time, final_time, n_samples).to(target.times.dtype)   # (B, S)
    states = tg.interp_state(target, Ts)
    des = swp.foot_reference(refs, [0, 1], Ts)[0]                    # (B, S, 2, 3)
    if decisions is not None:
        decisions.update(sample_seg=_segment(target.times, Ts),
                         sample_phase=phase_index_at_time(schedule, Ts).clamp(max=swp.P1 - 1),
                         sample_spline=swp.spline_segments(refs, [0, 1], Ts))
    return SwingPlan(refs=refs, planner=planner, times=Ts, states=states,
                     inputs=tg.interp_input(target, Ts), poses=states[..., 6:12], des=des,
                     R_des=rotation_zyx(x_init[:, 9:12]), warm=default_joints)


def knot_refs_plain(schedule: ModeSchedule, plan: SwingPlan, init_time, horizon: float,
                    n_intervals: int, joint_refs, decisions=None):
    """Kernel B8b2's plain version: the IK-modified target (the sample
    states with the joints ``joint_refs`` (B, S, nj)) and the per-knot
    reference bundle: knot times, x_nom, contact flags, the four contacts'
    foot position and velocity references.  ``decisions``, a dict,
    receives per knot the phase, the modified target's segment and the
    foot splines' segments.  Returns (ReferenceBundle, modified target)."""
    nj = joint_refs.shape[-1]
    dtype, dev = init_time.dtype, init_time.device
    states = torch.cat([plan.states[..., :12], joint_refs, plan.states[..., 12 + nj:]], dim=-1)
    mod_target = tg.TargetTrajectories(times=plan.times, states=states, inputs=plan.inputs)
    N = n_intervals
    times = init_time[:, None] + torch.arange(N + 1, dtype=dtype, device=dev) * (horizon / N)
    x_nom = tg.interp_state(mod_target, times)
    flags = mode_contacts(dtype, dev)[mode_at_time(schedule, times)]
    pos, vel, _ = swp.foot_reference(plan.refs, [0, 1, 2, 3], times)
    if decisions is not None:
        decisions.update(knot_phase=phase_index_at_time(schedule, times),
                         knot_seg=_segment(plan.times, times),
                         knot_spline=swp.spline_segments(plan.refs, [0, 1, 2, 3], times))
    bundle = sqp.ReferenceBundle(times=times, x_nom=x_nom, contact_flags=flags,
                                 foot_pos_ref=pos, foot_vel_ref=vel)
    return bundle, mod_target


# B8b1's decisions, per scenario, in the kernel's layout (S samples)
def _plan_decision_layout(n_samples: int):
    L = swp.NUM_FEET * swp.P1
    return (("cmd_phase", 1, ()), ("next_phase", L, (swp.NUM_FEET, swp.P1)),
            ("tail", L, (swp.NUM_FEET, swp.P1)), ("mid_seg", L, (swp.NUM_FEET, swp.P1)),
            ("fresh", L, (swp.NUM_FEET, swp.P1)), ("sample_seg", n_samples, (n_samples,)),
            ("sample_phase", n_samples, (n_samples,)),
            ("sample_spline", 6 * n_samples, (n_samples, 2, 3)))


# B8b2's decisions, per (scenario, knot)
KNOT_DECISIONS = (("knot_phase", 1, ()), ("knot_seg", 1, ()), ("knot_spline", 12, (4, 3)))


def _split_decisions(buf, layout):
    """Views of an int32 decision buffer (..., sum of sizes) by ``layout``."""
    out, o = {}, 0
    for name, n, shape in layout:
        out[name] = buf[..., o:o + n].reshape(*buf.shape[:-1], *shape)
        o += n
    return out


# the kernel stages up to 16 target nodes (the cmd_vel target has 8) and
# runs one thread per sample beside its (leg, phase) threads
MAX_TARGET_NODES = 16
MAX_SAMPLES = 245


def _batch_stride(t, name, dtype, shape, dev):
    _build.require(t, name, dtype, shape, dev, batch_stride=True)
    return t.stride(0)


def plan_strides(model: RobotModel, cfg: swp.SwingConfig, planner_state: swp.PlannerState,
                 schedule: ModeSchedule, target: tg.TargetTrajectories, init_time, x_init,
                 body_vel_cmd, default_joints, n_samples: int):
    """``swing_plan``'s checks of its inputs: each batched one's batch
    stride (in the C interface's order), or an error."""
    if x_init.dim() != 2:
        raise ValueError(f"x_init: expected (B, nx), got {tuple(x_init.shape)}")
    Bn, nx, nj = x_init.shape[0], x_init.shape[1], model.nj
    T, S = target.times.shape[-1], n_samples
    if not 0 < Bn <= _build.MAX_SCENARIOS or not 2 <= T <= MAX_TARGET_NODES:
        raise ValueError(f"swing_plan: {Bn} scenarios, {T} target nodes; the kernel takes "
                         f"1..{_build.MAX_SCENARIOS} and 2..{MAX_TARGET_NODES}")
    if not 2 <= S <= MAX_SAMPLES or nx != 12 + nj:
        raise ValueError(f"swing_plan: {S} samples, state width {nx}; the kernel takes "
                         f"2..{MAX_SAMPLES} and {12 + nj}")
    dev, f32 = x_init.device, torch.float32
    P1 = swp.P1
    strides = [_batch_stride(t, n, dt, shape, dev) for t, n, dt, shape in (
        (x_init, "x_init", f32, (Bn, nx)), (init_time, "init_time", f32, (Bn,)),
        (schedule.event_times, "event_times", f32, (Bn, P1 - 1)),
        (schedule.modes, "modes", torch.int64, (Bn, P1)),
        (target.times, "target.times", f32, (Bn, T)),
        (target.states, "target.states", f32, (Bn, T, nx)),
        (target.inputs, "target.inputs", f32, (Bn, T, nx)),
        (body_vel_cmd, "body_vel_cmd", f32, (Bn, 6)),
        (default_joints, "default_joints", f32, (Bn, nj)),
        (planner_state.latest_stance_position, "latest_stance_position", f32,
         (Bn, swp.NUM_FEET, 3)))]
    for name in ("swing_height", "swing_time_scale", "next_position_z", "foothold_yaw_lead",
                 "foothold_vel_fb"):
        _build.require(getattr(cfg, name), name, f32, (), dev)
    _build.require(cfg.feet_bias, "feet_bias", f32, (swp.NUM_FEET, 3), dev)
    return strides


@functools.lru_cache(maxsize=64)
def _plan_layout(Bn: int, S: int, nx: int, nj: int):
    """``plan_buffers``' layout: the floats of the buffer and each output's
    (shape, strides, offset), the node arrays first, every output 16-byte
    aligned; the decisions after them."""
    P1, L, N = swp.P1, swp.NUM_FEET, swp.N_NODES
    shapes = ((L, 3),) + ((L, P1, 3, N),) * 3 + ((L, P1),) * 3 + (
        (S,), (S, nx), (S, nx), (S, 6), (S, 2, 3), (3, 3), (nj,))
    views, o = [None] * len(shapes), 0
    for k in (1, 2, 3, 0, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13):
        shape = (Bn, *shapes[k])
        strides = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        views[k] = (shape, strides, o)
        o += -(-math.prod(shape) // 4) * 4
    return o, tuple(views)


def plan_buffers(Bn: int, n_samples: int, nx: int, nj: int, dev, with_decisions: bool):
    """``swing_plan``'s outputs, new on every call (the planner state goes
    on as the next step's input): the planner state, the three node arrays,
    the three windows, the sample times, states, inputs, poses and toe
    targets, R_des, the warm joints, and the decisions (int32) or None.
    One allocation, carved by ``_plan_layout`` into contiguous views that
    start 16 bytes apart (the kernel writes the node arrays as float4 runs)."""
    n, layout = _plan_layout(Bn, n_samples, nx, nj)
    n_dec = sum(k for _, k, _ in _plan_decision_layout(n_samples)) if with_decisions else 0
    buf = torch.empty(n + Bn * n_dec, dtype=torch.float32, device=dev)
    latest, *rest = (buf.as_strided(*v) for v in layout)
    dec = buf[n:].view(torch.int32).view(Bn, n_dec) if with_decisions else None
    return (latest, rest[0:3], rest[3:6], *rest[6:], dec)


def swing_plan(model: RobotModel, cfg: swp.SwingConfig, planner_state: swp.PlannerState,
               schedule: ModeSchedule, target: tg.TargetTrajectories, init_time, x_init,
               body_vel_cmd, default_joints, horizon: float, n_samples: int,
               with_decisions: bool = False):
    """Kernel B8b1 on the card (``csrc/reference_prep.cu``, ``hk_swing_plan``):
    ``swing_plan_plain`` in one launch, one block per scenario.  float32 on
    the card; each batched input (B, ...) contiguous within a scenario at
    any batch stride (0 for one shared by ``expand``: read, not copied);
    the swing configuration's fields are tensors (``plan_strides`` checks
    them all).  The model's constants come from B1's buffer
    (``soa_kernel.consts_buffer``, which refuses a model of another
    topology).  ``with_decisions`` adds a dict of the kernel's discrete
    choices, as ``swing_plan_plain``'s ``decisions``."""
    strides = plan_strides(model, cfg, planner_state, schedule, target, init_time, x_init,
                           body_vel_cmd, default_joints, n_samples)
    Bn, nx = x_init.shape
    T, S, dev = target.times.shape[-1], n_samples, x_init.device
    K = soa_kernel.consts_buffer(model, dev)
    latest, nodes, windows, Ts, states, inputs, poses, des, R_des, warm, dec = plan_buffers(
        Bn, S, nx, model.nj, dev, with_decisions)
    lib = _build.library()
    _build.check(lib.hk_swing_plan(
        K.data_ptr(), x_init.data_ptr(), init_time.data_ptr(), schedule.event_times.data_ptr(),
        schedule.modes.data_ptr(), target.times.data_ptr(), target.states.data_ptr(),
        target.inputs.data_ptr(), body_vel_cmd.data_ptr(), default_joints.data_ptr(),
        planner_state.latest_stance_position.data_ptr(), cfg.swing_height.data_ptr(),
        cfg.swing_time_scale.data_ptr(), cfg.feet_bias.data_ptr(),
        cfg.next_position_z.data_ptr(), cfg.foothold_yaw_lead.data_ptr(),
        cfg.foothold_vel_fb.data_ptr(), latest.data_ptr(),
        *(t.data_ptr() for t in nodes + windows), Ts.data_ptr(), states.data_ptr(),
        inputs.data_ptr(), poses.data_ptr(), des.data_ptr(), R_des.data_ptr(), warm.data_ptr(),
        None if dec is None else dec.data_ptr(), *strides, Bn, T, S, horizon,
        _build.stream(x_init)), "swing_plan")
    swing_plan.launches += 1
    refs = swp.SwingRefs(*nodes, schedule.event_times, *windows)
    plan = SwingPlan(refs=refs, planner=swp.PlannerState(latest), times=Ts, states=states,
                     inputs=inputs, poses=poses, des=des, R_des=R_des, warm=warm)
    return plan if dec is None else (plan, _split_decisions(dec, _plan_decision_layout(S)))


swing_plan.launches = 0


def knot_refs(schedule: ModeSchedule, plan: SwingPlan, init_time, horizon: float,
              n_intervals: int, joint_refs, with_decisions: bool = False):
    """Kernel B8b2 on the card (``csrc/reference_prep.cu``, ``hk_knot_refs``):
    ``knot_refs_plain`` in one launch, one thread per (scenario, knot), on
    B8b1's outputs (contiguous) and B8a's joint_refs; the modified target's
    states are the kernel's own output, its times and inputs B8b1's.
    ``with_decisions`` adds a dict of the kernel's discrete choices."""
    Bn, S, nx = plan.states.shape
    K1, nj = n_intervals + 1, joint_refs.shape[-1]
    if not (0 < Bn and n_intervals > 0 and Bn * K1 <= _build.MAX_SCENARIOS and S >= 2
            and nx == 12 + nj):
        raise ValueError(f"knot_refs: {Bn} scenarios, {n_intervals} intervals, {S} samples, "
                         f"state width {nx}, {nj} joints")
    dev, f32, P1 = plan.states.device, torch.float32, swp.P1
    strides = [_batch_stride(t, n, dt, shape, dev) for t, n, dt, shape in (
        (init_time, "init_time", f32, (Bn,)),
        (schedule.event_times, "event_times", f32, (Bn, P1 - 1)),
        (schedule.modes, "modes", torch.int64, (Bn, P1)))]
    for t, name, shape in ((plan.refs.node_times, "node_times", (Bn, 4, P1, 3, swp.N_NODES)),
                           (plan.refs.node_pos, "node_pos", (Bn, 4, P1, 3, swp.N_NODES)),
                           (plan.refs.node_vel, "node_vel", (Bn, 4, P1, 3, swp.N_NODES)),
                           (plan.times, "times", (Bn, S)), (plan.states, "states", (Bn, S, nx)),
                           (joint_refs, "joint_refs", (Bn, S, nj))):
        _build.require(t, name, f32, shape, dev)
    times = torch.empty((Bn, K1), dtype=f32, device=dev)
    x_nom = torch.empty((Bn, K1, nx), dtype=f32, device=dev)
    flags = torch.empty((Bn, K1, 4), dtype=f32, device=dev)
    pos, vel = (torch.empty((Bn, K1, 4, 3), dtype=f32, device=dev) for _ in range(2))
    mod_states = torch.empty((Bn, S, nx), dtype=f32, device=dev)
    dec = (torch.empty((Bn, K1, sum(n for _, n, _ in KNOT_DECISIONS)), dtype=torch.int32,
                       device=dev) if with_decisions else None)
    lib = _build.library()
    _build.check(lib.hk_knot_refs(
        init_time.data_ptr(), schedule.event_times.data_ptr(), schedule.modes.data_ptr(),
        plan.refs.node_times.data_ptr(), plan.refs.node_pos.data_ptr(),
        plan.refs.node_vel.data_ptr(), plan.times.data_ptr(), plan.states.data_ptr(),
        joint_refs.data_ptr(), times.data_ptr(), x_nom.data_ptr(), flags.data_ptr(),
        pos.data_ptr(), vel.data_ptr(), mod_states.data_ptr(),
        None if dec is None else dec.data_ptr(), *strides, Bn, K1, S, horizon / n_intervals,
        _build.stream(times)), "knot_refs")
    knot_refs.launches += 1
    bundle = sqp.ReferenceBundle(times=times, x_nom=x_nom, contact_flags=flags,
                                 foot_pos_ref=pos, foot_vel_ref=vel)
    mod_target = tg.TargetTrajectories(times=plan.times, states=mod_states, inputs=plan.inputs)
    out = (bundle, mod_target)
    return out if dec is None else (*out, _split_decisions(dec, KNOT_DECISIONS))


knot_refs.launches = 0
