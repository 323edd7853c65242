"""Full-order articulated-body physics backend (the MuJoCo/Gazebo analog).

Port of ``hunter_bipedal_control_tpu/backends/fullorder.py``: full 16-DoF
forward dynamics (the mass matrix and nonlinear effects of the model
library), spring-damper ground contacts at the 4 toe/heel points with a
Coulomb-clamped tangential force, a PD + feedforward motor model applying
the hybrid joint command each substep with effort-limit clamping, and the
Gazebo-style actuation delay as a 32-slot command ring.  Batched over B
scenarios.

``sim_step`` advances one control tick.  The command ring is plain torch on
either device; the ``substeps`` physics substeps are kernel B11
(``csrc/sim_step.cu``, one launch per tick) for a CUDA tensor and
``substeps_plain`` for a CPU tensor.  ``synth_imu``, the IMU readings, is
kernel B13a (``csrc/sensing.cu``) for a CUDA tensor and ``synth_imu_plain``
for a CPU tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import _build
from ..models.dynamics import mass_matrix_and_nle
from ..models.kinematics import contact_jacobians, contact_positions, fk, link_com_jacobians
from ..models.robot import RobotModel
from ..models.spatial import global_angular_velocity_from_euler_rates, rotation_zyx, zyx_to_quat
from ..ocp import soa_kernel
from ..ops.linalg import gj_inverse_plain
from ..runtime.controller import JointCommand

NV = 16
NJ = 10
NUM_FEET = 4
MAX_DELAY = 32
# one block per scenario: grid.x
MAX_BLOCKS = 2 ** 31 - 1


class SimParams(NamedTuple):
    dt: torch.Tensor              # physics substep (e.g. 0.00025), 0-d
    substeps: int                 # substeps per control tick
    contact_kn: torch.Tensor      # normal spring
    contact_dn: torch.Tensor      # normal damper
    contact_kt: torch.Tensor      # tangential damper
    friction_mu: torch.Tensor
    armature: torch.Tensor        # reflected rotor/gear inertia per joint
    joint_damping: torch.Tensor   # implicit joint viscous damping
    delay_steps: int              # actuation delay in substeps (0 = off)
    # domain-sweep knobs; None = off.  Scalars, or one per scenario: (B,)
    # and (B, 3)
    gravity_delta: torch.Tensor | None = None  # extra uniform field (terrain tilt)
    mass_scale: torch.Tensor | None = None     # plant link-mass/inertia scale
    sole_drop: torch.Tensor | None = None      # contact surface below the frames; None = 0


def default_sim_params(device=None, dtype=torch.float32, control_dt=0.002, substeps=8,
                       delay_ms=0.0) -> SimParams:
    """The JAX package's defaults: 8 substeps of 0.25 ms per 2 ms tick, the
    contact and armature values tuned for the stiff ankle chain, the sole
    1.19 cm below the contact frames; ``delay_ms`` counts in substeps."""
    dt = control_dt / substeps

    def t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    return SimParams(dt=t(dt), substeps=substeps, contact_kn=t(2.0e4), contact_dn=t(300.0),
                     contact_kt=t(500.0), friction_mu=t(0.7), armature=t(0.05),
                     joint_damping=t(0.2), delay_steps=int(round(delay_ms * 1e-3 / dt)),
                     sole_drop=t(0.0119))


class SimState(NamedTuple):
    q: torch.Tensor               # (B, 16)
    v: torch.Tensor               # (B, 16)
    t: torch.Tensor               # (B,)
    base_acc: torch.Tensor        # (B, 6) last substep's base acceleration (IMU synthesis)
    contact_forces: torch.Tensor  # (B, 4, 3) last substep's contact forces
    cmd_buffer: torch.Tensor      # (B, MAX_DELAY, 5, NJ) delayed command ring
    buf_head: torch.Tensor        # (B,) int64


def init_sim_state(q0, v0=None, t0=0.0) -> SimState:
    """q0 (B, 16); every scenario starts at time t0 with an empty ring."""
    Bn, dtype, dev = q0.shape[0], q0.dtype, q0.device

    def z(*shape):
        return torch.zeros((Bn, *shape), dtype=dtype, device=dev)

    return SimState(q=q0, v=z(NV) if v0 is None else v0,
                    t=torch.full((Bn,), t0, dtype=dtype, device=dev), base_acc=z(6),
                    contact_forces=z(NUM_FEET, 3), cmd_buffer=z(MAX_DELAY, 5, NJ),
                    buf_head=torch.zeros(Bn, dtype=torch.int64, device=dev))


def _contact_force(params: SimParams, p, vp):
    """Spring-damper ground force (world frame) at the points p, velocities
    vp (..., 3): the surface sits ``sole_drop`` below the frames, the
    ground plane stays at z = 0.  Also returns the in-contact decisions."""
    drop = 0.0 if params.sole_drop is None else params.sole_drop
    pen = drop - p[..., 2]
    in_contact = pen > 0.0
    zero = torch.zeros_like(pen)
    fn = torch.where(in_contact, params.contact_kn * pen - params.contact_dn * vp[..., 2], zero)
    fn = torch.maximum(fn, zero)
    ft = torch.where(in_contact[..., None], -params.contact_kt * vp[..., 0:2],
                     torch.zeros_like(vp[..., 0:2]))
    ft_norm = torch.linalg.vector_norm(ft, dim=-1) + 1e-9
    ft = ft * torch.minimum(torch.ones_like(fn), params.friction_mu * fn / ft_norm)[..., None]
    return torch.cat([ft, fn[..., None]], dim=-1), in_contact


def _motor_torque(active, qj, vj, effort_limit):
    """PD + feedforward motor model on the active command (B, 5, NJ),
    clamped to the effort limits."""
    pos_des, vel_des, kp, kd, ff = active.unbind(-2)
    tau = ff + kp * (pos_des - qj) + kd * (vel_des - vj)
    return torch.clamp(tau, -effort_limit, effort_limit)


def _per_scenario(x, shape):
    return None if x is None else torch.as_tensor(x).expand(shape)


def substeps_plain(model: RobotModel, params: SimParams, q, v, active, decisions=None,
                   a_sys=None):
    """``params.substeps`` semi-implicit Euler substeps under the active
    command (B, 5, NJ): (q, v, the last substep's acceleration (B, 16) and
    contact forces (B, 4, 3)).  ``decisions``, a list, gets each substep's
    in-contact decisions (B, 4); ``a_sys``, a list, each substep's system
    matrix M + diag(armature + dt damping) (B, 16, 16)."""
    Bn, dtype, dev = q.shape[0], q.dtype, q.device
    ms = _per_scenario(params.mass_scale, (Bn,))
    gd = _per_scenario(params.gravity_delta, (Bn, 3))
    zeros6 = torch.zeros((Bn, 6), dtype=dtype, device=dev)
    z6 = torch.zeros(6, dtype=dtype, device=dev)
    ones_j = torch.ones(NJ, dtype=dtype, device=dev)
    arm = torch.cat([z6, params.armature * ones_j])
    damp = torch.cat([z6, params.joint_damping * ones_j])
    effort = model.joint_effort.to(dtype)
    for _ in range(params.substeps):
        kin = fk(model, q)
        p_c = contact_positions(model, kin)
        J = contact_jacobians(model, kin)[..., 0:3, :]                  # (B, 4, 3, 16)
        v_c = torch.einsum("bcij,bj->bci", J, v)
        f_c, in_contact = _contact_force(params, p_c, v_c)
        if decisions is not None:
            decisions.append(in_contact)

        tau = _motor_torque(active, q[:, 6:], v[:, 6:], effort)
        tau_gen = torch.cat([zeros6, tau], dim=-1) + torch.einsum("bcij,bci->bj", J, f_c)

        M, h = mass_matrix_and_nle(model, q, v)
        if ms is not None:
            # uniform link mass/inertia scale: M and the inertia-derived
            # nle/gravity terms scale exactly; contacts and motors do not
            M = ms[:, None, None] * M
            h = ms[:, None] * h
        if gd is not None:
            # extra uniform field: its generalized force is (sum_k m_k
            # Jlin_k)' a, the linear block of the CMM
            Jl = link_com_jacobians(model, kin)[..., 0:3, :]            # (B, L, 3, 16)
            field = torch.einsum("k,bkiv,bi->bv", model.link_mass.to(dtype), Jl, gd)
            tau_gen = tau_gen + (field if ms is None else ms[:, None] * field)
        # armature on the actuated diagonal + implicit joint damping
        A_sys = M + torch.diag_embed(arm + params.dt * damp)
        if a_sys is not None:
            a_sys.append(A_sys)
        rhs = tau_gen - h - damp * v
        a = (gj_inverse_plain(A_sys) @ rhs[..., None])[..., 0]
        v = v + params.dt * a
        q = q + params.dt * v
    return q, v, a, f_c


def _push_command(params: SimParams, state: SimState, cmd: JointCommand):
    """Write the command into the ring at the head and read the active one:
    (ring, new head, active command (B, 5, NJ)).  Before the ring fills
    (head < delay_steps) the current command is active."""
    cmd_stack = torch.stack([cmd.pos_des, cmd.vel_des, cmd.kp, cmd.kd, cmd.tau_ff], dim=-2)
    rows = torch.arange(cmd_stack.shape[0], device=cmd_stack.device)
    buf = state.cmd_buffer.clone()
    buf[rows, state.buf_head % MAX_DELAY] = cmd_stack
    if params.delay_steps > 0:
        delayed = buf[rows, (state.buf_head - params.delay_steps) % MAX_DELAY]
        filled = (state.buf_head >= params.delay_steps)[:, None, None]
        active = torch.where(filled, delayed, cmd_stack)
    else:
        active = cmd_stack
    return buf, state.buf_head + 1, active


def _next_state(params: SimParams, state, buf, head, q, v, acc, f_c) -> SimState:
    return SimState(q=q, v=v, t=state.t + params.dt * params.substeps, base_acc=acc[:, 0:6],
                    contact_forces=f_c, cmd_buffer=buf, buf_head=head)


# SimParams' scalars in the order csrc/sim_step.cu reads them
N_PARAMS = 8
# the launches' fixed pointers kept for the last few (model, SimParams, B)
CACHE_SIZE = 8
_launch_args: dict = {}


def params_buffer(params: SimParams) -> torch.Tensor:
    """dt, the contact law's kn, dn, kt, mu, the armature, the joint damping
    and the sole drop, one float32 tensor on their device (no sync)."""
    drop = torch.zeros_like(params.dt) if params.sole_drop is None else params.sole_drop
    fields = (params.dt, params.contact_kn, params.contact_dn, params.contact_kt,
              params.friction_mu, params.armature, params.joint_damping, drop)
    if any(t.ndim for t in fields):
        raise ValueError("sim_step kernel: the SimParams scalars must be 0-d")
    return torch.cat([t.reshape(1).to(torch.float32) for t in fields])


def _static_args(model: RobotModel, params: SimParams, Bn, dev):
    """The kernel's pointers that do not change from tick to tick: the
    model's constants, the parameter buffer, the effort limits, the mass
    scale and the field (0 where None); checked when first built, then kept
    per (model, SimParams, B, device) until a SimParams tensor changes in
    place (its version counter)."""
    key = (id(model), id(params), Bn, dev)
    hit = _launch_args.get(key)
    if (hit is not None and hit[0] is model and hit[1] is params
            and all(t._version == n for t, n in hit[2])):
        return hit[3]
    f32 = torch.float32
    K = soa_kernel.consts_buffer(model, dev)
    P = params_buffer(params)
    _build.require(P, "params", f32, (N_PARAMS,), dev)
    effort = model.joint_effort
    _build.require(effort, "joint_effort", f32, (NJ,), dev)
    ms = _knob(params.mass_scale, (Bn,))
    gd = _knob(params.gravity_delta, (Bn, 3))
    if ms is not None:
        _build.require(ms, "mass_scale", f32, (Bn,), dev)
    if gd is not None:
        _build.require(gd, "gravity_delta", f32, (Bn, 3), dev)
    # the tensors are kept beside their pointers
    ptrs = (K.data_ptr(), P.data_ptr(), effort.data_ptr(),
            None if ms is None else ms.data_ptr(), None if gd is None else gd.data_ptr())
    if len(_launch_args) >= CACHE_SIZE:
        _launch_args.pop(next(iter(_launch_args)))
    versions = [(t, t._version) for t in params if torch.is_tensor(t)]
    _launch_args[key] = (model, params, versions, ptrs, (K, P, effort, ms, gd))
    return ptrs


def _knob(x, shape):
    """A knob as the kernel reads it: None, or contiguous (B, ...) (a scalar
    expanded)."""
    if x is None or (x.shape == shape and x.is_contiguous()):
        return x
    return _per_scenario(x, shape).contiguous()


def substeps(model: RobotModel, params: SimParams, q, v, active, with_decisions=False):
    """Kernel B11: the tick's ``params.substeps`` physics substeps.

    CPU: ``substeps_plain``.  CUDA: one launch of ``hk_sim_step``, one
    block per scenario, or an error: q, v (B, 16) and the active command
    (B, 5, 10) float32, contiguous, on the card; the SimParams scalars 0-d
    (``params_buffer``), mass_scale and
    gravity_delta None, scalars or (B,) and (B, 3); the model's constants
    from B1's buffer (``soa_kernel.consts_buffer``, which refuses a model of
    another topology); these checked once per (model, SimParams, B)
    (``_static_args``).  Returns (q, v, the last substep's acceleration
    (B, 16), contact forces (B, 4, 3)), contiguous (q, v and the
    acceleration views into one buffer), and with ``with_decisions`` also
    every substep's in-contact decisions (B, substeps, 4) bool."""
    if q.device.type == "cpu":
        dec = [] if with_decisions else None
        out = substeps_plain(model, params, q, v, active, dec)
        return (*out, torch.stack(dec, dim=1)) if with_decisions else out
    if q.dim() != 2:
        raise ValueError(f"q: expected (B, 16), got {tuple(q.shape)}")
    Bn, dev, f32 = q.shape[0], q.device, torch.float32
    if not 0 < Bn <= MAX_BLOCKS:
        raise ValueError(f"sim_step: B = {Bn} blocks, the grid takes 1..{MAX_BLOCKS}")
    if params.substeps < 1:
        raise ValueError(f"sim_step: {params.substeps} substeps")
    for t, name, shape in ((q, "q", (Bn, NV)), (v, "v", (Bn, NV)),
                           (active, "active", (Bn, 5, NJ))):
        _build.require(t, name, f32, shape, dev)
    K, P, effort, ms, gd = _static_args(model, params, Bn, dev)
    q_out, v_out, acc = torch.empty((3, Bn, NV), dtype=f32, device=dev).unbind(0)
    f_c = torch.empty((Bn, NUM_FEET, 3), dtype=f32, device=dev)
    dec = (torch.empty((Bn, params.substeps, NUM_FEET), dtype=torch.bool, device=dev)
           if with_decisions else None)
    lib = _build.library()
    _build.check(lib.hk_sim_step(K, P, effort, q.data_ptr(), v.data_ptr(), active.data_ptr(), ms,
                                 gd, q_out.data_ptr(), v_out.data_ptr(), acc.data_ptr(),
                                 f_c.data_ptr(), None if dec is None else dec.data_ptr(), Bn,
                                 params.substeps, _build.stream(q)), "sim_step")
    sim_step.launches += 1
    return (q_out, v_out, acc, f_c, dec) if with_decisions else (q_out, v_out, acc, f_c)


def sim_step(model: RobotModel, params: SimParams, state: SimState,
             cmd: JointCommand) -> SimState:
    """Advance one control tick = ``substeps`` physics substeps under one
    hybrid joint command (with the optional actuation delay): the ring in
    torch, the substeps by ``substeps`` (kernel B11 on the card)."""
    buf, head, active = _push_command(params, state, cmd)
    q, v, acc, f_c = substeps(model, params, state.q, state.v, active.contiguous())
    return _next_state(params, state, buf, head, q, v, acc, f_c)


sim_step.launches = 0


def synth_imu_plain(model: RobotModel, state: SimState, with_omega_world=False):
    """IMU readings from the simulated base link (LeggedHWSim::readSim):
    quaternion (x, y, z, w), local angular velocity, local specific force
    from the last substep's base acceleration, each (B, ...); with
    ``with_omega_world`` also the world angular velocity (B, 3)."""
    zyx = state.q[:, 3:6]
    Rt = rotation_zyx(zyx).transpose(-1, -2)
    quat = zyx_to_quat(zyx)
    omega_w = global_angular_velocity_from_euler_rates(zyx, state.v[:, 3:6])
    omega_local = (Rt @ omega_w[..., None])[..., 0]
    # accelerometer: specific force = R' (a_lin - g)
    g = torch.tensor([0.0, 0.0, 9.81], dtype=state.q.dtype, device=state.q.device)
    accel_local = (Rt @ (state.base_acc[:, 0:3] + g)[..., None])[..., 0]
    if with_omega_world:
        return quat, omega_local, accel_local, omega_w
    return quat, omega_local, accel_local


def synth_imu(model: RobotModel, state: SimState, with_omega_world=False):
    """Kernel B13a: the IMU readings (quaternion, local angular velocity,
    local specific force; with ``with_omega_world`` also the world angular
    velocity E(zyx) theta_dot, which the kernel computes on the way).

    CPU: ``synth_imu_plain``.  CUDA: one launch of ``hk_synth_imu``, one
    thread per scenario, or an error: q, v (B, 16) float32 (made contiguous
    here), and base_acc (B, 6) float32 in rows of contiguous entries (the
    plant's is a view of its (B, 16) acceleration, read by row stride), on
    the card.  The kernel reads no model constant."""
    if state.q.device.type == "cpu":
        return synth_imu_plain(model, state, with_omega_world)
    q, _ = _build.rows(state.q, "q", NV)
    v, _ = _build.rows(state.v, "v", NV)
    acc = state.base_acc
    Bn, dev, f32 = q.shape[0], q.device, torch.float32
    _build.require(q, "q", f32, (Bn, NV), dev)
    _build.require(v, "v", f32, (Bn, NV), dev)
    _build.require(acc, "base_acc", f32, (Bn, 6), dev, strided_rows=True)
    quat = torch.empty((Bn, 4), dtype=f32, device=dev)
    om_l, acc_l, om_w = (torch.empty((Bn, 3), dtype=f32, device=dev) for _ in range(3))
    _build.check(_build.library().hk_synth_imu(
        q.data_ptr(), v.data_ptr(), acc.data_ptr(), acc.stride(0),
        *(t.data_ptr() for t in (quat, om_l, acc_l, om_w)), Bn, _build.stream(q)), "synth_imu")
    synth_imu.launches += 1
    return (quat, om_l, acc_l, om_w) if with_omega_world else (quat, om_l, acc_l)


synth_imu.launches = 0
