"""Contact-force estimation (generalized-momentum disturbance observer) and
contact-state classification / early-late contact detection, batched.

Port of ``hunter_bipedal_control_tpu/estim/contact.py``.  The observer's
update is kernel B10 (``csrc/momentum_observer.cu``, one launch per update:
a warp per scenario, four a block) for a CUDA tensor and
``momentum_observer_plain`` for a CPU tensor: M, the Coriolis matrix, g
and the two legs' damped least-squares wrench solves (5 x 5 Gauss-Jordan)
in plain torch.  The full-order loop's per-tick
contact classification is kernel B16 (``contact_class``,
``csrc/reference_prep.cu::hk_contact_class``) for CUDA tensors and
``contact_class_plain`` for CPU tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..gait.mode_schedule import MAX_PHASES, ModeSchedule, phase_index_at_time, swing_windows
from ..kernels import _build
from ..models.centroidal import rbd_to_q_v
from ..models.dynamics import coriolis_matrix, gravity_vector, mass_matrix
from ..models.kinematics import contact_jacobians, fk
from ..models.robot import RobotModel
from ..ocp import soa_kernel
from ..ops.linalg import gj_inverse_plain

NUM_FEET = 4
NV = 16
NJ = 10
# a warp per scenario, four a block (grid.x = ceil(B / 4)); the C
# interface takes B as an int
MAX_BATCH = 2 ** 31 - 1


class ContactObserverParams(NamedTuple):
    cutoff_frequency: torch.Tensor   # 250
    contact_threshold: torch.Tensor  # 75


def default_contact_params(device=None, dtype=torch.float32) -> ContactObserverParams:
    return ContactObserverParams(
        cutoff_frequency=torch.tensor(250.0, dtype=dtype, device=device),
        contact_threshold=torch.tensor(75.0, dtype=dtype, device=device))


class ContactObserverState(NamedTuple):
    p_scg_z_last: torch.Tensor  # (B, 16) filtered momentum-rate integral
    est_forces: torch.Tensor    # (B, 16) [wrench L (6), wrench R (6), |F| x 2, |W| x 2]


def init_contact_observer(batch: int = 1, device=None,
                          dtype=torch.float32) -> ContactObserverState:
    return ContactObserverState(
        p_scg_z_last=torch.zeros((batch, NV), dtype=dtype, device=device),
        est_forces=torch.full((batch, 16), 50.0, dtype=dtype, device=device))


def leg_systems(model: RobotModel, q):
    """Per leg, the transposed toe Jacobian's joint block A (B, 2, 5, 6) and
    the damped normal matrix A A' + 1e-6 I (B, 2, 5, 5) the wrench solve
    inverts; legs 0 (L) and 1 (R) own joint columns 6..10 and 11..15."""
    Jc = contact_jacobians(model, fk(model, q))               # (B, 4, 6, 16), toes first
    A = torch.stack([Jc[:, 0, :, 6:11].transpose(-1, -2),
                     Jc[:, 1, :, 11:16].transpose(-1, -2)], dim=1)
    AAt = A @ A.transpose(-1, -2) + 1e-6 * torch.eye(5, dtype=q.dtype, device=q.device)
    return A, AAt.contiguous()


def momentum_observer_plain(model: RobotModel, params: ContactObserverParams,
                            state: ContactObserverState, rbd_measured, cmd_torque, dt):
    """First-order disturbance observer on the generalized momentum; per-leg
    wrench by min-norm least squares of S_l J' w = S_l tau_dist.  Returns
    (new state, tau_dist (B, 16)).  ``dt`` is a Python float."""
    dtype, dev = rbd_measured.dtype, rbd_measured.device
    q, v = rbd_to_q_v(rbd_measured)
    Bn = q.shape[0]
    lam = params.cutoff_frequency
    gama = torch.exp(-lam * dt)
    beta = (1.0 - gama) / (gama * dt)

    M = mass_matrix(model, q)
    C = coriolis_matrix(model, q, v)
    g = gravity_vector(model, q)
    p = (M @ v[..., None])[..., 0]
    tau_full = torch.cat([torch.zeros((Bn, 6), dtype=dtype, device=dev), cmd_torque], dim=-1)
    p_scg = beta * p + tau_full + (C.transpose(-1, -2) @ v[..., None])[..., 0] - g
    p_scg_z = (1.0 - gama) * p_scg + gama * state.p_scg_z_last
    tau_dist = beta * p - p_scg_z

    A, AAt = leg_systems(model, q)
    b = torch.stack([tau_dist[:, 6:11], tau_dist[:, 11:16]], dim=1)  # (B, 2, 5)
    w = (A.transpose(-1, -2) @ (gj_inverse_plain(AAt) @ b[..., None]))[..., 0]
    w_l, w_r = w[:, 0], w[:, 1]
    f_norms = torch.stack([torch.linalg.vector_norm(w_l[:, 0:3], dim=-1),
                           torch.linalg.vector_norm(w_r[:, 0:3], dim=-1)], dim=-1)
    w_norms = torch.stack([torch.linalg.vector_norm(w_l, dim=-1),
                           torch.linalg.vector_norm(w_r, dim=-1)], dim=-1)
    est = torch.cat([w_l, w_r, f_norms, w_norms], dim=-1)
    return ContactObserverState(p_scg_z_last=p_scg_z, est_forces=est), tau_dist


def params_buffer(params: ContactObserverParams) -> torch.Tensor:
    """The cutoff frequency as the kernel reads it: one float32 on its
    device (no sync)."""
    if params.cutoff_frequency.ndim:
        raise ValueError("momentum_observer kernel: the cutoff frequency must be 0-d")
    return params.cutoff_frequency.reshape(1).to(torch.float32)


def observer_inputs(rbd_measured, cmd_torque, p_scg_z_last):
    """The kernel's inputs checked and made contiguous: (B, rbd, tau,
    p_last)."""
    if rbd_measured.dim() != 2:
        raise ValueError(f"rbd_measured: expected (B, 32), got {tuple(rbd_measured.shape)}")
    Bn, dev, f32 = rbd_measured.shape[0], rbd_measured.device, torch.float32
    if not 0 < Bn <= MAX_BATCH:
        raise ValueError(f"momentum_observer: B = {Bn} scenarios, the kernel takes 1..{MAX_BATCH}")
    rbd, tau, p_last = (t.contiguous() for t in (rbd_measured, cmd_torque, p_scg_z_last))
    for t, name, shape in ((rbd, "rbd_measured", (Bn, 2 * NV)), (tau, "cmd_torque", (Bn, NJ)),
                           (p_last, "p_scg_z_last", (Bn, NV))):
        _build.require(t, name, f32, shape, dev)
    return Bn, rbd, tau, p_last


def observer_params(params: ContactObserverParams, dev) -> torch.Tensor:
    """``params_buffer`` checked for the kernel on ``dev``; kept, with its
    check, for the same cutoff tensor on the same device until the tensor
    is changed in place (its version moves)."""
    c = params.cutoff_frequency
    hit = _PARAMS.get("last")
    if hit is not None and hit[0] is c and hit[1] == c._version and hit[2] == dev:
        return hit[3]
    P = params_buffer(params)
    _build.require(P, "params", torch.float32, (1,), dev)
    _PARAMS["last"] = (c, c._version, dev, P)
    return P


_PARAMS = {}


def observer_buffers(Bn: int, dev):
    """The kernel's three outputs (B, 16): views of one allocation, new on
    every call (p_scg_z goes on as the next update's p_scg_z_last)."""
    return torch.empty((3, Bn, NV), dtype=torch.float32, device=dev).unbind(0)


def momentum_observer_update(model: RobotModel, params: ContactObserverParams,
                             state: ContactObserverState, rbd_measured, cmd_torque, dt):
    """Kernel B10: one observer update.

    CPU: ``momentum_observer_plain``.  CUDA: one launch of
    ``hk_momentum_observer``, a warp per scenario, or an error:
    rbd_measured (B, 32), cmd_torque (B, 10) and the state's (B, 16) fields
    float32 on the card (made contiguous here); the model's constants from
    B1's buffer (``soa_kernel.consts_buffer``, which refuses a model of
    another topology).  Returns (new state, tau_dist (B, 16)); ``dt`` is a
    Python float."""
    if rbd_measured.device.type == "cpu":
        return momentum_observer_plain(model, params, state, rbd_measured, cmd_torque, dt)
    Bn, rbd, tau, p_last = observer_inputs(rbd_measured, cmd_torque, state.p_scg_z_last)
    dev = rbd.device
    K = soa_kernel.consts_buffer(model, dev)
    P = observer_params(params, dev)
    p_scg_z, est, tau_dist = observer_buffers(Bn, dev)
    lib = _build.library()
    _build.check(lib.hk_momentum_observer(*(t.data_ptr() for t in (K, P, rbd, tau, p_last, p_scg_z,
                                                                  est, tau_dist)),
                                          Bn, float(dt), _build.stream(rbd)), "momentum_observer")
    momentum_observer_update.launches += 1
    return ContactObserverState(p_scg_z_last=p_scg_z, est_forces=est), tau_dist


momentum_observer_update.launches = 0


def classify_contact(params: ContactObserverParams, est_forces, cmd_contact_flags,
                     start_stop, t):
    """Trust the commanded contact except near phase boundaries, where the
    estimated normal force decides.  est_forces (B, 16); cmd_contact_flags
    (B, 4); start_stop (B, 4, 2) current window per leg; t (B,)."""
    start, stop = start_stop[..., 0], start_stop[..., 1]
    frac = (t[:, None] - start) / torch.clamp(stop - start, min=1e-6)
    # per-leg estimated force z: the reference indexes the wrench z of leg i % 2
    fz = torch.stack([est_forces[:, 2], est_forces[:, 8], est_forces[:, 2], est_forces[:, 8]],
                     dim=-1)
    force_contact = fz > params.contact_threshold
    swing_late = (cmd_contact_flags < 0.5) & (frac > 0.75)
    stance_early = (cmd_contact_flags > 0.5) & (frac < 0.25)
    return torch.where(swing_late | stance_early, force_contact, cmd_contact_flags > 0.5)


def early_late_contact_flags(contact_seq_at_t, measured_contact, cmd_contact, frac,
                             time_to_stop):
    """A swing leg measuring contact in the last quarter of its swing (and
    not within 9 ms of touchdown) flags 'early'; a stance leg not measuring
    contact in the first quarter of its stance flags 'late'."""
    early = (cmd_contact < 0.5) & measured_contact & (frac > 0.75) & (time_to_stop > 0.009)
    late = (cmd_contact > 0.5) & (~measured_contact) & (frac < 0.25)
    return early, late


def contact_class_plain(params: ContactObserverParams, est_forces, cmd_contact,
                        schedule: ModeSchedule, t_period, tt, horizon: float):
    """Kernel B16's plain version: the contact classification and early/late
    detection at tick time tt (B,) in the current phase's windows, the
    windows (``swing_windows``, StartStopTime4Legs, LeggedController.cpp:
    306-308) over the period's span [t_period - horizon, t_period + 2
    horizon]: (estimated contact, early, late), each (B, 4) bool."""
    win_starts, win_stops, _ = swing_windows(schedule, t_period - horizon,
                                             t_period + 2 * horizon)
    dtype = tt.dtype
    p = phase_index_at_time(schedule, tt.to(schedule.event_times.dtype)[:, None])
    idx = p.expand(tt.shape[0], 4)[..., None]
    ss = torch.stack([torch.gather(win_starts, -1, idx)[..., 0],
                      torch.gather(win_stops, -1, idx)[..., 0]], dim=-1).to(dtype)
    est_contact = classify_contact(params, est_forces, cmd_contact, ss, tt)
    frac = torch.clamp((tt[:, None] - ss[..., 0]) / torch.clamp(ss[..., 1] - ss[..., 0], min=1e-6),
                       0.0, 1.0)
    early, late = early_late_contact_flags(None, est_contact, cmd_contact, frac,
                                           ss[..., 1] - tt[:, None])
    return est_contact, early, late


def contact_class(params: ContactObserverParams, est_forces, cmd_contact,
                  schedule: ModeSchedule, t_period, tt, horizon: float):
    """Kernel B16: ``contact_class_plain``'s outputs at one tick.

    CPU: the plain version.  CUDA: one launch of ``hk_contact_class``, a
    thread per (scenario, leg), or an error: est_forces (B, 16), cmd_contact
    (B, 4), t_period and tt (B,) float32 and contiguous, the schedule's
    event times (B, MAX_PHASES) float32 and modes (B, MAX_PHASES + 1) int64
    each row contiguous at any batch stride, the contact threshold float32
    with one entry (read on the card, no sync); ``horizon`` a Python float."""
    if tt.device.type == "cpu":
        return contact_class_plain(params, est_forces, cmd_contact, schedule, t_period, tt,
                                   horizon)
    if tt.dim() != 1 or tt.shape[0] == 0:
        raise ValueError(f"tt: expected (B,), got {tuple(tt.shape)}")
    Bn, dev, f32 = tt.shape[0], tt.device, torch.float32
    if Bn > _build.MAX_SCENARIOS:
        raise ValueError(f"contact_class: B = {Bn}, the kernel takes 1..{_build.MAX_SCENARIOS}")
    ev, modes = schedule.event_times, schedule.modes
    for t, name, dtype, shape, kw in (
            (ev, "event_times", f32, (Bn, MAX_PHASES), {"batch_stride": True}),
            (modes, "modes", torch.int64, (Bn, MAX_PHASES + 1), {"batch_stride": True}),
            (t_period, "t_period", f32, (Bn,), {}), (tt, "tt", f32, (Bn,), {}),
            (cmd_contact, "cmd_contact", f32, (Bn, NUM_FEET), {}),
            (est_forces, "est_forces", f32, (Bn, NV), {}),
            (params.contact_threshold, "contact_threshold", f32,
             tuple(params.contact_threshold.shape), {})):
        _build.require(t, name, dtype, shape, dev, **kw)
    if params.contact_threshold.numel() != 1:
        raise ValueError("contact_class: the contact threshold must have one entry")
    out = torch.empty((3, Bn, NUM_FEET), dtype=torch.bool, device=dev)
    _build.check(_build.library().hk_contact_class(
        *(t.data_ptr() for t in (ev, modes, t_period, tt, cmd_contact, est_forces,
                                 params.contact_threshold, out[0], out[1], out[2])),
        ev.stride(0), modes.stride(0), Bn, float(horizon), float(2 * horizon),
        _build.stream(tt)), "contact_class")
    contact_class.launches += 1
    return out[0], out[1], out[2]


contact_class.launches = 0
