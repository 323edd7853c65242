"""Whole-body control: task formulation + weighted QP, batched.

Port of ``hunter_bipedal_control_tpu/wbc/wbc.py``.  38 decision variables
[accel (16), contact forces (12), joint torques (10)], 28 equality rows
(equations of motion, swing-foot zero force) and 40 inequality rows
(torque limits, friction pyramid); per-mode rows are fixed-size and
masked.  Every function takes a leading batch dim B.  The QP data come
from ``wbc_qp`` (kernel B9 on the card: ``csrc/wbc_qp.cu``; plain torch,
``wbc_qp_plain``, on the CPU) and go through ``ops/qp.py::solve_qp``
(kernel B4 on the card).  An unacceptable QP returns the last accepted
solution, as the reference's WBC does.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels import _build
from ..models.centroidal import (base_kinematics_from_centroidal, rbd_to_q_v,
                                 state_input_to_v_plain, state_to_q)
from ..models.dynamics import mass_matrix, nle
from ..models.kinematics import (base_jacobian, base_jacobian_dot, contact_jacobians,
                                 contact_jacobians_dot, contact_positions, fk)
from ..models.robot import RobotModel
from ..models.spatial import (global_angular_velocity_from_euler_rates, rotation_error_in_world,
                              rotation_zyx)
from ..ocp import soa_kernel
from ..ops.qp import solve_qp

NUM_FEET = 4
NV = 16
NF = 12
NJ = 10
NDEC = NV + NF + NJ                  # 38
N_EQ_ROWS = NV + NF                  # 28: EoM + swing zero-force
N_INEQ_ROWS = 2 * NJ + 5 * NUM_FEET  # 40: torque limits + friction pyramid


class WbcParams(NamedTuple):
    """task.info WBC blocks.  Tensors are 0-d; the QP settings are Python
    values: cold solves take ``qp_iters`` PDIP iterations; with
    ``qp_warm_start`` every solve (the first tick too) takes
    ``qp_iters_warm`` from the last primal, the duals restarting cold unless
    ``qp_warm_duals``."""

    torque_limits: torch.Tensor   # (5,) per-leg motor limits
    friction_coeff: torch.Tensor
    swing_kp: torch.Tensor
    swing_kd: torch.Tensor
    base_accel_kp: torch.Tensor
    base_accel_kd: torch.Tensor
    base_height_kp: torch.Tensor
    base_height_kd: torch.Tensor
    base_angular_kp: torch.Tensor
    base_angular_kd: torch.Tensor
    weight_swing: torch.Tensor
    weight_base_accel: torch.Tensor
    weight_contact_force: torch.Tensor
    qp_iters: int = 18
    qp_accept_tol: float = 5e-3
    qp_warm_start: bool = True
    qp_iters_warm: int = 10
    qp_warm_duals: bool = False


def default_wbc_params(device=None, dtype=torch.float32) -> WbcParams:
    def t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    return WbcParams(
        torque_limits=t([28.0, 60.0, 60.0, 60.0, 28.0]), friction_coeff=t(0.7),
        swing_kp=t(160.0), swing_kd=t(18.0), base_accel_kp=t(40.0), base_accel_kd=t(4.0),
        base_height_kp=t(20.0), base_height_kd=t(3.0), base_angular_kp=t(20.0),
        base_angular_kd=t(3.0), weight_swing=t(100.0), weight_base_accel=t(1.0),
        weight_contact_force=t(0.0))


class WbcState(NamedTuple):
    last_solution: torch.Tensor   # (B, 38)
    has_last: torch.Tensor        # (B,) bool
    last_eq_dual: torch.Tensor    # (B, 28)
    last_ineq_dual: torch.Tensor  # (B, 40)


def init_wbc_state(batch: int = 1, device=None, dtype=torch.float32) -> WbcState:
    return WbcState(last_solution=torch.zeros((batch, NDEC), dtype=dtype, device=device),
                    has_last=torch.zeros(batch, dtype=torch.bool, device=device),
                    last_eq_dual=torch.zeros((batch, N_EQ_ROWS), dtype=dtype, device=device),
                    last_ineq_dual=torch.ones((batch, N_INEQ_ROWS), dtype=dtype, device=device))


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _measured_pipeline(model: RobotModel, rbd_measured):
    """q, v, M, nle, J, dJ, base J / dJ and the feet of the measured state."""
    q, v = rbd_to_q_v(rbd_measured)
    lead = q.shape[:-1]
    kin = fk(model, q)
    M = mass_matrix(model, q)
    h = nle(model, q, v)
    J = contact_jacobians(model, kin)[..., 0:3, :].reshape(*lead, NF, NV)
    dJ = contact_jacobians_dot(model, q, v)[..., 0:3, :].reshape(*lead, NF, NV)
    Jb = base_jacobian(model, kin)
    dJb = base_jacobian_dot(model, q, v)
    p_feet = contact_positions(model, kin)
    v_feet = _mv(J, v).reshape(*lead, NUM_FEET, 3)
    return q, v, M, h, J, dJ, Jb, dJb, p_feet, v_feet


def _desired_pipeline(model: RobotModel, x_des, u_des):
    """Desired foot positions and velocities, and the desired base kinematics."""
    q_des = state_to_q(x_des)
    v_des = state_input_to_v_plain(model, x_des, u_des)
    kin = fk(model, q_des)
    p_feet = contact_positions(model, kin)
    J = contact_jacobians(model, kin)[..., 0:3, :]
    v_feet = (J @ v_des[..., None, :, None])[..., 0]
    base_kin = base_kinematics_from_centroidal(model, x_des, u_des)
    return q_des, v_des, p_feet, v_feet, base_kin


def wbc_qp_plain(model: RobotModel, params: WbcParams, x_des, u_des, rbd_measured,
                 contact_flags, stance_mode):
    """The weighted WBC's QP data (H, g, Aeq, beq, Ain, bin), batched (B, ...)."""
    dtype, dev = rbd_measured.dtype, rbd_measured.device
    Bn = rbd_measured.shape[0]
    q, v, M, h, J, dJ, Jb, dJb, p_feet_m, v_feet_m = _measured_pipeline(model, rbd_measured)
    _, _, p_feet_d, v_feet_d, base_kin = _desired_pipeline(model, x_des, u_des)
    eye_j = torch.eye(NJ, dtype=dtype, device=dev)

    def zeros(*shape):
        return torch.zeros((Bn, *shape), dtype=dtype, device=dev)

    # equality rows: EoM [M, -J', -S'] z = -nle (16), swing feet zero force (12)
    S = torch.cat([torch.zeros((NJ, 6), dtype=dtype, device=dev), eye_j], dim=1)
    A_eom = torch.cat([M, -J.transpose(-1, -2), -S.T.expand(Bn, NV, NJ)], dim=-1)
    swing = 1.0 - contact_flags
    A_zf = torch.cat([zeros(NF, NV), torch.diag_embed(swing.repeat_interleave(3, dim=-1)),
                      zeros(NF, NJ)], dim=-1)
    Aeq = torch.cat([A_eom, A_zf], dim=-2)
    beq = torch.cat([-h, zeros(NF)], dim=-1)

    # inequality rows: torque limits (20), friction pyramid per stance foot (20)
    tl = params.torque_limits.repeat(2)
    D_tau = torch.cat([torch.zeros((2 * NJ, NV + NF), dtype=dtype, device=dev),
                       torch.cat([eye_j, -eye_j], dim=0)], dim=1).expand(Bn, 2 * NJ, NDEC)
    mu = params.friction_coeff
    pyr = torch.tensor([[0.0, 0.0, -1.0], [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                        [0.0, -1.0, 0.0]], dtype=dtype, device=dev)
    pyr = torch.cat([pyr[0:1], torch.cat([pyr[1:, 0:2], (-mu).expand(4, 1)], dim=1)], dim=0)
    blocks = pyr * contact_flags[:, :, None, None]                   # (B, 4, 5, 3)
    D_fr = zeros(5 * NUM_FEET, NDEC)
    for i in range(NUM_FEET):
        D_fr[:, 5 * i:5 * i + 5, NV + 3 * i:NV + 3 * i + 3] = blocks[:, i]
    Ain = torch.cat([D_tau, D_fr], dim=-2)
    bin_ = torch.cat([tl, tl]).expand(Bn, 2 * NJ)
    bin_ = torch.cat([bin_, zeros(5 * NUM_FEET)], dim=-1)

    # weighted tasks: swing legs (12), base xy (2), height (1), angular (3),
    # contact forces (12), stance-mode zero base acceleration (6)
    accel_cmd = (params.swing_kp * (p_feet_d - p_feet_m)
                 + params.swing_kd * (v_feet_d - v_feet_m))
    A_sw = torch.cat([J, zeros(NF, NF + NJ)], dim=-1)
    b_sw = (accel_cmd - _mv(dJ, v).reshape(Bn, NUM_FEET, 3)).reshape(Bn, NF)
    w_sw = swing.repeat_interleave(3, dim=-1) * torch.sqrt(params.weight_swing)

    A_xy = zeros(2, NDEC)
    A_xy[:, 0, 0] = 1.0
    A_xy[:, 1, 1] = 1.0
    b_xy = base_kin.acceleration[:, 0:2]
    A_hz = zeros(1, NDEC)
    A_hz[:, 0, 2] = 1.0
    b_hz = (base_kin.acceleration[:, 2]
            + params.base_height_kp * (base_kin.pose[:, 2] - q[:, 2])
            + params.base_height_kd * (base_kin.velocity[:, 2] - v[:, 2]))[:, None]
    A_ang = torch.cat([Jb[:, 3:6], zeros(3, NF + NJ)], dim=-1)
    omega_meas = global_angular_velocity_from_euler_rates(q[:, 3:6], v[:, 3:6])
    ang_err = rotation_error_in_world(rotation_zyx(base_kin.pose[:, 3:6]),
                                      rotation_zyx(q[:, 3:6]))
    b_ang = (base_kin.acceleration[:, 3:6] + params.base_angular_kp * ang_err
             + params.base_angular_kd * (base_kin.velocity[:, 3:6] - omega_meas)
             - _mv(dJb[:, 3:6], v))
    w_base = torch.sqrt(params.weight_base_accel)
    A_cf = torch.cat([zeros(NF, NV), torch.eye(NF, dtype=dtype, device=dev).expand(Bn, NF, NF),
                      zeros(NF, NJ)], dim=-1)
    b_cf = u_des[:, 0:NF]
    w_cf = torch.sqrt(params.weight_contact_force)
    A_st = torch.cat([torch.eye(6, dtype=dtype, device=dev).expand(Bn, 6, 6),
                      zeros(6, NDEC - 6)], dim=-1)
    b_st = zeros(6)

    one, zero = torch.ones_like(swing[:, 0]), torch.zeros_like(swing[:, 0])
    walk_w = torch.where(stance_mode, zero, one)[:, None]
    stance_w = torch.where(stance_mode, one, zero)[:, None] * w_base
    rows_A = torch.cat([A_sw * (walk_w * w_sw)[..., None], A_xy * (walk_w * w_base)[..., None],
                        A_hz * (walk_w * w_base)[..., None], A_ang * (walk_w * w_base)[..., None],
                        A_cf * (walk_w * w_cf)[..., None], A_st * stance_w[..., None]], dim=-2)
    rows_b = torch.cat([b_sw * walk_w * w_sw, b_xy * walk_w * w_base, b_hz * walk_w * w_base,
                        b_ang * walk_w * w_base, b_cf * walk_w * w_cf, b_st * stance_w], dim=-1)
    H = (rows_A.transpose(-1, -2) @ rows_A
         + 1e-6 * torch.eye(NDEC, dtype=dtype, device=dev))
    g = -_mv(rows_A.transpose(-1, -2), rows_b)
    return H, g, Aeq.contiguous(), beq, Ain.contiguous(), bin_


# WbcParams' tensor fields, in the order csrc/wbc_qp.cu reads them
GAIN_FIELDS = ("torque_limits", "friction_coeff", "swing_kp", "swing_kd", "base_accel_kp",
               "base_accel_kd", "base_height_kp", "base_height_kd", "base_angular_kp",
               "base_angular_kd", "weight_swing", "weight_base_accel", "weight_contact_force")
N_PARAMS = 17
# one block (a warp) per scenario: grid.x
MAX_BLOCKS = 2 ** 31 - 1
# the six QP arrays per scenario (H, g, Aeq, beq, Ain, bin), views into one
# buffer, each array's offset a multiple of 4 floats: the kernel writes H,
# Aeq and Ain by 16-byte stores
OUT_SHAPES = ((NDEC, NDEC), (NDEC,), (N_EQ_ROWS, NDEC), (N_EQ_ROWS,), (N_INEQ_ROWS, NDEC),
              (N_INEQ_ROWS,))
# the gains buffers kept for the last few WbcParams
CACHE_SIZE = 8
_params_buffers: dict = {}


def _keep(cache: dict, key, value):
    if len(cache) >= CACHE_SIZE:
        cache.pop(next(iter(cache)))
    cache[key] = value
    return value[-1]


def params_buffer(params: WbcParams) -> torch.Tensor:
    """The WBC's gains and weights in the kernel's layout: the tensor fields
    of ``WbcParams`` in order, one float32 tensor on their device (one
    concatenation, no sync).  Kept per ``WbcParams`` and rebuilt when one of
    its tensors changes in place (its version counter); a tensor replaced
    makes another ``WbcParams``."""
    tensors = tuple(getattr(params, f) for f in GAIN_FIELDS)
    versions = tuple(t._version for t in tensors)
    hit = _params_buffers.get(id(params))
    if hit is not None and hit[0] is params and hit[1] == versions:
        return hit[2]
    if tuple(params.torque_limits.shape) != (5,) or any(t.ndim for t in tensors[1:]):
        raise ValueError("wbc_qp kernel: torque_limits must be (5,), the other gains 0-d")
    buf = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    return _keep(_params_buffers, id(params), (params, versions, buf))


def qp_buffers(batch: int, device):
    """The six QP arrays of ``batch`` scenarios as contiguous float32 views
    into one buffer, each at a 16-byte-aligned offset."""
    sizes = [batch * math.prod(shape) for shape in OUT_SHAPES]
    offsets, end = [], 0
    for n in sizes:
        offsets.append(end)
        end += -(-n // 4) * 4
    buf = torch.empty(end, dtype=torch.float32, device=device)
    return tuple(buf[o:o + n].view(batch, *shape)
                 for o, n, shape in zip(offsets, sizes, OUT_SHAPES))


def wbc_qp(model: RobotModel, params: WbcParams, x_des, u_des, rbd_measured, contact_flags,
           stance_mode):
    """Kernel B9: the weighted WBC's QP data (H, g, Aeq, beq, Ain, bin).

    CPU: ``wbc_qp_plain``.  CUDA: one launch of ``hk_wbc_qp``, a warp per
    scenario, or an error: x_des, u_des (B, 22), rbd_measured (B, 32),
    contact_flags (B, 4) float32 and stance_mode (B,) bool, contiguous, on
    the card; the model's constants come from B1's buffer
    (``soa_kernel.consts_buffer``, which refuses a model of another
    topology), the gains from ``params_buffer``; the outputs are
    ``qp_buffers``' views."""
    if rbd_measured.device.type == "cpu":
        return wbc_qp_plain(model, params, x_des, u_des, rbd_measured, contact_flags,
                            stance_mode)
    if rbd_measured.dim() != 2:
        raise ValueError(f"rbd_measured: expected (B, 32), got {tuple(rbd_measured.shape)}")
    Bn, dev, f32 = rbd_measured.shape[0], rbd_measured.device, torch.float32
    if not 0 < Bn <= MAX_BLOCKS:
        raise ValueError(f"wbc_qp: B = {Bn} blocks, the grid takes 1..{MAX_BLOCKS}")
    for t, name, shape in ((x_des, "x_des", (Bn, 22)), (u_des, "u_des", (Bn, 22)),
                           (rbd_measured, "rbd_measured", (Bn, 32)),
                           (contact_flags, "contact_flags", (Bn, NUM_FEET))):
        _build.require(t, name, f32, shape, dev)
    _build.require(stance_mode, "stance_mode", torch.bool, (Bn,), dev)
    K = soa_kernel.consts_buffer(model, dev)
    P = params_buffer(params)
    _build.require(P, "params", f32, (N_PARAMS,), dev)
    outs = qp_buffers(Bn, dev)
    lib = _build.library()
    _build.check(lib.hk_wbc_qp(*(t.data_ptr() for t in (K, P, x_des, u_des, rbd_measured,
                                                        contact_flags, stance_mode) + outs),
                               Bn, _build.stream(rbd_measured)), "wbc_qp")
    wbc_qp.launches += 1
    return outs


wbc_qp.launches = 0


def wbc_update(model: RobotModel, params: WbcParams, state: WbcState,
               x_des, u_des, rbd_measured, contact_flags, stance_mode):
    """One weighted-WBC update for B scenarios: returns (x (B, 38), new WbcState).

    x_des, u_des (B, 22); rbd_measured (B, 32); contact_flags (B, 4) float;
    stance_mode (B,) bool."""
    x, new_state, _ = wbc_solve(model, params, state, x_des, u_des, rbd_measured,
                                contact_flags, stance_mode)
    return x, new_state


def wbc_solve(model: RobotModel, params: WbcParams, state: WbcState,
              x_des, u_des, rbd_measured, contact_flags, stance_mode):
    """``wbc_update`` that also returns whether each QP passed the
    acceptance test (B,) bool: where it did not, x is the last solution."""
    dtype, dev = rbd_measured.dtype, rbd_measured.device
    H, g, Aeq, beq, Ain, bin_ = wbc_qp(model, params, *(t.contiguous() for t in (
        x_des, u_des, rbd_measured, contact_flags, stance_mode)))
    if params.qp_warm_start:
        warm = state.has_last[:, None]
        if params.qp_warm_duals:
            lam0 = torch.where(warm, state.last_ineq_dual, torch.ones_like(state.last_ineq_dual))
            nu0 = torch.where(warm, state.last_eq_dual, torch.zeros_like(state.last_eq_dual))
            margin = torch.where(state.has_last, torch.tensor(1e-2, dtype=dtype, device=dev),
                                 torch.tensor(1.0, dtype=dtype, device=dev))
        else:
            lam0 = torch.ones_like(state.last_ineq_dual)
            nu0 = torch.zeros_like(state.last_eq_dual)
            margin = 1.0
        x0 = torch.where(warm, state.last_solution, torch.zeros_like(state.last_solution))
        sol = solve_qp(H.contiguous(), g.contiguous(), Aeq, beq.contiguous(), Ain,
                       bin_.contiguous(), n_iters=params.qp_iters_warm, x0=x0.contiguous(),
                       lam0=lam0.contiguous(), nu0=nu0.contiguous(), warm_margin=margin)
    else:
        sol = solve_qp(H.contiguous(), g.contiguous(), Aeq, beq.contiguous(), Ain,
                       bin_.contiguous(), n_iters=params.qp_iters)

    res_scale = 1.0 + torch.maximum(beq.abs().amax(-1), bin_.abs().amax(-1))
    ok = torch.isfinite(sol.x).all(-1) & (sol.primal_residual < params.qp_accept_tol * res_scale)
    last = torch.where(state.has_last[:, None], state.last_solution,
                       torch.zeros_like(state.last_solution))
    x = torch.where(ok[:, None], sol.x, last)
    new_state = WbcState(
        last_solution=x,
        has_last=torch.ones_like(state.has_last),
        last_eq_dual=torch.where(ok[:, None], sol.eq_dual, state.last_eq_dual),
        last_ineq_dual=torch.where(ok[:, None], sol.ineq_dual, state.last_ineq_dual))
    return x, new_state, ok


def coulomb_friction_compensation(joint_vel, torques):
    """Coulomb friction feedforward (0.2 N m beyond 1e-3 rad/s), which the
    reference defines but never calls."""
    comp = torch.where(joint_vel.abs() > 0.001, torch.sign(joint_vel) * 0.2,
                       torch.zeros_like(joint_vel))
    return torques + comp
