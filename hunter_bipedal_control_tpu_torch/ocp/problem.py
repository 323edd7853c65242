"""The NMPC optimal-control problem: costs, soft constraints, equality
constraints — fixed-shape, mask-activated, Gauss-Newton quadratics.

Port of ``hunter_bipedal_control_tpu/ocp/problem.py`` in both of its
forms.  The dense form (``lin_backend='dense'``): ``knot_linearization_fused``
and ``stage_merit_fused`` take any leading batch dims — (B, N) for
scenarios x knots — instead of being vmapped.  The batch forms on the
scalarized SoA core (``lin_backend='soa'``, ``models/soa.py``):
``knot_linearization_batch`` and ``stage_merit_batch``, the plain versions
of kernel B1.  Every knot carries 16 equality rows and 36 soft rows; contact
flags toggle which rows are live.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.centroidal import (
    base_block_solve,
    base_velocity_from_momentum,
    centroidal_momentum_matrix,
    com_position,
    contact_forces,
    flow_map,
    joint_velocities,
    state_to_q,
)
from ..models.kinematics import (
    _skew_batch,
    contact_jacobians,
    contact_positions,
    fk,
    link_com_jacobians,
)
from ..models.robot import GRAVITY, RobotModel
from ..models.spatial import euler_rate_map_zyx_jacobian
from . import penalties

NUM_FEET = 4
N_EQ_PER_FOOT = 4
N_EQ = NUM_FEET * N_EQ_PER_FOOT  # 16


class OcpParams(NamedTuple):
    """All task.info-derived weights (defaults = hunter task.info)."""

    Q: torch.Tensor
    R: torch.Tensor
    friction_coeff: torch.Tensor
    cone_regularization: torch.Tensor
    cone_mu: torch.Tensor
    cone_delta: torch.Tensor
    swing_weight: torch.Tensor
    position_error_gain: torch.Tensor
    xy_position_gain: torch.Tensor
    stance_z_ref: torch.Tensor
    pos_limit_mu: torch.Tensor
    pos_limit_delta: torch.Tensor
    vel_limit_mu: torch.Tensor
    vel_limit_delta: torch.Tensor
    force_limit_mu: torch.Tensor
    force_limit_delta: torch.Tensor
    force_z_max: torch.Tensor
    joint_lower: torch.Tensor
    joint_upper: torch.Tensor
    joint_vel_limit: torch.Tensor
    # self-collision is not ported yet: only None (the reference's empty
    # collisionPairs list) is accepted
    collision: object = None


def default_ocp_params(model: RobotModel, dtype=torch.float32) -> OcpParams:
    nj = model.nj
    nu = 3 * NUM_FEET + nj
    dev = model.link_mass.device
    qdiag = np.concatenate(
        [np.full(6, 13.0), [500.0, 500.0, 500.0, 100.0, 500.0, 500.0], np.full(nj, 10.0)]
    )

    def c(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype, device=dev)

    return OcpParams(
        Q=c(np.diag(qdiag)),
        R=c(np.diag(np.full(nu, 1e-3 * 5.0))),
        friction_coeff=c(0.7),
        cone_regularization=c(25.0),
        cone_mu=c(0.1),
        cone_delta=c(5.0),
        swing_weight=c(20.0),
        position_error_gain=c(20.0),
        xy_position_gain=c(3.0),
        stance_z_ref=c(0.02),
        pos_limit_mu=c(1.0),
        pos_limit_delta=c(0.1),
        vel_limit_mu=c(1.0),
        vel_limit_delta=c(0.1),
        force_limit_mu=c(0.1),
        force_limit_delta=c(1.0),
        force_z_max=c(350.0),
        joint_lower=model.joint_lower.to(dtype),
        joint_upper=model.joint_upper.to(dtype),
        joint_vel_limit=model.joint_vel_limit.to(dtype),
    )


def make_input_cost(model: RobotModel, params: OcpParams, q_nominal) -> OcpParams:
    """initializeInputCostWeight (LeggedInterface.cpp:263-290): map the
    task-space foot-velocity weights into joint space at q_nominal (nq,)."""
    dtype, dev = params.Q.dtype, params.Q.device
    nj = model.nj
    J = contact_jacobians(model, fk(model, q_nominal))             # (4, 6, nv)
    base2feet = torch.cat([J[i, 0:3, 6:] for i in range(NUM_FEET)], dim=0)  # (12, nj)
    r_force = torch.diag(torch.full((12,), 1e-3 * 5.0, dtype=dtype, device=dev))
    r_eevel = torch.diag(torch.full((12,), 1e-3 * 2000.0, dtype=dtype, device=dev))
    r_joint = base2feet.T @ r_eevel @ base2feet
    R = torch.zeros((12 + nj, 12 + nj), dtype=dtype, device=dev)
    R[0:12, 0:12] = r_force
    R[12:, 12:] = r_joint
    return params._replace(R=R)


def weight_compensating_input(model: RobotModel, contact_flags, nu, dtype=None):
    """utils.h:73-93 — distribute m g over the stance feet: (..., 4) -> (..., nu)."""
    dtype = dtype or contact_flags.dtype
    n_stance = torch.clamp(contact_flags.sum(-1), min=1.0)
    fz = model.total_mass * GRAVITY / n_stance
    zero = torch.zeros_like(contact_flags)
    forces = torch.stack([zero, zero, fz[..., None] * contact_flags], dim=-1)
    rest = torch.zeros((*contact_flags.shape[:-1], nu - 3 * NUM_FEET),
                       dtype=dtype, device=contact_flags.device)
    return torch.cat([forces.reshape(*contact_flags.shape[:-1], -1).to(dtype), rest], dim=-1)


def _soft_penalty_terms(model, params: OcpParams, h, contact_flags):
    """(p, dp, d2p, mask) for each soft row h (..., ns) given flags (..., nc)."""
    nj = model.nj
    i0, i1, i2, i3 = 4, 12, 12 + nj, 12 + 2 * nj

    p_cone, d_cone, dd_cone = penalties.relaxed_barrier(
        h[..., 0:i0], params.cone_mu, params.cone_delta)
    p_xy, d_xy, dd_xy = penalties.quadratic(h[..., i0:i1], params.swing_weight)
    p_pos, d_pos, dd_pos = penalties.double_sided_relaxed_barrier(
        h[..., i1:i2], params.joint_lower, params.joint_upper,
        params.pos_limit_mu, params.pos_limit_delta)
    p_vel, d_vel, dd_vel = penalties.double_sided_relaxed_barrier(
        h[..., i2:i3], -params.joint_vel_limit, params.joint_vel_limit,
        params.vel_limit_mu, params.vel_limit_delta)
    p_f, d_f, dd_f = penalties.double_sided_relaxed_barrier(
        h[..., i3:], 0.0, params.force_z_max, params.force_limit_mu, params.force_limit_delta)

    def cat(*ts):
        return torch.cat(ts, dim=-1)

    swing = 1.0 - contact_flags
    ones = torch.ones_like(h[..., : 2 * nj + 4])
    mask = cat(contact_flags, torch.repeat_interleave(swing, 2, dim=-1), ones)
    return (cat(p_cone, p_xy, p_pos, p_vel, p_f), cat(d_cone, d_xy, d_pos, d_vel, d_f),
            cat(dd_cone, dd_xy, dd_pos, dd_vel, dd_f), mask)


def _quad_form(v, M):
    """0.5 v' M v over leading dims."""
    return ((0.5 * v) @ M * v).sum(-1)


def _assemble_quadratic(model, params: OcpParams, x, u, x_nom, contact_flags, h, Jx, Ju):
    nu = u.shape[-1]
    u_nom = weight_compensating_input(model, contact_flags, nu, x.dtype)
    dx = x - x_nom
    du = u - u_nom
    p, dp, d2p, mask = _soft_penalty_terms(model, params, h, contact_flags)
    w1 = mask * dp
    w2 = mask * d2p

    cost = _quad_form(dx, params.Q) + _quad_form(du, params.R) + torch.sum(mask * p, dim=-1)
    qx = dx @ params.Q.T + (Jx.transpose(-1, -2) @ w1[..., None])[..., 0]
    qu = du @ params.R.T + (Ju.transpose(-1, -2) @ w1[..., None])[..., 0]
    Qxx = params.Q + torch.einsum("...ri,...r,...rj->...ij", Jx, w2, Jx)
    Quu = params.R + torch.einsum("...ri,...r,...rj->...ij", Ju, w2, Ju)
    Qux = torch.einsum("...ri,...r,...rj->...ij", Ju, w2, Jx)
    return cost, qx, qu, Qxx, Quu, Qux


def _eq_and_soft_rows(params: OcpParams, x, forces, vj, p_c, v_c, contact_flags,
                      foot_pos_ref, foot_vel_ref, nj):
    """Masked equality rows g (..., 16), eq_mask, soft rows (..., 36) and the
    cone's sqrt term, from one kinematics pass (shared by combined_rows and
    knot_linearization_fused)."""
    zeros2 = torch.zeros_like(p_c[..., 0:2])
    zero_vel = v_c + torch.cat(
        [zeros2, (params.xy_position_gain * (p_c[..., 2] - params.stance_z_ref))[..., None]],
        dim=-1)
    normal_vel = (v_c[..., 2] - foot_vel_ref[..., 2]
                  + params.position_error_gain * (p_c[..., 2] - foot_pos_ref[..., 2]))
    stance = contact_flags > 0.5
    rows03 = torch.where(stance[..., None], zero_vel, forces)
    row3 = torch.where(stance, 0.0, normal_vel)
    g = torch.cat([rows03, row3[..., None]], dim=-1).reshape(*x.shape[:-1], N_EQ)
    eq_mask = torch.cat([torch.ones_like(forces), (~stance).to(x.dtype)[..., None]],
                        dim=-1).reshape(*x.shape[:-1], N_EQ)

    s_cone = torch.sqrt(forces[..., 0] ** 2 + forces[..., 1] ** 2 + params.cone_regularization)
    cone = params.friction_coeff * forces[..., 2] - s_cone
    xy = (v_c[..., 0:2] - foot_vel_ref[..., 0:2]
          + params.xy_position_gain * (p_c[..., 0:2] - foot_pos_ref[..., 0:2])
          ).reshape(*x.shape[:-1], 2 * NUM_FEET)
    soft = torch.cat([cone, xy, x[..., 12:12 + nj], vj, forces[..., 2]], dim=-1)
    return g * eq_mask, eq_mask, soft, s_cone


def _flow_rows(model, forces, p_c, p_com, vb, vj):
    m = model.total_mass
    g = torch.tensor([0.0, 0.0, -GRAVITY], dtype=forces.dtype, device=forces.device)
    hdot_lin = forces.sum(-2) / m + g
    hdot_ang = torch.linalg.cross(p_c - p_com[..., None, :], forces, dim=-1).sum(-2) / m
    return torch.cat([hdot_lin, hdot_ang, vb, vj], dim=-1)


def combined_rows(model: RobotModel, params: OcpParams, x, u, contact_flags,
                  foot_pos_ref, foot_vel_ref):
    """(flow (..., nx), g_eq masked (..., 16), eq_mask (..., 16), soft (..., 36))."""
    nc, nj = NUM_FEET, model.nj
    kin = fk(model, state_to_q(x))
    forces = contact_forces(u, nc)
    vj = joint_velocities(u, nj)
    p_com = com_position(model, kin)
    p_c = contact_positions(model, kin)
    J = contact_jacobians(model, kin)

    vb = base_velocity_from_momentum(model, kin, x[..., 0:6], vj)
    v = torch.cat([vb, vj], dim=-1)
    v_c = torch.einsum("...cij,...j->...ci", J[..., 0:3, :], v)

    flow = _flow_rows(model, forces, p_c, p_com, vb, vj)
    g, eq_mask, soft, _ = _eq_and_soft_rows(params, x, forces, vj, p_c, v_c, contact_flags,
                                            foot_pos_ref, foot_vel_ref, nj)
    return flow, g, eq_mask, soft


def stage_merit_fused(model: RobotModel, params: OcpParams, x, u, x_nom,
                      contact_flags, foot_pos_ref, foot_vel_ref, dt):
    """(stage cost, RK2 next state, masked eq residual) — the line-search merit."""
    nu = u.shape[-1]
    flow, g_masked, _, soft = combined_rows(
        model, params, x, u, contact_flags, foot_pos_ref, foot_vel_ref)
    u_nom = weight_compensating_input(model, contact_flags, nu, x.dtype)
    dx = x - x_nom
    du = u - u_nom
    p, _, _, mask = _soft_penalty_terms(model, params, soft, contact_flags)
    cost = _quad_form(dx, params.Q) + _quad_form(du, params.R) + torch.sum(mask * p, dim=-1)

    k2 = flow_map(model, x + dt * flow, u)
    xnext = x + 0.5 * dt * (flow + k2)
    return cost, xnext, g_masked


def _finish_linearization(model, params, x, u, x_nom, contact_flags, dt,
                          flow0, g0, eq_mask, soft0, Jx_f, Ju_f, C, D, Jsoft_x, Jsoft_u):
    """RK2 sensitivities (frozen-Jacobian expansion) + exact RK2 primal + GGN quadratic."""
    nx = x.shape[-1]
    A = (torch.eye(nx, dtype=x.dtype, device=x.device) + dt * Jx_f
         + (0.5 * dt * dt) * (Jx_f @ Jx_f))
    B = dt * Ju_f + (0.5 * dt * dt) * (Jx_f @ Ju_f)

    k2 = flow_map(model, x + dt * flow0, u)
    xnext = x + 0.5 * dt * (flow0 + k2)

    cost, qx, qu, Qxx, Quu, Qux = _assemble_quadratic(
        model, params, x, u, x_nom, contact_flags, soft0, Jsoft_x, Jsoft_u)
    return xnext, A, B, cost, qx, qu, Qxx, Quu, Qux, g0, C, D, eq_mask


def knot_linearization_fused(model: RobotModel, params: OcpParams, x, u, x_nom,
                             contact_flags, foot_pos_ref, foot_vel_ref, dt):
    """Everything the SQP needs at each knot (x (..., nx), u (..., nu)):
    (xnext, A, B, cost, qx, qu, Qxx, Quu, Qux, g, C, D, eq_mask).

    The h/u Jacobian columns are analytic and the (euler, joint) columns
    closed-form, as derived in the JAX package's docstring; the one tangent
    they need, D_q[(CMM, J_c, J_com)] along the primal velocity, is a
    forward-mode ``torch.func.jvp``."""
    nx = x.shape[-1]
    nc, nj = NUM_FEET, model.nj
    nq = nx - 6
    S = x.shape[:-1]
    dtype, dev = x.dtype, x.device
    h = x[..., 0:6]
    q = x[..., 6:]
    forces = contact_forces(u, nc)
    vj = joint_velocities(u, nj)

    def z(*sh):
        return torch.zeros((*S, *sh), dtype=dtype, device=dev)

    def const(a):
        a = torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=dev)
        return a.expand(*S, *a.shape)

    # ---- primal + analytic-column ingredients (one kinematics pass) ----
    kin = fk(model, q)
    p_com = com_position(model, kin)
    p_c = contact_positions(model, kin)
    J = contact_jacobians(model, kin)
    Jlin = J[..., 0:3, :]                                            # (..., nc, 3, nv)
    Acmm = centroidal_momentum_matrix(model, kin)
    Ab, Aj = Acmm[..., :, 0:6], Acmm[..., :, 6:]
    m = model.total_mass
    eye6 = torch.eye(6, dtype=dtype, device=dev).expand(*S, 6, 6)
    rhs = torch.cat([(m * h - (Aj @ vj[..., None])[..., 0])[..., None], m * eye6, -Aj], dim=-1)
    sol6 = base_block_solve(model, Ab, rhs)
    vb = sol6[..., :, 0]
    Vh = sol6[..., :, 1:7]
    Vv = sol6[..., :, 7:]
    v = torch.cat([vb, vj], dim=-1)
    v_c = torch.einsum("...cij,...j->...ci", Jlin, v)

    H = torch.einsum("...cik,...kl->...cil", Jlin[..., 0:6], Vh)       # (..., nc, 3, 6)
    W = torch.einsum("...cik,...kl->...cil", Jlin[..., 0:6], Vv) + Jlin[..., 6:]

    # ---- primal row values (as combined_rows) ----
    flow0 = _flow_rows(model, forces, p_c, p_com, vb, vj)
    g0, eq_mask, soft0, s_cone = _eq_and_soft_rows(
        params, x, forces, vj, p_c, v_c, contact_flags, foot_pos_ref, foot_vel_ref, nj)

    # ---- analytic h (6) and u (nu) Jacobian columns ----
    eyeC = np.eye(nc)
    flow_h = torch.cat([z(6, 6), Vh, z(nj, 6)], dim=-2)
    dang_df = (_skew_batch(p_c - p_com[..., None, :]) / m).transpose(-3, -2).reshape(*S, 3, 3 * nc)
    flow_f = torch.cat([const(np.tile(np.eye(3), (1, nc))) / m, dang_df, z(6 + nj, 3 * nc)],
                       dim=-2)
    flow_vj = torch.cat([z(6, nj), Vv, const(np.eye(nj))], dim=-2)
    flow_u = torch.cat([flow_f, flow_vj], dim=-1)

    sel_f = np.einsum("ci,jk->cjik", eyeC, np.eye(3)).reshape(nc, 3, 3 * nc)
    stance3 = (contact_flags > 0.5)[..., :, None, None]               # (..., nc, 1, 1)
    swing1 = (contact_flags < 0.5)[..., :, None]                      # (..., nc, 1)
    eq03_h = torch.where(stance3, H, 0.0)
    eq03_f = torch.where(stance3, 0.0, const(sel_f))
    eq03_vj = torch.where(stance3, W, 0.0)
    eq3_h = torch.where(swing1, H[..., 2, :], 0.0)
    eq3_vj = torch.where(swing1, W[..., 2, :], 0.0)
    eq_h = torch.cat([eq03_h, eq3_h[..., None, :]], dim=-2).reshape(*S, N_EQ, 6)
    eq_f = torch.cat([eq03_f, z(nc, 1, 3 * nc)], dim=-2).reshape(*S, N_EQ, 3 * nc)
    eq_vj = torch.cat([eq03_vj, eq3_vj[..., None, :]], dim=-2).reshape(*S, N_EQ, nj)
    eq_u = torch.cat([eq_f, eq_vj], dim=-1)

    cone_df = torch.stack([-forces[..., 0] / s_cone, -forces[..., 1] / s_cone,
                           params.friction_coeff.to(dtype).expand(s_cone.shape)], dim=-1)
    cone_f = (cone_df[..., :, None, :] * const(eyeC)[..., :, :, None]).reshape(*S, nc, 3 * nc)
    soft_h = torch.cat([z(nc, 6), H[..., 0:2, :].reshape(*S, 2 * nc, 6), z(2 * nj + nc, 6)],
                       dim=-2)
    fz_sel = (eyeC[:, :, None] * np.array([0.0, 0.0, 1.0])).reshape(nc, 3 * nc)
    soft_f = torch.cat([cone_f, z(2 * nc + 2 * nj, 3 * nc), const(fz_sel)], dim=-2)
    soft_vj = torch.cat([z(nc, nj), W[..., 0:2, :].reshape(*S, 2 * nc, nj), z(nj, nj),
                         const(np.eye(nj)), z(nc, nj)], dim=-2)
    soft_u = torch.cat([soft_f, soft_vj], dim=-1)

    # ---- analytic base-position (3) columns ----
    gxy = params.xy_position_gain
    gn = params.position_error_gain
    z_row = const(np.diag([0.0, 0.0, 1.0])) * gxy
    eq03_pos = torch.where(stance3, z_row[..., None, :, :], 0.0)
    eq3_pos = torch.where(swing1, gn * const([0.0, 0.0, 1.0])[..., None, :], 0.0)
    eq_pos = torch.cat([eq03_pos, eq3_pos[..., None, :]], dim=-2).reshape(*S, N_EQ, 3)
    xy_pos = (const(np.tile(np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]), (nc, 1))) * gxy)
    soft_pos = torch.cat([z(nc, 3), xy_pos, z(2 * nj + nc, 3)], dim=-2)
    flow_pos = z(nx, 3)

    # ---- closed-form (euler, joint) Jacobian columns (see the JAX package) ----
    vbar = v

    def _vel_quants(q_):
        kin_ = fk(model, q_)
        return (centroidal_momentum_matrix(model, kin_),
                contact_jacobians(model, kin_)[..., 0:3, :],
                link_com_jacobians(model, kin_)[..., 0:3, :])

    Adot, Jcdot, Jcomdot = torch.func.jvp(_vel_quants, (q,), (vbar,))[1]

    Jcom_full = link_com_jacobians(model, kin)                        # (..., L, 6, nq)
    Jcomlin, Jang = Jcom_full[..., 0:3, :], Jcom_full[..., 3:6, :]
    omega = torch.einsum("...kiv,...v->...ki", Jang, vbar)
    Iw = torch.einsum("...kij,kjl,...kml->...kim", kin.R, model.link_inertia, kin.R)
    hk = torch.einsum("...kij,...kj->...ki", Iw, omega)
    vck = torch.einsum("...kiv,...v->...ki", Jcomlin, vbar)
    Jcom_lin = Acmm[..., 0:3, :] / m                                  # dp_com/dq
    r_com = kin.com_w - p_com[..., None, :]

    dE = euler_rate_map_zyx_jacobian(q[..., 3:6])                     # (..., 3, 3, 3)
    dEve = torch.einsum("...abi,...b->...ai", dE, vbar[..., 3:6])
    L = model.n_links
    Et = kin.E.transpose(-1, -2)[..., None, :, :].expand(*S, L, 3, 3)
    dom = (omega - omega[..., 0:1, :])[..., :, None, :].expand(*S, L, 3, 3)
    w_e = torch.linalg.cross(Et, dom, dim=-1).transpose(-1, -2) + dEve[..., None, :, :]
    omc = omega[..., model.joint_child, :]                            # (..., nj, 3)
    anc = model.ancestor_mask.to(dtype)                               # (L, nj)
    ax = kin.joint_axis_w[..., None, :, :].expand(*S, L, nj, 3)
    w_j = (torch.linalg.cross(ax, omega[..., :, None, :] - omc[..., None, :, :], dim=-1)
           * anc[:, :, None]).transpose(-1, -2)                       # (..., L, 3, nj)
    w_q = torch.cat([z(L, 3, 3), w_e, w_j], dim=-1)

    JangT = Jang.transpose(-1, -2)                                    # (..., L, nq, 3)
    t_rot = torch.linalg.cross(JangT, hk[..., :, None, :].expand(JangT.shape), dim=-1) \
        - torch.einsum("...kab,...kvb->...kva", Iw, torch.linalg.cross(
            JangT, omega[..., :, None, :].expand(JangT.shape), dim=-1))
    t_w = torch.einsum("...kab,...kbv->...kva", Iw, w_q)
    drv = (Jcomlin - Jcom_lin[..., None, :, :]).transpose(-1, -2)     # (..., L, nq, 3)
    t_r = (torch.linalg.cross(drv, vck[..., :, None, :].expand(drv.shape), dim=-1)
           + torch.linalg.cross(r_com[..., :, None, :].expand(drv.shape),
                                Jcomdot.transpose(-1, -2), dim=-1)
           ) * model.link_mass[:, None, None]
    dAang = (t_rot + t_w + t_r).sum(-3).transpose(-1, -2)             # (..., 3, nq)
    dAv = torch.cat([Adot[..., 0:3, :], dAang], dim=-2)

    dvb = base_block_solve(model, Ab, -dAv)                           # (..., 6, nq)
    dvc = Jcdot + torch.einsum("...cik,...kv->...civ", Jlin[..., 0:6], dvb)

    dhdot_ang = -torch.einsum("...cab,...cbv->...av", _skew_batch(forces),
                              Jlin - Jcom_lin[..., None, :, :]) / m
    Jq_flow = torch.cat([z(3, nq), dhdot_ang, dvb, z(nj, nq)], dim=-2)

    zv_q = dvc + torch.cat([z(nc, 2, nq), gxy * Jlin[..., 2:3, :]], dim=-2)
    nvel_q = dvc[..., 2, :] + gn * Jlin[..., 2, :]
    Jq_eq = torch.cat([torch.where(stance3, zv_q, 0.0),
                       torch.where(swing1, nvel_q, 0.0)[..., None, :]], dim=-2
                      ).reshape(*S, N_EQ, nq)
    xy_q = (dvc[..., 0:2, :] + gxy * Jlin[..., 0:2, :]).reshape(*S, 2 * nc, nq)
    qj_q = const(np.concatenate([np.zeros((nj, 6)), np.eye(nj)], axis=1))
    Jq_soft = torch.cat([z(nc, nq), xy_q, qj_q, z(nj + nc, nq)], dim=-2)

    Jx_f = torch.cat([flow_h, flow_pos, Jq_flow[..., 3:]], dim=-1)
    C = torch.cat([eq_h, eq_pos, Jq_eq[..., 3:]], dim=-1)
    Jsoft_x = torch.cat([soft_h, soft_pos, Jq_soft[..., 3:]], dim=-1)

    return _finish_linearization(
        model, params, x, u, x_nom, contact_flags, dt,
        flow0, g0, eq_mask, soft0, Jx_f, flow_u, C, eq_u, Jsoft_x, soft_u)


# ---------------------------------------------------------------------------
# batch forms on the scalarized SoA core (lin_backend='soa'): the plain
# versions of kernel B1 (csrc/soa_linearize.cu)
# ---------------------------------------------------------------------------


# The JAX package's axis-last variants: the port's forms already take any
# leading dims with the rows on the last axis.
_soft_penalty_terms_last = _soft_penalty_terms
weight_compensating_input_batch = weight_compensating_input


def stage_merit_batch(model: RobotModel, params: OcpParams, xs, us, x_nom,
                      contact_flags, foot_pos_ref, foot_vel_ref, dt):
    """``stage_merit_fused`` over any leading dims on the scalarized SoA
    core: (stage cost, RK2 next state, masked eq residual)."""
    from ..models import soa

    flow, g_masked, _, soft = soa.combined_rows_arrays(
        model, params, xs, us, contact_flags, foot_pos_ref, foot_vel_ref)
    nu = us.shape[-1]
    u_nom = weight_compensating_input_batch(model, contact_flags, nu)
    dx = xs - x_nom
    du = us - u_nom
    p, _, _, mask = _soft_penalty_terms_last(model, params, soft, contact_flags)
    cost = _quad_form(dx, params.Q) + _quad_form(du, params.R) + torch.sum(mask * p, dim=-1)
    k2 = soa.flow_arrays(model, xs + dt * flow, us)
    xnext = xs + 0.5 * dt * (flow + k2)
    return cost, xnext, g_masked


def knot_linearization_batch(model: RobotModel, params: OcpParams, xs, us,
                             x_nom, flags, fpr, fvr, dt):
    """``knot_linearization_fused`` over any leading dims on the scalarized
    SoA core: the FK/CMM/dual chain as elementwise ops on batch-shaped
    scalars, then the dense 22-dim tail (RK2 sensitivity, exact RK2 primal,
    GGN quadratics).  Same 13 outputs."""
    from ..models import soa

    ing = soa.linearization_arrays(model, params, xs, us, flags, fpr, fvr)
    S = xs.shape[:-1]
    nx = xs.shape[-1]
    nc, nj = NUM_FEET, model.nj
    nq = nx - 6
    dtype, dev = xs.dtype, xs.device
    m = float(model.total_mass)

    def z(*sh):
        return torch.zeros((*S, *sh), dtype=dtype, device=dev)

    def bcast(a, *sh):
        a = torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=dev)
        return a.expand(*S, *sh)

    flow0, g0 = ing["flow0"], ing["g0"]
    eq_mask, soft0 = ing["eq_mask"], ing["soft0"]
    Vh, Vv, dvb = ing["Vh"], ing["Vv"], ing["dvb"]
    Jc, Jcdot = ing["Jc"], ing["Jcdot"]
    p_c, p_com = ing["p_c"], ing["p_com"]
    forces = us[..., : 3 * nc].reshape(*S, nc, 3)

    H = torch.einsum("...cij,...jk->...cik", Jc[..., 0:6], Vh)       # (...,nc,3,6)
    W = torch.einsum("...cij,...jk->...cik", Jc[..., 0:6], Vv) + Jc[..., 6:]
    dvc = Jcdot + torch.einsum("...cij,...jk->...cik", Jc[..., 0:6], dvb)
    # d/dq sum_i (p_ci - p_com) x f_i = -sum_i skew(f_i) (Jc_i - Jcom)
    Jcom = ing["Jcom"]                                                # (...,3,nq)
    dhdot_ang = -torch.einsum(
        "...cab,...cbv->...av", _skew_batch(forces), Jc - Jcom[..., None, :, :]) / m

    # ---- q-column blocks ----
    gxy = params.xy_position_gain
    gn = params.position_error_gain
    stance3 = (flags > 0.5)[..., None, None]                          # (...,nc,1,1)
    swing1 = (flags < 0.5)[..., None]                                 # (...,nc,1)
    zv_q = dvc + torch.cat([z(nc, 2, nq), gxy * Jc[..., 2:3, :]], dim=-2)
    nvel_q = dvc[..., 2, :] + gn * Jc[..., 2, :]                      # (...,nc,nq)
    Jq_eq = torch.cat(
        [torch.where(stance3, zv_q, 0.0),
         torch.where(swing1, nvel_q, 0.0)[..., None, :]], dim=-2).reshape(*S, N_EQ, nq)
    xy_q = (dvc[..., 0:2, :] + gxy * Jc[..., 0:2, :]).reshape(*S, 2 * nc, nq)
    qj_q = bcast(np.concatenate([np.zeros((nj, 6)), np.eye(nj)], axis=1), nj, nq)
    Jq_soft = torch.cat([z(nc, nq), xy_q, qj_q, z(nj, nq), z(nc, nq)], dim=-2)
    Jq_flow = torch.cat([z(3, nq), dhdot_ang, dvb, z(nj, nq)], dim=-2)

    # ---- h-column blocks ----
    flow_h = torch.cat([z(6, 6), Vh, z(nj, 6)], dim=-2)
    eq_h = torch.cat(
        [torch.where(stance3, H, 0.0),
         torch.where(swing1, H[..., 2, :], 0.0)[..., None, :]], dim=-2).reshape(*S, N_EQ, 6)
    soft_h = torch.cat([z(nc, 6), H[..., 0:2, :].reshape(*S, 2 * nc, 6), z(2 * nj + nc, 6)],
                       dim=-2)

    Jx_f = torch.cat([flow_h, Jq_flow], dim=-1)                       # (...,nx,nx)
    C = torch.cat([eq_h, Jq_eq], dim=-1)                              # (...,16,nx)
    Jsoft_x = torch.cat([soft_h, Jq_soft], dim=-1)

    # ---- u-column blocks ----
    dang = (_skew_batch(p_c - p_com[..., None, :]).movedim(-3, -2)
            .reshape(*S, 3, 3 * nc) / m)
    flow_f = torch.cat([bcast(np.tile(np.eye(3) / m, (1, nc)), 3, 3 * nc), dang,
                        z(6 + nj, 3 * nc)], dim=-2)
    flow_vj = torch.cat([z(6, nj), Vv, bcast(np.eye(nj), nj, nj)], dim=-2)
    flow_u = torch.cat([flow_f, flow_vj], dim=-1)

    sel_f = np.einsum("ci,jk->cjik", np.eye(nc), np.eye(3)).reshape(nc, 3, 3 * nc)
    eq03_f = torch.where(stance3, 0.0, bcast(sel_f, nc, 3, 3 * nc))
    eq_f = torch.cat([eq03_f, z(nc, 1, 3 * nc)], dim=-2).reshape(*S, N_EQ, 3 * nc)
    eq03_vj = torch.where(stance3, W, 0.0)
    eq3_vj = torch.where(swing1, W[..., 2, :], 0.0)
    eq_vj = torch.cat([eq03_vj, eq3_vj[..., None, :]], dim=-2).reshape(*S, N_EQ, nj)
    eq_u = torch.cat([eq_f, eq_vj], dim=-1)

    s_cone = torch.sqrt(forces[..., 0] ** 2 + forces[..., 1] ** 2
                        + params.cone_regularization)                 # (...,nc)
    cone_df = torch.stack(
        [-forces[..., 0] / s_cone, -forces[..., 1] / s_cone,
         params.friction_coeff.to(dtype).expand(s_cone.shape)], dim=-1)  # (...,nc,3)
    cone_f = (cone_df[..., None, :] * bcast(np.eye(nc), nc, nc)[..., None]
              ).reshape(*S, nc, 3 * nc)
    fz_sel = (np.eye(nc)[:, :, None] * np.array([0.0, 0.0, 1.0])).reshape(nc, 3 * nc)
    soft_f = torch.cat([cone_f, z(2 * nc + 2 * nj, 3 * nc), bcast(fz_sel, nc, 3 * nc)], dim=-2)
    soft_vj = torch.cat([z(nc, nj), W[..., 0:2, :].reshape(*S, 2 * nc, nj), z(nj, nj),
                         bcast(np.eye(nj), nj, nj), z(nc, nj)], dim=-2)
    soft_u = torch.cat([soft_f, soft_vj], dim=-1)

    # ---- dense tail: RK2 sensitivity + exact RK2 primal + GGN quadratic ----
    eye_nx = torch.eye(nx, dtype=dtype, device=dev)
    A = eye_nx + dt * Jx_f + (0.5 * dt * dt) * (Jx_f @ Jx_f)
    B = dt * flow_u + (0.5 * dt * dt) * (Jx_f @ flow_u)

    k2 = soa.flow_arrays(model, xs + dt * flow0, us)
    xnext = xs + 0.5 * dt * (flow0 + k2)

    cost, qx, qu, Qxx, Quu, Qux = _assemble_quadratic(
        model, params, xs, us, x_nom, flags, soft0, Jsoft_x, soft_u)
    return xnext, A, B, cost, qx, qu, Qxx, Quu, Qux, g0, C, eq_u, eq_mask
