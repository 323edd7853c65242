"""Batched damped-least-squares leg inverse kinematics.

Port of ``hunter_bipedal_control_tpu/refs/ik.py``: fixed iteration counts
with keep-if-improved updates, both legs solved together from one
whole-body FK.  The 5x5 damped normal systems of both legs go through ONE
``gj_inverse`` launch per iteration (kernel B6 on the card): the JAX
package solves the two legs' rotation steps one after the other.
"""
from __future__ import annotations

import torch

from ..models.kinematics import contact_jacobians, fk, frame_placements
from ..models.robot import RobotModel
from ..models.spatial import log3
from ..ops.linalg import gj_inverse, inv3

MAX_IT = 5
STEP = 0.7
DAMP = 1e-6


def _toe_state(model: RobotModel, q):
    """Positions (..., 2, 3), rotations (..., 2, 3, 3) and 6x5 per-leg
    Jacobian blocks (..., 2, 6, 5) of both toes."""
    kin = fk(model, q)
    Rf, pf = frame_placements(model, kin)
    toes = model.contact_frame_ids[0:2]
    J = contact_jacobians(model, kin)
    Jl = torch.stack([J[..., 0, :, 6:11], J[..., 1, :, 11:16]], dim=-3)
    return pf[..., toes, :], Rf[..., toes, :, :], Jl


def _damped_solve(J, err, damp=DAMP):
    """argmin ||J d - err||^2 + damp ||d||^2 for J (..., r, 5), err (..., r)."""
    Jt = J.transpose(-1, -2)
    A = Jt @ J + damp * torch.eye(J.shape[-1], dtype=J.dtype, device=J.device)
    return (gj_inverse(A.contiguous()) @ (Jt @ err[..., None]))[..., 0]


def _set_joints(q, qj):
    return torch.cat([q[..., :6], qj], dim=-1)


def translation_ik(model: RobotModel, q_init, des_pos, max_it: int = MAX_IT):
    """Both legs' translation IK.  des_pos: (..., 2, 3) desired toe positions."""
    lower, upper = model.joint_lower, model.joint_upper
    p0, _, _ = _toe_state(model, q_init)
    best_err = torch.linalg.vector_norm(p0 - des_pos, dim=-1)
    q, best_q = q_init, q_init
    for _ in range(max_it):
        p, _, Jl = _toe_state(model, q)
        d = _damped_solve(Jl[..., 0:3, :], p - des_pos)               # (..., 2, 5)
        qj = torch.clamp(q[..., 6:] + STEP * (-d).reshape(*d.shape[:-2], 10), lower, upper)
        q_new = _set_joints(q, qj)
        p_new, _, _ = _toe_state(model, q_new)
        new_err = torch.linalg.vector_norm(p_new - des_pos, dim=-1)
        improved = torch.repeat_interleave(new_err < best_err, 5, dim=-1)
        best_q = _set_joints(best_q, torch.where(improved, q_new[..., 6:], best_q[..., 6:]))
        best_err = torch.minimum(new_err, best_err)
        q = q_new
    return best_q


def rotation_ik(model: RobotModel, q_init, R_des, max_it: int = MAX_IT):
    """Rotation IK in the null space of the translation Jacobian.
    R_des: (..., 3, 3) world target for both toes."""
    lower, upper = model.joint_lower, model.joint_upper
    R_des_t = R_des.transpose(-1, -2)[..., None, :, :]

    def rot_err(R):
        return log3(R_des_t @ R)                                      # (..., 2, 3)

    _, R0, _ = _toe_state(model, q_init)
    best_err = torch.linalg.vector_norm(rot_err(R0), dim=-1)
    q, best_q = q_init, q_init
    eye3 = torch.eye(3, dtype=q.dtype, device=q.device)
    eye5 = torch.eye(5, dtype=q.dtype, device=q.device)
    for _ in range(max_it):
        _, R, Jl = _toe_state(model, q)
        Rt = R.transpose(-1, -2)
        Jlin = Rt @ Jl[..., 0:3, :]
        Jang = Rt @ Jl[..., 3:6, :]
        JJt = Jlin @ Jlin.transpose(-1, -2) + DAMP * eye3
        N = eye5 - Jlin.transpose(-1, -2) @ (inv3(JJt) @ Jlin)
        w = _damped_solve(Jang @ N, rot_err(R))
        d = -(N @ w[..., None])[..., 0]                               # (..., 2, 5)
        qj = torch.clamp(q[..., 6:] + STEP * d.reshape(*d.shape[:-2], 10), lower, upper)
        q_new = _set_joints(q, qj)
        _, R_new, _ = _toe_state(model, q_new)
        new_err = torch.linalg.vector_norm(rot_err(R_new), dim=-1)
        improved = torch.repeat_interleave(new_err < best_err, 5, dim=-1)
        best_q = _set_joints(best_q, torch.where(improved, q_new[..., 6:], best_q[..., 6:]))
        best_err = torch.minimum(new_err, best_err)
        q = q_new
    return best_q


def compute_ik(model: RobotModel, q_init, des_pos, R_des, trans_it: int = MAX_IT,
               rot_it: int = MAX_IT):
    """Translation IK then null-space rotation IK; returns (..., nj) joints."""
    q = translation_ik(model, q_init, des_pos, trans_it)
    q = rotation_ik(model, q, R_des, rot_it)
    return q[..., 6:].to(q_init.dtype)
