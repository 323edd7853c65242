"""Batched damped-least-squares leg inverse kinematics.

Port of ``hunter_bipedal_control_tpu/refs/ik.py``: fixed iteration counts
with keep-if-improved updates, both legs solved together from one
whole-body FK, the 5x5 damped normal systems of both legs inverted by the
plain Gauss-Jordan (the JAX package solves the two legs' rotation steps one
after the other).

``joint_reference_ik`` is the reference prep's two IK passes
(``solver/mpc.py::prepare_references``) and kernel B8a's entry point: a CPU
tensor takes ``joint_reference_ik_plain`` (two ``compute_ik`` calls), a
CUDA tensor one launch of ``leg_ik`` (``csrc/leg_ik.cu``) or an error.
"""
from __future__ import annotations

import torch

from ..kernels import _build
from ..models.kinematics import contact_jacobians, fk, frame_placements
from ..models.robot import RobotModel
from ..models.spatial import log3
from ..ocp import soa_kernel
from ..ops.linalg import gj_inverse_plain, inv3

MAX_IT = 5
STEP = 0.7
DAMP = 1e-6
# the (scenario, sample, leg) problems of one launch, counted by a C int
MAX_LEGS = 2 ** 31 - 1


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
    return (gj_inverse_plain(A) @ (Jt @ err[..., None]))[..., 0]


def _set_joints(q, qj):
    return torch.cat([q[..., :6], qj], dim=-1)


def translation_ik(model: RobotModel, q_init, des_pos, max_it: int = MAX_IT, decisions=None):
    """Both legs' translation IK.  des_pos: (..., 2, 3) desired toe positions.
    ``decisions``, a list, receives each step's keep-if-improved mask (..., 2)."""
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
        better = new_err < best_err
        if decisions is not None:
            decisions.append(better)
        improved = torch.repeat_interleave(better, 5, dim=-1)
        best_q = _set_joints(best_q, torch.where(improved, q_new[..., 6:], best_q[..., 6:]))
        best_err = torch.minimum(new_err, best_err)
        q = q_new
    return best_q


def rotation_ik(model: RobotModel, q_init, R_des, max_it: int = MAX_IT, decisions=None):
    """Rotation IK in the null space of the translation Jacobian.
    R_des: (..., 3, 3) world target for both toes; ``decisions`` as in
    ``translation_ik``."""
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
        better = new_err < best_err
        if decisions is not None:
            decisions.append(better)
        improved = torch.repeat_interleave(better, 5, dim=-1)
        best_q = _set_joints(best_q, torch.where(improved, q_new[..., 6:], best_q[..., 6:]))
        best_err = torch.minimum(new_err, best_err)
        q = q_new
    return best_q


def compute_ik(model: RobotModel, q_init, des_pos, R_des, trans_it: int = MAX_IT,
               rot_it: int = MAX_IT, decisions=None):
    """Translation IK then null-space rotation IK; returns (..., nj) joints."""
    q = translation_ik(model, q_init, des_pos, trans_it, decisions)
    q = rotation_ik(model, q, R_des, rot_it, decisions)
    return q[..., 6:].to(q_init.dtype)


def joint_reference_ik_plain(model: RobotModel, poses, warm_joints, des, R_des,
                             trans_it: int = 3, rot_it: int = 2, decisions=None):
    """The JAX package's two parallel IK passes (solver/mpc.py:89-91): every
    sample from ``warm_joints``, then every sample from its own pass-1
    result.  poses (B, S, 6), warm_joints (B, nj), des (B, S, 2, 3) toe
    targets, R_des (B, 3, 3) -> (qj1, joint_refs), both (B, S, nj).
    ``decisions``, a list, receives one list of keep-if-improved masks per
    pass."""
    nj = model.nj
    R = R_des[:, None]

    def solve_all(warm):
        q_ref = torch.cat([poses, warm.expand(*poses.shape[:-1], nj)], dim=-1)
        per_pass = None if decisions is None else []
        out = compute_ik(model, q_ref, des, R, trans_it, rot_it, per_pass)
        if decisions is not None:
            decisions.append(per_pass)
        return out

    qj1 = solve_all(warm_joints[:, None, :])
    return qj1, solve_all(qj1)


def joint_reference_ik(model: RobotModel, poses, warm_joints, des, R_des,
                       trans_it: int = 3, rot_it: int = 2):
    """Kernel B8a: ``joint_reference_ik_plain`` for a CPU tensor, one launch
    of ``leg_ik`` for a CUDA tensor."""
    if poses.device.type == "cpu":
        return joint_reference_ik_plain(model, poses, warm_joints, des, R_des, trans_it, rot_it)
    return leg_ik(model, poses, warm_joints, des, R_des, trans_it, rot_it)


def leg_ik(model: RobotModel, poses, warm_joints, des, R_des, trans_it: int = 3,
           rot_it: int = 2, with_decisions: bool = False):
    """Kernel B8a on the card: both IK passes of every (scenario, sample,
    leg) in one launch of ``hk_leg_ik``, as ``joint_reference_ik_plain``.
    Inputs float32, contiguous, on the card; the model's constants come from
    B1's buffer (``soa_kernel.consts_buffer``, which refuses a model of
    another topology).  Eight lanes per (scenario, sample, leg), two samples
    a warp; raises for 2 B S > 2^31 - 1 (the C interface counts the legs in
    an int).  ``with_decisions``
    adds a third output, every keep-if-improved test (2 passes, trans_it +
    rot_it steps, B, S, 2 legs) as bool, the masks the plain version's
    ``decisions`` list receives."""
    if poses.dim() != 3:
        raise ValueError(f"poses: expected (B, S, 6), got {tuple(poses.shape)}")
    Bn, S, nj = poses.shape[0], poses.shape[1], model.nj
    if not 0 < 2 * Bn * S <= MAX_LEGS:
        raise ValueError(f"leg_ik: 2 B S = {2 * Bn * S} legs, the kernel takes "
                         f"1..{MAX_LEGS}")
    if trans_it < 0 or rot_it < 0:
        raise ValueError(f"leg_ik: iteration counts {trans_it}, {rot_it}")
    dev, f32 = poses.device, torch.float32
    for t, name, shape in ((poses, "poses", (Bn, S, 6)), (warm_joints, "warm_joints", (Bn, nj)),
                           (des, "des", (Bn, S, 2, 3)), (R_des, "R_des", (Bn, 3, 3)),
                           (model.joint_lower, "joint_lower", (nj,)),
                           (model.joint_upper, "joint_upper", (nj,))):
        _build.require(t, name, f32, shape, dev)
    K = soa_kernel.consts_buffer(model, dev)
    qj1 = torch.empty((Bn, S, nj), dtype=f32, device=dev)
    refs = torch.empty_like(qj1)
    kept = (torch.empty((2, trans_it + rot_it, Bn, S, 2), dtype=torch.bool, device=dev)
            if with_decisions else None)
    lib = _build.library()
    _build.check(lib.hk_leg_ik(K.data_ptr(), model.joint_lower.data_ptr(),
                               model.joint_upper.data_ptr(), poses.data_ptr(),
                               warm_joints.data_ptr(), des.data_ptr(), R_des.data_ptr(),
                               qj1.data_ptr(), refs.data_ptr(),
                               None if kept is None else kept.data_ptr(), Bn, S, trans_it,
                               rot_it, STEP, DAMP, _build.stream(poses)), "leg_ik")
    leg_ik.launches += 1
    return (qj1, refs) if kept is None else (qj1, refs, kept)


leg_ik.launches = 0
