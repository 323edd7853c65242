"""Whole-body dynamics by Lagrangian automatic differentiation.

Port of ``hunter_bipedal_control_tpu/models/dynamics.py``.  The mass matrix
is sum_k J_k^T I_k J_k over the link-CoM Jacobians, and every
velocity-dependent term is derived from it by AD (``torch.func``):

    nle(q, v) = d(M v)/dq . v - dT/dq + dV/dq
    C(q, v)   = Christoffel contraction of dM/dq   (Mdot = C + C^T)
    g(q)      = dV/dq

Every function takes any leading batch dims on q and v.
"""
from __future__ import annotations

import torch
from torch.func import grad, jvp

from .kinematics import fk, link_com_jacobians
from .robot import GRAVITY, RobotModel


def mass_matrix(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """(..., nv, nv) joint-space inertia matrix."""
    kin = fk(model, q)
    J = link_com_jacobians(model, kin)          # (..., L, 6, nv)
    Jlin, Jang = J[..., 0:3, :], J[..., 3:6, :]
    Iw = torch.einsum("...kij,kjl,...kml->...kim", kin.R, model.link_inertia, kin.R)
    M = torch.einsum("k,...kiv,...kiw->...vw", model.link_mass, Jlin, Jlin)
    return M + torch.einsum("...kiv,...kij,...kjw->...vw", Jang, Iw, Jang)


def kinetic_energy(model: RobotModel, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return 0.5 * (v[..., None, :] @ mass_matrix(model, q) @ v[..., :, None])[..., 0, 0]


def potential_energy(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    return GRAVITY * (model.link_mass * fk(model, q).com_w[..., 2]).sum(-1)


def gravity_vector(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """(..., nv) generalized gravity g(q).  The batch rows are independent,
    so the gradient of their sum is each row's own gradient."""
    return grad(lambda q_: potential_energy(model, q_).sum())(q)


def nle(model: RobotModel, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., nv) nonlinear effects C(q, v) v + g(q)."""
    dMv = jvp(lambda q_: (mass_matrix(model, q_) @ v[..., None])[..., 0],
              (q.contiguous(),), (v.contiguous(),))[1]
    dTdq = grad(lambda q_: kinetic_energy(model, q_, v).sum())(q)
    return dMv - dTdq + gravity_vector(model, q)


def mass_matrix_and_nle(model: RobotModel, q: torch.Tensor, v: torch.Tensor):
    """(M (..., nv, nv), nle (..., nv)) from one evaluation of M, by
    reverse-mode autograd (the full-order plant's substeps call it eight
    times per tick; ``torch.func``'s forward mode in ``nle`` is slow on the
    CPU where a traced tensor meets the model's constant ones).  nle =
    d(M v)/dq . v - dT/dq + dV/dq: one reverse pass gives G = J' w - dT/dq
    + dV/dq, J = d(M v)/dq, at w = 0; a second one differentiates G . v by
    w, which is J v."""
    with torch.enable_grad():
        qd = q.detach().requires_grad_(True)
        vd = v.detach()
        w = torch.zeros_like(vd, requires_grad=True)
        M = mass_matrix(model, qd)
        Mv = (M @ vd[..., None])[..., 0]
        lagrangian = ((w * Mv).sum() - 0.5 * (vd * Mv).sum()
                      + potential_energy(model, qd).sum())
        G = torch.autograd.grad(lagrangian, qd, create_graph=True)[0]
        dMv = torch.autograd.grad((G * vd).sum(), w)[0]
    return M.detach(), dMv + G.detach()


def mass_matrix_jacobian(model: RobotModel, q: torch.Tensor) -> torch.Tensor:
    """(..., nv, nv, nv) dM_ij/dq_k: one forward-mode pass over nv tangents,
    the batch widened by nv (``jax.jacfwd`` of ``mass_matrix``)."""
    nv = q.shape[-1]
    eye = torch.eye(nv, dtype=q.dtype, device=q.device)
    qk = q[..., None, :].expand(*q.shape[:-1], nv, nv).contiguous()
    tk = eye.expand(*q.shape[:-1], nv, nv).contiguous()
    dM = jvp(lambda q_: mass_matrix(model, q_), (qk,), (tk,))[1]   # (..., k, i, j)
    return dM.movedim(-3, -1)


def coriolis_matrix(model: RobotModel, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., nv, nv) Coriolis matrix: C(q, v) v are the Coriolis forces and
    Mdot = C + C^T."""
    dM = mass_matrix_jacobian(model, q)
    term1 = torch.einsum("...ijk,...k->...ij", dM, v)
    term2 = torch.einsum("...ikj,...k->...ij", dM, v)
    term3 = torch.einsum("...jki,...k->...ij", dM, v)
    return 0.5 * (term1 + term2 - term3)


def inverse_dynamics(model: RobotModel, q, v, a) -> torch.Tensor:
    """(..., nv) generalized forces tau = M a + nle."""
    return (mass_matrix(model, q) @ a[..., None])[..., 0] + nle(model, q, v)


def forward_dynamics(model: RobotModel, q, v, tau_gen) -> torch.Tensor:
    """(..., nv) generalized accelerations under the total generalized force."""
    M = mass_matrix(model, q)
    rhs = tau_gen - nle(model, q, v)
    L = torch.linalg.cholesky(M + 1e-9 * torch.eye(M.shape[-1], dtype=M.dtype, device=M.device))
    y = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]
