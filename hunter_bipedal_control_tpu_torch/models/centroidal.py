"""Full centroidal dynamics model.

Port of ``hunter_bipedal_control_tpu/models/centroidal.py`` (the parts on
the MPC step's path).  Layouts as in the JAX package:

    x (12+nj) = [h_com/m (6); base pose p_xyz (3), theta_zyx (3); joints (nj)]
    u (3*nc+nj) = [contact forces world frame (nc*3); joint velocities (nj)]

All functions take any leading batch dims.
"""
from __future__ import annotations

import torch

from ..ops.linalg import inv3
from .kinematics import KinData, contact_positions, fk, link_com_jacobians
from .robot import GRAVITY, RobotModel


def com_position(model: RobotModel, kin: KinData) -> torch.Tensor:
    return (model.link_mass[:, None] * kin.com_w).sum(-2) / model.total_mass


def centroidal_momentum_matrix(model: RobotModel, kin: KinData) -> torch.Tensor:
    """(..., 6, nv) CMM A(q): rows [linear momentum; angular momentum about the CoM]."""
    J = link_com_jacobians(model, kin)                  # (..., L, 6, nv)
    Jlin, Jang = J[..., 0:3, :], J[..., 3:6, :]
    Iw = torch.einsum("...kij,kjl,...kml->...kim", kin.R, model.link_inertia, kin.R)
    p_com = com_position(model, kin)
    r = kin.com_w - p_com[..., None, :]                 # (..., L, 3)
    A_lin = torch.einsum("k,...kiv->...iv", model.link_mass, Jlin)
    zero = torch.zeros_like(r[..., 0])
    rx = torch.stack(
        [
            torch.stack([zero, -r[..., 2], r[..., 1]], dim=-1),
            torch.stack([r[..., 2], zero, -r[..., 0]], dim=-1),
            torch.stack([-r[..., 1], r[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )
    A_ang = torch.einsum("...kij,...kjv->...iv", Iw, Jang) + torch.einsum(
        "k,...kij,...kjv->...iv", model.link_mass, rx, Jlin
    )
    return torch.cat([A_lin, A_ang], dim=-2)


def state_to_q(x: torch.Tensor) -> torch.Tensor:
    return x[..., 6:]


def joint_velocities(u: torch.Tensor, nj: int) -> torch.Tensor:
    return u[..., u.shape[-1] - nj:]


def contact_forces(u: torch.Tensor, nc: int) -> torch.Tensor:
    return u[..., : 3 * nc].reshape(*u.shape[:-1], nc, 3)


def base_block_solve(model: RobotModel, Ab: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve A_b x = rhs through the block-upper-triangular structure of the
    CMM base block ([[m I3, A12], [0, A22]]): one closed-form 3x3 inverse.
    rhs may be (..., 6) or (..., 6, k)."""
    vec = rhs.ndim == Ab.ndim - 1
    if vec:
        rhs = rhs[..., None]
    A12 = Ab[..., 0:3, 3:6]
    A22 = Ab[..., 3:6, 3:6]
    x2 = inv3(A22) @ rhs[..., 3:6, :]
    x1 = (rhs[..., 0:3, :] - A12 @ x2) / model.total_mass
    x = torch.cat([x1, x2], dim=-2)
    return x[..., 0] if vec else x


def base_velocity_from_momentum(model: RobotModel, kin: KinData, h_norm: torch.Tensor,
                                vj: torch.Tensor) -> torch.Tensor:
    """(..., 6) [dp_base; dtheta_zyx] solving A_b v_b = m h_norm - A_j v_j."""
    A = centroidal_momentum_matrix(model, kin)
    Ab, Aj = A[..., :, 0:6], A[..., :, 6:]
    rhs = model.total_mass * h_norm - (Aj @ vj[..., None])[..., 0]
    return base_block_solve(model, Ab, rhs)


def flow_map(model: RobotModel, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Centroidal dynamics x_dot = f(x, u)."""
    nc, nj = model.num_contacts, model.nj
    kin = fk(model, state_to_q(x))
    forces = contact_forces(u, nc)                      # (..., nc, 3)
    vj = joint_velocities(u, nj)

    p_com = com_position(model, kin)
    p_c = contact_positions(model, kin)                 # (..., nc, 3)

    m = model.total_mass
    g = torch.tensor([0.0, 0.0, -GRAVITY], dtype=x.dtype, device=x.device)
    hdot_lin = forces.sum(-2) / m + g
    hdot_ang = torch.linalg.cross(p_c - p_com[..., None, :], forces, dim=-1).sum(-2) / m

    vb = base_velocity_from_momentum(model, kin, x[..., 0:6], vj)
    return torch.cat([hdot_lin, hdot_ang, vb, vj], dim=-1)
