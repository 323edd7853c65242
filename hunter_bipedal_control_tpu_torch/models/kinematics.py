"""Forward kinematics and frame Jacobians (world-aligned convention).

Port of ``hunter_bipedal_control_tpu/models/kinematics.py``.  The chain is
unrolled over the (fixed, small) joint count; every function takes any
leading batch dims on ``q`` and the returned KinData carries them.

The JAX ``fk`` carries a ``jax.custom_jvp`` whose tangents are the exact
closed forms of the primal Jacobians.  Here forward-mode autograd through
the plain chain (``torch.func.jvp``) gives the same tangents up to
rounding, which the parity tests hold at rtol 1e-9 in float64.

Jacobian row convention: rows 0:3 linear, 3:6 angular.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp

from .robot import RobotModel
from .spatial import axis_angle_rotation, euler_rate_map_zyx, rotation_zyx


class KinData(NamedTuple):
    """World placement of every moving link + joint axes."""

    R: torch.Tensor             # (..., n_links, 3, 3) world_R_link
    p: torch.Tensor             # (..., n_links, 3)
    joint_axis_w: torch.Tensor  # (..., nj, 3)
    joint_pos_w: torch.Tensor   # (..., nj, 3)
    com_w: torch.Tensor         # (..., n_links, 3)
    E: torch.Tensor             # (..., 3, 3) euler-rate map


def fk(model: RobotModel, q: torch.Tensor) -> KinData:
    """Forward kinematics for all links. q: (..., 6+nj)."""
    base_p = q[..., 0:3]
    base_R = rotation_zyx(q[..., 3:6])
    qj = q[..., 6:]

    Rs = [None] * model.n_links
    ps = [None] * model.n_links
    Rs[0], ps[0] = base_R, base_p
    axis_w = [None] * model.nj
    anchor_w = [None] * model.nj
    parents = model.joint_parent.tolist()
    children = model.joint_child.tolist()

    for j in range(model.nj):
        parent, child = parents[j], children[j]
        Rp, pp = Rs[parent], ps[parent]
        R_origin = Rp @ model.joint_origin_rot[j]
        p_origin = pp + (Rp @ model.joint_origin_pos[j][:, None])[..., 0]
        a_w = (R_origin @ model.joint_axis[j][:, None])[..., 0]
        Rs[child] = R_origin @ axis_angle_rotation(model.joint_axis[j], qj[..., j])
        ps[child] = p_origin
        axis_w[j] = a_w
        anchor_w[j] = p_origin

    R = torch.stack(Rs, dim=-3)
    p = torch.stack(ps, dim=-2)
    com_w = p + torch.einsum("...kij,kj->...ki", R, model.link_com)
    return KinData(
        R=R,
        p=p,
        joint_axis_w=torch.stack(axis_w, dim=-2),
        joint_pos_w=torch.stack(anchor_w, dim=-2),
        com_w=com_w,
        E=euler_rate_map_zyx(q[..., 3:6]),
    )


def frame_placements(model: RobotModel, kin: KinData):
    """World rotation/position of every named frame: ((..., nf, 3, 3), (..., nf, 3))."""
    Rp = kin.R[..., model.frame_parent, :, :]
    pp = kin.p[..., model.frame_parent, :]
    R = torch.einsum("...fij,fjk->...fik", Rp, model.frame_rot)
    p = pp + torch.einsum("...fij,fj->...fi", Rp, model.frame_pos)
    return R, p


def contact_positions(model: RobotModel, kin: KinData) -> torch.Tensor:
    """(..., nc, 3) world positions of the contact frames."""
    _, p = frame_placements(model, kin)
    return p[..., model.contact_frame_ids, :]


def _skew_batch(v):
    """(..., 3) -> (..., 3, 3)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def _point_jacobians(model: RobotModel, kin: KinData, points_w: torch.Tensor,
                     link_ids) -> torch.Tensor:
    """Jacobians of world points rigidly attached to links.

    points_w: (..., P, 3); link_ids: (P,) host int64.
    Returns (..., P, 6, nv) with rows [linear; angular], LOCAL_WORLD_ALIGNED.
    """
    P = points_w.shape[-2]
    batch = points_w.shape[:-2]
    dtype, dev = points_w.dtype, points_w.device
    mask = model.ancestor_mask[link_ids].to(dtype)                   # (P, nj)

    r = points_w[..., :, None, :] - kin.joint_pos_w[..., None, :, :]  # (..., P, nj, 3)
    axis = kin.joint_axis_w[..., None, :, :].expand(r.shape)
    lin_j = torch.linalg.cross(axis, r, dim=-1) * mask[:, :, None]
    ang_j = axis * mask[:, :, None]

    rb = points_w - kin.p[..., 0:1, :]                               # (..., P, 3)
    lin_base_trans = torch.eye(3, dtype=dtype, device=dev).expand(*batch, P, 3, 3)
    lin_base_rot = -(_skew_batch(rb) @ kin.E[..., None, :, :])       # (..., P, 3, 3)
    ang_base_rot = kin.E[..., None, :, :].expand(*batch, P, 3, 3)

    lin = torch.cat([lin_base_trans, lin_base_rot, lin_j.transpose(-1, -2)], dim=-1)
    ang = torch.cat([torch.zeros(*batch, P, 3, 3, dtype=dtype, device=dev),
                     ang_base_rot, ang_j.transpose(-1, -2)], dim=-1)
    return torch.cat([lin, ang], dim=-2)


def contact_jacobians(model: RobotModel, kin: KinData) -> torch.Tensor:
    """(..., nc, 6, nv) frame Jacobians of the contact frames."""
    pts = contact_positions(model, kin)
    link_ids = model.frame_parent[model.contact_frame_ids]
    return _point_jacobians(model, kin, pts, link_ids)


def base_jacobian(model: RobotModel, kin: KinData) -> torch.Tensor:
    """(..., 6, nv) frame Jacobian of the base link."""
    return _point_jacobians(model, kin, kin.p[..., 0:1, :], torch.zeros(1, dtype=torch.int64))[
        ..., 0, :, :]


def link_com_jacobians(model: RobotModel, kin: KinData) -> torch.Tensor:
    """(..., n_links, 6, nv) Jacobians at each link CoM."""
    return _point_jacobians(model, kin, kin.com_w, torch.arange(model.n_links))


# Time derivatives along v: v == dq/dt in the Euler-rate parameterization,
# so d/dt F(q) = jvp(F, q, v).

def contact_velocities(model: RobotModel, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., nc, 3) world-frame linear velocities of the contact points."""
    J = contact_jacobians(model, fk(model, q))
    return (J[..., 0:3, :] @ v[..., None, :, None])[..., 0]


def contact_jacobians_dot(model: RobotModel, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., nc, 6, nv) dJ/dt of the contact frame Jacobians."""
    return jvp(lambda q_: contact_jacobians(model, fk(model, q_)),
               (q.contiguous(),), (v.contiguous(),))[1]


def base_jacobian_dot(model: RobotModel, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 6, nv) dJ/dt of the base Jacobian."""
    return jvp(lambda q_: base_jacobian(model, fk(model, q_)),
               (q.contiguous(),), (v.contiguous(),))[1]
