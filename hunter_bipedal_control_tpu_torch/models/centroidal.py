"""Full centroidal dynamics model.

Port of ``hunter_bipedal_control_tpu/models/centroidal.py`` (the parts on
the MPC step's and the control tick's paths).  Layouts as in the JAX package:

    x (12+nj) = [h_com/m (6); base pose p_xyz (3), theta_zyx (3); joints (nj)]
    u (3*nc+nj) = [contact forces world frame (nc*3); joint velocities (nj)]

All functions take any leading batch dims.  Two of them are kernel
wrappers: ``rbd_state_to_centroidal`` (kernel B13b, ``csrc/sensing.cu``)
and ``state_input_to_v`` (kernel B14b, ``csrc/centroidal_flow.cu``) take
their plain versions (``*_plain``) for CPU tensors and launch the kernel
for CUDA tensors, or raise.  ``flow_map`` stays plain: the dense
linearization and ``base_kinematics_from_centroidal`` differentiate it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp

from ..kernels import _build
from ..ocp import soa_kernel
from ..ops.linalg import inv3
from .kinematics import KinData, contact_positions, fk, link_com_jacobians
from .robot import GRAVITY, RobotModel
from .spatial import (euler_rate_map_zyx, euler_rates_from_global_angular_velocity,
                      global_angular_velocity_from_euler_rates)

# the kernels' widths: the compiled model's state and configuration (nj = 10)
NX = 22
NQ = 16


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


def state_input_to_v_plain(model: RobotModel, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Full generalized velocity v = [v_base (6); vj] from (x, u)."""
    kin = fk(model, state_to_q(x))
    vj = joint_velocities(u, model.nj)
    vb = base_velocity_from_momentum(model, kin, x[..., 0:6], vj)
    return torch.cat([vb, vj], dim=-1)


def state_input_to_v(model: RobotModel, x: torch.Tensor, u: torch.Tensor, with_rbd=False):
    """Kernel B14b: the generalized velocity v (..., 16) from (x, u), and
    with ``with_rbd`` also the rbd state ``q_v_to_rbd_state`` makes of
    (x[6:], v) (..., 32).

    CPU: ``state_input_to_v_plain``.  CUDA: one launch of
    ``hk_state_input_to_v``, one thread per scenario, or an error: x and u
    (..., 22) float32 on the card (made contiguous here); the model's
    constants from B1's buffer (``soa_kernel.consts_buffer``, which refuses
    a model of another topology)."""
    if x.device.type == "cpu":
        v = state_input_to_v_plain(model, x, u)
        return (v, q_v_to_rbd_state(model, state_to_q(x), v)) if with_rbd else v
    xr, lead = _build.rows(x, "x", NX)
    ur, _ = _build.rows(u, "u", NX)
    Bn, dev, f32 = xr.shape[0], xr.device, torch.float32
    _build.require(xr, "x", f32, (Bn, NX), dev)
    _build.require(ur, "u", f32, (Bn, NX), dev)
    K = soa_kernel.consts_buffer(model, dev)
    v = torch.empty((Bn, NQ), dtype=f32, device=dev)
    rbd = torch.empty((Bn, 2 * NQ), dtype=f32, device=dev) if with_rbd else None
    _build.check(_build.library().hk_state_input_to_v(
        K.data_ptr(), xr.data_ptr(), ur.data_ptr(), v.data_ptr(),
        None if rbd is None else rbd.data_ptr(), Bn, _build.stream(xr)), "state_input_to_v")
    state_input_to_v.launches += 1
    v = v.reshape(*lead, NQ)
    return (v, rbd.reshape(*lead, 2 * NQ)) if with_rbd else v


state_input_to_v.launches = 0


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


class BaseKinematics(NamedTuple):
    pose: torch.Tensor          # (..., 6) [p_xyz, theta_zyx]
    velocity: torch.Tensor      # (..., 6) [dp world, omega world]
    acceleration: torch.Tensor  # (..., 6) [ddp world, domega world]


def base_kinematics_from_centroidal(model: RobotModel, x: torch.Tensor,
                                    u: torch.Tensor) -> BaseKinematics:
    """Base pose, velocity and acceleration of the desired state, with zero
    joint accelerations (u held fixed along the flow)."""
    vj = joint_velocities(u, model.nj)

    def vb_fn(x_):
        return base_velocity_from_momentum(model, fk(model, state_to_q(x_)), x_[..., 0:6], vj)

    vb, vb_dot = jvp(vb_fn, (x.contiguous(),), (flow_map(model, x, u),))
    theta = x[..., 9:12]
    E, Edot = jvp(euler_rate_map_zyx, (theta.contiguous(),), (vb[..., 3:6].contiguous(),))
    omega = (E @ vb[..., 3:6, None])[..., 0]
    omega_dot = (E @ vb_dot[..., 3:6, None] + Edot @ vb[..., 3:6, None])[..., 0]
    return BaseKinematics(pose=x[..., 6:12],
                          velocity=torch.cat([vb[..., 0:3], omega], dim=-1),
                          acceleration=torch.cat([vb_dot[..., 0:3], omega_dot], dim=-1))


# rbd state (2 (6+nj)) = [theta_zyx (3), p (3), qj (nj), omega_world (3), dp (3), dqj (nj)]

def rbd_to_q_v(rbd: torch.Tensor):
    """(q, v) in the Euler-rate parameterization from an rbd state."""
    ngc = rbd.shape[-1] // 2
    theta, omega = rbd[..., 0:3], rbd[..., ngc:ngc + 3]
    q = torch.cat([rbd[..., 3:6], theta, rbd[..., 6:ngc]], dim=-1)
    v = torch.cat([rbd[..., ngc + 3:ngc + 6],
                   euler_rates_from_global_angular_velocity(theta, omega), rbd[..., ngc + 6:]],
                  dim=-1)
    return q, v


def rbd_state_to_centroidal_plain(model: RobotModel, rbd: torch.Tensor) -> torch.Tensor:
    """Centroidal state x from an rbd state."""
    q, v = rbd_to_q_v(rbd)
    A = centroidal_momentum_matrix(model, fk(model, q))
    h_norm = (A @ v[..., None])[..., 0] / model.total_mass
    return torch.cat([h_norm, q], dim=-1)


def rbd_state_to_centroidal(model: RobotModel, rbd: torch.Tensor) -> torch.Tensor:
    """Kernel B13b: the centroidal state x (..., 22) from an rbd state
    (..., 32), h = A v summed as the links' momenta about the CoM.

    CPU: ``rbd_state_to_centroidal_plain``.  CUDA: one launch of
    ``hk_rbd_to_centroidal``, one thread per scenario, or an error: rbd
    float32 on the card (made contiguous here); the model's constants from
    B1's buffer (``soa_kernel.consts_buffer``)."""
    if rbd.device.type == "cpu":
        return rbd_state_to_centroidal_plain(model, rbd)
    r, lead = _build.rows(rbd, "rbd", 2 * NQ)
    Bn, dev, f32 = r.shape[0], r.device, torch.float32
    _build.require(r, "rbd", f32, (Bn, 2 * NQ), dev)
    K = soa_kernel.consts_buffer(model, dev)
    x = torch.empty((Bn, NX), dtype=f32, device=dev)
    _build.check(_build.library().hk_rbd_to_centroidal(K.data_ptr(), r.data_ptr(), x.data_ptr(),
                                                        Bn, _build.stream(r)),
                 "rbd_to_centroidal")
    rbd_state_to_centroidal.launches += 1
    return x.reshape(*lead, NX)


rbd_state_to_centroidal.launches = 0


def q_v_to_rbd_state(model: RobotModel, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    omega = global_angular_velocity_from_euler_rates(q[..., 3:6], v[..., 3:6])
    return torch.cat([q[..., 3:6], q[..., 0:3], q[..., 6:], omega, v[..., 0:3], v[..., 6:]],
                     dim=-1)
