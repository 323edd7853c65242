"""Rotation / spatial algebra (ZYX-Euler floating-base convention).

Port of ``hunter_bipedal_control_tpu/models/spatial.py``.  Every function
takes any leading batch dims: a vector argument is (..., 3), a matrix
(..., 3, 3).
"""
from __future__ import annotations

import torch


def _mat3(rows):
    """Stack a 3x3 nested list of (...)-shaped tensors into (..., 3, 3)."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotation_zyx(zyx):
    """World_R_body from ZYX Euler angles (yaw z, pitch y, roll x)."""
    z, y, x = zyx[..., 0], zyx[..., 1], zyx[..., 2]
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    cx, sx = torch.cos(x), torch.sin(x)
    return _mat3([
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
        [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
        [-sy, cy * sx, cy * cx],
    ])


def euler_rate_map_zyx(zyx):
    """E(theta) with omega_world = E @ dtheta_zyx."""
    z, y = zyx[..., 0], zyx[..., 1]
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    zero, one = torch.zeros_like(z), torch.ones_like(z)
    return _mat3([
        [zero, -sz, cz * cy],
        [zero, cz, sz * cy],
        [one, zero, -sy],
    ])


def euler_rate_map_zyx_jacobian(zyx):
    """dE/dtheta (..., 3, 3, 3), last axis = theta_i — the closed form of
    ``jax.jacfwd(euler_rate_map_zyx)`` (theta_2, roll, does not enter E)."""
    z, y = zyx[..., 0], zyx[..., 1]
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    zero = torch.zeros_like(z)
    d_z = _mat3([[zero, -cz, -sz * cy], [zero, -sz, cz * cy], [zero, zero, zero]])
    d_y = _mat3([[zero, zero, -cz * sy], [zero, zero, -sz * sy], [zero, zero, -cy]])
    return torch.stack([d_z, d_y, torch.zeros_like(d_z)], dim=-1)


def skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    zero = torch.zeros_like(v[..., 0])
    return _mat3([
        [zero, -v[..., 2], v[..., 1]],
        [v[..., 2], zero, -v[..., 0]],
        [-v[..., 1], v[..., 0], zero],
    ])


def axis_angle_rotation(axis, angle):
    """Rodrigues rotation about a (unit) axis (3,) by angle (...)."""
    c, s = torch.cos(angle)[..., None, None], torch.sin(angle)[..., None, None]
    K = skew(axis)
    return torch.eye(3, dtype=K.dtype, device=K.device) + s * K + (1.0 - c) * (K @ K)


def zyx_to_quat(zyx):
    """ZYX Euler (yaw, pitch, roll) -> quaternion (x, y, z, w)."""
    hz, hy, hx = 0.5 * zyx[..., 0], 0.5 * zyx[..., 1], 0.5 * zyx[..., 2]
    cz, sz = torch.cos(hz), torch.sin(hz)
    cy, sy = torch.cos(hy), torch.sin(hy)
    cx, sx = torch.cos(hx), torch.sin(hx)
    w = cz * cy * cx + sz * sy * sx
    x = cz * cy * sx - sz * sy * cx
    y = cz * sy * cx + sz * cy * sx
    z = sz * cy * cx - cz * sy * sx
    return torch.stack([x, y, z, w], dim=-1)


def log3(R):
    """SO(3) log map: (..., 3, 3) rotation -> (..., 3) rotation vector."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    vee = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                             R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    small = theta < 1e-6
    scale = torch.where(small, 1.0 + theta * theta / 6.0,
                        theta / torch.sin(torch.where(small, torch.ones_like(theta), theta)))
    return scale[..., None] * vee


def global_angular_velocity_from_euler_rates(zyx, dzyx):
    """omega_world = E(zyx) @ dzyx; (..., 3) -> (..., 3)."""
    return (euler_rate_map_zyx(zyx) @ dzyx[..., None])[..., 0]


def euler_rates_from_global_angular_velocity(zyx, omega_world):
    """Inverse of :func:`euler_rate_map_zyx` (closed form; singular at |pitch| = pi/2)."""
    z, y = zyx[..., 0], zyx[..., 1]
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    ty = sy / cy
    zero, one = torch.zeros_like(z), torch.ones_like(z)
    Einv = _mat3([
        [cz * ty, sz * ty, one],
        [-sz, cz, zero],
        [cz / cy, sz / cy, zero],
    ])
    return (Einv @ omega_world[..., None])[..., 0]


def quat_to_zyx(quat_xyzw):
    """Quaternion (x, y, z, w) -> ZYX Euler (yaw, pitch, roll)."""
    x, y, z, w = quat_xyzw[..., 0], quat_xyzw[..., 1], quat_xyzw[..., 2], quat_xyzw[..., 3]
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    return torch.stack([yaw, pitch, roll], dim=-1)


def rotation_error_in_world(R_des, R_meas):
    """World-frame rotation error of the WBC base-angular task:
    R_meas @ log3(R_meas^T @ R_des)."""
    err = log3(R_meas.transpose(-1, -2) @ R_des)
    return (R_meas @ err[..., None])[..., 0]
