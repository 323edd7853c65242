"""Leg-odometry Kalman filter (18 states, 28 measurements), batched.

Port of ``hunter_bipedal_control_tpu/estim/kalman.py``: IMU dead reckoning
fused with leg odometry,

    state  x (18) = [base pos (3), base vel (3), foot positions (4 x 3)]
    meas   y (28) = [-p_foot_rel (12), -v_foot_rel (12), foot heights (4)]

with contact-gated noise inflation, the 28 x 28 innovation solve by
Gauss-Jordan, covariance symmetrization and xy conditioning.  The update is
kernel B12 (``csrc/kalman_update.cu``, one launch per update) for a CUDA
tensor and ``kalman_update_plain`` for a CPU tensor.  Every function takes
a leading batch dim B.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import _build
from ..models.kinematics import contact_jacobians, contact_positions, fk
from ..models.robot import RobotModel
from ..models.spatial import euler_rates_from_global_angular_velocity, quat_to_zyx, rotation_zyx
from ..ocp import soa_kernel
from ..ops.linalg import gj_inverse_plain

NS = 18
NM = 28
NUM_FEET = 4
NJ = 10
# a warp per scenario, four a block (grid.x = ceil(B / 4)); the C
# interface takes B as an int
MAX_BATCH = 2 ** 31 - 1


class KalmanParams(NamedTuple):
    """kalmanFilter block of task.info (0-d tensors)."""

    foot_radius: torch.Tensor
    imu_process_noise_position: torch.Tensor
    imu_process_noise_velocity: torch.Tensor
    foot_process_noise_position: torch.Tensor
    foot_sensor_noise_position: torch.Tensor
    foot_sensor_noise_velocity: torch.Tensor
    foot_height_sensor_noise: torch.Tensor
    high_suspect_number: torch.Tensor


def default_kalman_params(device=None, dtype=torch.float32) -> KalmanParams:
    def t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    return KalmanParams(foot_radius=t(0.02), imu_process_noise_position=t(0.02),
                        imu_process_noise_velocity=t(0.02), foot_process_noise_position=t(0.5),
                        foot_sensor_noise_position=t(0.5), foot_sensor_noise_velocity=t(0.1),
                        foot_height_sensor_noise=t(0.01), high_suspect_number=t(100.0))


class KalmanState(NamedTuple):
    x_hat: torch.Tensor         # (B, 18)
    P: torch.Tensor             # (B, 18, 18)
    feet_heights: torch.Tensor  # (B, 4)


def init_kalman_state(batch: int = 1, device=None, dtype=torch.float32,
                      base_z: float = 0.0) -> KalmanState:
    x = torch.zeros((batch, NS), dtype=dtype, device=device)
    x[:, 2] = base_z
    return KalmanState(x_hat=x,
                       P=100.0 * torch.eye(NS, dtype=dtype, device=device).repeat(batch, 1, 1),
                       feet_heights=torch.zeros((batch, NUM_FEET), dtype=dtype, device=device))


def _structure_matrices(device=None, dtype=torch.float32) -> torch.Tensor:
    """The constant measurement matrix C (28, 18)."""
    C = np.zeros((NM, NS))
    c1 = np.concatenate([np.eye(3), np.zeros((3, 3))], axis=1)
    c2 = np.concatenate([np.zeros((3, 3)), np.eye(3)], axis=1)
    for i in range(4):
        C[3 * i:3 * i + 3, 0:6] = c1
        C[12 + 3 * i:15 + 3 * i, 0:6] = c2
    C[0:12, 6:18] = -np.eye(12)
    C[24, 8] = 1.0
    C[25, 11] = 1.0
    C[26, 14] = 1.0
    C[27, 17] = 1.0
    return torch.as_tensor(C, dtype=dtype, device=device)


def innovation(model: RobotModel, params: KalmanParams, state: KalmanState, zyx, joint_pos,
               joint_vel, omega_world, quat_xyzw, linear_accel_local, contact_flags, dt):
    """The prediction and innovation of one filter tick: (x_pred, Pm, ey,
    Ssy, C), with Ssy (B, 28, 28) the innovation covariance."""
    dtype, dev = state.x_hat.dtype, state.x_hat.device
    Bn = state.x_hat.shape[0]
    zeros3 = torch.zeros((Bn, 3), dtype=dtype, device=dev)
    # relative foot kinematics: base at the origin, orientation applied
    q_pino = torch.cat([zeros3, zyx, joint_pos], dim=-1)
    v_pino = torch.cat([zeros3, euler_rates_from_global_angular_velocity(zyx, omega_world),
                        joint_vel], dim=-1)
    kin = fk(model, q_pino)
    ee_pos = contact_positions(model, kin)                              # (B, 4, 3)
    J = contact_jacobians(model, kin)[..., 0:3, :]
    ee_vel = (J @ v_pino[:, None, :, None])[..., 0]
    ps = -ee_pos
    ps = torch.cat([ps[..., 0:2], ps[..., 2:3] + params.foot_radius], dim=-1).reshape(Bn, 12)
    vs = (-ee_vel).reshape(Bn, 12)
    y = torch.cat([ps, vs, state.feet_heights], dim=-1)

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    A = torch.eye(NS, dtype=dtype, device=dev)
    A[0:3, 3:6] = dt * eye3
    Bm = torch.zeros((NS, 3), dtype=dtype, device=dev)
    Bm[0:3] = 0.5 * dt * dt * eye3
    Bm[3:6] = dt * eye3

    # noise: contact gating interpolates in the contact weight (x hs on swing)
    hs = params.high_suspect_number
    gate = 1.0 + (hs - 1.0) * (1.0 - torch.clamp(contact_flags, 0.0, 1.0))   # (B, 4)
    gate3 = gate.repeat_interleave(3, dim=-1)
    q_diag = torch.cat([
        torch.full((Bn, 3), dt / 20.0, dtype=dtype, device=dev) * params.imu_process_noise_position,
        torch.full((Bn, 3), dt * 9.81 / 20.0, dtype=dtype, device=dev)
        * params.imu_process_noise_velocity,
        (dt * params.foot_process_noise_position) * gate3], dim=-1)
    r_diag = torch.cat([params.foot_sensor_noise_position * gate3,
                        params.foot_sensor_noise_velocity * gate3,
                        params.foot_height_sensor_noise * gate], dim=-1)

    g = torch.tensor([0.0, 0.0, -9.81], dtype=dtype, device=dev)
    accel = (rotation_zyx(quat_to_zyx(quat_xyzw)) @ linear_accel_local[..., None])[..., 0] + g
    C = _structure_matrices(dev, dtype)
    x_pred = state.x_hat @ A.T + accel @ Bm.T
    Pm = A @ state.P @ A.T + torch.diag_embed(q_diag)
    ey = y - x_pred @ C.T
    Ssy = C @ Pm @ C.T + torch.diag_embed(r_diag)
    return x_pred, Pm, ey, Ssy, C


def kalman_update_plain(model: RobotModel, params: KalmanParams, state: KalmanState,
                        zyx, joint_pos, joint_vel, omega_world, quat_xyzw,
                        linear_accel_local, contact_flags, dt):
    """One filter tick for B scenarios; returns (new KalmanState, base
    position (B, 3), base velocity (B, 3)).  ``dt`` is a Python float."""
    x_pred, Pm, ey, Ssy, C = innovation(model, params, state, zyx, joint_pos, joint_vel,
                                        omega_world, quat_xyzw, linear_accel_local,
                                        contact_flags, dt)
    Bn = ey.shape[0]
    sol = gj_inverse_plain(Ssy) @ torch.cat(
        [ey[..., None], C.expand(Bn, NM, NS)], dim=-1)
    s_ey, s_C = sol[..., 0], sol[..., 1:]
    PmCt = Pm @ C.T
    x_new = x_pred + (PmCt @ s_ey[..., None])[..., 0]
    eye = torch.eye(NS, dtype=Pm.dtype, device=Pm.device)
    P_new = (eye - PmCt @ s_C) @ Pm
    P_new = 0.5 * (P_new + P_new.transpose(-1, -2))

    # xy covariance conditioning
    det_xy = P_new[:, 0, 0] * P_new[:, 1, 1] - P_new[:, 0, 1] * P_new[:, 1, 0]
    P_cond = P_new.clone()
    P_cond[:, 0:2, 2:] = 0.0
    P_cond[:, 2:, 0:2] = 0.0
    P_cond[:, 0:2, 0:2] = P_new[:, 0:2, 0:2] / 10.0
    P_new = torch.where((det_xy > 1e-6)[:, None, None], P_cond, P_new)
    new_state = KalmanState(x_hat=x_new, P=P_new, feet_heights=state.feet_heights)
    return new_state, x_new[:, 0:3], x_new[:, 3:6]


def params_buffer(params: KalmanParams) -> torch.Tensor:
    """KalmanParams' eight scalars in order, one float32 tensor on their
    device (one concatenation, no sync)."""
    if any(t.ndim for t in params):
        raise ValueError("kalman_update kernel: the KalmanParams fields must be 0-d")
    return torch.cat([t.reshape(1).to(torch.float32) for t in params])


def kalman_update(model: RobotModel, params: KalmanParams, state: KalmanState,
                  zyx, joint_pos, joint_vel, omega_world, quat_xyzw,
                  linear_accel_local, contact_flags, dt):
    """Kernel B12: one filter tick for B scenarios.

    CPU: ``kalman_update_plain``.  CUDA: one launch of ``hk_kalman_update``
    (a warp per scenario, four a block), or an error: the sensors zyx,
    omega_world, linear_accel_local (B, 3), joint_pos, joint_vel (B, 10), quat_xyzw,
    contact_flags (B, 4) and the state's x_hat (B, 18), P (B, 18, 18),
    feet_heights (B, 4) float32 on the card (made contiguous here); the
    model's constants from B1's buffer (``soa_kernel.consts_buffer``, which
    refuses a model of another topology).  Returns (new KalmanState, base
    position (B, 3), base velocity (B, 3)); ``dt`` is a Python float."""
    if state.x_hat.device.type == "cpu":
        return kalman_update_plain(model, params, state, zyx, joint_pos, joint_vel, omega_world,
                                   quat_xyzw, linear_accel_local, contact_flags, dt)
    if state.x_hat.dim() != 2:
        raise ValueError(f"x_hat: expected (B, 18), got {tuple(state.x_hat.shape)}")
    Bn, dev, f32 = state.x_hat.shape[0], state.x_hat.device, torch.float32
    if not 0 < Bn <= MAX_BATCH:
        raise ValueError(f"kalman_update: B = {Bn} scenarios, the kernel takes 1..{MAX_BATCH}")
    ins = [t.contiguous() for t in (zyx, joint_pos, joint_vel, omega_world, quat_xyzw,
                                    linear_accel_local, contact_flags, state.x_hat, state.P,
                                    state.feet_heights)]
    names = ("zyx", "joint_pos", "joint_vel", "omega_world", "quat_xyzw",
             "linear_accel_local", "contact_flags", "x_hat", "P", "feet_heights")
    shapes = ((Bn, 3), (Bn, NJ), (Bn, NJ), (Bn, 3), (Bn, 4), (Bn, 3), (Bn, NUM_FEET), (Bn, NS),
              (Bn, NS, NS), (Bn, NUM_FEET))
    for t, name, shape in zip(ins, names, shapes):
        _build.require(t, name, f32, shape, dev)
    K = soa_kernel.consts_buffer(model, dev)
    P = params_buffer(params)
    _build.require(P, "params", f32, (len(KalmanParams._fields),), dev)
    x_new = torch.empty((Bn, NS), dtype=f32, device=dev)
    P_new = torch.empty((Bn, NS, NS), dtype=f32, device=dev)
    lib = _build.library()
    _build.check(lib.hk_kalman_update(*(t.data_ptr() for t in (K, P, *ins, x_new, P_new)), Bn,
                                      float(dt), _build.stream(x_new)), "kalman_update")
    kalman_update.launches += 1
    new_state = KalmanState(x_hat=x_new, P=P_new, feet_heights=state.feet_heights)
    return new_state, x_new[:, 0:3], x_new[:, 3:6]


kalman_update.launches = 0


def reset_kalman(batch: int = 1, device=None, dtype=torch.float32) -> KalmanState:
    """The /reset_estimation behaviour."""
    return init_kalman_state(batch, device, dtype)


def fuse_external_position(model: RobotModel, state: KalmanState, params: KalmanParams,
                           new_pos, zyx, joint_pos, contact_flags) -> KalmanState:
    """External odometry fusion: overwrite the base position, recompute the
    foot states from FK at the new base, and pin the contacting feet's heights."""
    feet = contact_positions(model, fk(model, torch.cat([new_pos, zyx, joint_pos], dim=-1)))
    feet = torch.cat([feet[..., 0:2], feet[..., 2:3] - params.foot_radius], dim=-1)
    x = torch.cat([new_pos, state.x_hat[:, 3:6], feet.reshape(-1, 12)], dim=-1)
    heights = torch.where(contact_flags > 0.5, feet[..., 2], state.feet_heights)
    return state._replace(x_hat=x, feet_heights=heights)
