"""Sensor noise and bias models for the full-order backend.

Port of the in-graph half of ``hunter_bipedal_control_tpu/backends/
sensor_noise.py``: the IMU covariances the reference declares for its
Gazebo backend (legged_gazebo/config/default.yaml: orientation 0.0012,
angular velocity 0.0004, linear acceleration 0.01, diagonal), slowly
walking gyro and accelerometer biases, and encoder noise.  Batched over B
scenarios.

JAX threads a PRNG key through the loop; here the draws come from a
``torch.Generator`` that the state carries (the generator is advanced in
place).  The two streams differ, so ``corrupt`` also takes its draws as an
argument, and the tests feed it the JAX package's own.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.spatial import quat_to_zyx, zyx_to_quat


class SensorNoiseParams(NamedTuple):
    """Per-sample standard deviations (the square roots of the reference's
    declared diagonal covariances) and bias random-walk intensities, 0-d."""

    ori_std: torch.Tensor          # rad, sqrt(0.0012) ~ 0.035
    gyro_std: torch.Tensor         # rad/s, sqrt(0.0004) = 0.02
    accel_std: torch.Tensor        # m/s^2, sqrt(0.01) = 0.1
    encoder_pos_std: torch.Tensor  # rad
    encoder_vel_std: torch.Tensor  # rad/s
    gyro_bias_std: torch.Tensor    # initial bias draw, rad/s
    accel_bias_std: torch.Tensor   # initial bias draw, m/s^2
    bias_walk_std: torch.Tensor    # random-walk intensity per sqrt(s)


def default_sensor_noise_params(device=None, dtype=torch.float32) -> SensorNoiseParams:
    def t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    return SensorNoiseParams(ori_std=t(math.sqrt(0.0012)), gyro_std=t(math.sqrt(0.0004)),
                             accel_std=t(math.sqrt(0.01)), encoder_pos_std=t(5e-4),
                             encoder_vel_std=t(5e-3), gyro_bias_std=t(2e-3),
                             accel_bias_std=t(2e-2), bias_walk_std=t(1e-3))


class NoiseState(NamedTuple):
    generator: torch.Generator  # advanced in place by every draw
    gyro_bias: torch.Tensor     # (B, 3)
    accel_bias: torch.Tensor    # (B, 3)


def init_noise_state(params: SensorNoiseParams, seed=0, batch: int = 1, device=None,
                     dtype=torch.float32, generator=None) -> NoiseState:
    """Initial biases drawn from ``generator`` (or a new one seeded with
    ``seed`` on ``device``)."""
    gen = generator if generator is not None else torch.Generator(
        device=torch.device("cpu" if device is None else device)).manual_seed(seed)
    dev = gen.device

    def n():
        return torch.randn((batch, 3), generator=gen, dtype=dtype, device=dev)

    return NoiseState(generator=gen, gyro_bias=params.gyro_bias_std * n(),
                      accel_bias=params.accel_bias_std * n())


def corrupt(params: SensorNoiseParams, state: NoiseState, quat_xyzw, omega_local,
            accel_local, joint_pos, joint_vel, dt, draws=None):
    """One tick of sensor corruption for B scenarios.  Returns (new
    NoiseState, quat, omega, accel, joint_pos, joint_vel).

    ``draws``: the standard-normal draws in the JAX package's key order:
    the gyro and accelerometer bias walks, the orientation, gyro and
    accelerometer noise (B, 3) each, the encoder position and velocity
    noise (B, nj) each; taken from the state's generator when None."""
    dtype, dev = omega_local.dtype, omega_local.device
    if draws is None:
        gen = state.generator
        draws = [torch.randn(x.shape, generator=gen, dtype=dtype, device=gen.device).to(dev)
                 for x in (omega_local,) * 5 + (joint_pos, joint_vel)]
    n_gw, n_aw, n_ori, n_gyro, n_acc, n_qj, n_vj = draws
    sdt = torch.sqrt(torch.tensor(dt, dtype=dtype))
    gyro_bias = state.gyro_bias + params.bias_walk_std * sdt * n_gw
    accel_bias = state.accel_bias + params.bias_walk_std * sdt * n_aw
    # orientation: small additive Euler-angle noise (away from gimbal lock
    # this is a small-angle rotation perturbation)
    zyx = quat_to_zyx(quat_xyzw) + params.ori_std * n_ori
    quat = zyx_to_quat(zyx)
    omega = omega_local + gyro_bias + params.gyro_std * n_gyro
    accel = accel_local + accel_bias + params.accel_std * n_acc
    qj = joint_pos + params.encoder_pos_std * n_qj
    vj = joint_vel + params.encoder_vel_std * n_vj
    return (NoiseState(generator=state.generator, gyro_bias=gyro_bias, accel_bias=accel_bias),
            quat, omega, accel, qj, vj)
