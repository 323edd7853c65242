"""Cubic Hermite splines on normalized time.

Port of ``hunter_bipedal_control_tpu/refs/splines.py``: node arrays carry
any leading batch dims, one query time per spline.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class PiecewiseCubic(NamedTuple):
    """n-node piecewise cubic: times (..., n), pos (..., n), vel (..., n)."""

    times: torch.Tensor
    pos: torch.Tensor
    vel: torch.Tensor


def _hermite_coeffs(t0, p0, v0, t1, p1, v1):
    """Coefficients a + b s + c s^2 + d s^3 on normalized s (CubicSpline.cpp:100-125)."""
    dt = torch.clamp(t1 - t0, min=1e-6)
    dv0 = v0 * dt
    dv1 = v1 * dt
    a = p0
    b = dv0
    c = -(3.0 * p0 + 2.0 * dv0 + dv1 - 3.0 * p1)
    d = 2.0 * p0 + dv0 + dv1 - 2.0 * p1
    return a, b, c, d, dt


def eval_piecewise(spline: PiecewiseCubic, t):
    """(position, velocity, acceleration) at time t (...) of splines with
    node arrays (..., n)."""
    times = spline.times
    n_seg = times.shape[-1] - 1
    t = t.expand(times.shape[:-1])
    i = torch.searchsorted(times.contiguous(), t.contiguous()[..., None], right=True) - 1
    i = torch.clamp(i, 0, n_seg - 1)

    def at(a, j):
        return torch.gather(a, -1, j)[..., 0]

    t0, t1 = at(times, i), at(times, i + 1)
    a, b, c, d, dt = _hermite_coeffs(
        t0, at(spline.pos, i), at(spline.vel, i), t1, at(spline.pos, i + 1), at(spline.vel, i + 1)
    )
    s = torch.clamp((t - t0) / dt, 0.0, 1.0)
    pos = a + b * s + c * s * s + d * s * s * s
    vel = (b + 2.0 * c * s + 3.0 * d * s * s) / dt
    acc = (2.0 * c + 6.0 * d * s) / (dt * dt)
    return pos, vel, acc
