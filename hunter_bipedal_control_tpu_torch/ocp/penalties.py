"""Soft-constraint penalty functions (closed-form value/grad/hess).

Port of ``hunter_bipedal_control_tpu/ocp/penalties.py``; elementwise, any shape.
"""
from __future__ import annotations

import torch


def relaxed_barrier(h, mu, delta):
    """-mu ln(h) for h > delta, quadratic extension below.  Returns (p, dp, d2p)."""
    delta_t = torch.as_tensor(delta, dtype=h.dtype, device=h.device)
    safe_h = torch.maximum(h, delta_t)
    log_branch = -mu * torch.log(safe_h)
    dlog = -mu / safe_h
    d2log = mu / (safe_h * safe_h)

    z = (h - 2.0 * delta) / delta
    quad_branch = mu * 0.5 * (z * z - 1.0) - mu * torch.log(delta_t)
    dquad = mu * z / delta
    d2quad = mu / (delta * delta) * torch.ones_like(h)

    use_log = h > delta
    p = torch.where(use_log, log_branch, quad_branch)
    dp = torch.where(use_log, dlog, dquad)
    d2p = torch.where(use_log, d2log, d2quad)
    return p, dp, d2p


def double_sided_relaxed_barrier(h, lower, upper, mu, delta):
    """Barrier on both (h - lower) and (upper - h)."""
    p1, d1, dd1 = relaxed_barrier(h - lower, mu, delta)
    p2, d2, dd2 = relaxed_barrier(upper - h, mu, delta)
    return p1 + p2, d1 - d2, dd1 + dd2


def quadratic(h, weight):
    """0.5 * weight * h^2."""
    return 0.5 * weight * h * h, weight * h, weight * torch.ones_like(h)
