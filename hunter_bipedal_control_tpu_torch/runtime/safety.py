"""Safety checks.

Port of ``hunter_bipedal_control_tpu/runtime/safety.py``: the orientation
check |roll| <= pi/2 and a finite-state check (the position-limit trip is
in runtime/controller.py).  Each takes a centroidal state (..., 22).
"""
from __future__ import annotations

import math

import torch


def check_orientation(x_centroidal, limit=math.pi / 2):
    """True = safe."""
    return x_centroidal[..., 11].abs() <= limit


def check_state_finite(x_centroidal):
    return torch.isfinite(x_centroidal).all(-1)


def check(x_centroidal) -> torch.Tensor:
    """True = safe to continue."""
    return check_orientation(x_centroidal) & check_state_finite(x_centroidal)
