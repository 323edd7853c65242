"""Ground-truth ("cheater") state estimation.

Port of ``hunter_bipedal_control_tpu/estim/cheater.py``: the reference's
cheater estimator substitutes ground-truth odometry for the Kalman filter;
here the ground truth is the plant state.
"""
from __future__ import annotations

from ..models.centroidal import q_v_to_rbd_state, rbd_state_to_centroidal
from ..models.robot import RobotModel


def cheater_estimate(model: RobotModel, q_true, v_true):
    """(rbd state (..., 32), centroidal x (..., 22)) from the plant's q, v."""
    rbd = q_v_to_rbd_state(model, q_true, v_true)
    return rbd, rbd_state_to_centroidal(model, rbd)
