"""Physics-free closed-loop backend: integrate the solver's own dynamics.

Port of ``hunter_bipedal_control_tpu/backends/dummy.py``, the reference's
dummy loop harness (LeggedRobotDummyNode.cpp:51-100, OCS2
MRT_ROS_Dummy_Loop): the plant is the centroidal flow map driven by the
policy's inputs, so any MPC / reference / gait fault shows as divergence.
Batched over leading dims.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.centroidal import flow_map
from ..models.robot import RobotModel


class DummyPlantState(NamedTuple):
    x: torch.Tensor  # (B, 22) centroidal state
    t: torch.Tensor  # (B,)


def init_dummy_plant(x0, t0=0.0) -> DummyPlantState:
    """x0 (B, nx); every scenario starts at time t0."""
    return DummyPlantState(x=x0, t=torch.full(x0.shape[:-1], t0, dtype=x0.dtype,
                                              device=x0.device))


def dummy_step(model: RobotModel, state: DummyPlantState, u, dt) -> DummyPlantState:
    """RK2 integration of the centroidal dynamics under the policy input u (B, nu)."""
    k1 = flow_map(model, state.x, u)
    k2 = flow_map(model, state.x + dt * k1, u)
    return DummyPlantState(x=state.x + 0.5 * dt * (k1 + k2), t=state.t + dt)
