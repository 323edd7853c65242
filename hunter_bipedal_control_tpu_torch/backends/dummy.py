"""Physics-free closed-loop backend: integrate the solver's own dynamics.

Port of ``hunter_bipedal_control_tpu/backends/dummy.py``, the reference's
dummy loop harness (LeggedRobotDummyNode.cpp:51-100, OCS2
MRT_ROS_Dummy_Loop): the plant is the centroidal flow map driven by the
policy's inputs, so any MPC / reference / gait fault shows as divergence.
Batched over leading dims.  ``dummy_step`` is kernel B14a
(``csrc/centroidal_flow.cu``, the RK2 step in one launch) for a CUDA tensor
and ``dummy_step_plain`` for a CPU tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import _build
from ..models.centroidal import NX, flow_map
from ..models.robot import RobotModel
from ..ocp import soa_kernel


class DummyPlantState(NamedTuple):
    x: torch.Tensor  # (B, 22) centroidal state
    t: torch.Tensor  # (B,)


def init_dummy_plant(x0, t0=0.0) -> DummyPlantState:
    """x0 (B, nx); every scenario starts at time t0."""
    return DummyPlantState(x=x0, t=torch.full(x0.shape[:-1], t0, dtype=x0.dtype,
                                              device=x0.device))


def dummy_step_plain(model: RobotModel, state: DummyPlantState, u, dt) -> DummyPlantState:
    """RK2 integration of the centroidal dynamics under the policy input u (B, nu)."""
    k1 = flow_map(model, state.x, u)
    k2 = flow_map(model, state.x + dt * k1, u)
    return DummyPlantState(x=state.x + 0.5 * dt * (k1 + k2), t=state.t + dt)


def dummy_step(model: RobotModel, state: DummyPlantState, u, dt) -> DummyPlantState:
    """Kernel B14a: one RK2 step of the centroidal dynamics under the policy
    input u (B, nu).

    CPU: ``dummy_step_plain``.  CUDA: one launch of ``hk_dummy_step``, one
    thread per scenario, or an error: x and u (..., 22) float32 on the card
    (made contiguous here), ``dt`` a Python float; the model's constants
    from B1's buffer (``soa_kernel.consts_buffer``, which refuses a model of
    another topology).  The time advances in torch."""
    if state.x.device.type == "cpu":
        return dummy_step_plain(model, state, u, dt)
    x, _ = _build.rows(state.x, "x", NX)
    ur, _ = _build.rows(u, "u", NX)
    Bn, dev, f32 = x.shape[0], x.device, torch.float32
    _build.require(x, "x", f32, (Bn, NX), dev)
    _build.require(ur, "u", f32, (Bn, NX), dev)
    K = soa_kernel.consts_buffer(model, dev)
    x_new = torch.empty_like(x)
    _build.check(_build.library().hk_dummy_step(K.data_ptr(), x.data_ptr(), ur.data_ptr(),
                                                 x_new.data_ptr(), Bn, float(dt),
                                                 _build.stream(x)), "dummy_step")
    dummy_step.launches += 1
    return DummyPlantState(x=x_new.reshape(state.x.shape), t=state.t + dt)


dummy_step.launches = 0
