"""Time-triggered rollout integrators over any leading dims.

Port of ``hunter_bipedal_control_tpu/solver/rollout.py``: OCS2's
``TimeTriggeredRollout`` as the rollout block of task.info:131-140
configures it (ODE45, AbsTol 1e-5, RelTol 1e-3, timeStep 0.015,
maxNumStepsPerSecond 10000), used by the DDP's nonlinear rollouts.  The
SQP's sensitivity integrator stays RK2 (``solver/sqp.rk2_step``).

``ode45_step`` is the JAX package's bounded Dormand-Prince 5(4): at most
``max_substeps`` slots, each of which advances (accepted step), retries
with a smaller h (rejected step) or does nothing (the interval is covered),
then one RK4 step over any residual.  Every operation follows the JAX
package's order, and clips propagate NaN as ``jnp.clip`` does.  The slot
loop over a batch stops once every lane is inactive: an inactive slot
leaves t, x and h unchanged, so the stop is exact.  On the card kernel B15
(``solver/ddp.py::closed_rollout``) runs these integrators inside the
DDP's rollouts; these are its plain versions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.centroidal import flow_map
from ..models.robot import RobotModel

# Dormand-Prince RK5(4) tableau (the MATLAB/scipy "ode45" / "RK45" pair).
_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
       187 / 2100, 1 / 40)

INTEGRATORS = ("RK2", "RK4", "ODE45")


class RolloutSettings(NamedTuple):
    """rollout block of task.info:131-140."""

    abs_tol: float = 1e-5          # AbsTolODE
    rel_tol: float = 1e-3          # RelTolODE
    time_step: float = 0.015      # timeStep (initial h guess)
    integrator: str = "ODE45"     # integratorType: 'ODE45' | 'RK2' | 'RK4'
    max_steps_per_second: float = 10000.0  # maxNumStepsPerSecond
    max_substeps: int = 16         # bound on adaptive slots per call


def integrator_kind(settings: RolloutSettings) -> str:
    """The integrator's name in upper case; raises on an unknown one."""
    kind = settings.integrator.upper()
    if kind not in INTEGRATORS:
        raise ValueError(f"unknown integratorType {settings.integrator!r}")
    return kind


def _clip(a, lo, hi):
    """``jnp.clip``: minimum(maximum(a, lo), hi), NaN in any operand kept."""
    return torch.minimum(torch.maximum(a, lo), hi)


def _dopri_substeps(f, x, dt, s: RolloutSettings):
    """Adaptive DoPri5(4) over [0, dt] in at most ``s.max_substeps`` slots,
    x (..., nx).  Returns (x_end, t_end (...), accepted (..., max_substeps)
    bool: the slots that advanced)."""
    dtype, dev = x.dtype, x.device
    lead = x.shape[:-1]
    dt = torch.as_tensor(dt, dtype=dtype, device=dev)
    h_min = torch.tensor(1.0 / s.max_steps_per_second, dtype=dtype, device=dev)
    h0 = torch.minimum(torch.tensor(s.time_step, dtype=dtype, device=dev), dt)
    t = torch.zeros(lead, dtype=dtype, device=dev)
    xk = x
    h = h0.expand(lead)
    accepted = torch.zeros((*lead, s.max_substeps), dtype=torch.bool, device=dev)
    h_floor = h_min * (1 + 1e-6)
    for slot in range(s.max_substeps):
        remaining = dt - t
        active = remaining > 1e-12
        if not bool(active.any()):
            break
        hs = _clip(h, h_min, torch.maximum(remaining, h_min))
        hv = hs[..., None]
        ks = []
        for i in range(7):
            xi = xk
            for j, aij in enumerate(_A[i]):
                xi = xi + hv * aij * ks[j]
            ks.append(f(xi))
        x5 = xk + hv * sum(b * k for b, k in zip(_B5, ks))
        x4 = xk + hv * sum(b * k for b, k in zip(_B4, ks))

        scale = s.abs_tol + s.rel_tol * torch.maximum(xk.abs(), x5.abs())
        err = torch.sqrt(torch.mean(torch.square((x5 - x4) / scale), dim=-1))
        accept = (err <= 1.0) | (hs <= h_floor)

        step = active & accept
        t = torch.where(step, t + hs, t)
        xk = torch.where(step[..., None], x5, xk)
        factor = _clip(0.9 * err ** (-0.2), torch.tensor(0.2, dtype=dtype, device=dev),
                       torch.tensor(5.0, dtype=dtype, device=dev))
        h = torch.where(active, _clip(hs * factor, h_min, dt), h)
        accepted[..., slot] = step
    return xk, t, accepted


def ode45_step(model: RobotModel, x, u, dt, settings: RolloutSettings = RolloutSettings(),
               with_accepted: bool = False):
    """Integrate the centroidal flow over [0, dt] under zero-order-hold u
    with the bounded adaptive DoPri5(4) (OCS2 IntegratorType::ODE45), then
    one fixed RK4 step over the residual the slots left.  With
    ``with_accepted`` also returns the count of accepted slots (...,) int32."""
    f = lambda xk: flow_map(model, xk, u)  # noqa: E731
    x_end, t_end, accepted = _dopri_substeps(f, x, dt, settings)
    residual = torch.clamp_min(torch.as_tensor(dt, dtype=x.dtype, device=x.device) - t_end,
                               0.0)[..., None]
    k1 = f(x_end)
    k2 = f(x_end + 0.5 * residual * k1)
    k3 = f(x_end + 0.5 * residual * k2)
    k4 = f(x_end + residual * k3)
    out = x_end + residual / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    if with_accepted:
        return out, accepted.sum(-1, dtype=torch.int32)
    return out


def rk4_step(model: RobotModel, x, u, dt):
    """Classical RK4 (OCS2 IntegratorType::RK4), the fixed-step option."""
    k1 = flow_map(model, x, u)
    k2 = flow_map(model, x + 0.5 * dt * k1, u)
    k3 = flow_map(model, x + 0.5 * dt * k2, u)
    k4 = flow_map(model, x + dt * k3, u)
    return x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


def rollout_step(model: RobotModel, x, u, dt, settings: RolloutSettings = RolloutSettings()):
    """One rollout interval with the configured integrator."""
    kind = integrator_kind(settings)
    if kind == "ODE45":
        return ode45_step(model, x, u, dt, settings)
    if kind == "RK4":
        return rk4_step(model, x, u, dt)
    from .sqp import rk2_step

    return rk2_step(model, x, u, dt)
