"""The flagship MPC problem, built in the port: the counterpart of the JAX
repository's ``__graft_entry__._build`` — nominal joints, trot schedule and
a 0.25 m/s walking target.  ``Mpc(flag.model, flag.settings, flag.params,
flag.planner_cfg)(flag.state, flag.schedule, flag.target, 0.0, flag.x0,
zeros(6), flag.default_joints)`` runs one batched step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .device import resolve_device
from .gait import mode_schedule as ms
from .models.robot import RobotModel, load_model
from .ocp import problem as ocp
from .refs import swing_planner as swp
from .refs import targets as tg
from .solver import mpc as mpc_mod
from .solver import sqp

DEFAULT_JOINTS = [0.10, 0., 0.40, 0.93, 0.53, -0.10, 0., -0.40, 0.93, -0.53]


class Flagship(NamedTuple):
    model: RobotModel
    settings: sqp.SqpSettings
    params: ocp.OcpParams
    planner_cfg: swp.SwingConfig
    default_joints: torch.Tensor   # (nj,)
    x0: torch.Tensor               # (B, nx) per-scenario initial states
    schedule: ms.ModeSchedule
    target: tg.TargetTrajectories
    state: mpc_mod.MpcState        # cold state for the B scenarios


def build_flagship(n_intervals: int = 53, horizon: float = 0.8, batch: int = 1,
                   device=None, dtype=torch.float32) -> Flagship:
    """The bench problem (trot, 0.25 m/s command) for ``batch`` scenarios
    whose initial states are x0 + 0.001 * scenario index, as bench.py
    batches them."""
    dev = resolve_device(device)
    m = load_model(device=dev, dtype=dtype)
    settings = sqp.SqpSettings(n_intervals=n_intervals, horizon=horizon, lin_backend="dense")
    dj = torch.tensor(DEFAULT_JOINTS, dtype=dtype, device=dev)
    qnom = torch.cat([torch.tensor([0., 0., 0.63], dtype=dtype, device=dev),
                      torch.zeros(3, dtype=dtype, device=dev), dj])
    params = ocp.make_input_cost(m, ocp.default_ocp_params(m, dtype), qnom)
    pcfg = swp.default_swing_config(dev, dtype)
    x0 = torch.cat([torch.zeros(6, dtype=dtype, device=dev), qnom])
    sched = ms.tile_template(ms.TROT_GAIT(dev), -horizon, 4 * horizon)
    target = tg.cmd_vel_to_target(
        torch.tensor([0.25, 0., 0., 0.], dtype=dtype, device=dev), x0, 0.0, horizon,
        tg.default_cmd_vel_config(nj=10, device=dev, dtype=dtype))
    xs = x0[None] + 0.001 * torch.arange(batch, dtype=dtype, device=dev)[:, None]
    state = mpc_mod.init_mpc_state(m, settings, batch, device=dev, dtype=dtype)
    return Flagship(m, settings, params, pcfg, dj, xs, sched, target, state)

