"""Carry weights and state across from the JAX package.

``from_numpy`` takes one of the JAX package's NamedTuples whose leaves were
mapped to numpy arrays (``jax.tree.map(np.asarray, obj)``) and returns the
port's NamedTuple of tensors with the same field names.  This module never
imports JAX: it matches the NamedTuple by class name.
"""
from __future__ import annotations

import numpy as np
import torch

from .backends.dummy import DummyPlantState
from .backends.fullorder import SimParams, SimState
from .backends.sensor_noise import NoiseState, SensorNoiseParams
from .device import resolve_device
from .estim.contact import ContactObserverParams, ContactObserverState
from .estim.kalman import KalmanParams, KalmanState
from .gait.adaptive import GaitRunState
from .gait.mode_schedule import ModeSchedule
from .models.robot import INDEX_FIELDS, RobotModel
from .ocp.problem import OcpParams
from .refs.swing_planner import PlannerState, SwingConfig
from .refs.targets import CmdVelConfig, TargetTrajectories
from .runtime.controller import GainConfig
from .runtime.loop import LoopState
from .runtime.sim_loop import SimLoopState
from .solver.mpc import MpcState
from .solver.sqp import SqpSolution
from .wbc.wbc import WbcParams, WbcState

_TYPES = {cls.__name__: cls for cls in (
    RobotModel, OcpParams, SwingConfig, CmdVelConfig, ModeSchedule, TargetTrajectories,
    MpcState, PlannerState, WbcParams, WbcState, GainConfig, KalmanParams, KalmanState,
    ContactObserverParams, ContactObserverState, SqpSolution, GaitRunState, DummyPlantState,
    LoopState, SimParams, SimState, SensorNoiseParams, NoiseState, SimLoopState)}
# fields that stay Python values, with their types
_SETTINGS = {"WbcParams": {f: type(d) for f, d in WbcParams._field_defaults.items()},
             "SimParams": {"substeps": int, "delay_steps": int}}


def _generator(key, dev) -> torch.Generator:
    """A generator for a JAX PRNG key: seeded from the key's words (the two
    streams differ; the seed only keeps the conversion deterministic)."""
    words = np.asarray(key).astype(np.uint64).ravel()[-2:]
    seed = int(words[0]) << 32 | int(words[-1])
    return torch.Generator(device=dev).manual_seed(seed)


def _leaf(v, dev, dtype):
    a = np.asarray(v)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=dev)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=dev)
    return torch.as_tensor(a.astype(np.float64), dtype=dtype, device=dev)


def from_numpy(obj, device=None, dtype=torch.float32):
    """JAX NamedTuple with numpy leaves -> the port's NamedTuple of tensors.

    Covers RobotModel (int index arrays stay int64, on the host), OcpParams
    (``collision=None`` only), SwingConfig, CmdVelConfig, ModeSchedule,
    TargetTrajectories, MpcState, SqpSolution (a policy), WbcParams (its
    Python settings, the ``qp_*`` fields, stay Python values), WbcState,
    GainConfig, KalmanParams, KalmanState, ContactObserverParams,
    ContactObserverState, the dummy loop's GaitRunState, DummyPlantState
    and LoopState, and the full-order loop's SimParams (its ``substeps`` and
    ``delay_steps`` stay Python ints, a None knob stays None), SimState,
    SensorNoiseParams, NoiseState (a generator seeded from the JAX key's
    words in place of the key) and SimLoopState.  The port's states are
    batched: map a JAX state that is not to (1, ...) leaves first; params
    stay unbatched."""
    dev = resolve_device(device)
    name = type(obj).__name__
    if name not in _TYPES:
        raise TypeError(f"no port counterpart for {name}")
    cls = _TYPES[name]
    fields = {}
    for field in cls._fields:
        if name == "NoiseState" and field == "generator":
            fields[field] = _generator(obj.key, dev)
            continue
        v = getattr(obj, field)
        if name == "RobotModel" and field in ("nj", "n_links"):
            fields[field] = int(v)
        elif name == "RobotModel" and field.endswith("_names"):
            fields[field] = tuple(str(s) for s in v)
        elif field in _SETTINGS.get(name, {}):
            # a Python setting (jax.tree.map made it a 0-d array)
            fields[field] = _SETTINGS[name][field](np.asarray(v).item())
        elif name == "RobotModel" and field in INDEX_FIELDS:
            fields[field] = torch.as_tensor(np.asarray(v).astype(np.int64))
        elif field == "collision":
            if v is not None:
                raise NotImplementedError("self-collision parameters are not ported yet")
            fields[field] = None
        elif v is None:
            fields[field] = None
        elif type(v).__name__ in _TYPES:
            fields[field] = from_numpy(v, dev, dtype)
        else:
            fields[field] = _leaf(v, dev, dtype)
    return cls(**fields)
