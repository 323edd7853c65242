"""The port's entry points.

``build_flagship`` is the flagship MPC problem, the counterpart of the JAX
repository's ``__graft_entry__._build``: nominal joints, trot schedule and
a 0.25 m/s walking target.  ``Mpc(flag.model, flag.settings, flag.params,
flag.planner_cfg)(flag.state, flag.schedule, flag.target, 0.0, flag.x0,
zeros(6), flag.default_joints)`` runs one batched step; ``projected_lq``
gives its cold step's projected LQ data, the input of the Riccati sweep.

``build_controller`` and ``tick_chain`` run the 500 Hz control tick that
consumes the MPC's plan: Kalman update -> momentum observer -> policy
evaluation -> WBC -> gain schedule, with the standing robot's sensor
readings of the repository's tick benchmark (``bench.py``).

``build_wbc_batch`` and ``wbc_chain`` run the WBC alone on a batch of
standing states, as the repository's batched-WBC benchmark does: ticks
carrying the WBC state, the first one cold.  ``walking_wbc_batch`` draws a
batch of walking robots (mixed contacts, both stance modes) from a seed,
``estimator_batch`` the inputs of both estimators' updates,
``centroidal_batch`` those of the loops' sensing, plant and conversion,
``qp_batch`` seeded QPs of the WBC's and the hierarchical WBC's shapes,
``contact_class_batch`` seeded inputs of the full-order loop's contact
classification, ``swing_plan_edge_batch`` the reference prep's swing
planner on the schedules at its edges.

``ddp_solve`` runs the SLQ/DDP solver (``solver/ddp.py``) on the
flagship's first problem, warm-started from SQP solves.

``mpc_chain`` is the chained B=1 solve of the benchmark (``bench.py``'s
``chained`` and ``chained_rpar``): each solve starts from the flagship's
cold state and consumes the previous solution's one-step state, in either
Riccati mode.  ``build_loop`` and ``run_loop`` run the dummy closed loop
(100 Hz MPC + five 500 Hz ticks per period against the dummy plant) on the
repository's golden stance -> walk scenario.

``build_sim_loop`` and ``run_sim_loop`` run the full-order closed loop
(``runtime/sim_loop.py``: the plant's physics substeps, sensing, the Kalman
filter and momentum observer in the loop, the MPC, the WBC) in the
configuration of the repository benchmark's real-time demonstration
(``bench.py``'s ``rt_factor``), on the commands ``rt_commands`` gives.
"""
from __future__ import annotations

import math
import time
from typing import NamedTuple

import torch

from .device import resolve_device
from .estim import contact as obs_mod
from .estim import kalman as kf_mod
from .gait import mode_schedule as ms
from .models.centroidal import q_v_to_rbd_state
from .models.kinematics import contact_positions, fk
from .models.robot import RobotModel, load_model
from .models.spatial import zyx_to_quat
from .ocp import problem as ocp
from .refs import swing_planner as swp
from .refs import targets as tg
from .backends import fullorder
from .backends import sensor_noise as sn
from .runtime import loop as loop_mod
from .runtime import sim_loop as sim_loop_mod
from .runtime.controller import Controller, GainConfig, JointCommand, TickOutput, default_gains
from .solver import ddp
from .solver import mpc as mpc_mod
from .solver import riccati, sqp
from .wbc import wbc as wbc_mod

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
                   device=None, dtype=torch.float32, lin_backend: str = "soa") -> Flagship:
    """The bench problem (trot, 0.25 m/s command) for ``batch`` scenarios
    whose initial states are x0 + 0.001 * scenario index, as bench.py
    batches them.  ``lin_backend``: 'soa' (kernel B1 on the card) or
    'dense' (plain torch)."""
    dev = resolve_device(device)
    m = load_model(device=dev, dtype=dtype)
    settings = sqp.SqpSettings(n_intervals=n_intervals, horizon=horizon, lin_backend=lin_backend)
    qnom = nominal_q(0.63, dev, dtype)
    dj = qnom[6:]
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


def projected_lq(flag: Flagship):
    """The flagship's cold step up to the Riccati sweep: the reference prep
    at t = 0, the warm start, the linearization and the projection.
    Returns (lq, E, P, e, dx0) as ``riccati.riccati_solve`` takes them,
    contiguous, on the flagship's device and dtype."""
    b = flag.x0.shape[0]
    z = torch.zeros((b, 6), dtype=flag.x0.dtype, device=flag.x0.device)
    sched = ms.ModeSchedule(*(a.expand(b, *a.shape) for a in flag.schedule))
    target = tg.TargetTrajectories(*(a.expand(b, *a.shape) for a in flag.target))
    bundle, _, _, _ = mpc_mod.prepare_references(
        flag.model, flag.settings, flag.planner_cfg, flag.state.planner, sched, target,
        z[:, 0], flag.x0, z, flag.default_joints.expand(b, -1))
    xs, us = mpc_mod._warm_start(flag.model, flag.settings, bundle, flag.state, flag.x0)
    xn, A, Bm, _, qx, qu, Qxx, Quu, Qux, g, C, D, mask = sqp.knot_linearization_all(
        flag.model, flag.settings, flag.params, bundle, xs, us)
    proj = sqp.project_knot(flag.settings, *(t.contiguous() for t in (
        A, Bm, xn - xs[:, 1:], qx, qu, Qxx, Quu, Qux, g, C, D, mask)))
    A_t, B_t, d_t, qx_t, qw, Qxx_t, Qww, Qwx, E, e, P = [t.contiguous() for t in proj]
    lq = riccati.StageLQ(A=A_t, B=B_t, d=d_t, Qxx=Qxx_t, Qww=Qww, Qwx=Qwx, qx=qx_t, qw=qw)
    return lq, E, P, e, (flag.x0 - xs[:, 0]).contiguous()


def nominal_q(base_z: float, device, dtype) -> torch.Tensor:
    """(nq,) the base at (0, 0, base_z), level, on the nominal joints."""
    return torch.cat([torch.tensor([0., 0., base_z], dtype=dtype, device=device),
                      torch.zeros(3, dtype=dtype, device=device),
                      torch.tensor(DEFAULT_JOINTS, dtype=dtype, device=device)])


TICK_DT = 0.002      # 500 Hz
TICK_BASE_Z = 0.624  # the standing base height of the tick benchmark


class TickSetup(NamedTuple):
    controller: Controller
    kalman_params: kf_mod.KalmanParams
    observer_params: obs_mod.ContactObserverParams
    kalman: kf_mod.KalmanState
    observer: obs_mod.ContactObserverState
    wbc: wbc_mod.WbcState
    q0: torch.Tensor              # (nq,) standing configuration
    default_joints: torch.Tensor  # (nj,)


def build_controller(batch: int = 1, device=None, dtype=torch.float32) -> TickSetup:
    """The control tick's module, default parameters and cold states for
    ``batch`` scenarios, standing at base height 0.624 m on the nominal joints."""
    dev = resolve_device(device)
    m = load_model(device=dev, dtype=dtype)
    q0 = nominal_q(TICK_BASE_Z, dev, dtype)
    ctrl = Controller(m, wbc_mod.default_wbc_params(dev, dtype), default_gains(dev, dtype))
    return TickSetup(ctrl, kf_mod.default_kalman_params(dev, dtype),
                     obs_mod.default_contact_params(dev, dtype),
                     kf_mod.init_kalman_state(batch, dev, dtype),
                     obs_mod.init_contact_observer(batch, dev, dtype),
                     wbc_mod.init_wbc_state(batch, dev, dtype), q0, q0[6:])


def standing_sensors(setup: TickSetup) -> dict:
    """The Kalman filter's sensor inputs (B, ...) of a robot standing still at
    ``setup.q0``: the keyword arguments of ``kalman_update`` but ``dt``."""
    q0 = setup.q0
    Bn, nj = setup.kalman.x_hat.shape[0], setup.default_joints.shape[0]
    zyx = q0[3:6].expand(Bn, 3)
    zeros3 = torch.zeros((Bn, 3), dtype=q0.dtype, device=q0.device)
    return dict(zyx=zyx, joint_pos=q0[6:].expand(Bn, nj),
                joint_vel=torch.zeros((Bn, nj), dtype=q0.dtype, device=q0.device),
                omega_world=zeros3, quat_xyzw=zyx_to_quat(zyx),
                linear_accel_local=torch.tensor([0., 0., 9.81], dtype=q0.dtype,
                                                device=q0.device).expand(Bn, 3),
                contact_flags=torch.ones((Bn, 4), dtype=q0.dtype, device=q0.device))


def tick_chain(setup: TickSetup, policy: sqp.SqpSolution, schedule: ms.ModeSchedule,
               n_ticks: int, dt: float = TICK_DT, on_tick=None):
    """``n_ticks`` chained ticks (Kalman update -> momentum observer ->
    ``control_tick``) at t = 0, dt, 2 dt, ..., carrying the estimator and
    WBC states, walking on ``policy`` (B, N+1, ...) along ``schedule``.
    ``on_tick(i, out, (kalman, observer, wbc))``, if given, is called after
    each tick with its output and the states it carries on.

    Returns (TickOutput whose fields are stacked over the ticks, (B, K, ...),
    (kalman, observer, wbc) final states)."""
    ctrl = setup.controller
    m = ctrl.model
    q0, dj = setup.q0, setup.default_joints
    Bn = setup.kalman.x_hat.shape[0]
    dtype, dev = q0.dtype, q0.device
    sensors = standing_sensors(setup)
    zyx, qj, zeros3 = sensors["zyx"], sensors["joint_pos"], sensors["omega_world"]
    zeros_j = sensors["joint_vel"]
    x_est = torch.cat([torch.zeros(6, dtype=dtype, device=dev), q0]).expand(Bn, -1)
    walk = torch.ones(Bn, dtype=torch.bool, device=dev)
    estop = torch.zeros(Bn, dtype=torch.bool, device=dev)
    kf, obs, wst, last_tau = setup.kalman, setup.observer, setup.wbc, zeros_j
    outs = []
    for i in range(n_ticks):
        t = torch.tensor(float(i), dtype=dtype, device=dev) * dt
        kf, pos, vel = kf_mod.kalman_update(m, setup.kalman_params, kf, **sensors, dt=dt)
        rbd = torch.cat([zyx, pos, qj, zeros3, vel, zeros_j], dim=-1)
        obs, _ = obs_mod.momentum_observer_update(m, setup.observer_params, obs, rbd,
                                                  last_tau, dt)
        out, wst = ctrl(wst, policy, schedule, t, x_est, rbd, dj, walk, estop, dt)
        last_tau = out.command.tau_ff
        outs.append(out)
        if on_tick is not None:
            on_tick(i, out, (kf, obs, wst))
    stacked = TickOutput(
        command=JointCommand(*(torch.stack(f, dim=1) for f in zip(*(o.command for o in outs)))),
        **{f: torch.stack([getattr(o, f) for o in outs], dim=1)
           for f in TickOutput._fields if f != "command"})
    return stacked, (kf, obs, wst)


class WbcBatch(NamedTuple):
    model: RobotModel
    params: wbc_mod.WbcParams
    x_des: torch.Tensor         # (B, 22) nominal standing state
    u_des: torch.Tensor         # (B, 22) zero input
    rbd: torch.Tensor           # (B, 32) measured states, scenario b offset by 1e-4 b
    contact_flags: torch.Tensor  # (B, 4) all feet in contact
    stance_mode: torch.Tensor   # (B,) False


def build_wbc_batch(batch: int = 4096, device=None, dtype=torch.float32) -> WbcBatch:
    """``batch`` WBC problems around the flagship's nominal standing state."""
    dev = resolve_device(device)
    m = load_model(device=dev, dtype=dtype)
    q = nominal_q(0.63, dev, dtype)
    x0 = torch.cat([torch.zeros(6, dtype=dtype, device=dev), q])
    rbd = q_v_to_rbd_state(m, q, torch.zeros(16, dtype=dtype, device=dev))
    rbds = rbd[None] + 1e-4 * torch.arange(batch, dtype=dtype, device=dev)[:, None]
    return WbcBatch(m, wbc_mod.default_wbc_params(dev, dtype), x0.expand(batch, -1).contiguous(),
                    torch.zeros((batch, 22), dtype=dtype, device=dev), rbds,
                    torch.ones((batch, 4), dtype=dtype, device=dev),
                    torch.zeros(batch, dtype=torch.bool, device=dev))


# the contact modes walking_wbc_batch draws from: one leg (toe and heel),
# the other, both, none
WALK_FLAGS = ((1., 0., 1., 0.), (0., 1., 0., 1.), (1., 1., 1., 1.), (0., 0., 0., 0.))


def walking_wbc_batch(batch: int = 4096, device=None, dtype=torch.float32,
                      seed: int = 0) -> WbcBatch:
    """``batch`` WBC problems of a walking robot, drawn from ``seed``: the
    nominal standing state moved by normal offsets (base position 1 cm,
    Euler angles 0.2 rad, joints 0.05 rad; velocities 0.5), desired states
    around it (momentum 0.2, pose 0.05) with the weight-compensating forces
    of each scenario's contacts plus noise (1 N, joint velocities 0.5), the
    contact flags one of ``WALK_FLAGS`` per scenario and stance mode on
    for about half of them."""
    dev = resolve_device(device)
    f64 = torch.float64
    g = torch.Generator(device="cpu").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, dtype=f64)

    m64 = load_model(device="cpu", dtype=f64)
    q0 = nominal_q(0.63, "cpu", f64)
    q = q0 + torch.cat([0.01 * randn(batch, 3), 0.2 * randn(batch, 3),
                        0.05 * randn(batch, 10)], dim=-1)
    rbd = q_v_to_rbd_state(m64, q, 0.5 * randn(batch, 16))
    x_des = torch.cat([0.2 * randn(batch, 6), q0 + 0.05 * randn(batch, 16)], dim=-1)
    flags = torch.tensor(WALK_FLAGS, dtype=f64)[
        torch.randint(len(WALK_FLAGS), (batch,), generator=g)]
    u_des = (ocp.weight_compensating_input(m64, flags, 22)
             + torch.cat([randn(batch, 12), 0.5 * randn(batch, 10)], dim=-1))
    stance = torch.randint(2, (batch,), generator=g).bool()
    t = lambda a: a.to(dev, dtype).contiguous()
    return WbcBatch(load_model(device=dev, dtype=dtype), wbc_mod.default_wbc_params(dev, dtype),
                    t(x_des), t(u_des), t(rbd), t(flags), stance.to(dev))


def qp_batch(batch: int, me: int = 28, mi: int = 40, seed: int = 0, device=None,
             dtype=torch.float32):
    """``batch`` seeded QPs (H, g, Aeq, beq, Ain, bin) of the WBC's 38
    variables [accel (16), forces (12), torques (10)], drawn with numpy.

    me = 28 and mi = 40: the weighted WBC's shape (``wbc_qp``): H = X X' /
    38 + 0.5 I, the equations of motion as 16 random rows, the swing feet's
    zero-force rows (zero for the feet in contact), the torque limits and
    the friction pyramid of the feet in contact (``WALK_FLAGS``).
    me = 1: a level of the hierarchical WBC (JAX ``wbc/hierarchical.py``
    :157, :220): H = Ah' Ah + (1e-5 tr / 38 + 1e-7) I with Ah = A P (six
    unit rows A, P the null-space projector of 18 random rows), one zero
    equality row; with mi = 40 its level-0 torque and friction rows times P
    (:100-117), offset by a prior solution, with mi = 1 its placeholder
    row (:218-219): zero, bound 1."""
    import numpy as np

    n, nv, nf = wbc_mod.NDEC, 16, 12
    if (me, mi) not in ((wbc_mod.N_EQ_ROWS, wbc_mod.N_INEQ_ROWS), (1, 40), (1, 1)):
        raise ValueError(f"qp_batch draws me, mi = 28, 40 or 1, 40 or 1, 1; got {me}, {mi}")
    rng = np.random.default_rng(seed)
    eye = np.eye(n)
    flags = np.asarray(WALK_FLAGS)[rng.integers(len(WALK_FLAGS), size=batch)]
    pyr = np.array([[0., 0., -1.], [1., 0., -0.7], [-1., 0., -0.7], [0., 1., -0.7],
                    [0., -1., -0.7]])
    D = np.zeros((batch, 40, n))
    D[:, 0:10, nv + nf:] = eye[:10, :10]
    D[:, 10:20, nv + nf:] = -eye[:10, :10]
    for i in range(4):
        D[:, 20 + 5 * i:25 + 5 * i, nv + 3 * i:nv + 3 * i + 3] = pyr * flags[:, i, None, None]
    f = np.concatenate([np.tile([28., 60., 60., 60., 28.], 4), np.zeros(20)])
    if me > 1:
        X = rng.standard_normal((batch, n, n))
        H = X @ X.transpose(0, 2, 1) / n + 0.5 * eye
        g = rng.standard_normal((batch, n))
        zf = np.zeros((batch, nf, n))
        zf[:, :, nv:nv + nf] = eye[:nf, :nf] * np.repeat(1.0 - flags, 3, axis=-1)[:, None]
        Aeq = np.concatenate([rng.standard_normal((batch, nv, n)), zf], axis=1)
        beq = np.concatenate([rng.standard_normal((batch, nv)), np.zeros((batch, nf))], axis=1)
        Ain, bin_ = D, np.broadcast_to(f, (batch, 40))
    else:
        A0 = rng.standard_normal((batch, 18, n))
        P = eye - A0.transpose(0, 2, 1) @ np.linalg.solve(A0 @ A0.transpose(0, 2, 1), A0)
        A = rng.standard_normal((batch, 6, n))
        A /= np.linalg.norm(A, axis=-1, keepdims=True)
        Ah = A @ P
        H = Ah.transpose(0, 2, 1) @ Ah
        H = H + (1e-5 * np.trace(H, axis1=1, axis2=2) / n + 1e-7)[:, None, None] * eye
        g = (Ah.transpose(0, 2, 1) @ rng.standard_normal((batch, 6, 1)))[..., 0]
        Aeq, beq = np.zeros((batch, 1, n)), np.zeros((batch, 1))
        if mi == 40:
            x_prev = 0.1 * rng.standard_normal((batch, n, 1))
            Ain, bin_ = D @ P, f - (D @ x_prev)[..., 0]
        else:
            Ain, bin_ = np.zeros((batch, 1, n)), np.ones((batch, 1))
    dev = resolve_device(device)
    return tuple(torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
                 for a in (H, g, Aeq, beq, Ain, bin_))


def wbc_chain(wb: WbcBatch, n_ticks: int):
    """``n_ticks`` chained WBC updates from the cold state, tick k measuring
    rbd + 1e-5 k.  Returns (solutions (B, K, 38), accepted (B, K), final
    WbcState); the first tick is the cold solve."""
    Bn = wb.rbd.shape[0]
    state = wbc_mod.init_wbc_state(Bn, wb.rbd.device, wb.rbd.dtype)
    xs, oks = [], []
    for k in range(n_ticks):
        x, state, ok = wbc_mod.wbc_solve(wb.model, wb.params, state, wb.x_des, wb.u_des,
                                         wb.rbd + 1e-5 * k, wb.contact_flags, wb.stance_mode)
        xs.append(x)
        oks.append(ok)
    return torch.stack(xs, dim=1), torch.stack(oks, dim=1), state


class Chain(NamedTuple):
    costs: torch.Tensor   # (K, B) each solve's cost
    states: torch.Tensor  # (K+1, B, nx) each solve's initial state, then the last one's states[1]
    seconds: list         # K host-clock durations, each ending in a device sync on the card


def mpc_chain(flag: Flagship, k_chain: int = 20, riccati_parallel: bool = False,
              lin_backend: str = "soa") -> Chain:
    """``k_chain`` chained solves (bench.py:117-178): every solve starts from
    the flagship's cold ``MpcState`` and consumes the previous solution's
    one-step state ``states[:, 1]``, with the sequential (B3) or the
    parallel-in-time (B5) Riccati and the SoA (B1) or dense linearization."""
    settings = flag.settings._replace(riccati_parallel=riccati_parallel,
                                      lin_backend=lin_backend)
    mpc = mpc_mod.Mpc(flag.model, settings, flag.params, flag.planner_cfg)
    x = flag.x0
    cuda = x.device.type == "cuda"
    zeros6 = torch.zeros(6, dtype=x.dtype, device=x.device)
    costs, states, seconds = [], [x], []
    for _ in range(k_chain):
        t0 = time.perf_counter()
        sol, _, _ = mpc(flag.state, flag.schedule, flag.target, 0.0, x, zeros6, flag.default_joints)
        if cuda:
            torch.cuda.synchronize(x.device)
        seconds.append(time.perf_counter() - t0)
        x = sol.states[:, 1]
        costs.append(sol.cost)
        states.append(x)
    return Chain(torch.stack(costs), torch.stack(states), seconds)


class DdpRun(NamedTuple):
    solution: sqp.SqpSolution
    seconds: float                 # host clock around the DDP solve alone
    refs: sqp.ReferenceBundle
    warm: sqp.SqpSolution          # the last SQP solve, DDP's warm start


def ddp_solve(flag: Flagship, settings: ddp.DdpSettings, n_warm: int = 3,
              on_iteration=None, riccati_solver: str = "ns") -> DdpRun:
    """The SLQ/DDP solve of ``flag``'s first MPC problem (tests/test_ddp.py's
    use): the references of the first step, ``n_warm`` SQP solves from the
    initializer trajectories (``flag.settings``), then ``ddp.solve`` from
    the last of them, on ``flag``'s device.  ``settings`` must share the
    flagship's knots and horizon; ``on_iteration`` and ``riccati_solver``
    go to ``ddp.solve``."""
    if (settings.n_intervals, settings.horizon) != (flag.settings.n_intervals,
                                                    flag.settings.horizon):
        raise ValueError("ddp_solve: the DDP settings' knots and horizon differ from the flagship's")
    if n_warm < 1:
        raise ValueError("ddp_solve: DDP starts from at least one SQP solve")
    x = flag.x0
    warm, _, refs = mpc_mod.mpc_step(flag.model, flag.settings, flag.params, flag.planner_cfg,
                                     flag.state, flag.schedule, flag.target, 0.0, x,
                                     torch.zeros(6, dtype=x.dtype, device=x.device),
                                     flag.default_joints)
    for _ in range(n_warm - 1):
        warm = sqp.solve(flag.model, flag.settings, flag.params, refs, x, warm.states,
                         warm.inputs[:, :-1])
    cuda = x.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    sol = ddp.solve(flag.model, settings, flag.params, refs, x, warm.states,
                    warm.inputs[:, :-1], on_iteration, riccati_solver)
    if cuda:
        torch.cuda.synchronize(x.device)
    return DdpRun(sol, time.perf_counter() - t0, refs, warm)


class LoopSetup(NamedTuple):
    model: RobotModel
    settings: sqp.SqpSettings
    params: ocp.OcpParams
    planner_cfg: swp.SwingConfig
    wbc_params: wbc_mod.WbcParams
    gains: GainConfig
    cmd_cfg: tg.CmdVelConfig
    config: loop_mod.LoopConfig
    state: loop_mod.LoopState
    default_joints: torch.Tensor


def build_loop(device=None, dtype=torch.float32, riccati_parallel: bool = False,
               lin_backend: str = "soa") -> LoopSetup:
    """The golden stance -> walk scenario's closed loop (tests/test_golden.py):
    default ``SqpSettings`` (53 knots over 0.8 s) but the Riccati mode and
    the linearization backend, base
    at z = 0.63 on the nominal joints, the input cost made there, default
    swing, WBC, gain and command configurations, and a cold loop state for
    one scenario."""
    dev = resolve_device(device)
    m = load_model(device=dev, dtype=dtype)
    settings = sqp.SqpSettings(riccati_parallel=riccati_parallel, lin_backend=lin_backend)
    qnom = nominal_q(0.63, dev, dtype)
    params = ocp.make_input_cost(m, ocp.default_ocp_params(m, dtype), qnom)
    x0 = torch.cat([torch.zeros(6, dtype=dtype, device=dev), qnom])[None]
    return LoopSetup(m, settings, params, swp.default_swing_config(dev, dtype),
                     wbc_mod.default_wbc_params(dev, dtype), default_gains(dev, dtype),
                     tg.default_cmd_vel_config(nj=m.nj, device=dev, dtype=dtype),
                     loop_mod.LoopConfig(), loop_mod.init_loop_state(m, settings, x0), qnom[6:])


def run_loop(setup: LoopSetup, cmds):
    """The closed loop over the commands cmds (P, 4) (or (P, B, 4)), one MPC
    period each, from ``setup.state``.  Returns (final LoopState, telemetry
    (P, B, ...))."""
    cmds = torch.as_tensor(cmds, dtype=setup.state.plant.x.dtype,
                           device=setup.state.plant.x.device)
    return loop_mod.run_dummy_loop(setup.model, setup.settings, setup.params,
                                   setup.planner_cfg, setup.wbc_params, setup.gains,
                                   setup.cmd_cfg, setup.config, setup.state, cmds, cmds.shape[0],
                                   setup.default_joints)


class SimLoopSetup(NamedTuple):
    model: RobotModel
    settings: sqp.SqpSettings
    params: ocp.OcpParams
    planner_cfg: swp.SwingConfig
    wbc_params: wbc_mod.WbcParams
    gains: GainConfig
    cmd_cfg: tg.CmdVelConfig
    kalman_params: kf_mod.KalmanParams
    observer_params: obs_mod.ContactObserverParams
    sim_params: fullorder.SimParams
    config: loop_mod.LoopConfig
    state: sim_loop_mod.SimLoopState
    default_joints: torch.Tensor
    noise_params: sn.SensorNoiseParams | None


def build_sim_loop(device=None, dtype=torch.float32, riccati_parallel: bool = False,
                   lin_backend: str = "soa", noise: bool = False, n_intervals: int = 53,
                   horizon: float = 0.8, noise_seed: int = 0) -> SimLoopSetup:
    """The full-order closed loop of the benchmark's real-time demonstration
    for one scenario: ``SqpSettings`` of ``n_intervals`` knots over
    ``horizon`` seconds (the product shape by default) in the given Riccati
    mode and linearization backend, the input cost made at the nominal
    stance (z = 0.63), default swing, WBC, gain, command, Kalman, observer
    and plant parameters (8 substeps of 0.25 ms per 2 ms tick, no delay),
    the robot at z = 0.624 on the nominal joints; with ``noise`` the
    default sensor noise, seeded with ``noise_seed``."""
    dev = resolve_device(device)
    m = load_model(device=dev, dtype=dtype)
    settings = sqp.SqpSettings(n_intervals=n_intervals, horizon=horizon,
                               riccati_parallel=riccati_parallel, lin_backend=lin_backend)
    qnom = nominal_q(0.63, dev, dtype)
    params = ocp.make_input_cost(m, ocp.default_ocp_params(m, dtype), qnom)
    noise_params = sn.default_sensor_noise_params(dev, dtype) if noise else None
    state = sim_loop_mod.init_sim_loop_state(m, settings, nominal_q(TICK_BASE_Z, dev, dtype)[None],
                                             noise_params=noise_params, noise_seed=noise_seed)
    return SimLoopSetup(m, settings, params, swp.default_swing_config(dev, dtype),
                        wbc_mod.default_wbc_params(dev, dtype), default_gains(dev, dtype),
                        tg.default_cmd_vel_config(nj=m.nj, device=dev, dtype=dtype),
                        kf_mod.default_kalman_params(dev, dtype),
                        obs_mod.default_contact_params(dev, dtype),
                        fullorder.default_sim_params(dev, dtype), loop_mod.LoopConfig(), state,
                        qnom[6:], noise_params)


class SimBatch(NamedTuple):
    model: RobotModel
    params: fullorder.SimParams
    state: fullorder.SimState
    command: JointCommand


def sim_step_batch(batch: int = 1024, device=None, dtype=torch.float32, seed: int = 0,
                   delay_ms: float = 9.0) -> SimBatch:
    """``batch`` plant states and joint commands of a scenario sweep, drawn
    from ``seed``: the standing robot with its base lowered to where the
    feet touch the contact surface, then moved by normal offsets (base 3 mm
    and 0.05 rad, joints 0.05 rad), so that about half the contact points
    are in contact; the second half of the scenarios walking (velocities
    0.3 m/s, 0.5 rad/s, joints 1 rad/s), the first half nearly still; PD
    commands around the state (kp 20-40, kd 1-2, feedforward 5 N m), the
    command ring full of such commands with heads on both sides of the
    delay (``delay_ms``, counted in substeps) and past the ring's wrap;
    per-scenario mass_scale in [0.9, 1.1] and gravity_delta in +-0.5 m/s^2."""
    dev = resolve_device(device)
    f64 = torch.float64
    g = torch.Generator(device="cpu").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, dtype=f64)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=g, dtype=f64)

    m64 = load_model(device="cpu", dtype=f64)
    params64 = fullorder.default_sim_params("cpu", f64, delay_ms=delay_ms)
    q0 = nominal_q(TICK_BASE_Z, "cpu", f64)
    feet_z = contact_positions(m64, fk(m64, q0))[:, 2].mean()
    q0[2] -= feet_z - params64.sole_drop
    q = q0 + torch.cat([0.003 * randn(batch, 3), 0.05 * randn(batch, 3),
                        0.05 * randn(batch, fullorder.NJ)], dim=-1)
    walking = (torch.arange(batch) >= batch // 2).to(f64)[:, None]
    scale = torch.cat([torch.full((3,), 0.3, dtype=f64), torch.full((3,), 0.5, dtype=f64),
                       torch.ones(fullorder.NJ, dtype=f64)])
    v = (0.02 + 0.98 * walking) * scale * randn(batch, fullorder.NV)

    def commands(*lead):
        nj = fullorder.NJ
        return torch.stack([q[:, 6:].reshape(batch, *([1] * (len(lead) - 1)), nj)
                            + 0.05 * randn(*lead, nj), 0.5 * randn(*lead, nj),
                            uniform(20.0, 40.0, *lead, nj), uniform(1.0, 2.0, *lead, nj),
                            5.0 * randn(*lead, nj)], dim=-2)

    cmd = commands(batch)
    ring = commands(batch, fullorder.MAX_DELAY)
    head = torch.randint(0, 3 * fullorder.MAX_DELAY, (batch,), generator=g)
    params64 = params64._replace(mass_scale=uniform(0.9, 1.1, batch),
                                 gravity_delta=uniform(-0.5, 0.5, batch, 3))
    t = lambda a: a.to(dev, dtype).contiguous()
    state = fullorder.SimState(q=t(q), v=t(v), t=t(torch.zeros(batch, dtype=f64)),
                               base_acc=t(torch.zeros(batch, 6, dtype=f64)),
                               contact_forces=t(torch.zeros(batch, fullorder.NUM_FEET, 3,
                                                            dtype=f64)),
                               cmd_buffer=t(ring), buf_head=head.to(dev))
    params = fullorder.SimParams(*(t(a) if torch.is_tensor(a) else a for a in params64))
    return SimBatch(load_model(device=dev, dtype=dtype), params, state,
                    JointCommand(*(t(c) for c in cmd.unbind(-2))))


class EstimatorBatch(NamedTuple):
    model: RobotModel
    observer_params: obs_mod.ContactObserverParams
    observer: obs_mod.ContactObserverState
    rbd: torch.Tensor            # (B, 32) measured states
    cmd_torque: torch.Tensor     # (B, 10)
    kalman_params: kf_mod.KalmanParams
    kalman: kf_mod.KalmanState
    sensors: dict                # kalman_update's sensor arguments, (B, ...)


def estimator_batch(batch: int = 4096, device=None, dtype=torch.float32,
                    seed: int = 0) -> EstimatorBatch:
    """``batch`` inputs of both estimators' updates, of walking robots drawn
    from ``seed``.  The observer: the nominal standing state moved by normal
    offsets (base 1 cm, Euler angles 0.2 rad, joints 0.05 rad), velocities
    of scale 1 (so the Coriolis term matters), torques of 5 N m, and a
    filter state near its zero-disturbance value beta M v (plus 5 of
    noise).  The Kalman filter: the same joints and angles as sensors
    (angular velocity 0.3 rad/s, specific force g plus 0.5 m/s^2 of noise),
    contact flags one of ``WALK_FLAGS`` for half the scenarios and uniform
    fractions in [0, 1] for the rest; a state of base 0.6 m up, velocities
    0.3 m/s, feet 5 cm around the origin, and a covariance X X' / 18 +
    0.1 I scaled per scenario by 10^u, u uniform in [-5, 2] (so that
    the xy conditioning's test goes both ways)."""
    from .models.dynamics import mass_matrix

    dev = resolve_device(device)
    f64 = torch.float64
    g = torch.Generator(device="cpu").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, dtype=f64)

    m64 = load_model(device="cpu", dtype=f64)
    q = nominal_q(0.63, "cpu", f64) + torch.cat([0.01 * randn(batch, 3), 0.2 * randn(batch, 3),
                                                 0.05 * randn(batch, 10)], dim=-1)
    v = randn(batch, 16)
    rbd = q_v_to_rbd_state(m64, q, v)
    op64 = obs_mod.default_contact_params("cpu", f64)
    gama = torch.exp(-op64.cutoff_frequency * TICK_DT)
    beta = (1.0 - gama) / (gama * TICK_DT)
    p = (mass_matrix(m64, q) @ v[..., None])[..., 0]
    observer = obs_mod.ContactObserverState(p_scg_z_last=beta * p + 5.0 * randn(batch, 16),
                                            est_forces=torch.full((batch, 16), 50.0, dtype=f64))
    zyx = q[:, 3:6]
    flags = torch.tensor(WALK_FLAGS, dtype=f64)[
        torch.randint(len(WALK_FLAGS), (batch,), generator=g)]
    frac = torch.rand(batch, 4, generator=g, dtype=f64)
    flags = torch.where((torch.arange(batch) % 2 == 1)[:, None], frac, flags)
    sensors = dict(zyx=zyx, joint_pos=q[:, 6:], joint_vel=v[:, 6:],
                   omega_world=0.3 * randn(batch, 3), quat_xyzw=zyx_to_quat(zyx),
                   linear_accel_local=torch.tensor([0., 0., 9.81], dtype=f64)
                   + 0.5 * randn(batch, 3), contact_flags=flags)
    X = randn(batch, kf_mod.NS, kf_mod.NS)
    scale = 10.0 ** (-5.0 + 7.0 * torch.rand(batch, 1, 1, generator=g, dtype=f64))
    P = scale * (X @ X.transpose(-1, -2) / kf_mod.NS + 0.1 * torch.eye(kf_mod.NS, dtype=f64))
    x_hat = torch.cat([torch.tensor([0., 0., 0.6], dtype=f64) + 0.01 * randn(batch, 3),
                       0.3 * randn(batch, 3), 0.05 * randn(batch, 12)], dim=-1)
    kalman = kf_mod.KalmanState(x_hat=x_hat, P=P, feet_heights=0.01 * randn(batch, 4))
    t = lambda a: a.to(dev, dtype).contiguous()
    return EstimatorBatch(
        load_model(device=dev, dtype=dtype), obs_mod.default_contact_params(dev, dtype),
        obs_mod.ContactObserverState(*(t(a) for a in observer)), t(rbd),
        t(5.0 * randn(batch, 10)), kf_mod.default_kalman_params(dev, dtype),
        kf_mod.KalmanState(*(t(a) for a in kalman)), {k: t(a) for k, a in sensors.items()})


class ContactClassBatch(NamedTuple):
    params: obs_mod.ContactObserverParams
    est_forces: torch.Tensor     # (B, 16)
    cmd_contact: torch.Tensor    # (B, 4) the commanded contacts at tt
    schedule: ms.ModeSchedule    # (B, MAX_PHASES), (B, MAX_PHASES + 1)
    t_period: torch.Tensor       # (B,) the period's start
    tt: torch.Tensor             # (B,) the tick's time
    horizon: float


def contact_class_batch(batch: int = 4096, device=None, dtype=torch.float32,
                        seed: int = 0) -> ContactClassBatch:
    """``batch`` inputs of the full-order loop's contact classification
    (``estim.contact.contact_class``), drawn from ``seed`` in float32 and
    cast to ``dtype`` exactly: per scenario a schedule of 6-40 phases of
    0.05-0.4 s from a start in [0, 30] s (BIG_TIME beyond), each phase's
    mode the previous one's with probability 0.4, else uniform; the tick
    on an event time, one float32 ulp before or after one (four scenarios
    in five), or uniform over the next 1.5 s; the period's start 0-4 ticks
    of 2 ms before it; the observer's forces N(75, 60) with one entry in
    20 NaN; the commanded contacts those of the tick's mode; the product
    shape's 0.8 s horizon."""
    dev = resolve_device(device)
    g = torch.Generator(device="cpu").manual_seed(seed)
    f32 = torch.float32

    def rand(*shape):
        return torch.rand(*shape, generator=g, dtype=f32)

    P = ms.MAX_PHASES
    t0 = 30.0 * rand(batch)
    dur = 0.05 + 0.35 * rand(batch, P)
    ev = t0[:, None] - 0.5 + torch.stack([dur[:, :i + 1].sum(-1) for i in range(P)], -1)
    n_real = torch.randint(6, 41, (batch,), generator=g)
    ev = torch.where(torch.arange(P) < n_real[:, None], ev, torch.tensor(ms.BIG_TIME, dtype=f32))
    modes = torch.randint(0, 4, (batch, P + 1), generator=g)
    keep = rand(batch, P + 1) < 0.4
    for p in range(1, P + 1):
        modes[:, p] = torch.where(keep[:, p], modes[:, p - 1], modes[:, p])
    # the tick: on an event time (kinds 0-2: on it, an ulp before, after)
    i = torch.minimum(torch.randint(0, 41, (batch,), generator=g), n_real - 1)
    e = torch.gather(ev, 1, i[:, None])[:, 0]
    kind = torch.arange(batch) % 5
    tt = torch.where(kind == 1, torch.nextafter(e, torch.tensor(-math.inf)),
                     torch.where(kind == 2, torch.nextafter(e, torch.tensor(math.inf)), e))
    tt = torch.where(kind == 4, t0 + 1.5 * rand(batch), tt)
    t_period = tt - 0.002 * torch.randint(0, 5, (batch,), generator=g).to(f32)
    est = 75.0 + 60.0 * torch.randn(batch, 16, generator=g, dtype=f32)
    est = torch.where(rand(batch, 16) < 0.05, torch.tensor(math.nan), est)
    sched = ms.ModeSchedule(event_times=ev, modes=modes)
    cmd = ms.contact_flags_at_time(sched, tt[:, None])[:, 0]
    t = lambda a: a.to(dev, dtype).contiguous()
    return ContactClassBatch(obs_mod.default_contact_params(dev, dtype), t(est), t(cmd),
                             ms.ModeSchedule(event_times=t(ev), modes=modes.to(dev)),
                             t(t_period), t(tt), 0.8)


# swing_plan_edge_batch's scenarios, in order
SWING_EDGE_CASES = ("all_stance", "single_swing", "single_swing_at_init", "padded_tail",
                    "padded_tail_cycling", "no_real_event", "trot_on_event",
                    "trot_ulp_before_event", "flying_trot_t20_on_event")


def swing_plan_edge_batch(device=None, horizon: float = 0.8):
    """``mpc.swing_plan``'s arguments (model, swing config, planner state,
    schedule, target, init time, x_init, command, default joints, horizon,
    samples), float32, on the schedules at the swing planner's edges, one
    scenario each (SWING_EDGE_CASES): every phase in stance; a single swing
    phase inside the horizon, and one starting at the init time; the padded
    tail (two real events, the init time past the last, the modes constant
    or cycling beyond them); no real event; a trot with the init time on an
    event time and one float32 ulp before it; a flying trot near t = 20 s
    with the init time on an event.  The product shape's 0.8 s horizon and
    6 samples, or ``horizon`` and its samples; per scenario a cmd_vel
    target made at its init time, x_init, the command and the latest stance
    positions drawn from a fixed seed around the standing robot, the yaw
    lead and velocity feedback on."""
    dev = resolve_device(device)
    f32, P, big, H = torch.float32, ms.MAX_PHASES, ms.BIG_TIME, horizon

    def sched(events, modes):
        ev = torch.full((P,), big, dtype=f32)
        ev[:len(events)] = torch.tensor(events, dtype=f32)
        md = torch.full((P + 1,), modes[-1], dtype=torch.int64)
        md[:len(modes)] = torch.tensor(modes)
        return ev, md

    def tiled(tmpl, t0, t1):
        s = ms.tile_template(tmpl("cpu"), t0, t1)
        return s.event_times, s.modes

    trot = tiled(ms.TROT_GAIT, -H, 4 * H)
    on_trot = float(trot[0][trot[0] > 0.1][0])
    fly = tiled(ms.FLYING_TROT_GAIT, 20.0 - H, 20.0 + 4 * H)
    on_fly = float(fly[0][fly[0] > 20.1][0])
    cycling = tiled(ms.TROT_GAIT, 0.1, 0.4)
    cases = {
        "all_stance": (tiled(ms.STANCE_GAIT, -H, 4 * H), 0.37),
        "single_swing": (sched([0.2, 0.5], [3, 1, 3]), 0.1),
        "single_swing_at_init": (sched([0.3, 0.6], [3, 2, 3]), 0.3),
        "padded_tail": (sched([0.1, 0.4], [1, 2, 1]), 0.55),
        "padded_tail_cycling": (cycling, 0.55),
        "no_real_event": (sched([], [3]), 0.2),
        "trot_on_event": (trot, on_trot),
        "trot_ulp_before_event": (trot, float(torch.nextafter(torch.tensor(on_trot, dtype=f32),
                                                              torch.tensor(-math.inf)))),
        "flying_trot_t20_on_event": (fly, on_fly),
    }
    assert tuple(cases) == SWING_EDGE_CASES
    B = len(cases)
    g = torch.Generator(device="cpu").manual_seed(0)
    ev = torch.stack([c[0][0] for c in cases.values()])
    modes = torch.stack([c[0][1] for c in cases.values()])
    t0 = torch.tensor([c[1] for c in cases.values()], dtype=f32)
    qnom = nominal_q(0.63, "cpu", f32)
    x = torch.cat([torch.zeros(6), qnom]) + 0.02 * torch.randn(B, 22, generator=g)
    cmd_vel = torch.tensor([0.25, 0.1, 0.0, 0.3]) + 0.05 * torch.randn(B, 4, generator=g)
    target = tg.cmd_vel_to_target(cmd_vel, x, t0, H, tg.default_cmd_vel_config(nj=10,
                                                                              device="cpu"))
    latest = 0.1 * torch.randn(B, 4, 3, generator=g)
    cmd = 0.2 * torch.randn(B, 6, generator=g)
    m = load_model(device=dev)
    cfg = swp.default_swing_config(dev)._replace(foothold_yaw_lead=torch.tensor(0.1, device=dev),
                                                 foothold_vel_fb=torch.tensor(0.3, device=dev))
    t = lambda a: a.to(dev).contiguous()  # noqa: E731
    return (m, cfg, swp.PlannerState(t(latest)),
            ms.ModeSchedule(t(ev), modes.to(dev)), tg.TargetTrajectories(*map(t, target)),
            t(t0), t(x), t(cmd), t(qnom[6:]).expand(B, -1), H,
            int(H / mpc_mod.JOINT_REF_STEP) + 1)


class CentroidalBatch(NamedTuple):
    model: RobotModel
    plant: fullorder.SimState    # q, v, base_acc of walking robots (empty command ring)
    rbd: torch.Tensor            # (B, 32) the same states
    x: torch.Tensor              # (B, 22) their centroidal states
    u: torch.Tensor              # (B, 22) inputs: contact forces, joint velocities


def centroidal_batch(batch: int = 4096, device=None, dtype=torch.float32,
                     seed: int = 0) -> CentroidalBatch:
    """``batch`` inputs of the loops' sensing, plant and state conversion
    (``synth_imu``, ``rbd_state_to_centroidal``, ``dummy_step``,
    ``state_input_to_v``), walking robots drawn from ``seed`` as
    ``estimator_batch`` draws them: the nominal standing state moved by
    normal offsets (base 1 cm, Euler angles 0.2 rad, joints 0.05 rad),
    velocities of scale 1, and the base acceleration of a walking tick
    (linear 2 m/s^2, angular 10 rad/s^2); their centroidal states
    (``rbd_state_to_centroidal_plain`` in float64); inputs with the
    weight-compensating forces of one of ``WALK_FLAGS``'s contact sets
    (stance and swing feet, or all in flight) plus 10 N of noise on the
    stance feet, and joint velocities of scale 1."""
    from .models.centroidal import rbd_state_to_centroidal_plain

    dev = resolve_device(device)
    f64 = torch.float64
    g = torch.Generator(device="cpu").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, dtype=f64)

    m64 = load_model(device="cpu", dtype=f64)
    q = nominal_q(0.63, "cpu", f64) + torch.cat([0.01 * randn(batch, 3), 0.2 * randn(batch, 3),
                                                 0.05 * randn(batch, 10)], dim=-1)
    v = randn(batch, 16)
    acc = torch.cat([2.0 * randn(batch, 3), 10.0 * randn(batch, 3)], dim=-1)
    rbd = q_v_to_rbd_state(m64, q, v)
    x = rbd_state_to_centroidal_plain(m64, rbd)
    flags = torch.tensor(WALK_FLAGS, dtype=f64)[
        torch.randint(len(WALK_FLAGS), (batch,), generator=g)]
    u = (ocp.weight_compensating_input(m64, flags, 22)
         + torch.cat([10.0 * randn(batch, 12) * flags.repeat_interleave(3, dim=-1),
                      randn(batch, 10)], dim=-1))
    t = lambda a: a.to(dev, dtype).contiguous()
    # base_acc as the plant holds it: a (B, 6) view of a (B, 16) acceleration
    acc16 = torch.cat([acc, torch.zeros(batch, 10, dtype=f64)], dim=-1)
    plant = fullorder.init_sim_state(t(q), t(v))._replace(base_acc=t(acc16)[:, 0:6])
    return CentroidalBatch(load_model(device=dev, dtype=dtype), plant, t(rbd), t(x), t(u))


def rt_commands(periods: int):
    """The real-time demonstration's commands (P, 4): 0.1 s of stance, then
    0.3 m/s forward."""
    cmds = torch.zeros((periods, 4), dtype=torch.float64)
    cmds[10:, 0] = 0.3
    return cmds


def run_sim_loop(setup: SimLoopSetup, cmds):
    """The full-order closed loop over the commands cmds (P, 4) (or
    (P, B, 4)), one MPC period each, from ``setup.state``.  Returns (final
    SimLoopState, telemetry (P, B, ...))."""
    cmds = torch.as_tensor(cmds, dtype=setup.state.plant.q.dtype,
                           device=setup.state.plant.q.device)
    return sim_loop_mod.run_sim_loop(setup.model, setup.settings, setup.params,
                                     setup.planner_cfg, setup.wbc_params, setup.gains,
                                     setup.cmd_cfg, setup.kalman_params, setup.observer_params,
                                     setup.sim_params, setup.config, setup.state, cmds,
                                     cmds.shape[0], setup.default_joints, setup.noise_params)
