"""SLQ/DDP solver — the reference's alternative solver family.

Port of ``hunter_bipedal_control_tpu/solver/ddp.py``, batched over
scenarios like ``solver/sqp.py``.  Per iteration: the knot linearization
(kernel B1 on the card, ``sqp.knot_linearization_all``), the projection of
the equality rows with d = 0 (kernel B2, ``sqp.project_knot``; the DDP
Gram's inverse, the JAX package's ``gj_inverse`` with its natural-order
pivot, happens inside it), the Riccati backward pass (kernel B3,
``riccati.riccati_solve``, whose linear rollout is not used; on the CPU
``riccati.backward_scan``), the map of the w-space policy back to u-space,
then the nonlinear closed-loop rollouts of every line-search step

    u_k = u_bar_k + alpha kff_k + K_k (x_k - x_bar_k)

in one launch of kernel B15 (``closed_rollout``, ``csrc/ddp_rollout.cu``)
and the selection of the first step whose merit beats the current
trajectory's.  The warm start is first re-rolled open loop (B15 with no
feedback), so every iterate is dynamically feasible.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import _build
from ..models.robot import RobotModel
from ..ocp import problem as ocp
from ..ocp import soa_kernel
from . import riccati, sqp
from .rollout import INTEGRATORS, RolloutSettings, integrator_kind, ode45_step, rollout_step


class DdpSettings(NamedTuple):
    """ddp block of task.info (:36-75)."""

    n_intervals: int = 53
    horizon: float = 0.8
    n_iterations: int = 1          # maxNumIterations
    hess_reg: float = 1e-5         # DIAGONAL_SHIFT hessianCorrection
    proj_reg: float = 1e-6
    min_step: float = 1e-2         # lineSearch.minStepLength
    alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)
    # the rollouts' integrator: 'RK2' (default) | 'ODE45' (the reference's
    # rollout block, task.info:131-140) | 'RK4'; see solver/rollout.py
    integrator: str = "RK2"
    abs_tol: float = 1e-5          # AbsTolODE
    rel_tol: float = 1e-3          # RelTolODE
    max_steps_per_second: float = 10000.0
    max_substeps: int = 16         # bound on ODE45 slots per interval


def rollout_settings(settings: DdpSettings) -> RolloutSettings:
    """The rollouts' integrator settings: ODE45's first step is the interval."""
    return RolloutSettings(
        abs_tol=settings.abs_tol, rel_tol=settings.rel_tol,
        time_step=settings.horizon / settings.n_intervals, integrator=settings.integrator,
        max_steps_per_second=settings.max_steps_per_second,
        max_substeps=settings.max_substeps)


def sqp_settings(settings: DdpSettings) -> sqp.SqpSettings:
    """The SQP pieces DDP shares: the SoA linearization and the projection
    with DDP's regularizations and the pivoting Gram inverse."""
    return sqp.SqpSettings(n_intervals=settings.n_intervals, horizon=settings.horizon,
                           proj_reg=settings.proj_reg, hess_reg=settings.hess_reg,
                           proj_pivot=True, lin_backend="soa")


# ---------------------------------------------------------------------------
# the closed-loop rollouts — kernel B15
# ---------------------------------------------------------------------------


def closed_rollout_plain(model: RobotModel, params: ocp.OcpParams, refs: sqp.ReferenceBundle,
                         x_init, xs_bar, us_bar, Ks, kffs, alphas, rs: RolloutSettings):
    """Nonlinear rollouts of B scenarios under A step sizes (ddp.py:78-96).

    x_init (B, nx), xs_bar (B, N+1, nx), us_bar (B, N, nu), Ks (B, N, nu, nx)
    and kffs (B, N, nu), or both None for the open loop u_k = u_bar_k (the
    re-roll, ddp.py:189-194), alphas (A,).  The interval is ``rs.time_step``.
    Returns xs (B, A, N+1, nx), us (B, A, N, nu), cost (B, A) = sum of
    dt * stage cost, eq (B, A) = sum |g mask|_1 / N and, per knot, ODE45's
    accepted slots (B, A, N) int32 (0 for RK2 and RK4)."""
    kind = integrator_kind(rs)
    dt = rs.time_step
    Bn, N = us_bar.shape[0], us_bar.shape[1]
    A = alphas.shape[0]
    x = x_init[:, None].expand(Bn, A, -1)
    a = alphas[None, :, None]
    xs, us, cs, gs, slots = [], [], [], [], []
    for k in range(N):
        if Ks is None:
            u = us_bar[:, None, k].expand(Bn, A, -1)
        else:
            fb = (Ks[:, None, k] @ (x - xs_bar[:, None, k])[..., None])[..., 0]
            u = us_bar[:, None, k] + a * kffs[:, None, k] + fb
        ref = [r[:, None, k].expand(Bn, A, *r.shape[2:]) for r in
               (refs.x_nom, refs.contact_flags, refs.foot_pos_ref, refs.foot_vel_ref)]
        c, g, _ = ocp.stage_cost_eq(model, params, x, u, *ref)
        xs.append(x)
        us.append(u)
        cs.append(c * dt)
        gs.append(g.abs().sum(-1))
        if kind == "ODE45":
            x, n_acc = ode45_step(model, x, u, dt, rs, with_accepted=True)
        else:
            x, n_acc = rollout_step(model, x, u, dt, rs), torch.zeros_like(c, dtype=torch.int32)
        slots.append(n_acc)
    xs.append(x)
    return (torch.stack(xs, dim=2), torch.stack(us, dim=2), torch.stack(cs, -1).sum(-1),
            torch.stack(gs, -1).sum(-1) / N, torch.stack(slots, -1))


# the kernel's integrator argument (csrc/ddp_rollout.cu: 0 RK2, 1 RK4, 2 ODE45)
INTEGRATOR_CODE = {kind: i for i, kind in enumerate(INTEGRATORS)}


def closed_rollout(model: RobotModel, params: ocp.OcpParams, refs: sqp.ReferenceBundle,
                   x_init, xs_bar, us_bar, Ks, kffs, alphas, rs: RolloutSettings):
    """``closed_rollout_plain``'s outputs — kernel B15.

    CPU: the plain version.  CUDA (float32): one launch of
    ``hk_ddp_rollout``, a thread per (scenario, step size) walking the N
    knots, or an error: every input float32, contiguous, on one card (the
    references as B1 takes them, (B, N+1, ...)); the model's constants from
    B1's buffer (``soa_kernel.consts_buffer``, which refuses a model of
    another topology)."""
    if x_init.device.type == "cpu":
        return closed_rollout_plain(model, params, refs, x_init, xs_bar, us_bar, Ks, kffs,
                                    alphas, rs)
    kind = integrator_kind(rs)
    if us_bar.dim() != 3:
        raise ValueError(f"us_bar: expected (B, N, nu), got {tuple(us_bar.shape)}")
    Bn, N = us_bar.shape[0], us_bar.shape[1]
    A = alphas.shape[0] if alphas.dim() == 1 else -1
    if not 0 < Bn * A <= _build.MAX_SCENARIOS or N < 1:
        raise ValueError(f"closed_rollout: B A = {Bn * A} rollouts (1..{_build.MAX_SCENARIOS}),"
                         f" N = {N}")
    if (Ks is None) != (kffs is None):
        raise ValueError("closed_rollout: pass both Ks and kffs, or neither")
    if not 0 < rs.max_substeps:
        raise ValueError("closed_rollout: max_substeps must be positive")
    f32, dev, nx, nu = torch.float32, x_init.device, soa_kernel.NX, soa_kernel.NU
    ins = [(x_init, "x_init", (Bn, nx)), (xs_bar, "xs_bar", (Bn, N + 1, nx)),
           (us_bar, "us_bar", (Bn, N, nu)), (alphas, "alphas", (A,))]
    if Ks is not None:
        ins += [(Ks, "Ks", (Bn, N, nu, nx)), (kffs, "kffs", (Bn, N, nu))]
    for t, name, shape in ins:
        _build.require(t, name, f32, shape, dev)
    consts, prm, Q, R, _, _, x_nom, flags, fpr, fvr = soa_kernel.kernel_inputs(
        model, params, xs_bar, us_bar, *sqp.kernel_refs(refs), (Bn,))
    xs = torch.empty((Bn, A, N + 1, nx), dtype=f32, device=dev)
    us = torch.empty((Bn, A, N, nu), dtype=f32, device=dev)
    cost = torch.empty((Bn, A), dtype=f32, device=dev)
    eq = torch.empty_like(cost)
    slots = torch.empty((Bn, A, N), dtype=torch.int32, device=dev)
    fb = (None, None) if Ks is None else (Ks.data_ptr(), kffs.data_ptr())
    _build.check(_build.library().hk_ddp_rollout(
        consts.data_ptr(), prm.data_ptr(), Q.data_ptr(), R.data_ptr(), x_init.data_ptr(),
        xs_bar.data_ptr(), us_bar.data_ptr(), *fb, alphas.data_ptr(), x_nom.data_ptr(),
        flags.data_ptr(), fpr.data_ptr(), fvr.data_ptr(), xs.data_ptr(), us.data_ptr(),
        cost.data_ptr(), eq.data_ptr(), slots.data_ptr(), Bn, A, N, INTEGRATOR_CODE[kind],
        rs.max_substeps, float(rs.time_step), float(rs.abs_tol), float(rs.rel_tol),
        float(1.0 / rs.max_steps_per_second), _build.stream(x_init)), "ddp_rollout")
    closed_rollout.launches += 1
    return xs, us, cost, eq, slots


closed_rollout.launches = 0


# ---------------------------------------------------------------------------
# solver
# ---------------------------------------------------------------------------


def _pick(a, idx):
    """a (B, A, ...) at each scenario's index idx (B,) -> (B, ...)."""
    return a[torch.arange(a.shape[0], device=a.device), idx]


def solve(model: RobotModel, settings: DdpSettings, params: ocp.OcpParams,
          refs: sqp.ReferenceBundle, x_init, xs_ws, us_ws, on_iteration=None,
          riccati_solver: str = "ns") -> sqp.SqpSolution:
    """``settings.n_iterations`` SLQ iterations per scenario from a warm
    start (feasible or not), x_init (B, nx), xs_ws (B, N+1, nx), us_ws (B, N,
    nu).  The warm start is re-rolled open loop first.  ``on_iteration``,
    if given, receives each iteration's data as a dict (the trajectory it
    linearized, the LQ data before and after the projection, the policy,
    every rollout and the choice).  ``riccati_solver`` picks the backward
    pass's Huu solve on the CPU: 'ns' (the JAX package's Newton-Schulz) or
    'gj' (exact); on the card B3 solves exactly (Cholesky).

    The cost and constraint metric of the trajectory an iteration starts
    from, and the solution's, are those its rollout computed (the re-roll's,
    or the chosen rollout's): the JAX package evaluates ``stage_total``
    again on the same trajectory (ddp.py:159, :198)."""
    if params.collision is not None:
        raise NotImplementedError("self-collision terms are not ported yet")
    if settings.n_iterations < 1:
        raise ValueError("DDP runs at least one iteration")
    sset = sqp_settings(settings)
    rs = rollout_settings(settings)
    integrator_kind(rs)
    Bn, nx = x_init.shape
    dtype, dev = x_init.dtype, x_init.device
    alphas = torch.tensor(settings.alphas, dtype=dtype, device=dev)

    x_init, us = x_init.contiguous(), us_ws.contiguous()
    xs, _, cost0, eq0, _ = closed_rollout(model, params, refs, x_init, xs_ws.contiguous(), us,
                                          None, None, alphas[:1], rs)
    xs, cost0, eq0 = xs[:, 0], cost0[:, 0], eq0[:, 0]
    zero_x = torch.zeros((Bn, nx), dtype=dtype, device=dev)
    for _ in range(settings.n_iterations):
        lin = sqp.knot_linearization_all(model, sset, params, refs, xs, us)
        (_, A, B, _, qx, qu, Qxx, Quu, Qux, g, C, D, gmask) = lin
        d = torch.zeros_like(qx)
        # single shooting: no defects, and the projection's B e term of
        # d_t is dropped (ddp.py:143)
        (A_t, B_t, _, qx_t, qw, Qxx_t, Qww, Qwx, E, e0, P) = sqp.project_knot(
            sset, *(t.contiguous() for t in (A, B, d, qx, qu, Qxx, Quu, Qux, g, C, D, gmask)))
        lq = riccati.StageLQ(*(t.contiguous() for t in (A_t, B_t, d, Qxx_t, Qww, Qwx, qx_t,
                                                        qw)))
        if dev.type == "cpu":
            Kw, kw, _, _ = riccati.backward_scan(
                lq, torch.zeros((Bn, nx, nx), dtype=dtype, device=dev), zero_x,
                settings.hess_reg, solver=riccati_solver)
        else:
            Kw, kw, _, _ = riccati.riccati_solve(lq, E.contiguous(), P.contiguous(),
                                                 e0.contiguous(), zero_x, settings.hess_reg)
        # du = e + E dx + P (Kw dx + kw)  ->  K = E + P Kw, kff = e + P kw
        Ks = E + P @ Kw
        kffs = e0 + (P @ kw[..., None])[..., 0]

        xs_a, us_a, cost_a, eq_a, slots = closed_rollout(
            model, params, refs, x_init, xs, us, Ks.contiguous(), kffs.contiguous(), alphas, rs)
        merit_a = cost_a + 10.0 * eq_a
        merit0 = cost0 + 10.0 * eq0
        finite = torch.isfinite(merit_a)
        accept = (merit_a < merit0[:, None]) & finite
        any_ok = accept.any(-1)
        best = torch.where(any_ok, torch.argmax(accept.to(torch.int32), dim=-1),
                           torch.argmin(torch.where(finite, merit_a, torch.inf), dim=-1))
        # keep the old trajectory if no step size gave a finite merit
        keep = ~finite.any(-1)
        if on_iteration is not None:
            on_iteration(dict(xs=xs, us=us, lin=lin, lq=lq, E=E, P=P, e=e0, Kw=Kw, kw=kw,
                              Ks=Ks, kffs=kffs, xs_a=xs_a, us_a=us_a, cost_a=cost_a,
                              eq_a=eq_a, slots=slots, best=best, any_ok=any_ok, keep=keep))
        k3 = keep[:, None, None]
        xs = torch.where(k3, xs, _pick(xs_a, best))
        us = torch.where(k3, us, _pick(us_a, best))
        cost0 = torch.where(keep, cost0, _pick(cost_a, best))
        eq0 = torch.where(keep, eq0, _pick(eq_a, best))
        step = alphas[best] * any_ok.to(dtype)

    return sqp.SqpSolution(times=refs.times, states=xs, inputs=torch.cat([us, us[:, -1:]], dim=1),
                           cost=cost0, constraint_violation=eq0, step_size=step)
