"""Multiple-shooting SQP over the centroidal OCP.

Port of ``hunter_bipedal_control_tpu/solver/sqp.py``: per-knot
linearization and the line search's merit (``knot_linearization_all`` and
``eval_merit``; with ``lin_backend='soa'``, the default, kernel B1 on the
card, ``ocp/soa_kernel.py``), the equality projection (kernel B2,
``project_knot``), the Riccati sweep and forward rollout (kernel B3,
``riccati.riccati_solve``, or with ``riccati_parallel`` kernel B5,
``riccati.riccati_solve_parallel``) and the filter line search.  Every
array carries a leading scenario dim B; knots follow it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import _build
from ..models.robot import RobotModel
from ..ocp import problem as ocp
from ..ocp import soa_kernel
from ..ops.linalg import gj_inverse_plain
from . import riccati


class SqpSettings(NamedTuple):
    """Static solver configuration (sqp block of task.info; see the JAX
    package for each knob).  ``lin_backend`` selects the linearization and
    merit: 'soa' (default, as in the JAX package) runs the scalarized SoA
    batch forms on the CPU and kernel B1 on the card; 'dense' runs the
    dense forms (plain torch) on both.  Both Riccati modes and the 'model'
    line search are ported.  ``riccati_solver``, ``riccati_ns_iters`` and
    ``riccati_ns_refine`` choose the Huu solve of the sequential Riccati on
    the CPU only; with ``riccati_parallel``, ``riccati_solver='gj'`` makes
    every solve of the CPU's associative Riccati exact (the JAX package
    ignores it there).  On the card both Riccati kernels solve exactly
    (Cholesky).  ``small_mm`` selects the NS ('vpu') or Cholesky ('mxu')
    stage-element solve of the CPU's associative Riccati, as in the JAX
    package; ``riccati_ns_precision`` only routes TPU products and is
    ignored here."""

    n_intervals: int = 53
    horizon: float = 0.8
    n_iterations: int = 1
    proj_reg: float = 1e-6
    hess_reg: float = 1e-6
    riccati_parallel: bool = False
    g_max: float = 1e-2
    g_min: float = 1e-6
    alphas: tuple = (1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125)
    armijo_factor: float = 1e-4
    linesearch: str = "model"
    riccati_solver: str = "ns"
    riccati_ns_iters: int = 20
    riccati_ns_refine: int = 2
    riccati_ns_precision: str = "highest"
    small_mm: str = "vpu"
    proj_pivot: bool = False
    lin_backend: str = "soa"


class ReferenceBundle(NamedTuple):
    """Per-knot reference data (N+1 knots) per scenario."""

    times: torch.Tensor          # (B, N+1)
    x_nom: torch.Tensor          # (B, N+1, nx)
    contact_flags: torch.Tensor  # (B, N+1, 4)
    foot_pos_ref: torch.Tensor   # (B, N+1, 4, 3)
    foot_vel_ref: torch.Tensor   # (B, N+1, 4, 3)


class SqpSolution(NamedTuple):
    times: torch.Tensor     # (B, N+1)
    states: torch.Tensor    # (B, N+1, nx)
    inputs: torch.Tensor    # (B, N+1, nu)  (last row repeats N-1)
    cost: torch.Tensor      # (B,)
    constraint_violation: torch.Tensor  # (B,)
    step_size: torch.Tensor  # (B,) accepted alpha of the last iteration


def check_settings(settings: SqpSettings) -> None:
    """Refuse configurations this port does not run yet."""
    if settings.lin_backend not in ("soa", "dense"):
        raise ValueError(f"unknown lin_backend {settings.lin_backend!r}")
    if settings.riccati_solver not in ("ns", "gj"):
        raise ValueError(f"unknown riccati_solver {settings.riccati_solver!r}")
    if settings.linesearch != "model":
        raise NotImplementedError("only linesearch='model' is ported")


# ---------------------------------------------------------------------------
# constraint projection — kernel B2
# ---------------------------------------------------------------------------


def project_knot_plain(settings: SqpSettings, A_, B_, d_, qx_, qu_, Qxx_, Quu_,
                       Qux_, g_, C_, D_, mask_):
    """Eliminate the equality rows at each knot (leading dims ...) by the
    fixed-shape projection du = e + E dx + P w, P = I - D^+ D, and rewrite
    the LQ data in w.  Masked rows carry a unit Gram diagonal."""
    nu = B_.shape[-1]
    nx = A_.shape[-1]
    m = D_.shape[-2]
    eye_u = torch.eye(nu, dtype=A_.dtype, device=A_.device)
    Dt = D_.transpose(-1, -2)
    DDt = (D_ @ Dt + torch.diag_embed(1.0 - mask_)
           + settings.proj_reg * torch.eye(m, dtype=D_.dtype, device=D_.device))
    Dpinv = Dt @ gj_inverse_plain(DDt, pivot=settings.proj_pivot)      # (..., nu, m)
    X = Dpinv @ torch.cat([g_[..., None], C_, D_], dim=-1)
    e = -X[..., :, 0]
    E = -X[..., :, 1:1 + nx]
    P = eye_u - X[..., :, 1 + nx:]

    U = torch.cat([e[..., None], E, P], dim=-1)
    YQ = Quu_ @ U
    Qe = YQ[..., :, 0] + qu_
    QuuE = YQ[..., :, 1:1 + nx]
    QuuP = YQ[..., :, 1 + nx:]
    BU = B_ @ U
    d_t = d_ + BU[..., :, 0]
    A_t = A_ + BU[..., :, 1:1 + nx]
    B_t = BU[..., :, 1 + nx:]

    R1 = torch.cat([Qe[..., None], QuuE, Qux_, QuuP], dim=-1)
    T = torch.cat([E, P], dim=-1).transpose(-1, -2) @ R1             # (..., nx+nu, 1+2nx+nu)
    TE, TP = T[..., :nx, :], T[..., nx:, :]
    qx_t = qx_ + TE[..., :, 0] + (Qux_.transpose(-1, -2) @ e[..., None])[..., 0]
    qw = TP[..., :, 0]
    EQux = TE[..., :, 1 + nx:1 + 2 * nx]
    Qxx_t = Qxx_ + TE[..., :, 1:1 + nx] + EQux + EQux.transpose(-1, -2)
    Qwx = TP[..., :, 1:1 + nx] + TP[..., :, 1 + nx:1 + 2 * nx]
    sigma = 1.0 + torch.diagonal(Quu_, dim1=-2, dim2=-1).sum(-1) / nu
    Qww = (TP[..., :, 1 + 2 * nx:] + sigma[..., None, None] * (eye_u - P)
           + settings.hess_reg * eye_u)
    return A_t, B_t, d_t, qx_t, qw, Qxx_t, Qww, Qwx, E, e, P


def project_knot(settings: SqpSettings, A_, B_, d_, qx_, qu_, Qxx_, Quu_,
                 Qux_, g_, C_, D_, mask_):
    """Per-knot equality projection — kernel B2.

    Returns (A_t, B_t, d_t, qx_t, qw, Qxx_t, Qww, Qwx, E, e, P).  CPU:
    ``project_knot_plain``.  CUDA (float32, nx = nu = 22, 16 rows): one
    launch of ``hk_project_knot``, one block per knot over all leading dims."""
    if A_.device.type == "cpu":
        return project_knot_plain(settings, A_, B_, d_, qx_, qu_, Qxx_, Quu_,
                                  Qux_, g_, C_, D_, mask_)
    nx, nu, m = A_.shape[-1], B_.shape[-1], D_.shape[-2]
    if (nx, nu, m) != (22, 22, 16):
        raise ValueError(f"project_knot kernel is built for nx=nu=22, m=16; got {nx},{nu},{m}")
    lead = A_.shape[:-2]
    f32, dev = torch.float32, A_.device
    ins = [(A_, "A", (nx, nx)), (B_, "B", (nx, nu)), (d_, "d", (nx,)), (qx_, "qx", (nx,)),
           (qu_, "qu", (nu,)), (Qxx_, "Qxx", (nx, nx)), (Quu_, "Quu", (nu, nu)),
           (Qux_, "Qux", (nu, nx)), (g_, "g", (m,)), (C_, "C", (m, nx)), (D_, "D", (m, nu)),
           (mask_, "mask", (m,))]
    for t, name, tail in ins:
        _build.require(t, name, f32, (*lead, *tail), dev)
    n_knots = A_.numel() // (nx * nx)
    if n_knots == 0:
        raise ValueError("project_knot kernel needs at least one knot")

    def out(*tail):
        return torch.empty((*lead, *tail), dtype=f32, device=dev)

    outs = [out(nx, nx), out(nx, nu), out(nx), out(nx), out(nu), out(nx, nx),
            out(nu, nu), out(nu, nx), out(nu, nx), out(nu), out(nu, nu)]
    lib = _build.library()
    ptrs = [t.data_ptr() for t, _, _ in ins] + [o.data_ptr() for o in outs]
    _build.check(lib.hk_project_knot(*ptrs, n_knots, float(settings.proj_reg),
                                     float(settings.hess_reg), int(settings.proj_pivot),
                                     _build.stream(A_)), "project_knot")
    project_knot.launches += 1
    return tuple(outs)


project_knot.launches = 0


# ---------------------------------------------------------------------------
# solver
# ---------------------------------------------------------------------------


def initializer_trajectories(model: RobotModel, settings: SqpSettings, refs: ReferenceBundle,
                             x_init):
    """LeggedRobotInitializer parity: hold the measured state, weight-
    compensating inputs from the contact schedule.  x_init (B, nx)."""
    N = settings.n_intervals
    nu = 12 + model.nj
    xs = x_init[:, None, :].expand(-1, N + 1, -1).clone()
    us = ocp.weight_compensating_input(model, refs.contact_flags[:, :N], nu, x_init.dtype)
    return xs, us


def _first_true(mask):
    """Index of the first True along the last dim (0 when none)."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


def _take(a, idx):
    return torch.gather(a, -1, idx[..., None])[..., 0]


def _knot_refs(settings: SqpSettings, refs: ReferenceBundle):
    """The references at the N linearized knots: (x_nom, flags, fpr, fvr)."""
    N = settings.n_intervals
    return (refs.x_nom[:, :N], refs.contact_flags[:, :N], refs.foot_pos_ref[:, :N],
            refs.foot_vel_ref[:, :N])


def _kernel_refs(refs: ReferenceBundle):
    """The N+1-knot references as the B1 kernel takes them (contiguous)."""
    return tuple(a.contiguous() for a in (refs.x_nom, refs.contact_flags, refs.foot_pos_ref,
                                          refs.foot_vel_ref))


def knot_linearization_all_plain(model: RobotModel, settings: SqpSettings,
                                 params: ocp.OcpParams, refs: ReferenceBundle, xs, us):
    """All per-knot LQ data of B trajectories (xs (B, N+1, nx), us (B, N, nu))
    in one batched pass of the backend's plain forms (SoA:
    ``knot_linearization_batch``; dense: ``knot_linearization_fused``),
    cost quadratics dt-scaled and equality rows masked:
    (xnext, A, B, cost, qx, qu, Qxx, Quu, Qux, g, C, D, mask)."""
    dt = settings.horizon / settings.n_intervals
    lin = (ocp.knot_linearization_fused if settings.lin_backend == "dense"
           else ocp.knot_linearization_batch)
    (xnext, A, B, cost, qx, qu, Qxx, Quu, Qux, g, C, D, mask) = lin(
        model, params, xs[:, :settings.n_intervals], us, *_knot_refs(settings, refs), dt)
    cost, qx, qu, Qxx, Quu, Qux = (dt * a for a in (cost, qx, qu, Qxx, Quu, Qux))
    return xnext, A, B, cost, qx, qu, Qxx, Quu, Qux, g, C * mask[..., None], D * mask[..., None], mask


def knot_linearization_all(model: RobotModel, settings: SqpSettings, params: ocp.OcpParams,
                           refs: ReferenceBundle, xs, us):
    """``knot_linearization_all_plain``'s outputs.  'dense', or any backend
    on the CPU: the plain version.  'soa' on CUDA: one launch of kernel B1's
    ``hk_soa_linearize`` (``soa_kernel.soa_linearize``)."""
    if settings.lin_backend == "dense" or xs.device.type == "cpu":
        return knot_linearization_all_plain(model, settings, params, refs, xs, us)
    return soa_kernel.soa_linearize(model, params, xs.contiguous(), us.contiguous(),
                                    *_kernel_refs(refs), settings.horizon / settings.n_intervals)


def eval_merit_plain(model: RobotModel, settings: SqpSettings, params: ocp.OcpParams,
                     refs: ReferenceBundle, xs, us):
    """(total cost, constraint metric) of trajectories with a candidate dim:
    xs (B, K, N+1, nx), us (B, K, N, nu) -> (B, K), by the backend's plain
    forms (SoA: ``stage_merit_batch``; dense: ``stage_merit_fused``).  The
    metric is |defects|_1 / N + |eq residual|_1 / N."""
    N = settings.n_intervals
    dt = settings.horizon / N
    merit = ocp.stage_merit_fused if settings.lin_backend == "dense" else ocp.stage_merit_batch
    rep = [a[:, None].expand(-1, xs.shape[1], *a.shape[1:]) for a in _knot_refs(settings, refs)]
    costs, xnext, eq_res = merit(model, params, xs[:, :, :N], us, *rep, dt)
    defects = xs[:, :, 1:] - xnext
    g_metric = defects.abs().sum((-1, -2)) / N + eq_res.abs().sum((-1, -2)) / N
    return dt * costs.sum(-1), g_metric


def eval_merit(model: RobotModel, settings: SqpSettings, params: ocp.OcpParams,
               refs: ReferenceBundle, xs, us):
    """``eval_merit_plain``'s outputs.  'dense', or any backend on the CPU:
    the plain version.  'soa' on CUDA: one launch of kernel B1's
    ``hk_soa_merit`` for all candidates (``soa_kernel.soa_merit``)."""
    if settings.lin_backend == "dense" or xs.device.type == "cpu":
        return eval_merit_plain(model, settings, params, refs, xs, us)
    return soa_kernel.soa_merit(model, params, xs.contiguous(), us.contiguous(),
                                *_kernel_refs(refs), settings.horizon / settings.n_intervals)


def solve(model: RobotModel, settings: SqpSettings, params: ocp.OcpParams,
          refs: ReferenceBundle, x_init, xs_ws, us_ws):
    """One MPC solve per scenario: ``n_iterations`` SQP iterations from the
    warm start.  x_init (B, nx), xs_ws (B, N+1, nx), us_ws (B, N, nu)."""
    check_settings(settings)
    if params.collision is not None:
        raise NotImplementedError("self-collision terms are not ported yet")
    N = settings.n_intervals
    Bn = x_init.shape[0]
    dtype, dev = x_init.dtype, x_init.device

    def sqp_iteration(xs, us):
        (xnext, A, B, cost_k, qx, qu, Qxx, Quu, Qux, g, C, D, gmask) = (
            knot_linearization_all(model, settings, params, refs, xs, us))
        defects = xnext - xs[:, 1:]

        (A_t, B_t, d_t, qx_t, qw, Qxx_t, Qww, Qwx, E, e0, P) = project_knot(
            settings, *(t.contiguous() for t in (A, B, defects, qx, qu, Qxx, Quu, Qux,
                                                  g, C, D, gmask)))

        lq = riccati.StageLQ(*(t.contiguous() for t in (A_t, B_t, d_t, Qxx_t, Qww, Qwx,
                                                        qx_t, qw)))
        rargs = (lq, *(t.contiguous() for t in (E, P, e0, x_init - xs[:, 0])),
                 settings.hess_reg)
        if settings.riccati_parallel and xs.device.type == "cpu":
            _, _, dxs_full, dus = riccati.riccati_solve_parallel_plain(
                *rargs, settings.small_mm, settings.riccati_solver == "gj")
        elif settings.riccati_parallel:
            _, _, dxs_full, dus = riccati.riccati_solve_parallel(*rargs)
        elif xs.device.type == "cpu":
            _, _, dxs_full, dus = riccati.riccati_solve_plain(
                *rargs, settings.riccati_ns_iters, settings.riccati_ns_refine,
                settings.riccati_solver)
        else:
            _, _, dxs_full, dus = riccati.riccati_solve(*rargs)

        # ---- line search ----
        cost0 = cost_k.sum(-1)
        g0 = defects.abs().sum((-1, -2)) / N + g.abs().sum((-1, -2)) / N
        cost0_, g0_ = cost0[:, None], g0[:, None]

        def filter_accept(cost_a, g_a, alphas_v):
            finite = torch.isfinite(cost_a) & torch.isfinite(g_a)
            reduce_g = g_a < (1.0 - 1e-3) * g0_
            armijo = cost_a < cost0_ - settings.armijo_factor * alphas_v * cost0_.abs()
            accept = torch.where(
                g0_ > settings.g_max, reduce_g,
                torch.where(g0_ < settings.g_min, armijo, reduce_g | (cost_a < cost0_)))
            return accept & finite

        # the Gauss-Newton model pre-selects alpha; the exact merit is taken
        # at that alpha and at a quarter-step fallback
        alphas_all = torch.tensor(settings.alphas, dtype=dtype, device=dev).expand(Bn, -1)
        dx_ = dxs_full[:, :-1]
        c1 = torch.einsum("bki,bki->b", qx, dx_) + torch.einsum("bki,bki->b", qu, dus)
        c2 = (torch.einsum("bki,bkij,bkj->b", dx_, Qxx, dx_)
              + 2.0 * torch.einsum("bki,bkij,bkj->b", dus, Qux, dx_)
              + torch.einsum("bki,bkij,bkj->b", dus, Quu, dus))
        cost_m = cost0_ + alphas_all * c1[:, None] + 0.5 * alphas_all ** 2 * c2[:, None]
        g_m = (1.0 - alphas_all) * g0_
        accept_m = filter_accept(cost_m, g_m, alphas_all)
        score_m = torch.where(g0_ > settings.g_max, g_m, cost_m)
        score_m = torch.where(torch.isfinite(score_m), score_m, torch.inf)
        alpha_hat = torch.where(accept_m.any(-1),
                                _take(alphas_all, _first_true(accept_m)),
                                _take(alphas_all, torch.argmin(score_m, dim=-1)))
        alphas = torch.stack([alpha_hat, 0.25 * alpha_hat], dim=-1)

        a4 = alphas[:, :, None, None]
        cost_a, g_a = eval_merit(model, settings, params, refs,
                                 xs[:, None] + a4 * dxs_full[:, None],
                                 us[:, None] + a4 * dus[:, None])
        finite = torch.isfinite(cost_a) & torch.isfinite(g_a)
        accept = filter_accept(cost_a, g_a, alphas)
        idx = _first_true(accept)
        any_ok = accept.any(-1)
        smallest_finite = torch.where(finite.any(-1), alphas[:, -1] * finite[:, -1], 0.0)
        alpha = torch.where(any_ok, _take(alphas, idx), smallest_finite)

        a3 = alpha[:, None, None]
        xs_new = xs + a3 * dxs_full
        us_new = us + a3 * dus
        cost_acc = torch.where(alpha > 0.0,
                               torch.where(any_ok, _take(cost_a, idx), cost_a[:, -1]), cost0)
        g_acc = torch.where(alpha > 0.0, torch.where(any_ok, _take(g_a, idx), g_a[:, -1]), g0)
        return xs_new, us_new, alpha, cost_acc, g_acc

    xs, us = xs_ws, us_ws
    for _ in range(settings.n_iterations):
        xs, us, alpha, cost_acc, g_acc = sqp_iteration(xs, us)

    return SqpSolution(
        times=refs.times,
        states=xs,
        inputs=torch.cat([us, us[:, -1:]], dim=1),
        cost=cost_acc,
        constraint_violation=g_acc,
        step_size=alpha,
    )
