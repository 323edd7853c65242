"""Batched dense convex QP by a fixed-count primal-dual interior point —
kernel B4.

Port of ``hunter_bipedal_control_tpu/ops/qp.py``.  Problem form, per batch
row:

    min 0.5 x'Hx + g'x   s.t.  Aeq x = beq,   Ain x <= bin

``solve_qp`` is the kernel wrapper: a CPU tensor goes through
``solve_qp_plain``, a CUDA tensor launches ``csrc/solve_qp.cu`` (one warp
per QP, every iteration in one launch) or raises.  Both keep the JAX
semantics: a failed Cholesky gives NaN (``jnp.linalg.cholesky`` returns a
NaN lower triangle, it does not raise), the factored matrices are
symmetrized first, ``mu_min`` defaults to 50 eps of the dtype, and NaN
propagates through every max and min.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import _build

# the largest n, me, mi the kernel takes (csrc/solve_qp.cu: MAX_DIM)
MAX_DIM = 64


class QpSolution(NamedTuple):
    x: torch.Tensor                # (..., n)
    eq_dual: torch.Tensor          # (..., me)
    ineq_dual: torch.Tensor        # (..., mi)
    iterations: torch.Tensor       # (...,) int32
    primal_residual: torch.Tensor  # (...,)


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _mtv(A, x):
    return (A.transpose(-1, -2) @ x[..., None])[..., 0]


def cholesky_nan(A):
    """Lower Cholesky factor of 0.5 (A + A'), with the lower triangle NaN
    where the factorization fails (``jnp.linalg.cholesky``'s behaviour)."""
    L, info = torch.linalg.cholesky_ex(0.5 * (A + A.transpose(-1, -2)))
    nan = torch.full_like(L, float("nan")).tril()
    return torch.where((info > 0)[..., None, None], nan, L)


def _margin(v, like):
    """warm_margin as a tensor that broadcasts against the (..., m) vectors."""
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return v[..., None] if v.ndim else v


def solve_qp_plain(H, g, Aeq, beq, Ain, bin, n_iters: int = 18, eq_reg: float = 1e-8,
                   frac_to_boundary: float = 0.99, mu_min: float | None = None,
                   x0=None, lam0=None, nu0=None, warm_margin=1e-2) -> QpSolution:
    """The PDIP on batched tensors: H (..., n, n), g (..., n), Aeq (..., me, n),
    beq (..., me), Ain (..., mi, n), bin (..., mi).  ``warm_margin`` is a
    float or a (...,) tensor."""
    n, me, mi = H.shape[-1], Aeq.shape[-2], Ain.shape[-2]
    dtype, dev = H.dtype, H.device
    if mu_min is None:
        mu_min = float(torch.finfo(dtype).eps) * 50.0
    lead = H.shape[:-2]
    margin = _margin(warm_margin, H)

    x = torch.zeros((*lead, n), dtype=dtype, device=dev) if x0 is None else x0
    s = torch.maximum(bin - _mv(Ain, x), torch.ones_like(bin) if x0 is None else margin)
    lam = (torch.ones((*lead, mi), dtype=dtype, device=dev) if lam0 is None
           else torch.maximum(lam0, margin))
    nu = torch.zeros((*lead, me), dtype=dtype, device=dev) if nu0 is None else nu0
    eye_n = torch.eye(n, dtype=dtype, device=dev)
    eye_e = torch.eye(me, dtype=dtype, device=dev)
    AeqT, AinT = Aeq.transpose(-1, -2), Ain.transpose(-1, -2)

    for _ in range(n_iters):
        mu = (s * lam).sum(-1) / mi
        sigma_mu = torch.clamp(0.2 * mu, min=mu_min)[..., None]
        r_dual = _mv(H, x) + g + _mv(AeqT, nu) + _mv(AinT, lam)
        r_eq = _mv(Aeq, x) - beq
        r_ineq = _mv(Ain, x) + s - bin
        r_cent = lam * s - sigma_mu
        s_safe = torch.clamp(s, min=1e-12)
        w = lam / s_safe
        Hbar = H + AinT @ (w[..., None] * Ain)
        rbar = r_dual + _mv(AinT, (lam * r_ineq - r_cent) / s_safe)
        trace = torch.diagonal(Hbar, dim1=-2, dim2=-1).sum(-1)
        L = cholesky_nan(Hbar + (1e-7 * trace / n)[..., None, None] * eye_n)
        sol = torch.cholesky_solve(torch.cat([AeqT, rbar[..., None]], dim=-1), L)
        HiA, Hir = sol[..., :me], sol[..., me]
        Ls = cholesky_nan(Aeq @ HiA + eq_reg * eye_e)
        dnu = torch.cholesky_solve((r_eq - _mv(Aeq, Hir))[..., None], Ls)[..., 0]
        dx = -Hir - _mv(HiA, dnu)
        ds = -r_ineq - _mv(Ain, dx)
        dlam = -(r_cent + lam * ds) / s_safe

        # fraction-to-boundary step (where() sends NaN steps to 1.0, as JAX)
        one = torch.ones_like(s)
        neg_s = torch.where(ds < 0, -frac_to_boundary * s / torch.clamp(ds, max=-1e-12), one)
        neg_l = torch.where(dlam < 0, -frac_to_boundary * lam / torch.clamp(dlam, max=-1e-12),
                            one)
        alpha = torch.clamp(torch.minimum(neg_s.amin(-1), neg_l.amin(-1)), max=1.0)[..., None]
        x = x + alpha * dx
        s = torch.clamp(s + alpha * ds, min=1e-12)
        lam = torch.clamp(lam + alpha * dlam, min=1e-12)
        nu = nu + alpha * dnu

    res = torch.maximum((_mv(Aeq, x) - beq).abs().amax(-1),
                        torch.clamp(_mv(Ain, x) - bin, min=0.0).amax(-1))
    its = torch.full(lead, n_iters, dtype=torch.int32, device=dev)
    return QpSolution(x=x, eq_dual=nu, ineq_dual=lam, iterations=its, primal_residual=res)


def solve_qp(H, g, Aeq, beq, Ain, bin, n_iters: int = 18, eq_reg: float = 1e-8,
             frac_to_boundary: float = 0.99, mu_min: float | None = None,
             x0=None, lam0=None, nu0=None, warm_margin=1e-2) -> QpSolution:
    """Batched PDIP — kernel B4.

    CPU: ``solve_qp_plain``.  CUDA (float32, contiguous, one leading batch
    dim, n, me, mi in 1..``MAX_DIM``): one launch of ``hk_solve_qp``, one
    warp per QP.  A missing start point and a ``warm_margin`` given as a
    number travel as kernel arguments; a margin tensor (a scalar or one per
    QP, at any stride) is read in place."""
    if H.device.type == "cpu":
        return solve_qp_plain(H, g, Aeq, beq, Ain, bin, n_iters, eq_reg, frac_to_boundary,
                              mu_min, x0, lam0, nu0, warm_margin)
    if H.ndim != 3:
        raise ValueError(f"solve_qp kernel takes one batch dim, got H of shape {tuple(H.shape)}")
    Bn, n, me, mi = H.shape[0], H.shape[-1], Aeq.shape[-2], Ain.shape[-2]
    if not (Bn >= 1 and all(1 <= d <= MAX_DIM for d in (n, me, mi))):
        raise ValueError(f"solve_qp kernel takes batch >= 1 and n, me, mi in 1..{MAX_DIM}; "
                         f"got {Bn}, {n}, {me}, {mi}")
    f32, dev = torch.float32, H.device
    if mu_min is None:
        mu_min = float(torch.finfo(f32).eps) * 50.0
    margin, margin_stride, margin_value = None, 0, 0.0
    if torch.is_tensor(warm_margin):
        margin = torch.as_tensor(warm_margin, dtype=f32, device=dev).expand(Bn)
        margin_stride = margin.stride(0)
    else:
        margin_value = float(warm_margin)
    ins = [(H, "H", (n, n)), (g, "g", (n,)), (Aeq, "Aeq", (me, n)), (beq, "beq", (me,)),
           (Ain, "Ain", (mi, n)), (bin, "bin", (mi,)), (x0, "x0", (n,)), (lam0, "lam0", (mi,)),
           (nu0, "nu0", (me,))]
    for t, name, tail in ins:
        if t is not None:
            _build.require(t, name, f32, (Bn, *tail), dev)
    x = torch.empty((Bn, n), dtype=f32, device=dev)
    nu = torch.empty((Bn, me), dtype=f32, device=dev)
    lam = torch.empty((Bn, mi), dtype=f32, device=dev)
    res = torch.empty(Bn, dtype=f32, device=dev)
    its = torch.empty(Bn, dtype=torch.int32, device=dev)
    ptrs = [None if t is None else t.data_ptr() for t, _, _ in ins]
    lib = _build.library()
    _build.check(lib.hk_solve_qp(*ptrs, None if margin is None else margin.data_ptr(),
                                 x.data_ptr(), nu.data_ptr(), lam.data_ptr(), res.data_ptr(),
                                 its.data_ptr(), Bn, n, me, mi, int(n_iters), margin_stride,
                                 float(eq_reg), float(frac_to_boundary), float(mu_min),
                                 margin_value, _build.stream(H)), "solve_qp")
    solve_qp.launches += 1
    return QpSolution(x=x, eq_dual=nu, ineq_dual=lam, iterations=its, primal_residual=res)


solve_qp.launches = 0
