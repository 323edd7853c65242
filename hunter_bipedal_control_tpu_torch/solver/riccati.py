"""Riccati sweeps + forward rollout: sequential (kernel B3) and
parallel-in-time (kernel B5).

Port of ``hunter_bipedal_control_tpu/solver/riccati.py`` and of the two
forward rollouts in ``solver/sqp.py::solve``.

* ``riccati_solve`` (B3, ``riccati_parallel=False``): the sequential
  backward sweep ``backward_scan`` and the rollout scan.  Its plain version
  is the JAX algorithm (Newton-Schulz solve of Huu, 20 iterations + 2
  refinements), or its ``riccati_solver='gj'`` exact solve; on a CUDA
  tensor it launches ``csrc/riccati.cu``, which solves Huu exactly by a
  Cholesky factor of its symmetric part (NS was a TPU workaround for
  row-sequential LU) and forms S by the Gram form S = sym(Qxx) + H_xx -
  Yx' Yx, Y = L^-1 [Hux hu], so its gains leave the recursion's chain.
* ``riccati_solve_parallel`` (B5, ``riccati_parallel=True``, the B=1
  latency configuration): per-stage scattering elements, a reverse
  associative scan of their star products, gains read back per knot, and
  the closed-loop rollout as an associative scan of affine maps.  Its plain
  version is the JAX algorithm (NS solves), or with ``exact=True`` Cholesky
  and LU solves, the float64 yardstick; on a CUDA tensor it launches
  ``csrc/riccati_assoc.cu``, whose solves are exact.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import _build
from ..ops.linalg import gj_solve, ns_inverse, spd_solve
from ..ops.scan import associative_scan


class StageLQ(NamedTuple):
    """Per-knot LQ data after projection, (..., N, ...) per field."""

    A: torch.Tensor     # (..., N, nx, nx)
    B: torch.Tensor     # (..., N, nx, nu)
    d: torch.Tensor     # (..., N, nx)
    Qxx: torch.Tensor   # (..., N, nx, nx)
    Qww: torch.Tensor   # (..., N, nu, nu)
    Qwx: torch.Tensor   # (..., N, nu, nx)
    qx: torch.Tensor    # (..., N, nx)
    qw: torch.Tensor    # (..., N, nu)


def backward_scan(lq: StageLQ, S_term, s_term, reg: float, ns_iters: int = 20,
                  ns_refine: int = 2, solver: str = "ns"):
    """Sequential Riccati, returns (Ks, kffs, Ss, ss); Ss[k], ss[k] are the
    value function at knot k+1 that step k consumed.  ``solver``: 'ns'
    (Newton-Schulz + refinement, the JAX default) or 'gj' (no-pivot
    Gauss-Jordan, an exact solve)."""
    nx = lq.A.shape[-1]
    nu = lq.B.shape[-1]
    N = lq.A.shape[-3]
    eye_u = torch.eye(nu, dtype=lq.A.dtype, device=lq.A.device)
    S, s = S_term, s_term
    Ks, kffs, Ss, ss = [None] * N, [None] * N, [None] * N, [None] * N
    for k in range(N - 1, -1, -1):
        A, B, d = lq.A[..., k, :, :], lq.B[..., k, :, :], lq.d[..., k, :]
        M = torch.cat([A, B, d[..., None]], dim=-1)                   # (..., nx, nx+nu+1)
        ABt = torch.cat([A.transpose(-1, -2), B.transpose(-1, -2)], dim=-2)
        SM = S @ M
        SM = torch.cat([SM[..., :-1], (SM[..., -1] + s)[..., None]], dim=-1)
        H = ABt @ SM                                                  # (..., nx+nu, nx+nu+1)
        Huu = lq.Qww[..., k, :, :] + H[..., nx:, nx:nx + nu]
        shift = reg * (1.0 + torch.diagonal(Huu, dim1=-2, dim2=-1).sum(-1) / nu)
        Huu = Huu + shift[..., None, None] * eye_u
        Hux = lq.Qwx[..., k, :, :] + H[..., nx:, :nx]
        hu = lq.qw[..., k, :] + H[..., nx:, -1]
        rhs = torch.cat([Hux, hu[..., None]], dim=-1)
        Kk = -(gj_solve(Huu, rhs) if solver == "gj" else spd_solve(Huu, rhs, ns_iters, ns_refine))
        HK = Hux.transpose(-1, -2) @ Kk
        S_new = lq.Qxx[..., k, :, :] + H[..., :nx, :nx] + HK[..., :nx]
        S_new = 0.5 * (S_new + S_new.transpose(-1, -2))
        s_new = lq.qx[..., k, :] + H[..., :nx, -1] + HK[..., nx]
        Ks[k], kffs[k], Ss[k], ss[k] = Kk[..., :nx], Kk[..., nx], S, s
        S, s = S_new, s_new
    return (torch.stack(Ks, dim=-3), torch.stack(kffs, dim=-2),
            torch.stack(Ss, dim=-3), torch.stack(ss, dim=-2))


def forward_rollout(Ks, kffs, E, P, e, A, B, d, dx0):
    """Linear rollout of the deltas (sqp.py:338-361):
    w = K dx + kff, du = e + E dx + P w, dx' = A dx + B w + d.
    Returns dxs (..., N+1, nx), dus (..., N, nu)."""
    N = Ks.shape[-3]
    mv = lambda M_, v_: (M_ @ v_[..., None])[..., 0]  # noqa: E731
    dx = dx0
    dxs, dus = [dx0], []
    for k in range(N):
        w = mv(Ks[..., k, :, :], dx) + kffs[..., k, :]
        dus.append(e[..., k, :] + mv(E[..., k, :, :], dx) + mv(P[..., k, :, :], w))
        dx = mv(A[..., k, :, :], dx) + mv(B[..., k, :, :], w) + d[..., k, :]
        dxs.append(dx)
    return torch.stack(dxs, dim=-2), torch.stack(dus, dim=-2)


def riccati_solve_plain(lq: StageLQ, E, P, e, dx0, reg: float, ns_iters: int = 20,
                        ns_refine: int = 2, solver: str = "ns"):
    nx = lq.A.shape[-1]
    batch = lq.A.shape[:-3]
    zero_S = torch.zeros((*batch, nx, nx), dtype=lq.A.dtype, device=lq.A.device)
    Ks, kffs, _, _ = backward_scan(lq, zero_S, zero_S[..., 0], reg, ns_iters, ns_refine, solver)
    dxs, dus = forward_rollout(Ks, kffs, E, P, e, lq.A, lq.B, lq.d, dx0)
    return Ks, kffs, dxs, dus


def riccati_solve(lq: StageLQ, E, P, e, dx0, reg: float):
    """Riccati backward sweep (zero terminal cost) + forward rollout — kernel B3.

    lq fields (B, N, ...), E (B, N, nu, nx), P (B, N, nu, nu), e (B, N, nu),
    dx0 (B, nx).  Returns (Ks, kffs, dxs (B, N+1, nx), dus (B, N, nu)).
    CPU: ``riccati_solve_plain`` with its defaults.  CUDA (float32,
    nx = nu = 22): one launch of ``hk_riccati_solve``, one block of nine
    warps per scenario, which solves Huu exactly: per knot one warp factors
    sym(Huu) with the forward sweep fused in, another turns the knot
    before into gains, the next knot's inputs arrive meanwhile; the rollout
    runs in one warp.  A Huu that is not positive definite gives NaN gains
    at its knot and every earlier one, and a NaN rollout."""
    if lq.A.device.type == "cpu":
        return riccati_solve_plain(lq, E, P, e, dx0, reg)
    Bn, N, nx, _ = lq.A.shape
    nu = lq.B.shape[-1]
    if (nx, nu) != (22, 22):
        raise ValueError(f"riccati_solve kernel is built for nx = nu = 22, got {nx}, {nu}")
    f32, dev = torch.float32, lq.A.device
    shapes = {
        "A": (Bn, N, nx, nx), "B": (Bn, N, nx, nu), "d": (Bn, N, nx), "Qxx": (Bn, N, nx, nx),
        "Qww": (Bn, N, nu, nu), "Qwx": (Bn, N, nu, nx), "qx": (Bn, N, nx), "qw": (Bn, N, nu),
    }
    ins = []
    for name, shape in shapes.items():
        t = getattr(lq, name)
        _build.require(t, name, f32, shape, dev)
        ins.append(t)
    for t, name, shape in ((E, "E", (Bn, N, nu, nx)), (P, "P", (Bn, N, nu, nu)),
                           (e, "e", (Bn, N, nu)), (dx0, "dx0", (Bn, nx))):
        _build.require(t, name, f32, shape, dev)
        ins.append(t)
    Ks = torch.empty((Bn, N, nu, nx), dtype=f32, device=dev)
    kffs = torch.empty((Bn, N, nu), dtype=f32, device=dev)
    dxs = torch.empty((Bn, N + 1, nx), dtype=f32, device=dev)
    dus = torch.empty((Bn, N, nu), dtype=f32, device=dev)
    if Bn == 0 or N == 0:
        raise ValueError("riccati_solve kernel needs at least one scenario and one knot")
    lib = _build.library()
    ptrs = [t.data_ptr() for t in ins + [Ks, kffs, dxs, dus]]
    _build.check(lib.hk_riccati_solve(*ptrs, Bn, N, float(reg), _build.stream(lq.A)),
                 "riccati_solve")
    riccati_solve.launches += 1
    return Ks, kffs, dxs, dus


riccati_solve.launches = 0


# ---------------------------------------------------------------------------
# parallel-in-time Riccati — kernel B5
# ---------------------------------------------------------------------------


def _chol_solve(A, b):
    """Solve A x = b by Cholesky of 0.5 (A + A') (as ``jnp.linalg.cholesky``
    symmetrizes its input); NaN where the factorization fails, as JAX's NaN
    factor gives.  b: (..., n, k)."""
    L, info = torch.linalg.cholesky_ex(0.5 * (A + A.transpose(-1, -2)))
    x = torch.cholesky_solve(b, L)
    return torch.where((info > 0)[..., None, None], torch.nan, x)


def _stage_elements(lq: StageLQ, reg: float, mm: str = "mxu", exact: bool = False):
    """Scattering elements (F, C, X, c, q) per stage, (..., N, ...) each.
    ``mm='vpu'`` (the SQP's default ``small_mm``) solves Qr by NS as the
    JAX package does; otherwise, or with ``exact``, by Cholesky."""
    nx = lq.A.shape[-1]
    nu = lq.B.shape[-1]
    eye_u = torch.eye(nu, dtype=lq.A.dtype, device=lq.A.device)
    shift = reg * (1.0 + torch.diagonal(lq.Qww, dim1=-2, dim2=-1).sum(-1) / nu)
    Qr = lq.Qww + shift[..., None, None] * eye_u
    rhs = torch.cat([lq.Qwx, lq.qw[..., None], lq.B.transpose(-1, -2)], dim=-1)
    iQ = spd_solve(Qr, rhs) if mm == "vpu" and not exact else _chol_solve(Qr, rhs)
    iQwx, iqw, iBt = iQ[..., :nx], iQ[..., nx], iQ[..., nx + 1:]
    F = lq.A - lq.B @ iQwx
    C = lq.B @ iBt
    X = lq.Qxx - lq.Qwx.transpose(-1, -2) @ iQwx
    X = 0.5 * (X + X.transpose(-1, -2))
    c = lq.d - (lq.B @ iqw[..., None])[..., 0]
    q = lq.qx - (lq.Qwx.transpose(-1, -2) @ iqw[..., None])[..., 0]
    return F, C, X, c, q


def _combine(e2, e1, exact: bool = False):
    """Star product of the later suffix composite e2 and the earlier element
    e1.  (I + C1 X2) has real eigenvalues >= 1: NS (18 iterations without
    equilibration + 2 refinements) as the JAX package, or an LU solve."""
    F1, C1, X1, c1, q1 = e1
    F2, C2, X2, c2, q2 = e2
    n = F1.shape[-1]
    eye = torch.eye(n, dtype=F1.dtype, device=F1.device)
    M = eye + C1 @ X2
    if exact:
        W = torch.linalg.solve_ex(M, eye.expand(M.shape))[0]
    else:
        W = ns_inverse(M, iters=18, spd=False)
        W = W + W @ (eye - M @ W)
        W = W + W @ (eye - M @ W)
    F2W = F2 @ W
    F = F2W @ F1
    C = C2 + (F2W @ C1) @ F2.transpose(-1, -2)
    X2W = X2 @ W
    X = X1 + F1.transpose(-1, -2) @ (X2W @ F1)
    X = 0.5 * (X + X.transpose(-1, -2))
    c = c2 + (F2W @ (c1 - (C1 @ q2[..., None])[..., 0])[..., None])[..., 0]
    q = q1 + (F1.transpose(-1, -2)
              @ (W.transpose(-1, -2) @ (q2 + (X2 @ c1[..., None])[..., 0])[..., None]))[..., 0]
    return F, C, X, c, q


def backward_associative(lq: StageLQ, S_term, s_term, reg: float, mm: str = "mxu",
                         exact: bool = False):
    """Parallel-in-time Riccati: returns (Ks, kffs, Ss, ss) as
    ``backward_scan`` does (Ss[k], ss[k] the value function at knot k+1).
    The gains solve Huu by NS (the JAX algorithm) or, with ``exact``, by
    Cholesky; ``exact`` also makes every other solve exact."""
    nx = lq.A.shape[-1]
    nu = lq.B.shape[-1]
    F, C, X, c, q = _stage_elements(lq, reg, mm, exact)
    zm = torch.zeros_like(F[..., :1, :, :])
    zv = torch.zeros_like(c[..., :1, :])
    elems = (torch.cat([F, zm], dim=-3), torch.cat([C, zm], dim=-3),
             torch.cat([X, S_term[..., None, :, :]], dim=-3), torch.cat([c, zv], dim=-2),
             torch.cat([q, s_term[..., None, :]], dim=-2))
    kd = F.ndim - 3
    _, _, Xs, _, qs = associative_scan(lambda a, b: _combine(a, b, exact), elems,
                                       (kd,) * 5, reverse=True)
    S_next, s_next = Xs[..., 1:, :, :], qs[..., 1:, :]

    SM = S_next @ torch.cat([lq.A, lq.B, lq.d[..., None]], dim=-1)
    SM = torch.cat([SM[..., :-1], (SM[..., -1] + s_next)[..., None]], dim=-1)
    H = lq.B.transpose(-1, -2) @ SM
    Huu = lq.Qww + H[..., nx:nx + nu]
    shift = reg * (1.0 + torch.diagonal(Huu, dim1=-2, dim2=-1).sum(-1) / nu)
    Huu = Huu + shift[..., None, None] * torch.eye(nu, dtype=Huu.dtype, device=Huu.device)
    rhs = torch.cat([lq.Qwx + H[..., :nx], (lq.qw + H[..., -1])[..., None]], dim=-1)
    Kk = -(_chol_solve(Huu, rhs) if exact else spd_solve(Huu, rhs))
    return Kk[..., :nx], Kk[..., nx], S_next, s_next


def forward_associative(A_cl, b_cl, dx0):
    """Linear rollout dx_{k+1} = A_cl[k] dx_k + b_cl[k] by an associative
    scan of affine maps.  Returns dxs (..., N+1, nx) including dx0."""

    def comb(e1, e2):
        M1, v1 = e1
        M2, v2 = e2
        return M2 @ M1, (M2 @ v1[..., None])[..., 0] + v2

    kd = A_cl.ndim - 3
    Ms, vs = associative_scan(comb, (A_cl, b_cl), (kd, kd))
    tail = (Ms @ dx0[..., None, :, None])[..., 0] + vs
    return torch.cat([dx0[..., None, :], tail], dim=-2)


def riccati_solve_parallel_plain(lq: StageLQ, E, P, e, dx0, reg: float, mm: str = "vpu",
                                 exact: bool = False):
    """The ``riccati_parallel=True`` solve of ``sqp.py`` (:310-336): backward
    associative sweep (zero terminal cost), closed-loop maps
    A_cl = A + B K, b_cl = d + B kff, forward scan, w = K dx + kff,
    du = e + E dx + P w.  Returns (Ks, kffs, dxs, dus) as ``riccati_solve``."""
    nx = lq.A.shape[-1]
    zero_S = torch.zeros((*lq.A.shape[:-3], nx, nx), dtype=lq.A.dtype, device=lq.A.device)
    Ks, kffs, _, _ = backward_associative(lq, zero_S, zero_S[..., 0], reg, mm, exact)
    A_cl = lq.A + lq.B @ Ks
    b_cl = lq.d + (lq.B @ kffs[..., None])[..., 0]
    dxs = forward_associative(A_cl, b_cl, dx0)
    ws = (Ks @ dxs[..., :-1, :, None])[..., 0] + kffs
    dus = e + (E @ dxs[..., :-1, :, None])[..., 0] + (P @ ws[..., None])[..., 0]
    return Ks, kffs, dxs, dus


def riccati_solve_parallel(lq: StageLQ, E, P, e, dx0, reg: float):
    """Parallel-in-time Riccati + rollout — kernel B5.

    Arguments and results as ``riccati_solve``.  CPU:
    ``riccati_solve_parallel_plain`` with its defaults (the JAX algorithm).
    CUDA (float32, nx = nu = 22, 1 <= B <= 65535): one call of
    ``hk_riccati_assoc``, which launches ceil(log2(N+1)) + ceil(log2 N) + 3
    kernels, one block per (knot, scenario) each; its solves are exact."""
    if lq.A.device.type == "cpu":
        return riccati_solve_parallel_plain(lq, E, P, e, dx0, reg)
    Bn, N, nx, _ = lq.A.shape
    nu = lq.B.shape[-1]
    if (nx, nu) != (22, 22):
        raise ValueError(f"riccati_solve_parallel kernel is built for nx = nu = 22, got {nx}, {nu}")
    if not 1 <= Bn <= 65535 or N < 1:
        raise ValueError(f"riccati_solve_parallel kernel takes 1 <= B <= 65535 scenarios and "
                         f"N >= 1 knots, got B = {Bn}, N = {N}")
    f32, dev = torch.float32, lq.A.device
    shapes = {
        "A": (Bn, N, nx, nx), "B": (Bn, N, nx, nu), "d": (Bn, N, nx), "Qxx": (Bn, N, nx, nx),
        "Qww": (Bn, N, nu, nu), "Qwx": (Bn, N, nu, nx), "qx": (Bn, N, nx), "qw": (Bn, N, nu),
    }
    ins = []
    for name, shape in shapes.items():
        t = getattr(lq, name)
        _build.require(t, name, f32, shape, dev)
        ins.append(t)
    for t, name, shape in ((E, "E", (Bn, N, nu, nx)), (P, "P", (Bn, N, nu, nu)),
                           (e, "e", (Bn, N, nu)), (dx0, "dx0", (Bn, nx))):
        _build.require(t, name, f32, shape, dev)
        ins.append(t)
    outs = [torch.empty((Bn, N, nu, nx), dtype=f32, device=dev),
            torch.empty((Bn, N, nu), dtype=f32, device=dev),
            torch.empty((Bn, N + 1, nx), dtype=f32, device=dev),
            torch.empty((Bn, N, nu), dtype=f32, device=dev)]
    elem = 3 * nx * nx + 2 * nx
    scratch = [torch.empty((Bn, N + 1, elem), dtype=f32, device=dev) for _ in range(2)]
    scratch += [torch.empty((Bn, N, nx * nx + nx), dtype=f32, device=dev) for _ in range(2)]
    lib = _build.library()
    ptrs = [t.data_ptr() for t in ins + outs + scratch]
    _build.check(lib.hk_riccati_assoc(*ptrs, Bn, N, float(reg), _build.stream(lq.A)),
                 "riccati_solve_parallel")
    riccati_solve_parallel.launches += 1
    return tuple(outs)


riccati_solve_parallel.launches = 0
