"""Sequential Riccati backward sweep + forward rollout — kernel B3.

Port of ``hunter_bipedal_control_tpu/solver/riccati.py::backward_scan`` and
of the forward rollout scan in ``solver/sqp.py::solve``.  The plain
versions are the JAX algorithm itself (Newton-Schulz solve of Huu, 20
iterations + 2 refinements), or its ``riccati_solver='gj'`` exact solve;
``riccati_solve`` launches ``csrc/riccati.cu`` on a CUDA tensor, which
factors Huu by Cholesky instead (NS was a TPU workaround for row-sequential
LU).  ``backward_associative`` (B5, the
``riccati_parallel=True`` configuration) is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import _build
from ..ops.linalg import gj_solve, spd_solve


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
    CPU: ``riccati_solve_plain`` with its defaults.  CUDA (float32): one
    launch of ``hk_riccati_solve``, one block per scenario, which solves Huu
    exactly (Cholesky)."""
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
