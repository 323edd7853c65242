"""Kernel B3's elimination order against the JAX package's sequential
Riccati sweep and rollout on the CPU.

``csrc/riccati.cu`` computes each knot in another order than JAX's
``backward_scan``: H = [A B]' S [A B d | s] on its lower block triangle,
with Qxx and Qww entering as their symmetric parts; one right-looking
Cholesky of the shifted sym(Huu) with the forward sweep fused into it,
which gives L and Y = L^-1 [Hux hu]; S and s by the Gram form,
S = sym(Qxx) + H_xx - Yx' Yx and s = qx + H_x - Yx' yh; the gains
[K kff] = -L'^-1 Y by a back sweep that the recursion does not wait for;
then the rollout w = K dx + kff, du = e + E dx + P w, dx' = A dx + B w + d.
``kernel_order`` writes that order out in torch.  Its pivots' reciprocal
square roots are exact here where the kernel's are float32 approximations
(``rsqrt.approx`` and one Newton step), and its sums are torch's, so it
holds the algebra, not the kernel's rounding:
in float64 it is held to JAX's ``backward_scan(..., solver='gj')`` and the
rollout scan within 1e-9 of each output's scale, max(1, max |JAX|), on the
seeded LQ of ``tests/test_torch_kernels.py::lq_data`` (B=2, N=6) and on the
projected first SQP iteration of a small flagship (``entry.projected_lq``,
B=2, N=8, float64).  A Huu that is not positive definite at one knot gives
NaN gains at that knot and at every earlier one, finite ones after it.

On the product shape's projected LQ data (``entry.projected_lq``, B=1,
N=53, float32: the data chip_smoke's phase 4d holds B3 on), the gains of the
kernel's order lie ~3e-5 (K) and ~1.5e-5 (kff) from the float64 exact
solve in float64 as in float32: the projection leaves Qww asymmetric (~3e-3
of its scale), and the kernel solves sym(Huu) where the exact plain version
solves Huu as projected.  With Qxx and Qww symmetrized the order is the
exact solve in float64 (1e-9) and within TOL_FACTOR x the float32 exact
plain version's error in float32: the kernel's arithmetic is not the term.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunter_bipedal_control_tpu.solver import riccati as jric
from hunter_bipedal_control_tpu_torch.entry import build_flagship, projected_lq
from hunter_bipedal_control_tpu_torch.solver import riccati as tric

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_kernels import _jax_forward, lq_data  # noqa: E402

RTOL = 1e-9
NX = NU = 22


def _lower_sym(M):
    """The symmetric matrix whose lower triangle is M's (the kernel forms
    one triangle of a symmetric product and mirrors it)."""
    return torch.tril(M) + torch.tril(M, -1).transpose(-1, -2)


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def factor_sweep(W, n):
    """The kernel's fused factor: W (..., n, n + m) holds [Huu | R] with
    Huu's lower triangle; right-looking, step k scales column k below the
    pivot and row k of the right-hand side by the pivot's reciprocal square
    root (L_ik, Y_k) and takes L's column k off the trailing lower triangle
    and, times Y_k, off the right-hand side below.  A pivot that is not > 0
    makes all of L and Y NaN.  Returns (L, Y = L^-1 R, 1 / diag L)."""
    W = W.clone()
    inv = torch.empty(W.shape[:-2] + (n,), dtype=W.dtype)
    ok = torch.ones(W.shape[:-2], dtype=torch.bool)
    for k in range(n):
        dk = W[..., k, k]
        ok &= dk > 0
        r = dk.clamp(min=1e-300).rsqrt()
        l = W[..., k + 1:, k] * r[..., None]                 # L_ik, rows below k
        y = W[..., k, n:] * r[..., None]                     # Y_k
        W[..., k + 1:, k + 1:n] -= l[..., :, None] * l[..., None, :]
        W[..., k + 1:, n:] -= l[..., :, None] * y[..., None, :]
        W[..., k + 1:, k] = l
        W[..., k, k] = dk * r
        W[..., k, n:] = y
        inv[..., k] = r
    W = torch.where(ok[..., None, None], W, torch.nan)
    inv = torch.where(ok[..., None], inv, torch.nan)
    return torch.tril(W[..., :n]), W[..., n:], inv


def back_sweep(L, Y, inv):
    """The kernel's deferred back sweep: X = L'^-1 Y, one column a lane,
    multiplying by the pivots' reciprocals."""
    V = Y.clone()
    n = L.shape[-1]
    for i in range(n - 1, -1, -1):
        V[..., i, :] *= inv[..., i, None]
        V[..., :i, :] -= L[..., i, :i, None] * V[..., i, None, :]
    return V


def kernel_order(lq, E, P, e, dx0, reg):
    """B3 (zero terminal cost) in the kernel's order: (K, kff, dxs, dus)."""
    Bn, N = lq.A.shape[:2]
    dt = lq.A.dtype
    S = torch.zeros((Bn, NX, NX), dtype=dt)
    s = torch.zeros((Bn, NX), dtype=dt)
    Ks, kffs = [None] * N, [None] * N
    slot = None
    for k in range(N - 1, -1, -1):
        A, B, d = lq.A[:, k], lq.B[:, k], lq.d[:, k]
        SM = S @ torch.cat([A, B, d[..., None]], -1)
        SM[..., -1] += s
        H = torch.cat([A, B], -1).transpose(-1, -2) @ SM
        Sp = _sym(lq.Qxx[:, k]) + _lower_sym(H[:, :NX, :NX])
        sp = lq.qx[:, k] + H[:, :NX, -1]
        Huu = _lower_sym(H[:, NX:, NX:NX + NU]) + _sym(lq.Qww[:, k])
        shift = reg * (1.0 + torch.diagonal(Huu, dim1=-2, dim2=-1).sum(-1) / NU)
        Huu = Huu + shift[:, None, None] * torch.eye(NU, dtype=dt)
        rhs = torch.cat([lq.Qwx[:, k] + H[:, NX:, :NX], (lq.qw[:, k] + H[:, NX:, -1])[..., None]],
                        -1)
        L, Y, inv = factor_sweep(torch.cat([Huu, rhs], -1), NU)
        if slot is not None:  # the knot after this one, off the chain
            Kk = -back_sweep(*slot[1:])
            Ks[slot[0]], kffs[slot[0]] = Kk[..., :NX], Kk[..., NX]
        slot = (k, L, Y, inv)
        Yx, yh = Y[..., :NX], Y[..., NX]
        S = Sp - _lower_sym(Yx.transpose(-1, -2) @ Yx)
        s = sp - (Yx.transpose(-1, -2) @ yh[..., None])[..., 0]
    Kk = -back_sweep(*slot[1:])
    Ks[0], kffs[0] = Kk[..., :NX], Kk[..., NX]
    Ks, kffs = torch.stack(Ks, 1), torch.stack(kffs, 1)
    mv = lambda M, v: (M @ v[..., None])[..., 0]  # noqa: E731
    dx, dxs, dus = dx0, [dx0], []
    for k in range(N):
        w = mv(Ks[:, k], dx) + kffs[:, k]
        dus.append(e[:, k] + mv(E[:, k], dx) + mv(P[:, k], w))
        dx = mv(lq.A[:, k], dx) + mv(lq.B[:, k], w) + lq.d[:, k]
        dxs.append(dx)
    return Ks, kffs, torch.stack(dxs, 1), torch.stack(dus, 1)


def jax_solve(lq, E, P, e, dx0, reg):
    """JAX's sequential sweep with the exact solve and its rollout scan,
    scenario by scenario: (K, kff, dxs, dus) as numpy arrays."""
    out = []
    z = jnp.zeros((NX, NX))
    for b in range(lq.A.shape[0]):
        jlq = jric.StageLQ(*(jnp.asarray(f[b].numpy()) for f in lq))
        jK, jk, _, _ = jric.backward_scan(jlq, z, z[0], reg, solver="gj", mm="vpu")
        jdxs, jdus = _jax_forward(jK, jk, *(jnp.asarray(a[b].numpy()) for a in (E, P, e)),
                                  jlq.A, jlq.B, jlq.d, jnp.asarray(dx0[b].numpy()))
        out.append([np.asarray(a) for a in (jK, jk, jdxs, jdus)])
    return [np.stack(a) for a in zip(*out)]


def close(got, ref):
    got = got.numpy()
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref))
    assert err <= RTOL * max(1.0, np.max(np.abs(ref))), (err, np.max(np.abs(ref)))


def _random_case():
    return (*lq_data(np.random.default_rng(2), 2, 6), 1e-6)


def _flagship_case():
    flag = build_flagship(8, 0.24, batch=2, device="cpu", dtype=torch.float64)
    return (*projected_lq(flag), flag.settings.hess_reg)


@pytest.mark.parametrize("case", [_random_case, _flagship_case], ids=["lq_data", "flagship"])
def test_kernel_order_matches_jax(case):
    args = case()
    assert args[0].A.dtype == torch.float64
    for name, a, b in zip(("K", "kff", "dxs", "dus"), kernel_order(*args), jax_solve(*args)):
        assert torch.isfinite(a).all(), name
        close(a, b)


def test_kernel_order_not_spd_gives_nan():
    """An indefinite Qww at knot 3 of 6: NaN gains at knots 0-3, finite
    ones at 4 and 5 (the sweep runs backward), NaN states from knot 1 on."""
    lq, E, P, e, dx0, reg = _random_case()
    Qww = lq.Qww.clone()
    Qww[0, 3] = -1e3 * torch.eye(NU, dtype=torch.float64)
    K, kff, dxs, dus = kernel_order(lq._replace(Qww=Qww), E, P, e, dx0, reg)
    bad = torch.isnan(K[0]).flatten(1).all(-1)
    assert bad.tolist() == [True] * 4 + [False] * 2
    assert torch.isnan(kff[0, :4]).all() and torch.isfinite(kff[0, 4:]).all()
    assert torch.isfinite(K[0, 4:]).all()
    assert torch.isnan(dxs[0, 1:]).all() and torch.isnan(dus[0]).all()
    assert torch.isfinite(K[1]).all()   # the other scenario is untouched


def _scaled(got, ref):
    return [((g.double() - r).abs().max() / r.abs().max()).item() for g, r in zip(got, ref)]


def test_kernel_order_symmetric_parts_on_4d_data():
    """chip_smoke 4d's K and kff gap (2.63e-5 / 2.13e-5 on the card against
    the float32 exact plain version's 8.7e-7 / 5.2e-7) is the symmetric
    parts', not the kernel's rounding."""
    flag = build_flagship(53, 0.8, batch=1, device="cpu", dtype=torch.float32)
    lq, E, P, e, dx0 = projected_lq(flag)
    reg = flag.settings.hess_reg

    def cast(data, dt):
        return (tric.StageLQ(*(f.to(dt) for f in data)), *(a.to(dt) for a in (E, P, e, dx0)))

    def exact(data, dt):
        return tric.riccati_solve_plain(*cast(data, dt), reg, solver="gj")

    asym = (lq.Qww - lq.Qww.transpose(-1, -2)).abs().max() / lq.Qww.abs().max()
    assert asym > 1e-3
    ref = exact(lq, torch.float64)
    gap64 = _scaled(kernel_order(*cast(lq, torch.float64), reg), ref)
    gap32 = _scaled(kernel_order(*cast(lq, torch.float32), reg), ref)
    exact32 = _scaled(exact(lq, torch.float32), ref)
    for q in (0, 1):   # K, kff: the symmetric parts' gap, the same in both precisions
        assert gap64[q] > 1e-5 and gap32[q] > 5 * exact32[q]
        assert abs(gap32[q] - gap64[q]) < 0.1 * gap64[q]
    sym = lq._replace(Qxx=_sym(lq.Qxx), Qww=_sym(lq.Qww))
    ref_s = exact(sym, torch.float64)
    assert max(_scaled(kernel_order(*cast(sym, torch.float64), reg), ref_s)) < RTOL
    got32 = _scaled(kernel_order(*cast(sym, torch.float32), reg), ref_s)
    exact32_s = _scaled(exact(sym, torch.float32), ref_s)
    assert all(g <= 2.0 * x for g, x in zip(got32, exact32_s)), (got32, exact32_s)
