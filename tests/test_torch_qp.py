"""Kernel B4's elimination order against the JAX package's ``solve_qp`` on
the CPU.

``csrc/solve_qp.cu`` eliminates the KKT system in another order than JAX's
two ``cho_solve`` calls over [Aeq' rbar]: one forward sweep Y = L^-1 [Aeq' |
rbar], the Schur matrix as the Gram product Y_A' Y_A + eq_reg I, Aeq Hbar^-1
rbar = Y_A' y_r, and dx = -L'^-1 (y_r + Y_A dnu).  ``kernel_order`` writes
that elimination's algebra out in torch (one forward sweep, the Gram Schur
matrix, one back sweep of one column; its triangular solves divide by the
pivots where the kernel multiplies by their reciprocals, so it holds the
algebra, not the kernel's rounding); in float64 it is held to JAX's
``solve_qp`` (under ``vmap``) within 1e-9 of each output's scale, max(1,
max |JAX|), on seeded QPs (``entry.qp_batch``, drawn with numpy) of the
WBC's shape (38 variables, 28 equality rows with the zero rows of the feet
in contact, 40 torque and friction rows; cold and warm) and of the
hierarchical WBC's levels (one zero equality row, 40 or 1 inequality rows,
15 iterations, cold).  On a QP whose Hbar is not SPD both give NaN in the
same rows.  The sizes the kernel compiles in equal the WBC's (``wbc.NDEC``,
``N_EQ_ROWS``, ``N_INEQ_ROWS``) and its largest dimension the wrapper's
``MAX_DIM``.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunter_bipedal_control_tpu.ops.qp import solve_qp as jsolve_qp
from hunter_bipedal_control_tpu_torch.entry import qp_batch
from hunter_bipedal_control_tpu_torch.ops import qp as tqp
from hunter_bipedal_control_tpu_torch.wbc import wbc as twbc

F64 = torch.float64
B = 4
SRC = os.path.join(os.path.dirname(tqp.__file__), "..", "csrc", "solve_qp.cu")


def kernel_order(H, g, Aeq, beq, Ain, bin_, n_iters, eq_reg=1e-8, frac=0.99, x0=None,
                 lam0=None, nu0=None, warm_margin=1e-2):
    """The PDIP of ``csrc/solve_qp.cu`` on batched tensors, its elimination
    order written out (the default mu_min, 50 eps of the dtype)."""
    n, me, mi = H.shape[-1], Aeq.shape[-2], Ain.shape[-2]
    lead, dt = H.shape[:-2], H.dtype
    mu_min = float(torch.finfo(dt).eps) * 50.0
    mv = lambda A, v: (A @ v[..., None])[..., 0]
    x = torch.zeros((*lead, n), dtype=dt) if x0 is None else x0
    s = torch.maximum(bin_ - mv(Ain, x), torch.ones_like(bin_) if x0 is None
                      else torch.full_like(bin_, warm_margin))
    lam = torch.ones((*lead, mi), dtype=dt) if lam0 is None else lam0.clamp(min=warm_margin)
    nu = torch.zeros((*lead, me), dtype=dt) if nu0 is None else nu0
    AeqT, AinT = Aeq.transpose(-1, -2), Ain.transpose(-1, -2)
    for _ in range(n_iters):
        mu = (s * lam).sum(-1) / mi
        sigma_mu = torch.clamp(0.2 * mu, min=mu_min)[..., None]
        r_dual = mv(H, x) + g + mv(AeqT, nu) + mv(AinT, lam)
        r_eq = mv(Aeq, x) - beq
        r_ineq = mv(Ain, x) + s - bin_
        r_cent = lam * s - sigma_mu
        s_safe = s.clamp(min=1e-12)
        w = lam / s_safe
        # one triangle of sym(H) + Ain' diag(w) Ain, the trace regularization
        Hbar = 0.5 * (H + H.transpose(-1, -2)) + AinT @ (w[..., None] * Ain)
        rbar = r_dual + mv(AinT, (lam * r_ineq - r_cent) / s_safe)
        reg = 1e-7 * torch.diagonal(Hbar, dim1=-2, dim2=-1).sum(-1) / n
        L = tqp.cholesky_nan(Hbar + reg[..., None, None] * torch.eye(n, dtype=dt))
        # one forward sweep over [Aeq' | rbar]
        Y = torch.linalg.solve_triangular(L, torch.cat([AeqT, rbar[..., None]], -1), upper=False)
        YA, yr = Y[..., :me], Y[..., me]
        Ls = tqp.cholesky_nan(YA.transpose(-1, -2) @ YA + eq_reg * torch.eye(me, dtype=dt))
        rhs = r_eq - mv(YA.transpose(-1, -2), yr)
        dnu = torch.cholesky_solve(rhs[..., None], Ls)[..., 0]
        dx = -torch.linalg.solve_triangular(L.transpose(-1, -2), (yr + mv(YA, dnu))[..., None],
                                            upper=True)[..., 0]
        ds = -r_ineq - mv(Ain, dx)
        dlam = -(r_cent + lam * ds) / s_safe
        one = torch.ones_like(s)
        ratio_s = torch.where(ds < 0, -frac * s / ds.clamp(max=-1e-12), one)
        ratio_l = torch.where(dlam < 0, -frac * lam / dlam.clamp(max=-1e-12), one)
        alpha = torch.minimum(ratio_s.amin(-1), ratio_l.amin(-1)).clamp(max=1.0)[..., None]
        x = x + alpha * dx
        s = (s + alpha * ds).clamp(min=1e-12)
        lam = (lam + alpha * dlam).clamp(min=1e-12)
        nu = nu + alpha * dnu
    res = torch.maximum((mv(Aeq, x) - beq).abs().amax(-1),
                        (mv(Ain, x) - bin_).clamp(min=0.0).amax(-1))
    return x, nu, lam, res


def _jax(data, n_iters, **kw):
    arrays = {k: jnp.asarray(v.numpy()) for k, v in kw.items() if torch.is_tensor(v)}
    static = {k: v for k, v in kw.items() if not torch.is_tensor(v)}
    out = jax.jit(jax.vmap(lambda d, a: jsolve_qp(*d, n_iters=n_iters, **static, **a)))(
        [jnp.asarray(t.numpy()) for t in data], arrays)
    return [np.asarray(a) for a in (out.x, out.eq_dual, out.ineq_dual, out.primal_residual)]


def _scaled(got, ref):
    got = got.numpy()
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


CASES = {
    "wbc_cold": (28, 40, 10, False),
    "wbc_warm": (28, 40, 10, True),
    "level_mi40": (1, 40, 15, False),
    "level_mi1": (1, 1, 15, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_order_matches_jax_f64(case):
    me, mi, n_iters, warm = CASES[case]
    data = qp_batch(B, me, mi, seed=3, device="cpu", dtype=F64)
    kw = {}
    if warm:
        rng = np.random.default_rng(4)
        kw = dict(x0=torch.tensor(0.1 * rng.standard_normal((B, 38))),
                  lam0=torch.tensor(rng.uniform(0.0, 2.0, (B, mi))),
                  nu0=torch.tensor(rng.standard_normal((B, me))), warm_margin=1e-2)
    got = kernel_order(*data, n_iters, **kw)
    ref = _jax(data, n_iters, **kw)
    for name, a, b in zip(("x", "eq_dual", "ineq_dual", "primal_residual"), got, ref):
        assert np.isfinite(b).all(), name
        assert _scaled(a, b) < 1e-9, (name, _scaled(a, b))


def test_kernel_order_not_spd_gives_nan():
    H, *rest = qp_batch(3, 28, 40, seed=5, device="cpu", dtype=F64)
    H = H.clone()
    H[1] = -1e3 * torch.eye(38, dtype=F64)
    data = (H, *rest)
    got = kernel_order(*data, 10)
    ref = _jax(data, 10)
    for name, a, b in zip(("x", "eq_dual", "ineq_dual"), got, ref):
        np.testing.assert_array_equal(torch.isnan(a).any(-1).numpy(), np.isnan(b).any(-1))
        np.testing.assert_array_equal(np.isnan(b).any(-1), [False, True, False])
    assert torch.isnan(got[3][1]) and np.isnan(ref[3][1])


def test_compiled_sizes_match_the_wbc():
    with open(SRC) as f:
        src = f.read()
    m = re.search(r"constexpr int WBC_N = (\d+), WBC_ME = (\d+), WBC_MI = (\d+);", src)
    assert m, "WBC_N / WBC_ME / WBC_MI not found in solve_qp.cu"
    assert tuple(int(v) for v in m.groups()) == (twbc.NDEC, twbc.N_EQ_ROWS, twbc.N_INEQ_ROWS)
    m = re.search(r"constexpr int MAX_DIM = (\d+);", src)
    assert m and int(m.group(1)) == tqp.MAX_DIM
