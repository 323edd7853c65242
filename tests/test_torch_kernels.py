"""The plain versions of the MPC step's three kernels — B6 gj_inverse, B2
project_knot, B3 riccati_solve — against their JAX functions in float64 on
the CPU, rtol 1e-9.  The CUDA kernels themselves are held to these plain
versions in tests/test_torch_cuda.py (card only) and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunter_bipedal_control_tpu.ops.linalg import gj_inverse as jgj
from hunter_bipedal_control_tpu.solver import riccati as jric, sqp as jsqp
from hunter_bipedal_control_tpu_torch.ops import linalg as tlinalg
from hunter_bipedal_control_tpu_torch.solver import riccati as tric, sqp as tsqp

F64 = torch.float64
RTOL = 1e-9
NX = NU = 22
M = 16


def close(got, ref, rtol=RTOL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = ref.detach().cpu().numpy() if torch.is_tensor(ref) else np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(1.0, np.abs(ref).max()))


def spd(rng, shape, n, shift):
    X = rng.standard_normal((*shape, n, n))
    return X @ np.swapaxes(X, -1, -2) / n + shift * np.eye(n)


def knot_data(rng, shape, masked=None, asym=False):
    """Projection inputs shaped like the SQP's: masked equality rows, SPD
    Quu, stance/swing masks.  ``masked`` True / False masks every row / no
    row; ``asym`` adds an asymmetric part to Qxx and Quu."""
    A = np.eye(NX) + 0.05 * rng.standard_normal((*shape, NX, NX))
    B = 0.05 * rng.standard_normal((*shape, NX, NU))
    mask = (rng.random((*shape, M)) > 0.25).astype(np.float64)
    if masked is not None:
        mask = np.full_like(mask, 0.0 if masked else 1.0)
    C = rng.standard_normal((*shape, M, NX)) * mask[..., None]
    D = rng.standard_normal((*shape, M, NU)) * mask[..., None]
    Qxx, Quu = spd(rng, shape, NX, 1.0), spd(rng, shape, NU, 0.5)
    if asym:
        Qxx = Qxx + 0.3 * rng.standard_normal(Qxx.shape)
        Quu = Quu + 0.3 * rng.standard_normal(Quu.shape)
    return (A, B, 0.01 * rng.standard_normal((*shape, NX)), rng.standard_normal((*shape, NX)),
            rng.standard_normal((*shape, NU)), Qxx, Quu,
            0.1 * rng.standard_normal((*shape, NU, NX)), rng.standard_normal((*shape, M)),
            C, D, mask)


def lq_data(rng, Bn, N):
    proj = tsqp.project_knot_plain(tsqp.SqpSettings(), *map(torch.tensor, knot_data(rng, (Bn, N))))
    A_t, B_t, d_t, qx_t, qw, Qxx_t, Qww, Qwx, E, e, P = proj
    lq = tric.StageLQ(A=A_t, B=B_t, d=d_t, Qxx=Qxx_t, Qww=Qww, Qwx=Qwx, qx=qx_t, qw=qw)
    return lq, E, P, e, torch.tensor(0.01 * rng.standard_normal((Bn, NX)))


# ---------------------------------------------------------------------------
# plain versions vs the JAX package (CPU, float64)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pivot", [True, False], ids=["pivot", "nopivot"])
@pytest.mark.parametrize("n", [5, 16])
def test_gj_inverse_plain(pivot, n):
    A = spd(np.random.default_rng(n), (9,), n, 0.5)
    close(tlinalg.gj_inverse(torch.tensor(A), pivot=pivot), jgj(jnp.asarray(A), pivot))


def test_gj_inverse_pivot_order_is_natural():
    """The JAX pivot search picks rows 0..n-1 in order (its score is NaN for
    every un-pivoted row, and argmax returns the first NaN): the pivoted and
    unpivoted JAX results differ only through the +1e-30."""
    A = spd(np.random.default_rng(0), (4,), 16, 0.5)
    A[:, 5, 5] += 100.0   # a large diagonal a real diagonal pivot would pick first
    a, b = np.asarray(jgj(jnp.asarray(A), True)), np.asarray(jgj(jnp.asarray(A), False))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pivot", [False, True], ids=["nopivot", "pivot"])
def test_project_knot_plain(pivot):
    settings = jsqp.SqpSettings(proj_pivot=pivot)
    args = knot_data(np.random.default_rng(1), (6,))
    ref = jax.vmap(lambda *a: jsqp.project_knot(settings, *a))(*args)
    got = tsqp.project_knot(tsqp.SqpSettings(proj_pivot=pivot), *map(torch.tensor, args))
    assert len(got) == len(ref) == 11
    for a, b in zip(got, ref):
        close(a, b)


PROJ_CASES = {"asym": {"asym": True}, "all_masked": {"masked": True},
              "none_masked": {"masked": False}}


@pytest.fixture(scope="module")
def proj_cases():
    """Each case's inputs (two knots: asymmetric Quu, Qxx and Qux; every row
    masked; no row masked) and JAX's projection of them, from one vmapped
    call over all of them."""
    rng = np.random.default_rng(3)
    data = {case: knot_data(rng, (2,), **kw) for case, kw in PROJ_CASES.items()}
    args = [np.concatenate(parts) for parts in zip(*data.values())]
    settings = jsqp.SqpSettings()
    ref = jax.vmap(lambda *a: jsqp.project_knot(settings, *a))(*args)
    return {case: (data[case], [np.asarray(r)[2 * i:2 * i + 2] for r in ref])
            for i, case in enumerate(PROJ_CASES)}


@pytest.mark.parametrize("case", list(PROJ_CASES))
def test_project_knot_plain_cases(proj_cases, case):
    """The plain projection against JAX's on inputs the SQP's data does not
    always show: asymmetric Quu / Qxx / Qux (the kernel assumes no symmetry),
    every equality row masked (G = (1 + proj_reg) I, P = I), none masked."""
    args, ref = proj_cases[case]
    got = tsqp.project_knot(tsqp.SqpSettings(), *map(torch.tensor, args))
    assert len(got) == len(ref) == 11
    for a, b in zip(got, ref):
        close(a, b)
    if case == "all_masked":
        close(got[10], np.broadcast_to(np.eye(NU), (2, NU, NU)))


def _jax_forward(Ks, kffs, E, P, e, A_t, B_t, d_t, dx0):
    """The forward rollout scan of the JAX solve (sqp.py:346-361)."""
    nu = Ks.shape[1]
    KEA = jnp.concatenate([Ks, E, A_t], axis=1)
    PB = jnp.concatenate([P, B_t], axis=1)

    def forward(dx, inp):
        kea, pb, d_, kff, e_ = inp
        r = kea @ dx
        w = r[:nu] + kff
        pbw = pb @ w
        return r[2 * nu:] + pbw[nu:] + d_, (dx, e_ + r[nu:2 * nu] + pbw[:nu])

    dx_last, (dxs, dus) = jax.lax.scan(forward, dx0, (KEA, PB, d_t, kffs, e))
    return jnp.concatenate([dxs, dx_last[None]], axis=0), dus


@pytest.mark.parametrize("solver", ["ns", "gj"])
def test_riccati_solve_plain(solver):
    _check_riccati(solver)


def _check_riccati(solver):
    Bn, N, reg = 2, 6, 1e-6
    lq, E, P, e, dx0 = lq_data(np.random.default_rng(2), Bn, N)
    if solver == "ns":      # the wrapper: its plain version's defaults on the CPU
        Ks, kffs, dxs, dus = tric.riccati_solve(lq, E, P, e, dx0, reg)
    else:
        Ks, kffs, dxs, dus = tric.riccati_solve_plain(lq, E, P, e, dx0, reg, solver=solver)
    z = jnp.zeros((NX, NX))
    for b in range(Bn):
        jlq = jric.StageLQ(*(jnp.asarray(f[b].numpy()) for f in lq))
        jK, jk, _, _ = jric.backward_scan(jlq, z, z[0], reg, solver=solver, mm="vpu")
        close(Ks[b], jK)
        close(kffs[b], jk)
        jdxs, jdus = _jax_forward(jK, jk, *(jnp.asarray(a[b].numpy()) for a in (E, P, e)),
                                  jlq.A, jlq.B, jlq.d, jnp.asarray(dx0[b].numpy()))
        close(dxs[b], jdxs)
        close(dus[b], jdus)


def test_cpu_path_launches_no_kernel():
    counts = (tlinalg.gj_inverse.launches, tsqp.project_knot.launches,
              tric.riccati_solve.launches)
    _check_riccati("ns")
    tlinalg.gj_inverse(torch.eye(5, dtype=F64)[None])
    assert (tlinalg.gj_inverse.launches, tsqp.project_knot.launches,
            tric.riccati_solve.launches) == counts == (0, 0, 0)
