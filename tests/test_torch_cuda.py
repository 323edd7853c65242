"""The CUDA kernels of the MPC step against their plain PyTorch versions,
on the card, at the main path's shapes in float32 (marker ``cuda``; each
test skips without a card).  This file imports no JAX, so it also runs on
a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are chip_smoke.py's: max |kernel - plain| / max(1, max |plain|)
within 1e-5 (gj_inverse), 1e-4 (project_knot) and 2e-3 (riccati_solve,
whose kernel factors Huu by Cholesky where the plain version iterates
Newton-Schulz).
"""
import numpy as np
import pytest
import torch

from hunter_bipedal_control_tpu_torch.ops import linalg
from hunter_bipedal_control_tpu_torch.solver import riccati, sqp

NX = NU = 22
M = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rel_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1.0))


def spd(rng, batch, n):
    X = rng.standard_normal((batch, n, n))
    return X @ np.swapaxes(X, -1, -2) / n + 0.5 * np.eye(n)


def knot_data(rng, shape, device):
    """Projection inputs shaped like the SQP's (masked rows, SPD Quu)."""
    def spd_(n, shift):
        X = rng.standard_normal((*shape, n, n))
        return X @ np.swapaxes(X, -1, -2) / n + shift * np.eye(n)

    mask = (rng.random((*shape, M)) > 0.25).astype(np.float64)
    arrays = (np.eye(NX) + 0.05 * rng.standard_normal((*shape, NX, NX)),
              0.05 * rng.standard_normal((*shape, NX, NU)),
              0.01 * rng.standard_normal((*shape, NX)), rng.standard_normal((*shape, NX)),
              rng.standard_normal((*shape, NU)), spd_(NX, 1.0), spd_(NU, 0.5),
              0.1 * rng.standard_normal((*shape, NU, NX)), rng.standard_normal((*shape, M)),
              rng.standard_normal((*shape, M, NX)) * mask[..., None],
              rng.standard_normal((*shape, M, NU)) * mask[..., None], mask)
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,pivot", [(128 * 7 * 2, 5, True), (128 * 66, 16, False)])
def test_gj_inverse_kernel(cuda, batch, n, pivot):
    A = torch.tensor(spd(np.random.default_rng(n), batch, n), dtype=torch.float32, device=cuda)
    before = linalg.gj_inverse.launches
    got = linalg.gj_inverse(A, pivot=pivot)
    torch.cuda.synchronize()
    assert linalg.gj_inverse.launches == before + 1
    assert rel_err(got, linalg.gj_inverse_plain(A, pivot)) < 1e-5


@pytest.mark.cuda
def test_gj_inverse_kernel_refuses_bad_input(cuda):
    with pytest.raises(TypeError):
        linalg.gj_inverse(torch.eye(5, device=cuda, dtype=torch.float64)[None])
    with pytest.raises(ValueError):
        linalg.gj_inverse(torch.eye(5, device=cuda).expand(3, 5, 5))


@pytest.mark.cuda
def test_project_knot_kernel(cuda):
    args = knot_data(np.random.default_rng(4), (128, 66), cuda)
    got = sqp.project_knot(sqp.SqpSettings(), *args)
    ref = sqp.project_knot_plain(sqp.SqpSettings(), *args)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert rel_err(a, b) < 1e-4


@pytest.mark.cuda
def test_riccati_solve_kernel(cuda):
    rng = np.random.default_rng(5)
    proj = sqp.project_knot_plain(sqp.SqpSettings(), *knot_data(rng, (128, 66), cuda))
    A_t, B_t, d_t, qx_t, qw, Qxx_t, Qww, Qwx, E, e, P = [t.contiguous() for t in proj]
    lq = riccati.StageLQ(A=A_t, B=B_t, d=d_t, Qxx=Qxx_t, Qww=Qww, Qwx=Qwx, qx=qx_t, qw=qw)
    dx0 = torch.tensor(0.01 * rng.standard_normal((128, NX)), dtype=torch.float32, device=cuda)
    got = riccati.riccati_solve(lq, E, P, e, dx0, 1e-6)
    ref = riccati.riccati_solve_plain(lq, E, P, e, dx0, 1e-6)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert rel_err(a, b) < 2e-3
