"""Small dense linear algebra: the Gauss-Jordan inverse kernel (B6) and the
plain routines the Riccati plain version uses.

Port of ``hunter_bipedal_control_tpu/ops/linalg.py``.  ``gj_inverse`` is a
kernel wrapper: a CPU tensor goes through ``gj_inverse_plain``, a CUDA
tensor launches ``csrc/gj_inverse.cu`` (or raises).  ``ns_inverse``,
``spd_solve`` and ``gj_solve`` are plain torch, used by the Riccati plain
version: on the card the Riccati kernel (B3) factors Huu by Cholesky
instead.  The JAX ``bsmm`` (a TPU tile-padding dodge) is a plain matmul
here.
"""
from __future__ import annotations

import torch

from ..kernels import _build


def ns_inverse(A, iters: int = 16, spd: bool = True):
    """Approximate inverse of a (batched) square matrix by Newton-Schulz (as
    in the JAX package: X0 = A~^T / (||A~||_1 ||A~||_inf), X <- X (2I - A~ X)).
    ``spd`` applies the symmetric Jacobi equilibration A~ = D^-1/2 A D^-1/2
    first; without it A~ = A."""
    n = A.shape[-1]
    if spd:
        d = torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1), min=1e-12)
        s = 1.0 / torch.sqrt(d)
        As = A * s[..., :, None] * s[..., None, :]
    else:
        As = A
    a1 = As.abs().sum(-2, keepdim=True).amax(-1, keepdim=True)
    ainf = As.abs().sum(-1, keepdim=True).amax(-2, keepdim=True)
    X = As.transpose(-1, -2) / (a1 * ainf + 1e-30)
    eye2 = 2.0 * torch.eye(n, dtype=A.dtype, device=A.device)
    for _ in range(iters):
        X = X @ (eye2 - As @ X)
    return X * s[..., :, None] * s[..., None, :] if spd else X


def spd_solve(A, b, iters: int = 20, refine: int = 2):
    """Solve A x = b for SPD (batched) A: NS inverse + iterative refinement.
    b may be (..., n) or (..., n, k)."""
    X = ns_inverse(A, iters)
    vec = b.ndim == A.ndim - 1
    if vec:
        b = b[..., None]
    x = X @ b
    for _ in range(refine):
        x = x + X @ (b - A @ x)
    return x[..., 0] if vec else x


def _gauss_jordan(M, n: int, eps: float = 0.0):
    """Eliminate the first n columns of the tableau M (..., n, w) with pivots
    in the natural order, each pivot row divided by (pivot + eps)."""
    for k in range(n):
        pval = M[..., k, k:k + 1]
        if eps:
            pval = pval + eps
        piv_row = M[..., k, :] / pval
        col = M[..., :, k].clone()
        col[..., k] = 0.0
        M = M - col[..., :, None] * piv_row[..., None, :]
        M[..., k, :] = piv_row
    return M


def gj_solve(A, b):
    """Solve A x = b for (batched) A by no-pivot Gauss-Jordan on the
    tableau [A | b] — the JAX package's ``riccati_solver='gj'`` solve.
    b: (..., n) or (..., n, k)."""
    n = A.shape[-1]
    vec = b.ndim == A.ndim - 1
    if vec:
        b = b[..., None]
    x = _gauss_jordan(torch.cat([A, b], dim=-1), n)[..., :, n:]
    return x[..., 0] if vec else x


def inv3(M):
    """Closed-form (batched) 3x3 inverse via the adjugate."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    cof = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return cof / det[..., None, None]


def gj_inverse_plain(A, pivot: bool = True):
    """(Batched) inverse by Gauss-Jordan on the tableau [A | I].

    The JAX ``gj_inverse(pivot=True)`` scores the un-pivoted diagonal as
    ``|diag| - done * inf``; with ``done == 0`` that is ``0 * inf = NaN``,
    and ``argmax`` returns the first NaN, so its pivots are taken in the
    natural order 0..n-1.  Its only difference from ``pivot=False`` is the
    ``+1e-30`` on each pivot, which this version keeps."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    M = _gauss_jordan(torch.cat([A, eye], dim=-1), n, 1e-30 if pivot else 0.0)
    return M[..., :, n:]


def gj_inverse(A, pivot: bool = True):
    """Batched small (n <= 32) inverse by Gauss-Jordan — kernel B6.

    CPU: ``gj_inverse_plain``.  CUDA (float32, contiguous): one launch of
    ``hk_gj_inverse`` over all leading dims (one thread per matrix for
    n <= 16, one block per matrix above)."""
    if A.device.type == "cpu":
        return gj_inverse_plain(A, pivot)
    n = A.shape[-1]
    _build.require(A, "A", torch.float32, A.shape[:-2] + (n, n))
    if n > 32:
        raise ValueError(f"gj_inverse kernel takes n <= 32, got {n}")
    out = torch.empty_like(A)
    batch = A.numel() // (n * n)
    if batch == 0:
        return out
    lib = _build.library()
    _build.check(lib.hk_gj_inverse(A.data_ptr(), out.data_ptr(), batch, n, int(pivot),
                                   _build.stream(A)), "gj_inverse")
    gj_inverse.launches += 1
    gj_inverse.launches_by_n[n] = gj_inverse.launches_by_n.get(n, 0) + 1
    return out


gj_inverse.launches = 0
gj_inverse.launches_by_n = {}  # the same launches by matrix size n
