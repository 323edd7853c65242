"""Associative scan with ``jax.lax.associative_scan``'s odd/even recursion.

The JAX package runs the parallel-in-time Riccati's star products and its
affine rollout through that recursion; scanning in the same tree makes
float32 results round as the JAX package's do.
"""
from __future__ import annotations

import torch


def _sl(x, dim: int, start, stop=None, step: int = 1):
    idx = [slice(None)] * x.ndim
    idx[dim] = slice(start, stop, step)
    return x[tuple(idx)]


def _interleave(a, b, dim: int):
    """a at the even and b at the odd positions along ``dim``."""
    shape = list(a.shape)
    shape[dim] = a.shape[dim] + b.shape[dim]
    out = a.new_empty(shape)
    _sl(out, dim, 0, None, 2).copy_(a)
    _sl(out, dim, 1, None, 2).copy_(b)
    return out


def associative_scan(fn, elems, dims, reverse: bool = False):
    """Inclusive scan of ``fn`` over a tuple of tensors, ``dims[i]`` the scan
    axis of ``elems[i]`` (non-negative), with ``jax.lax.associative_scan``'s
    odd/even recursion, so that float32 results round as the JAX package's
    do.  ``fn(a, b)`` gets the earlier pieces as ``a``; with ``reverse`` the
    scan runs from the end, so ``a`` holds the later (higher-index) ones."""
    elems = list(elems)
    if reverse:
        elems = [e.flip(d) for e, d in zip(elems, dims)]

    def scan(el):
        n = el[0].shape[dims[0]]
        if n < 2:
            return el
        reduced = fn([_sl(e, d, 0, -1, 2) for e, d in zip(el, dims)],
                     [_sl(e, d, 1, None, 2) for e, d in zip(el, dims)])
        odd = scan(list(reduced))
        rest = [_sl(e, d, 2, None, 2) for e, d in zip(el, dims)]
        if n % 2 == 0:
            even = fn([_sl(e, d, 0, -1) for e, d in zip(odd, dims)], rest)
        else:
            even = fn(odd, rest)
        even = [torch.cat([_sl(e, d, 0, 1), r], dim=d) for e, r, d in zip(el, even, dims)]
        return [_interleave(e, o, d) for e, o, d in zip(even, odd, dims)]

    out = scan(elems)
    if reverse:
        out = [e.flip(d) for e, d in zip(out, dims)]
    return tuple(out)

