"""Kernel B1's wrappers: the SoA linearization and line-search merit on the
card (``csrc/soa_linearize.cu``).

``soa_linearize`` returns what ``solver.sqp.knot_linearization_all_plain``
returns for ``lin_backend='soa'`` (the 13 per-knot outputs, dt-scaled and
masked) in one launch of ``hk_soa_linearize``; ``soa_merit`` returns what
``solver.sqp.eval_merit_plain`` returns (per scenario and candidate the
dt-scaled total cost and the constraint metric) in one launch of
``hk_soa_merit``, which sums its knots in a fixed order (the same bits on
every launch) through a scratch buffer and integer tickets the wrapper keeps
per device and stream.  The plain versions are those two functions; the solver
takes them for CPU tensors and these wrappers for CUDA tensors, which
launch the kernel or raise.

The model's constants go to the card once per model and device, from
``models.soa.build_consts``; the tree's topology is compiled into the
kernel, and a model whose topology or sizes differ is refused.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..kernels import _build
from ..models import soa

NJ, N_LINKS, NC = 10, 11, 4
NX = NU = 12 + NJ
N_EQ = 4 * NC
# grid.x of the linearization is the flat (scenario, knot) index, of the
# merit the flat (scenario, candidate, group of knots)
MAX_BLOCKS = 2 ** 31 - 1

_topology = None
_DEV_CONSTS: dict = {}
_CHECKED: dict = {}
# the wrappers' buffers kept by their owner's identity (bounded): the
# constants per (model, device), the OCP's parameters per OcpParams
CACHE_SIZE = 8
_BY_MODEL: dict = {}
_BY_PARAMS: dict = {}
# the merit's tickets and partial sums per (device, stream): merit_scratch
_MERIT_SCRATCH: dict = {}


def _keep(cache: dict, key, value):
    if len(cache) >= CACHE_SIZE:
        cache.pop(next(iter(cache)))
    cache[key] = value
    return value[-1]


def compiled_topology() -> dict:
    """The topology and buffer sizes ``csrc/soa_linearize.cu`` was compiled for."""
    global _topology
    if _topology is None:
        buf = (ctypes.c_int * 512)()
        n = _build.library().hk_soa_topology(ctypes.cast(buf, ctypes.c_void_p), 512)
        if n < 0:
            raise RuntimeError("hk_soa_topology: buffer too small")
        v = list(buf[:n])
        nj, L, nc = v[0], v[1], v[2]
        i = 7
        parent, child = tuple(v[i:i + nj]), tuple(v[i + nj:i + 2 * nj])
        i += 2 * nj
        cparent = tuple(v[i:i + nc])
        anc = np.array(v[i + nc:i + nc + L * nj]).reshape(L, nj)
        _topology = {"nj": nj, "n_links": L, "nc": nc, "nx": v[3], "nu": v[4],
                     "n_consts": v[5], "n_params": v[6], "parent": parent, "child": child,
                     "contact_parent": cparent,
                     "subtree_links": tuple(tuple(int(k) for k in np.nonzero(anc[:, j])[0])
                                            for j in range(nj))}
    return _topology


def check_topology(c: soa.SoaConsts) -> None:
    """Raise ValueError unless the model's topology is the compiled one."""
    if id(c) in _CHECKED:
        return
    top = compiled_topology()
    mine = {"nj": c.nj, "n_links": c.n_links, "nc": c.nc, "parent": c.parent,
            "child": c.child, "contact_parent": c.contact_parent,
            "subtree_links": c.subtree_links}
    bad = {k: (v, top[k]) for k, v in mine.items() if v != top[k]}
    if bad:
        raise ValueError(f"soa kernel: the model's topology differs from the compiled one "
                         f"(model, compiled): {bad}")
    _CHECKED[id(c)] = c


def consts_values(c: soa.SoaConsts) -> np.ndarray:
    """The constants buffer in the kernel's layout (float64; derived
    constants computed in float64 as the plain version folds them)."""
    parts = [np.ravel(c.origin_pos), np.ravel(c.origin_rot), np.ravel(c.axis),
             np.ravel(c.rod_K), np.ravel(c.rod_KK), np.ravel(c.com_local), np.ravel(c.mass),
             np.ravel(c.inertia), np.ravel(c.contact_pos),
             [c.total_mass, 1.0 / c.total_mass],
             [float(sum(c.mass[k] for k in links)) for links in c.subtree_links]]
    return np.concatenate([np.asarray(p, dtype=np.float64) for p in parts])


def consts_buffer(model, device) -> torch.Tensor:
    """The model's constants on ``device`` (float32), built once per model:
    looked up first by the model's identity (a model's arrays are not
    changed in place), then by its content."""
    key = (id(model), str(device))
    hit = _BY_MODEL.get(key)
    if hit is not None and hit[0] is model:
        return hit[1]
    c = soa.build_consts(model)
    check_topology(c)
    key = (id(c), str(device))
    hit = _DEV_CONSTS.get(key)
    if hit is None:
        vals = consts_values(c)
        if vals.shape[0] != compiled_topology()["n_consts"]:
            raise ValueError(f"soa kernel: {vals.shape[0]} constants, the kernel takes "
                             f"{compiled_topology()['n_consts']}")
        hit = (c, torch.as_tensor(vals, dtype=torch.float32, device=device))
        _DEV_CONSTS[key] = hit
    return _keep(_BY_MODEL, (id(model), str(device)), (model, hit[1]))


def params_buffer(params) -> torch.Tensor:
    """The OCP's scalar gains and joint limits in the kernel's layout, one
    float32 tensor on the params' device (one concatenation, no sync), kept
    per ``OcpParams`` and rebuilt when one of its tensors changes in place
    (its version counter); a tensor replaced makes another ``OcpParams``."""
    tensors = tuple(t for t in params if torch.is_tensor(t))
    versions = tuple(t._version for t in tensors)
    hit = _BY_PARAMS.get(id(params))
    if hit is not None and hit[0] is params and hit[1] == versions:
        return hit[2]
    fields = (params.xy_position_gain, params.stance_z_ref, params.position_error_gain,
              params.friction_coeff, params.cone_regularization, params.cone_mu,
              params.cone_delta, params.swing_weight, params.pos_limit_mu,
              params.pos_limit_delta, params.vel_limit_mu, params.vel_limit_delta,
              params.force_limit_mu, params.force_limit_delta, params.force_z_max,
              params.joint_lower, params.joint_upper, params.joint_vel_limit)
    buf = torch.cat([t.reshape(-1).to(torch.float32) for t in fields])
    return _keep(_BY_PARAMS, id(params), (params, versions, buf))


def kernel_inputs(model, params, xs, us, x_nom, flags, fpr, fvr, lead):
    """Check every input and return the common pointer list."""
    dev = xs.device
    f32 = torch.float32
    Bn, N = lead[0], us.shape[-2]
    for t, name, shape in ((xs, "xs", (*lead, N + 1, NX)), (us, "us", (*lead, N, NU)),
                           (x_nom, "x_nom", (Bn, N + 1, NX)), (flags, "flags", (Bn, N + 1, NC)),
                           (fpr, "foot_pos_ref", (Bn, N + 1, NC, 3)),
                           (fvr, "foot_vel_ref", (Bn, N + 1, NC, 3)),
                           (params.Q, "Q", (NX, NX)), (params.R, "R", (NU, NU))):
        _build.require(t, name, f32, shape, dev)
    if params.collision is not None:
        raise NotImplementedError("self-collision terms are not ported yet")
    K = consts_buffer(model, dev)
    P = params_buffer(params)
    if P.numel() != compiled_topology()["n_params"]:
        raise ValueError(f"soa kernel: {P.numel()} parameters, the kernel takes "
                         f"{compiled_topology()['n_params']}")
    return [K, P, params.Q, params.R, xs, us, x_nom, flags, fpr, fvr]


def soa_linearize(model, params, xs, us, x_nom, flags, fpr, fvr, dt):
    """Kernel B1's linearization: xs (B, N+1, nx), us (B, N, nu), the
    references x_nom (B, N+1, nx), flags (B, N+1, nc), fpr/fvr (B, N+1, nc,
    3), float32, contiguous, on the card -> (xnext, A, B, cost, qx, qu, Qxx,
    Quu, Qux, g, C, D, mask) over (B, N), as
    ``sqp.knot_linearization_all_plain``.  One block per (scenario, knot):
    raises for B N > 2^31 - 1 (the grid's x limit)."""
    if us.dim() != 3:
        raise ValueError(f"us: expected (B, N, nu), got {tuple(us.shape)}")
    Bn, N = us.shape[0], us.shape[1]
    if not 0 < Bn * N <= MAX_BLOCKS:
        raise ValueError(f"soa_linearize: B N = {Bn * N} blocks, the grid takes 1..{MAX_BLOCKS}")
    ins = kernel_inputs(model, params, xs, us, x_nom, flags, fpr, fvr, (Bn,))

    def out(*tail):
        return torch.empty((Bn, N, *tail), dtype=torch.float32, device=xs.device)

    outs = [out(NX), out(NX, NX), out(NX, NU), out(), out(NX), out(NU), out(NX, NX),
            out(NU, NU), out(NU, NX), out(N_EQ), out(N_EQ, NX), out(N_EQ, NU), out(N_EQ)]
    lib = _build.library()
    _build.check(lib.hk_soa_linearize(*(t.data_ptr() for t in ins + outs), Bn, N, float(dt),
                                      _build.stream(xs)), "soa_linearize")
    soa_linearize.launches += 1
    return tuple(outs)


soa_linearize.launches = 0


def merit_scratch(device, stream, n_cand_total: int, n_partials: int):
    """The merit's scratch on ``device`` for launches on ``stream``: its
    tickets (one int32 per (scenario, candidate), 0 between launches: each
    launch leaves them 0, so a buffer is zeroed once, by a copy from the
    host when it is made or grown) and its knots' partial sums (float32,
    any contents), at least the sizes asked for."""
    key = (str(device), stream)
    hit = _MERIT_SCRATCH.get(key)
    if hit is None or hit[0].numel() < n_cand_total or hit[1].numel() < n_partials:
        n_t = max(n_cand_total, 0 if hit is None else hit[0].numel())
        n_p = max(n_partials, 0 if hit is None else hit[1].numel())
        hit = (torch.zeros(n_t, dtype=torch.int32).to(device),
               torch.empty(n_p, dtype=torch.float32, device=device))
        _MERIT_SCRATCH[key] = hit
    return hit


def soa_merit(model, params, xs, us, x_nom, flags, fpr, fvr, dt):
    """Kernel B1's merit: candidates xs (B, K, N+1, nx), us (B, K, N, nu),
    references as ``soa_linearize``'s -> (cost (B, K), metric (B, K)), as
    ``sqp.eval_merit_plain``.  A warp per (scenario, candidate, knot), the
    sums over the knots in knot order in the same launch (``merit_scratch``):
    raises for B K > 2^31 - 1, and the launch fails for a grid of more than
    2^31 - 1 blocks of knots."""
    if us.dim() != 4:
        raise ValueError(f"us: expected (B, K, N, nu), got {tuple(us.shape)}")
    Bn, Kc, N = us.shape[0], us.shape[1], us.shape[2]
    if not 0 < Bn * Kc <= MAX_BLOCKS or N < 1:
        raise ValueError(f"soa_merit: B K = {Bn * Kc} (1..{MAX_BLOCKS}), N = {N}")
    ins = kernel_inputs(model, params, xs, us, x_nom, flags, fpr, fvr, (Bn, Kc))
    cost = torch.empty((Bn, Kc), dtype=torch.float32, device=xs.device)
    metric = torch.empty_like(cost)
    lib = _build.library()
    stream = _build.stream(xs)
    tickets, partials = merit_scratch(xs.device, stream, Bn * Kc,
                                      Bn * Kc * lib.hk_soa_merit_partials(N))
    _build.check(lib.hk_soa_merit(*(t.data_ptr() for t in ins), partials.data_ptr(),
                                  tickets.data_ptr(), cost.data_ptr(), metric.data_ptr(), Bn, Kc,
                                  N, float(dt), stream), "soa_merit")
    soa_merit.launches += 1
    return cost, metric


soa_merit.launches = 0
