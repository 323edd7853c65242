"""Kernel B15's order (``csrc/ddp_rollout.cu``: a warp per rollout, lanes
owning the 22 components) transcribed in torch on CPU tensors, against the
JAX package's rollouts (solver/ddp.py:78-96 and the re-roll :189-194:
``rollout_step`` + ``stage_cost_value`` + ``eq_constraints`` knot by knot).

``kernel_order`` follows the kernel step by step: the feedback row of each
component in j's order; a flow from the joints' local transforms (R_origin
rod), the two legs' chains (R (R_origin rod), the base-fixed velocity
pass), per-link world inertias, CoM, momentum, I and W summed as the
half-warp shuffle tree sums them, the base block solved by the adjugate,
the contact torques summed as lanes 0-3's tree; the row pass's contact
velocities from the contact links' full velocities (om = w0 + om_j, vo = v0
+ w0 x (p - p0) + vo_j); the equality rows' |g mask| and the soft rows'
penalties (row r on lane r % 32) summed by the warp's tree; the quadratic
forms as (Q' dx)_j dx_j summed by the tree; the integrators per component
in rollout.py's order, ODE45's error norm summed in component order.

Data: the DDP's first iteration on the flagship (trot, 0.25 m/s; 8 knots
over 0.4 s, so both legs swing; float64, warm-started by the port's SQP),
every step size.  In float64 every output is held to JAX's within 1e-10 of
max(1, |JAX|) for RK2, RK4 and ODE45 (at task.info's tolerances, one slot
an interval here, and at tighter ones, which reject and take several),
closed and open loop.  In float32 at task.info's tolerances the
transcription's ODE45 accepted slots equal the float32 plain version's and
its states are within 1e-4 of their scale from the float64 run's.  (At the
tighter tolerances the step size control drives the error norm to ~1,
where the plain version's own float32 and float64 runs decide 7 of 48
knots differently: no float32 rounding of the flow is held to equal slots
there.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build
from hunter_bipedal_control_tpu.ocp import problem as jocp
from hunter_bipedal_control_tpu.solver import rollout as jro
from hunter_bipedal_control_tpu.solver import sqp as jsqp
from hunter_bipedal_control_tpu_torch import entry
from hunter_bipedal_control_tpu_torch.models import soa
from hunter_bipedal_control_tpu_torch.ocp import problem as tocp
from hunter_bipedal_control_tpu_torch.ocp import soa_kernel
from hunter_bipedal_control_tpu_torch.solver import ddp as tddp
from hunter_bipedal_control_tpu_torch.solver.rollout import _B4, _B5, _A

F64 = torch.float64
N, HORIZON = 8, 0.4
SETTINGS = dict(n_intervals=N, horizon=HORIZON, n_iterations=1)
NX = NU = 22
NJ, L, NC = 10, 11, 4
CONTACT_LINK = (5, 10, 5, 10)
G = 9.81


# ---------------------------------------------------------------------------
# the kernel's order
# ---------------------------------------------------------------------------


def _tree(v):
    """A xor-butterfly's sum over the last dim (a power of two of lanes), as
    lane 0 gets it: v[l] + v[l + h] for h = n/2, ..., 1."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _lanes(v, n):
    """v (..., m) padded with zeros to n lanes."""
    return torch.cat([v, v.new_zeros(*v.shape[:-1], n - v.shape[-1])], -1)


def _consts(model, dtype):
    """soa_kernel's constants buffer, split by the kernel's layout."""
    k = torch.as_tensor(soa_kernel.consts_values(soa.build_consts(model)), dtype=dtype)
    sizes = dict(opos=NJ * 3, orot=NJ * 9, axis=NJ * 3, rk=NJ * 9, rkk=NJ * 9, coml=L * 3,
                 mass=L, iner=L * 9, cpos=NC * 3, m=1, invm=1)
    out, o = {}, 0
    for name, n in sizes.items():
        out[name] = k[o:o + n]
        o += n
    for name in ("orot", "rk", "rkk", "iner"):
        out[name] = out[name].reshape(-1, 3, 3)
    for name in ("opos", "axis", "coml", "cpos"):
        out[name] = out[name].reshape(-1, 3)
    out["m"], out["invm"] = out["m"][0], out["invm"][0]
    out["axis_par"] = (out["orot"] @ out["axis"][..., None])[..., 0]
    return out


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _inv3(M):
    """soa.py::inv3: the adjugate over the determinant."""
    m = [[M[..., i, j] for j in range(3)] for i in range(3)]
    c00 = m[1][1] * m[2][2] - m[1][2] * m[2][1]
    c01 = m[1][2] * m[2][0] - m[1][0] * m[2][2]
    c02 = m[1][0] * m[2][1] - m[1][1] * m[2][0]
    det = m[0][0] * c00 + m[0][1] * c01 + m[0][2] * c02
    inv_det = 1.0 / det
    c10 = m[0][2] * m[2][1] - m[0][1] * m[2][2]
    c11 = m[0][0] * m[2][2] - m[0][2] * m[2][0]
    c12 = m[0][1] * m[2][0] - m[0][0] * m[2][1]
    c20 = m[0][1] * m[1][2] - m[0][2] * m[1][1]
    c21 = m[0][2] * m[1][0] - m[0][0] * m[1][2]
    c22 = m[0][0] * m[1][1] - m[0][1] * m[1][0]
    rows = [[c00, c10, c20], [c01, c11, c21], [c02, c12, c22]]
    return torch.stack([torch.stack([inv_det * c for c in r], -1) for r in rows], -2)


def warp_flow(C, x, u, rows=False):
    """The flow at x, u (R, 22) as one warp computes it; with ``rows`` also
    the contact points and velocities (R, 4, 3)."""
    dtype = x.dtype
    Rn = x.shape[0]
    qj, vj = x[:, 12:], u[:, 12:]
    cj, sj = torch.cos(qj), torch.sin(qj)
    eye = torch.eye(3, dtype=dtype)
    rod = eye + sj[..., None, None] * C["rk"] + (1.0 - cj)[..., None, None] * C["rkk"]
    T = C["orot"] @ rod                                             # (R, 10, 3, 3)
    z, y, xa = x[:, 9], x[:, 10], x[:, 11]
    cz, sz, cy, sy, cx, sx = (torch.cos(z), torch.sin(z), torch.cos(y), torch.sin(y),
                              torch.cos(xa), torch.sin(xa))
    R0 = torch.stack([cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
                      sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
                      -sy, cy * sx, cy * cx], -1).reshape(Rn, 3, 3)
    p0 = x[:, 6:9]
    Rl, pl, om_j, vo_j = [R0] * L, [p0] * L, [torch.zeros_like(p0)] * L, [torch.zeros_like(p0)] * L
    for g in range(2):
        R, p, om, vo = R0, p0, torch.zeros_like(p0), torch.zeros_like(p0)
        for n in range(5):
            j = 5 * g + n
            ch = j + 1
            por = p + _mv(R, C["opos"][j])
            aw = _mv(R, C["axis_par"][j])
            R = R @ T[:, j]
            vo = vo + _cross(om, por - p)
            om = om + vj[:, j:j + 1] * aw
            p = por
            Rl[ch], pl[ch], om_j[ch], vo_j[ch] = R, p, om, vo
    Rl, pl, om_j, vo_j = (torch.stack(a, 1) for a in (Rl, pl, om_j, vo_j))   # (R, 11, ...)
    com = pl + _mv(Rl, C["coml"])
    Iw = Rl @ C["iner"] @ Rl.transpose(-1, -2)
    mk = C["mass"][:, None]
    pcom = C["invm"] * _tree(_lanes((mk * com).transpose(1, 2), 16))          # (R, 3)
    cdot = vo_j + _cross(om_j, com - pl)
    r = com - pcom[:, None]
    d = com - p0[:, None]
    hl_k = mk * cdot
    ha_k = _mv(Iw, om_j) + mk * _cross(r, cdot)
    W_k = mk[..., None] * (d[..., :, None] * r[..., None, :])
    hl, ha = (_tree(_lanes(v.transpose(1, 2), 16)) for v in (hl_k, ha_k))
    Itot, W = (_tree(_lanes(v.flatten(2).transpose(1, 2), 16)).reshape(Rn, 3, 3)
               for v in (Iw, W_k))
    trW = (W[:, 0, 0] + W[:, 1, 1]) + W[:, 2, 2]
    Gm = (Itot + trW[:, None, None] * eye) - W
    zero, one = torch.zeros_like(cz), torch.ones_like(cz)
    E = torch.stack([zero, -sz, cz * cy, zero, cz, sz * cy, one, zero, -sy], -1).reshape(Rn, 3, 3)
    GE = Gm @ E
    sv = pcom - p0
    sk = torch.stack([zero, -sv[:, 2], sv[:, 1], sv[:, 2], zero, -sv[:, 0],
                      -sv[:, 1], sv[:, 0], zero], -1).reshape(Rn, 3, 3)
    A12 = -C["m"] * (sk @ E)
    m = C["m"]
    x2 = _mv(_inv3(GE), m * x[:, 3:6] - ha)
    vb = torch.cat([C["invm"] * ((m * x[:, 0:3] - hl) - _mv(A12, x2)), x2], -1)
    pc = pl[:, CONTACT_LINK] + _mv(Rl[:, CONTACT_LINK], C["cpos"])                 # (R, 4, 3)
    tq = _cross(pc - pcom[:, None], u[:, :12].reshape(Rn, 4, 3))
    ha_c = (tq[:, 0] + tq[:, 1]) + (tq[:, 2] + tq[:, 3])
    f = u[:, :12].reshape(Rn, 4, 3)
    fs = ((f[:, 0] + f[:, 1]) + f[:, 2]) + f[:, 3]
    out = torch.cat([C["invm"] * fs + torch.tensor([0.0, 0.0, -G], dtype=dtype),
                     C["invm"] * ha_c, vb, u[:, 12:]], -1)
    if not rows:
        return out
    w0 = _mv(E, vb[:, 3:])
    kl = list(CONTACT_LINK)
    om = w0[:, None] + om_j[:, kl]
    vo = (vb[:, None, :3] + _cross(w0[:, None], pl[:, kl] - p0[:, None])) + vo_j[:, kl]
    vc = vo + _cross(om, pc - pl[:, kl])
    return out, pc, vc


def _row_terms(model, params, x, u, fl, fpr, fvr, pc, vc):
    """(|g mask|_1, sum mask p) of the row pass, summed by the warp's tree."""
    Rn = x.shape[0]
    stance = fl > 0.5
    zv = torch.stack([vc[..., 0], vc[..., 1],
                      vc[..., 2] + params.xy_position_gain * (pc[..., 2] - params.stance_z_ref)],
                     -1)
    g3 = torch.where(stance[..., None], zv, u[:, :12].reshape(Rn, 4, 3))
    nv = (vc[..., 2] - fvr[..., 2]) + params.position_error_gain * (pc[..., 2] - fpr[..., 2])
    g4 = torch.where(stance, torch.zeros_like(nv), nv)
    mask4 = torch.where(stance, torch.zeros_like(nv), torch.ones_like(nv))
    e = torch.cat([g3.abs(), (g4 * mask4).abs()[..., None]], -1).reshape(Rn, 16)
    eq = _tree(_lanes(e, 32))
    f = u[:, :12].reshape(Rn, 4, 3)
    cone = params.friction_coeff * f[..., 2] - torch.sqrt(
        f[..., 0] * f[..., 0] + f[..., 1] * f[..., 1] + params.cone_regularization)
    xy = ((vc[..., :2] - fvr[..., :2]) + params.xy_position_gain * (pc[..., :2] - fpr[..., :2]))
    soft = torch.cat([cone, xy.reshape(Rn, 8), x[:, 12:], u[:, 12:], f[..., 2]], -1)
    p, _, _, mask = tocp._soft_penalty_terms(model, params, soft, fl)
    mp = mask * p
    lanes = _lanes(mp[:, :32], 32) + _lanes(mp[:, 32:], 32)
    return eq, _tree(lanes)


def _u_nom(model, fl):
    n = torch.clamp(((fl[:, 0] + fl[:, 1]) + fl[:, 2]) + fl[:, 3], min=1.0)
    fz = (model.total_mass * G / n)[:, None] * fl
    z = torch.zeros_like(fl)
    return torch.cat([torch.stack([z, z, fz], -1).reshape(-1, 12),
                      fl.new_zeros(fl.shape[0], NU - 12)], -1)


def _quad(d, Q):
    """(Q' d)_j d_j per lane j (each a sequential sum over i), the tree's sum."""
    s = torch.zeros_like(d)
    for i in range(d.shape[-1]):
        s = s + d[:, i:i + 1] * Q[i]
    return _tree(_lanes(s * d, 32))


def _rk4(C, x, u, h, k1):
    hh = 0.5 * h
    k2 = warp_flow(C, x + hh * k1, u)
    k3 = warp_flow(C, x + hh * k2, u)
    k4 = warp_flow(C, x + h * k3, u)
    return x + (h / 6.0) * (((k1 + 2.0 * k2) + 2.0 * k3) + k4)


def _ode45(C, x, u, k0, dt, rs):
    """The kernel's ODE45 per rollout: masked slots, the error norm's
    squares summed in component order; returns (x, accepted slots)."""
    dtype = x.dtype
    Rn = x.shape[0]
    h_min = torch.tensor(1.0 / rs.max_steps_per_second, dtype=dtype)
    h_floor = h_min * torch.tensor(1.000001, dtype=dtype)
    t = torch.zeros(Rn, dtype=dtype)
    h = torch.full((Rn,), min(rs.time_step, dt), dtype=dtype)
    xk, kf = x, k0
    acc = torch.zeros(Rn, dtype=torch.int32)
    dt_t = torch.tensor(dt, dtype=dtype)
    for _ in range(rs.max_substeps):
        remaining = dt_t - t
        active = remaining > 1e-12
        if not bool(active.any()):
            break
        hs = torch.minimum(torch.maximum(h, h_min), torch.maximum(remaining, h_min))
        hv = hs[:, None]
        ks = [kf]
        for st in range(1, 7):
            v = xk
            for j, a in enumerate(_A[st]):
                v = v + (hv * a) * ks[j]
            ks.append(warp_flow(C, v, u))
        s5 = _B5[0] * ks[0]
        s4 = _B4[0] * ks[0]
        for j in range(1, 7):
            s5 = s5 + _B5[j] * ks[j]
            s4 = s4 + _B4[j] * ks[j]
        x5, x4 = xk + hv * s5, xk + hv * s4
        scale = rs.abs_tol + rs.rel_tol * torch.maximum(xk.abs(), x5.abs())
        q = (x5 - x4) / scale
        sq = torch.zeros(Rn, dtype=dtype)
        for i in range(NX):
            sq = sq + q[:, i] * q[:, i]
        err = torch.sqrt(sq / NX)
        step = active & ((err <= 1.0) | (hs <= h_floor))
        t = torch.where(step, t + hs, t)
        xk = torch.where(step[:, None], x5, xk)
        kf = torch.where(step[:, None], warp_flow(C, xk, u), kf)
        acc = acc + step.to(torch.int32)
        factor = torch.clamp(0.9 * err ** -0.2, 0.2, 5.0)
        h = torch.where(active, torch.minimum(torch.maximum(hs * factor, h_min), dt_t), h)
    residual = torch.clamp_min(dt_t - t, 0.0)
    done = (residual == 0.0) & torch.isfinite(kf).all(-1)
    return torch.where(done[:, None], xk, _rk4(C, xk, u, residual[:, None], kf)), acc


def kernel_order(model, params, refs, x_init, xs_bar, us_bar, Ks, kffs, alphas, rs):
    """B15's outputs (as ``closed_rollout_plain``'s) in the kernel's order,
    B = 1 scenario, A step sizes as the warps."""
    dtype = x_init.dtype
    C = _consts(model, dtype)
    dt = rs.time_step
    A = alphas.shape[0]
    x = x_init[0].expand(A, NX).clone()
    xs, us, slots = [], [], []
    cost, eq_acc = torch.zeros(A, dtype=dtype), torch.zeros(A, dtype=dtype)
    for k in range(us_bar.shape[1]):
        ub = us_bar[0, k].expand(A, NU)
        if Ks is None:
            u = ub
        else:
            d = x - xs_bar[0, k]
            fb = torch.zeros_like(x)
            for j in range(NX):
                fb = fb + Ks[0, k, :, j] * d[:, j:j + 1]
            u = (ub + alphas[:, None] * kffs[0, k]) + fb
        fl = refs.contact_flags[0, k].expand(A, NC)
        fpr = refs.foot_pos_ref[0, k].expand(A, NC, 3)
        fvr = refs.foot_vel_ref[0, k].expand(A, NC, 3)
        k0, pc, vc = warp_flow(C, x, u, rows=True)
        eq, cp = _row_terms(model, params, x, u, fl, fpr, fvr, pc, vc)
        c = (0.5 * _quad(x - refs.x_nom[0, k], params.Q)
             + 0.5 * _quad(u - _u_nom(model, fl), params.R)) + cp
        cost = cost + c * dt
        eq_acc = eq_acc + eq
        xs.append(x)
        us.append(u)
        kind = rs.integrator.upper()
        if kind == "RK2":
            k1 = warp_flow(C, x + dt * k0, u)
            x, n_acc = x + (0.5 * dt) * (k0 + k1), torch.zeros(A, dtype=torch.int32)
        elif kind == "RK4":
            x, n_acc = _rk4(C, x, u, dt, k0), torch.zeros(A, dtype=torch.int32)
        else:
            x, n_acc = _ode45(C, x, u, k0, dt, rs)
        slots.append(n_acc)
    xs.append(x)
    Nk = us_bar.shape[1]
    return (torch.stack(xs, 1)[None], torch.stack(us, 1)[None], cost[None],
            (eq_acc / Nk)[None], torch.stack(slots, -1)[None])


# ---------------------------------------------------------------------------
# the data and JAX's rollouts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ddp_data():
    """The flagship's DDP first iteration (trot, 8 knots over 0.4 s, float64)."""
    flag = entry.build_flagship(N, HORIZON, device="cpu", dtype=F64)
    its = []
    run = entry.ddp_solve(flag, tddp.DdpSettings(**SETTINGS), on_iteration=its.append)
    return flag, run, its[0]


@pytest.fixture(scope="module")
def jax_problem():
    m, _, params, *_ = _build(N, HORIZON, jnp.float64)
    return m, params


def _jax_rollouts(jm, jparams, refs, x0, xs_bar, us_bar, Ks, kffs, alphas, rs):
    """Per step size, ddp.py:78-96's rollout knot by knot (JAX, float64)."""
    js = jro.RolloutSettings(**rs._asdict())
    jrefs = jsqp.ReferenceBundle(**{f: jnp.asarray(getattr(refs, f)[0].numpy())
                                    for f in jsqp.ReferenceBundle._fields})
    dt = rs.time_step

    @jax.jit
    def knot(x, u, k):
        c = jocp.stage_cost_value(jm, jparams, x, u, jrefs.x_nom[k], jrefs.contact_flags[k],
                                  jrefs.foot_pos_ref[k], jrefs.foot_vel_ref[k]) * dt
        g, mask = jocp.eq_constraints(jm, jparams, x, u, jrefs.contact_flags[k],
                                      jrefs.foot_pos_ref[k], jrefs.foot_vel_ref[k])
        return c, jnp.abs(g * mask).sum(), jro.rollout_step(jm, x, u, dt, js)

    xb, ub = xs_bar[0].numpy(), us_bar[0].numpy()
    out = []
    for alpha in alphas.tolist():
        x = jnp.asarray(x0[0].numpy())
        xs, us, cs, gs = [], [], [], []
        for k in range(ub.shape[0]):
            u = jnp.asarray(ub[k])
            if Ks is not None:
                u = u + alpha * kffs[0, k].numpy() + Ks[0, k].numpy() @ (x - xb[k])
            c, gsum, x_next = knot(x, u, k)
            xs.append(x)
            us.append(u)
            cs.append(c)
            gs.append(gsum)
            x = x_next
        xs.append(x)
        out.append((jnp.stack(xs), jnp.stack(us), jnp.stack(cs).sum(),
                    jnp.stack(gs).sum() / ub.shape[0]))
    return out


def _close(got, ref, rtol):
    got = got.detach().double().numpy()
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= rtol, err


def _args(flag, run, it, loop, dtype):
    alphas = torch.tensor(tddp.DdpSettings().alphas, dtype=dtype)
    c = lambda t: None if t is None else t.to(dtype)  # noqa: E731
    refs = type(run.refs)(*(c(t) if t.is_floating_point() else t for t in run.refs))
    if loop == "closed":
        return (refs, c(flag.x0), c(it["xs"]), c(it["us"]), c(it["Ks"]), c(it["kffs"]), alphas)
    return (refs, c(flag.x0), c(run.warm.states), c(run.warm.inputs[:, :-1]), None, None,
            alphas[:1])


# ODE45 at task.info's tolerances accepts every interval in one slot on this
# data; at TIGHT's it rejects and takes several
TIGHT = dict(abs_tol=1e-9, rel_tol=1e-7)


@pytest.mark.parametrize("loop", ["closed", "open"])
@pytest.mark.parametrize("integrator", ["RK2", "RK4", "ODE45", "ODE45_tight"])
def test_kernel_order_matches_jax(ddp_data, jax_problem, integrator, loop):
    flag, run, it = ddp_data
    tight = integrator.endswith("_tight")
    integrator = integrator.split("_")[0]
    rs = tddp.rollout_settings(tddp.DdpSettings(**SETTINGS, integrator=integrator,
                                                **(TIGHT if tight else {})))
    args = _args(flag, run, it, loop, F64)
    got = kernel_order(flag.model, flag.params, *args, rs)
    ref = _jax_rollouts(*jax_problem, *args, rs)
    for a, (xs, us, c, e) in enumerate(ref):
        _close(got[0][0, a], xs, 1e-10)
        _close(got[1][0, a], us, 1e-10)
        _close(got[2][0, a], c, 1e-10)
        _close(got[3][0, a], e, 1e-10)
    assert (got[4] > 0).all() == (integrator == "ODE45")
    if tight:
        assert int(got[4].max()) > 1
    # the data exercises swing legs: their rows and penalties
    flags = run.refs.contact_flags[0]
    assert (flags < 0.5).any() and (flags > 0.5).any()


def test_kernel_order_float32_ode45_slots(ddp_data):
    """In float32 at task.info's tolerances, the transcription's accepted
    slots equal the float32 plain version's, and its states stay within
    1e-4 of the float64 run."""
    flag, run, it = ddp_data
    rs = tddp.rollout_settings(tddp.DdpSettings(**SETTINGS, integrator="ODE45"))
    f32 = entry.build_flagship(N, HORIZON, device="cpu", dtype=torch.float32)
    args32 = _args(flag, run, it, "closed", torch.float32)
    got = kernel_order(f32.model, f32.params, *args32, rs)
    plain = tddp.closed_rollout_plain(f32.model, f32.params, *args32, rs)
    assert torch.equal(got[4], plain[4])
    ref64 = kernel_order(flag.model, flag.params, *_args(flag, run, it, "closed", F64), rs)
    _close(got[0], ref64[0].numpy(), 1e-4)
