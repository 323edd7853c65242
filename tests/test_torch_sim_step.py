"""Kernel B11's order (``csrc/sim_step.cu``: a block of one or four warps
per scenario, the legs' chains side by side, M from its distinct entries,
the solve in registers) transcribed in torch on CPU tensors, against the
JAX package's full-order plant (backends/fullorder.py::sim_step).

``kernel_order`` follows the kernel substep by substep: the joints' local
transforms (R_origin rod) and the base, the two legs' chains with the
velocity pass (R (R_origin rod), as soa_model.cuh::leg_chain_dev walks
them), the world inertias; per point (11 link CoMs, 4 contacts) the Jacobian
columns that move it, in the kernel's slots (the Euler-rate columns, then
the leg's joints), each part of the lanes summing dJ/dt v over its slots
and the parts added as the half-warp shuffle and the warps add them; the
links' wrenches with the field folded into the gravity vector, the contact
law on the velocity pass's point velocities; M's base block from the
links' composite sums (m r and I + m (|r|^2 - r r') about the base origin)
and nle's base rows from sum F and sum r x F + T, each summed as the
half-warp shuffle tree sums it; I_k J_k once per (link, joint column);
each joint column's generalized force over the links it moves, each
column's Jc' f over the contacts; M's other distinct entries from the
kernel's table, each over the links both columns move; the tableau [ms M + diag(arm + dt damp) | rhs]
eliminated by Gauss-Jordan in the natural order (every other row less the
pivot row times A_rk / (A_kk + 1e-30), the rows not normalized on the way,
each right-hand side divided by its own pivot + 1e-30 at the end), the
inverse never formed; semi-implicit Euler.  The zero columns are not
formed; the poison 0 x sum(q + v) rides on the contact velocities and the
right-hand side.

Held to JAX's ``sim_step`` in float64 within 1e-10 of max(1, |JAX|) tick
by tick: the sim loop's standing robot beside ``entry.sim_step_batch``'s
seeded sweep states (B=4, the knobs None), and sweep states with
per-scenario ``mass_scale`` / ``gravity_delta`` and a 9 ms delay ring.  In
float32 the transcription (both warp layouts' sums) is within 2x the
float32 plain version's own distance from the float64 plain version, on
each output's scale, outside the scenarios whose in-contact decisions
flipped (it flips at most 2x the float32 plain version's scenarios + 2).
A NaN in q, v, the command, the mass scale or the field gives NaN where
``substeps_plain`` has it.  The tables (M's 115 entries outside the base
block, I J's 30 pairs) cover what the model's ancestor mask says they
must.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunter_bipedal_control_tpu.backends import fullorder as jfo
from hunter_bipedal_control_tpu.runtime.controller import JointCommand as JCmd
from hunter_bipedal_control_tpu_torch.backends import fullorder as tfo
from hunter_bipedal_control_tpu_torch.entry import build_sim_loop, sim_step_batch
from hunter_bipedal_control_tpu_torch.models import soa
from hunter_bipedal_control_tpu_torch.models.robot import load_model
from hunter_bipedal_control_tpu_torch.ocp import soa_kernel
from hunter_bipedal_control_tpu_torch.runtime.controller import JointCommand

F64, F32 = torch.float64, torch.float32
NQ, NJ, L, NC, LEG = 16, 10, 11, 4, 5
G = 9.81
WIDE, WIDE_MAX_BATCH = 4, 4 * 132
TOL64 = 1e-10
FIELDS = ("q", "v", "base_acc", "contact_forces")


# ---------------------------------------------------------------------------
# the kernel's order
# ---------------------------------------------------------------------------


def _consts(model, dtype):
    """soa_kernel's constants buffer, split by the kernel's layout."""
    k = torch.as_tensor(soa_kernel.consts_values(soa.build_consts(model)), dtype=dtype)
    sizes = dict(opos=NJ * 3, orot=NJ * 9, axis=NJ * 3, rk=NJ * 9, rkk=NJ * 9, coml=L * 3,
                 mass=L, iner=L * 9)
    out, o = {}, 0
    for name, n in sizes.items():
        out[name] = k[o:o + n]
        o += n
    out["cpos"] = k[o:o + NC * 3].reshape(NC, 3)
    out["m"] = k[o + NC * 3]
    for name in ("orot", "rk", "rkk", "iner"):
        out[name] = out[name].reshape(-1, 3, 3)
    for name in ("opos", "axis", "coml"):
        out[name] = out[name].reshape(-1, 3)
    return out


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def link_leg(k):
    return (k - 1) // LEG


def link_depth(k):
    return 0 if k == 0 else (k - 1) % LEG + 1


def joint_parent(j):
    return 0 if j % LEG == 0 else j


def contact_link(c):
    return LEG * (1 + c % 2)


def m_entries():
    """csrc/sim_step.cu::m_entry: (i, j, first link, links) of M's 115
    distinct entries outside the base block, sorted by the count of links
    both columns move."""
    out = []
    for t in range(LEG):
        for g in range(2):
            col = 6 + LEG * g + t
            out += [(u, col, LEG * g + 1 + t, LEG - t) for u in range(6)]
            out += [(6 + LEG * g + n, col, LEG * g + 1 + t, LEG - t) for n in range(t + 1)]
    out += [(6 + n1, 6 + LEG + n2, 0, 0) for n1 in range(LEG) for n2 in range(LEG)]
    return out


def ij_entries():
    """csrc/sim_step.cu::ij_entry: per leg, link by link, the joints that
    move it."""
    return [(LEG * g + d, 6 + LEG * g + n) for g in range(2) for d in range(1, LEG + 1)
            for n in range(d)]


def _tree(v):
    """A half warp's xor-butterfly sum over the last dim (16 lanes), as every
    lane of the half gets it: v[l] + v[l + h] for h = 8, 4, 2, 1."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _lanes16(vals):
    """Per-link values (a list of L tensors (B, ...)) on lanes 0-10 of a half
    warp, zeros on 11-15: (B, ..., 16)."""
    x = torch.stack(vals, -1)
    return torch.cat([x, x.new_zeros(*x.shape[:-1], 16 - L)], -1)


def slot_column(slot, k):
    """The column of a point on link k in slot 0..7, None past its depth."""
    if slot < 3:
        return 3 + slot
    return 6 + LEG * link_leg(k) + slot - 3 if slot - 3 < link_depth(k) else None


def _chain(C, q, v):
    """Phase 1: the joints' local transforms and the base, the legs side by
    side with the velocity pass, then the world inertias."""
    dtype, B = q.dtype, q.shape[0]
    eye = torch.eye(3, dtype=dtype)
    qj = q[:, 6:]
    rod = (eye + torch.sin(qj)[..., None, None] * C["rk"]
           + (1.0 - torch.cos(qj))[..., None, None] * C["rkk"])
    T = C["orot"] @ rod
    ax = _mv(C["orot"], C["axis"])
    cz, sz, cy, sy, cx, sx = (torch.cos(q[:, 3]), torch.sin(q[:, 3]), torch.cos(q[:, 4]),
                              torch.sin(q[:, 4]), torch.cos(q[:, 5]), torch.sin(q[:, 5]))
    R0 = torch.stack([cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
                      sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
                      -sy, cy * sx, cy * cx], -1).reshape(B, 3, 3)
    zero, one = torch.zeros_like(cz), torch.ones_like(cz)
    zd, yd = v[:, 3], v[:, 4]
    E = torch.stack([zero, -sz, cz * cy, zero, cz, sz * cy, one, zero, -sy], -1).reshape(B, 3, 3)
    Ed = torch.stack([zero, -cz * zd, -sz * zd * cy - cz * sy * yd,
                      zero, -sz * zd, cz * zd * cy - sz * sy * yd,
                      zero, zero, -cy * yd], -1).reshape(B, 3, 3)
    p0 = q[:, 0:3]
    R, p, com, om, vo = [R0] * L, [p0] * L, [p0 + _mv(R0, C["coml"][0])] * L, [None] * L, [None] * L
    om[0], vo[0] = _mv(E, v[:, 3:6]), v[:, 0:3]
    aw, anchor = [None] * NJ, [None] * NJ
    for g in range(2):
        Rg, pg, omg, vog = R0, p0, om[0], vo[0]
        for n in range(LEG):
            j = LEG * g + n
            ch = j + 1
            por = pg + _mv(Rg, C["opos"][j])
            a = _mv(Rg, ax[j])
            Rc = Rg @ T[:, j]
            vog = vog + _cross(omg, por - pg)
            omg = omg + v[:, 6 + j, None] * a
            pg, Rg = por, Rc
            R[ch], p[ch], om[ch], vo[ch] = Rg, pg, omg, vog
            com[ch] = pg + _mv(Rg, C["coml"][ch])
            aw[j], anchor[j] = a, pg
    Iw = [(R[k] @ C["iner"][k]) @ R[k].transpose(-1, -2) for k in range(L)]
    return dict(R=R, p=p, com=com, om=om, vo=vo, aw=aw, anchor=anchor, E=E, Ed=Ed, Iw=Iw)


def _column(ch, v, i, x, xd):
    """csrc/sim_step.cu::column_dev: (lin, ang, dlin, dang) of column i >= 3."""
    if i < 6:
        c = i - 3
        a, ad, o, ov = ch["E"][..., c], ch["Ed"][..., c], ch["p"][0], v[:, 0:3]
    else:
        j = i - 6
        a, o, ov = ch["aw"][j], ch["anchor"][j], ch["vo"][j + 1]
        ad = _cross(ch["om"][joint_parent(j)], a)
    r, rd = x - o, xd - ov
    return _cross(a, r), a, _cross(ad, r) + _cross(a, rd), ad


def _contact_law(P, p, vp):
    """csrc/sim_step.cu::contact_force: (the force, the in-contact decision)."""
    pen = P["drop"] - p[..., 2]
    in_c = pen > 0.0
    zero = torch.zeros_like(pen)
    fn = torch.where(in_c, P["kn"] * pen - P["dn"] * vp[..., 2], zero)
    fn = torch.where(fn < 0.0, zero, fn)
    ft0 = torch.where(in_c, -P["kt"] * vp[..., 0], zero)
    ft1 = torch.where(in_c, -P["kt"] * vp[..., 1], zero)
    ft_norm = torch.sqrt(ft0 * ft0 + ft1 * ft1) + 1e-9
    r = P["mu"] * fn / ft_norm
    r = torch.where(r > 1.0, torch.ones_like(r), r)
    return torch.stack([ft0 * r, ft1 * r, fn], -1), in_c


def kernel_order(model, params: tfo.SimParams, q, v, active, nw=None, decisions=None):
    """B11's substeps on CPU tensors in the kernel's order: (q, v, the last
    substep's acceleration (B, 16), contact forces (B, 4, 3)); ``nw``, the
    warps a scenario (the kernel's choice from B by default), sets how the
    parts' dJ/dt v sums are added; ``decisions`` gets each substep's (B, 4)."""
    dtype, B = q.dtype, q.shape[0]
    nw = nw or (WIDE if B <= WIDE_MAX_BATCH else 1)
    C = _consts(model, dtype)
    P = {n: getattr(params, f).to(dtype) for n, f in
         (("dt", "dt"), ("kn", "contact_kn"), ("dn", "contact_dn"), ("kt", "contact_kt"),
          ("mu", "friction_mu"), ("arm", "armature"), ("damp", "joint_damping"))}
    P["drop"] = torch.zeros((), dtype=dtype) if params.sole_drop is None else params.sole_drop
    ms = (torch.ones(B, dtype=dtype) if params.mass_scale is None
          else torch.as_tensor(params.mass_scale, dtype=dtype).expand(B))
    gd = (torch.zeros(B, 3, dtype=dtype) if params.gravity_delta is None
          else torch.as_tensor(params.gravity_delta, dtype=dtype).expand(B, 3))
    gvec = torch.tensor([0.0, 0.0, G], dtype=dtype) - gd
    effort = model.joint_effort.to(dtype)
    diag = torch.cat([torch.zeros(6, dtype=dtype), (P["arm"] + P["dt"] * P["damp"]).expand(NJ)])
    damp = torch.cat([torch.zeros(6, dtype=dtype), P["damp"].expand(NJ)])
    e3 = torch.eye(3, dtype=dtype)
    for _ in range(params.substeps):
        ch = _chain(C, q, v)
        pz = 0.0 * (q + v).sum(-1)                                    # (B,)
        JL = torch.zeros(B, L, NQ, 3, dtype=dtype)
        JA = torch.zeros_like(JL)
        JC = torch.zeros(B, NC, NQ, 3, dtype=dtype)
        JL[:, :, 0:3] = e3
        JC[:, :, 0:3] = e3
        F, Tq, fc, dec = [None] * L, [None] * L, [None] * NC, [None] * NC
        nle_terms, base_terms = [None] * L, [None] * L
        for pt in range(L + NC):
            link = pt < L
            kl = pt if link else contact_link(pt - L)
            x = ch["com"][kl] if link else ch["p"][kl] + _mv(ch["R"][kl], C["cpos"][pt - L])
            xd = ch["vo"][kl] + _cross(ch["om"][kl], x - ch["p"][kl])
            parts = []
            for part in range(2 * nw):
                s = torch.zeros(B, 6, dtype=dtype)
                for slot in range(part, 3 + LEG, 2 * nw):
                    i = slot_column(slot, kl)
                    if i is None:
                        break
                    lin, ang, dlin, dang = _column(ch, v, i, x, xd)
                    if link:
                        JL[:, kl, i], JA[:, kl, i] = lin, ang
                        s = s + torch.cat([dlin, dang], -1) * v[:, i, None]
                    else:
                        JC[:, pt - L, i] = lin
                parts.append(s)
            if link:
                # the shuffle across the halves, then warp 0 adds the warps in order
                warps = [parts[2 * w] + parts[2 * w + 1] for w in range(nw)]
                acc = warps[0]
                for w in warps[1:]:
                    acc = acc + w
                w_ = ch["om"][kl]
                Iw = ch["Iw"][kl]
                mk = C["mass"][kl]
                F[kl] = mk * (acc[:, 0:3] + gvec)
                Tq[kl] = _mv(Iw, acc[:, 3:6]) + _cross(w_, _mv(Iw, w_))
                r = x - ch["p"][0]
                rr = (r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1]) + r[:, 2] * r[:, 2]
                Ic = Iw + mk * (rr[:, None, None] * e3 - r[:, :, None] * r[:, None, :])
                base_terms[kl] = torch.cat([mk * r, Ic.flatten(1)], -1)
                nle_terms[kl] = torch.cat([F[kl], _cross(r, F[kl]) + Tq[kl]], -1)
            else:
                c = pt - L
                fc[c], dec[c] = _contact_law(P, x, xd + pz[:, None])
        fc, dec = torch.stack(fc, 1), torch.stack(dec, 1)
        if decisions is not None:
            decisions.append(dec)
        # the links' sums as the half-warp trees add them
        S = _tree(_lanes16(base_terms))                               # (B, 12)
        S1, Ic = S[:, 0:3], S[:, 3:].reshape(B, 3, 3)
        N = _tree(_lanes16(nle_terms))                                # (B, 6)
        E = ch["E"]
        M = torch.zeros(B, NQ, NQ, dtype=dtype)
        M[:, 0:3, 0:3] = C["m"] * e3
        for c in range(3):
            t = _cross(E[..., c], S1)
            M[:, 0:3, 3 + c] = M[:, 3 + c, 0:3] = t
        for a_ in range(3):
            for b_ in range(a_, 3):
                M[:, 3 + a_, 3 + b_] = M[:, 3 + b_, 3 + a_] = _dot3(E[..., a_],
                                                                    _mv(Ic, E[..., b_]))
        hb = torch.cat([N[:, 0:3], torch.stack([_dot3(E[..., c], N[:, 3:6]) for c in range(3)],
                                               -1)], -1)
        IJ = torch.zeros_like(JL)
        for k, i in ij_entries():
            IJ[:, k, i] = _mv(ch["Iw"][k], JA[:, k, i])
        gen = []
        for r in range(NQ):
            g, n = (0, 0) if r < 6 else divmod(r - 6, LEG)
            ks = range(0) if r < 6 else range(LEG * g + 1 + n, LEG * g + 6)
            h = hb[:, r] if r < 6 else torch.zeros(B, dtype=dtype)
            for k in ks:
                h = h + (_dot3(JL[:, k, r], F[k]) + _dot3(JA[:, k, r], Tq[k]))
            jf = torch.zeros(B, dtype=dtype)
            for c in range(NC):
                if r >= 6 and c % 2 != g:
                    continue
                for e in range(3):
                    jf = jf + JC[:, c, r, e] * fc[:, c, e]
            gen.append(jf - ms * h)
        gen = torch.stack(gen, -1)
        for i, j, k0, n in m_entries():
            lin = torch.zeros(B, dtype=dtype)
            ang = torch.zeros(B, dtype=dtype)
            for k in range(k0, k0 + n):
                lin = lin + C["mass"][k] * _dot3(JL[:, k, i], JL[:, k, j])
                ang = ang + _dot3(JA[:, k, i], IJ[:, k, j])
            M[:, i, j] = M[:, j, i] = lin + ang
        pos_des, vel_des, kp, kd, ff = active.to(dtype).unbind(-2)
        t = (ff + kp * (pos_des - q[:, 6:])) + kd * (vel_des - v[:, 6:])
        t = torch.where(t < -effort, -effort, t)
        tau = torch.where(t > effort, effort, t)
        rhs = ((torch.cat([torch.zeros(B, 6, dtype=dtype), tau], -1) + gen) - damp * v) + pz[:, None]
        rows = torch.cat([ms[:, None, None] * M + torch.diag(diag), rhs[..., None]], -1)
        invs = []
        for kp_ in range(NQ):
            inv = 1.0 / (rows[:, kp_, kp_] + 1e-30)
            invs.append(inv)
            m = rows[:, :, kp_] * inv[:, None]
            m[:, kp_] = 0.0
            new = rows[:, :, kp_ + 1:] - m[..., None] * rows[:, kp_, None, kp_ + 1:]
            rows = torch.cat([rows[:, :, :kp_ + 1], new], -1)
        a = rows[:, :, NQ] * torch.stack(invs, -1)
        v = v + P["dt"] * a
        q = q + P["dt"] * v
    return q, v, a, fc


# ---------------------------------------------------------------------------
# the JAX side (tests/test_torch_fullorder.py's use)
# ---------------------------------------------------------------------------

_JM = {}


def _jax_model():
    if "m" not in _JM:
        from hunter_bipedal_control_tpu.models.robot import load_model as jload

        _JM["m"] = jload(dtype=jnp.float64)
    return _JM["m"]


def _jax_params(p: tfo.SimParams, **knobs):
    vals = {f: (jnp.asarray(getattr(p, f).numpy()) if torch.is_tensor(getattr(p, f))
                else getattr(p, f)) for f in p._fields}
    vals.update(gravity_delta=None, mass_scale=None)
    vals.update(knobs)
    return jfo.SimParams(**vals)


def _jax_states(st: tfo.SimState):
    arrays = {f: jnp.asarray(getattr(st, f).numpy()) for f in
              ("q", "v", "t", "base_acc", "contact_forces", "cmd_buffer")}
    return jfo.SimState(**arrays, buf_head=jnp.asarray(st.buf_head.numpy().astype(np.int32)))


def _standing_and_sweep():
    """The sim loop's cold plant (z = 0.624, a PD hold at the nominal
    joints) beside sim_step_batch's sweep states (B=4, no delay, the knobs
    None): B=5 under the default plant."""
    setup = build_sim_loop("cpu", F64)
    st = setup.state.plant
    zeros = torch.zeros((1, NJ), dtype=F64)
    cmd = JointCommand(setup.default_joints[None].clone(), zeros, torch.full_like(zeros, 40.0),
                       torch.full_like(zeros, 2.0), zeros)
    sb = sim_step_batch(4, "cpu", F64, seed=21, delay_ms=0.0)
    state = tfo.SimState(*(torch.cat([a, b]) for a, b in zip(st, sb.state)))
    cmd = JointCommand(*(torch.cat([a, b]) for a, b in zip(cmd, sb.command)))
    return setup.model, sb.params._replace(mass_scale=None, gravity_delta=None), state, cmd


def _order_tick(model, params, st, cmd, nw=None):
    buf, head, active = tfo._push_command(params, st, cmd)
    q, v, acc, f_c = kernel_order(model, params, st.q, st.v, active, nw)
    return tfo._next_state(params, st, buf, head, q, v, acc, f_c)


def _near(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("case", ["standing_and_sweep", "knobs_delay_9ms"])
def test_kernel_order_matches_jax(case):
    """Three ticks in float64, tick by tick against a vmapped JAX sim_step
    (per-scenario knobs as vmapped arguments)."""
    if case == "standing_and_sweep":
        model, params, st, cmd = _standing_and_sweep()
        knobs = {}
    else:
        sb = sim_step_batch(4, "cpu", F64, seed=22, delay_ms=9.0)
        model, params, st, cmd = sb.model, sb.params, sb.state, sb.command
        knobs = {"mass_scale": params.mass_scale, "gravity_delta": params.gravity_delta}
        assert params.delay_steps == 36
    jm = _jax_model()

    def one(s, c, *k):
        return jfo.sim_step(jm, _jax_params(params, **dict(zip(knobs, k))), s, c)

    step = jax.jit(jax.vmap(one))
    jst = _jax_states(st)
    kargs = [jnp.asarray(t.numpy()) for t in knobs.values()]
    contact = []
    for tick in range(3):
        dec = []
        buf, head, active = tfo._push_command(params, st, cmd)
        out = kernel_order(model, params, st.q, st.v, active, decisions=dec)
        contact.append(torch.stack(dec).any(0))
        st = tfo._next_state(params, st, buf, head, *out)
        jst = step(jst, JCmd(*(jnp.asarray(t.numpy()) for t in cmd)), *kargs)
        for f in FIELDS:
            err = _near(getattr(st, f).numpy(), getattr(jst, f))
            assert err <= TOL64, (tick, f, err)
    contact = torch.stack(contact).any(0)
    assert contact.any() and not contact.all()


def _own(a, ref):
    return ((a.double() - ref.double()).abs().max() / ref.double().abs().max().clamp(min=1e-30)).item()


@pytest.mark.parametrize("nw", [1, WIDE], ids=["one_warp", "four_warps"])
def test_kernel_order_float32_within_plain_error(nw):
    """One tick of 64 sweep scenarios (9 ms delay ring, mass scale, field)
    in float32: each output within 2x the float32 plain version's distance
    from the float64 plain version, on its own scale, outside the scenarios
    whose decisions flipped against the float64 plain version's."""
    sb = sim_step_batch(64, "cpu", F64, seed=23, delay_ms=9.0)
    active = tfo._push_command(sb.params, sb.state, sb.command)[2]
    p32 = tfo.SimParams(*(a.to(F32) if torch.is_tensor(a) else a for a in sb.params))
    m32 = load_model(device="cpu", dtype=F32)
    d32, d64, dk = [], [], []
    ref64 = tfo.substeps_plain(sb.model, sb.params, sb.state.q, sb.state.v, active, d64)
    args32 = (sb.state.q.to(F32), sb.state.v.to(F32), active.to(F32))
    ref32 = tfo.substeps_plain(m32, p32, *args32, d32)
    got = kernel_order(m32, p32, *args32, nw=nw, decisions=dk)
    d64 = torch.stack(d64, 1)
    flip_k = (torch.stack(dk, 1) != d64).flatten(1).any(-1)
    flip_p = (torch.stack(d32, 1) != d64).flatten(1).any(-1)
    keep = ~(flip_k | flip_p)
    assert int(flip_k.sum()) <= 2 * int(flip_p.sum()) + 2
    assert keep.sum() >= 48
    for name, a, b, c in zip(FIELDS, got, ref32, ref64):
        assert a.dtype == F32 and torch.isfinite(a).all(), name
        e, e32 = _own(a[keep], c[keep]), _own(b[keep], c[keep])
        assert e <= 2.0 * e32, (name, e, e32)


@pytest.mark.parametrize("where", ["q", "v", "command", "mass_scale", "gravity_delta"])
@pytest.mark.parametrize("substeps", [1, 8])
def test_kernel_order_nan_where_plain_has_it(where, substeps):
    """A NaN in one scenario's input gives NaN where substeps_plain has it
    (the zero columns the kernel does not form carry the poison term)."""
    sb = sim_step_batch(4, "cpu", F64, seed=24, delay_ms=0.0)
    params = sb.params._replace(substeps=substeps)
    q, v = sb.state.q.clone(), sb.state.v.clone()
    active = tfo._push_command(params, sb.state, sb.command)[2].clone()
    ms, gd = params.mass_scale.clone(), params.gravity_delta.clone()
    if where == "q":
        q[1, 8] = float("nan")
    elif where == "v":
        v[1, 13] = float("nan")
    elif where == "command":
        active[1, 2, 3] = float("nan")
    elif where == "mass_scale":
        ms[1] = float("nan")
    else:
        gd[1, 0] = float("nan")
    params = params._replace(mass_scale=ms, gravity_delta=gd)
    got = kernel_order(sb.model, params, q, v, active)
    ref = tfo.substeps_plain(sb.model, params, q, v, active)
    for name, a, b in zip(FIELDS, got, ref):
        assert torch.equal(a.isnan(), b.isnan()), (name, a.isnan(), b.isnan())
        assert not a[[0, 2, 3]].isnan().any(), name
    assert got[0][1].isnan().all()


def test_tables_cover_the_ancestor_mask():
    """M's table holds each of the 115 (i <= j) pairs outside the 6x6 base
    block once, over exactly the links whose Jacobians have both columns
    (the model's ancestor mask), in descending link counts; I J's table
    holds each link's joint columns that are not identically zero."""
    anc = load_model(device="cpu").ancestor_mask.numpy().astype(bool)   # (L, nj)
    moves = np.zeros((L, NQ), bool)
    moves[:, :6] = True
    moves[:, 6:] = anc
    entries = m_entries()
    assert sorted((i, j) for i, j, _, _ in entries) == [(i, j) for i in range(NQ)
                                                        for j in range(max(i, 6), NQ)]
    counts = [n for _, _, _, n in entries]
    assert counts == sorted(counts, reverse=True)
    for i, j, k0, n in entries:
        assert list(range(k0, k0 + n)) == [k for k in range(L) if moves[k, i] and moves[k, j]]
    assert sorted(ij_entries()) == [(k, i) for k in range(L) for i in range(6, NQ) if moves[k, i]]
    for k in range(L):
        assert [slot_column(s, k) for s in range(3 + LEG) if slot_column(s, k) is not None] == [
            i for i in range(3, NQ) if moves[k, i]]


def test_params_buffer():
    """The wrapper's parameter buffer: the eight scalars in the kernel's
    order, the sole drop 0 where it is None, refused for a scalar that is
    not 0-d."""
    params = tfo.default_sim_params("cpu", F32, delay_ms=9.0)
    want = [params.dt, params.contact_kn, params.contact_dn, params.contact_kt,
            params.friction_mu, params.armature, params.joint_damping, params.sole_drop]
    assert torch.equal(tfo.params_buffer(params), torch.stack(want))
    no_drop = params._replace(sole_drop=None)
    assert tfo.params_buffer(no_drop)[7] == 0.0
    with pytest.raises(ValueError, match="0-d"):
        tfo.params_buffer(params._replace(armature=torch.zeros(10)))
