"""Port parity: kernel B9's plain version, ``wbc/wbc.py::wbc_qp_plain``,
and a transcription of the kernel's order (``kernel_order``), against the
QP data that the JAX ``wbc_update`` hands ``solve_qp``, and the routing of
its wrapper ``wbc_qp``, on the CPU.

The JAX data are recorded by a stand-in for the name ``wbc.py`` calls
(``hunter_bipedal_control_tpu.wbc.wbc.solve_qp``), one scenario at a time
under ``jax.disable_jit()``; the JAX package is not changed.  B=3 perturbed
states as tests/test_torch_wbc.py builds them (three contact modes), walking,
in stance mode, and with both stance modes in one batch.  Each of the six
arrays (H, g, Aeq, beq, Ain, bin) within 1e-9 of its own scale (max |JAX|,
floored at 1) in float64 and 1e-4 in float32 (both sides float32).
``wbc_qp`` on CPU tensors is ``wbc_qp_plain`` bit for bit and launches
nothing; the wrapper refuses what its kernel does not take before any launch.

``kernel_order`` writes ``csrc/wbc_qp.cu``'s algebra out in torch: the
chains leg by leg from the base's frame, the desired state's base-fixed
velocity pass, its base velocity from per-link sums and each link's full
velocity as the base's plus its base-fixed one; the 16 Jacobian columns of
every link CoM and contact point; M's upper triangle mirrored; the desired
base acceleration from per-link and per-contact terms; the right-hand sides
(log3 by atan2); H from the 15 dense rows' 16x16 block, the unit rows'
squared weights on the diagonal and the poison terms, g the same way.  Its
sums are torch's, so it holds the algebra, not the kernel's rounding: in
float64 within 1e-9 of JAX's data in both stance modes and on walking
flags.  A NaN in the measurement, the desired state or input, a flag or a
gain puts NaN at the entries of H and g where ``wbc_qp_plain`` (the dense
product rows_A' rows_A) puts it, and in the same rows of the other four
arrays; an Inf, a non-finite value at the same entries of H and g.  The
gains buffer is kept per ``WbcParams`` and rebuilt on a change; the six
outputs are views at 16-byte-aligned offsets of one buffer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hunter_bipedal_control_tpu.wbc.wbc as jwbc
from hunter_bipedal_control_tpu.models.centroidal import q_v_to_rbd_state
from hunter_bipedal_control_tpu.models.robot import load_model as jload
from hunter_bipedal_control_tpu.ocp.problem import weight_compensating_input
from hunter_bipedal_control_tpu_torch import convert
from hunter_bipedal_control_tpu_torch.models import soa
from hunter_bipedal_control_tpu_torch.wbc import wbc as twbc

DJ = np.array([0.10, 0., 0.40, 0.93, 0.53, -0.10, 0., -0.40, 0.93, -0.53])
QNOM = np.concatenate([[0., 0., 0.63], np.zeros(3), DJ])
FLAGS = np.array([[1., 0., 1., 0.], [0., 1., 0., 1.], [1., 1., 1., 1.]])
B = 3
STANCE = {"walking": [False] * B, "stance": [True] * B, "mixed": [False, True, False]}
NAMES = ("H", "g", "Aeq", "beq", "Ain", "bin")
TOL = {torch.float64: 1e-9, torch.float32: 1e-4}


def scaled_err(got, ref):
    got = got.detach().double().numpy()
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


@pytest.fixture(scope="module")
def states():
    """(rbd, x_des, u_des) float64, as tests/test_torch_wbc.py draws them."""
    jm = jload(dtype=jnp.float64)
    rng = np.random.default_rng(20)
    q = QNOM + np.concatenate([0.01 * rng.standard_normal((B, 6)),
                               0.05 * rng.standard_normal((B, 10))], axis=1)
    v = 0.1 * rng.standard_normal((B, 16))
    rbd = np.asarray(jax.vmap(lambda a, b: q_v_to_rbd_state(jm, a, b))(q, v))
    x_des = np.concatenate([0.05 * rng.standard_normal((B, 6)), np.tile(QNOM, (B, 1))
                            + 0.02 * rng.standard_normal((B, 16))], axis=1)
    u_des = np.asarray(jax.vmap(lambda f: weight_compensating_input(jm, f, 22, jnp.float64))(
        FLAGS)) + np.concatenate([rng.standard_normal((B, 12)),
                                  0.2 * rng.standard_normal((B, 10))], axis=1)
    return rbd, x_des, u_des


def jax_qp_data(states, stance, jdtype):
    """The six arrays JAX's ``wbc_update`` passes ``solve_qp``, per scenario,
    stacked (numpy)."""
    rbd, x_des, u_des = states
    jm = jload(dtype=jdtype)
    params = jwbc.default_wbc_params(jdtype)
    state = jwbc.init_wbc_state(jdtype)
    seen, real = [], jwbc.solve_qp

    def record(*args, **kwargs):
        seen.append([np.asarray(a) for a in args[:6]])
        return real(*args, **kwargs)

    jwbc.solve_qp = record
    try:
        with jax.disable_jit():
            for i in range(B):
                a = [jnp.asarray(t[i], jdtype) for t in (x_des, u_des, rbd, FLAGS)]
                jwbc.wbc_update(jm, params, state, *a, jnp.asarray(STANCE[stance][i]))
    finally:
        jwbc.solve_qp = real
    assert len(seen) == B
    return [np.stack(arrs) for arrs in zip(*seen)]


@pytest.fixture(scope="module")
def jax_data(states):
    """``jax_qp_data`` on the module's states, each (stance, dtype) once."""
    memo = {}

    def get(stance, jdtype):
        key = (stance, jnp.dtype(jdtype).name)
        if key not in memo:
            memo[key] = jax_qp_data(states, stance, jdtype)
        return memo[key]

    return get


def port_args(states, stance, dtype):
    rbd, x_des, u_des = states
    model = convert.from_numpy(jax.tree.map(np.asarray, jload(dtype=jnp.float64)), "cpu", dtype)
    params = twbc.default_wbc_params("cpu", dtype)
    arrays = [torch.tensor(a, dtype=dtype) for a in (x_des, u_des, rbd, FLAGS)]
    return (model, params, *arrays, torch.tensor(STANCE[stance]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("stance", list(STANCE))
def test_wbc_qp_plain_matches_jax(states, jax_data, stance, dtype):
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    ref = jax_data(stance, jdtype)
    got = twbc.wbc_qp_plain(*port_args(states, stance, dtype))
    for name, a, b in zip(NAMES, got, ref):
        assert a.dtype == dtype, name
        assert scaled_err(a, b) < TOL[dtype], name
    walk = ~torch.tensor(STANCE[stance])
    # the swing rows see the tasks only when walking
    assert (got[1].abs().amax(-1)[walk] > 1.0).all()


def test_wbc_qp_routes_cpu_to_plain(states):
    args = port_args(states, "mixed", torch.float32)
    before = twbc.wbc_qp.launches
    got = twbc.wbc_qp(*args)
    ref = twbc.wbc_qp_plain(*args)
    assert twbc.wbc_qp.launches == before
    for name, a, b in zip(NAMES, got, ref):
        assert a.device.type == "cpu" and torch.equal(a, b), name


def test_wbc_qp_refuses_what_the_kernel_does_not_take(states):
    """Off the CPU the wrapper checks before it builds or launches anything:
    a tensor that is not on the card, a batch that is not one leading dim,
    gains of the wrong shape."""
    model, params, x_des, u_des, rbd, flags, stance = port_args(states, "mixed", torch.float32)
    meta = [t.to("meta") for t in (x_des, u_des, rbd, flags, stance)]
    before = twbc.wbc_qp.launches
    with pytest.raises(ValueError, match="CUDA"):
        twbc.wbc_qp(model, params, *meta)
    with pytest.raises(ValueError, match="rbd_measured"):
        twbc.wbc_qp(model, params, *meta[:2], meta[2][None], *meta[3:])
    with pytest.raises(ValueError, match="torque_limits"):
        twbc.params_buffer(params._replace(torque_limits=params.torque_limits[:4]))
    assert twbc.params_buffer(params).shape == (twbc.N_PARAMS,)
    assert twbc.wbc_qp.launches == before


# ---------------------------------------------------------------------------
# the kernel's order (csrc/wbc_qp.cu), transcribed
# ---------------------------------------------------------------------------

NQ, NF, NJ, L, NC = 16, 12, 10, 11, 4
NDEC = NQ + NF + NJ
GRAVITY = 9.81
ND = NF + 3


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _euler_E(trig):
    cz, sz, cy, sy = trig.unbind(-1)
    z, o = torch.zeros_like(cz), torch.ones_like(cz)
    return torch.stack([torch.stack([z, -sz, cz * cy], -1), torch.stack([z, cz, sz * cy], -1),
                        torch.stack([o, z, -sy], -1)], -2)


def _euler_Edot(trig, thd):
    cz, sz, cy, sy = trig.unbind(-1)
    zd, yd = thd[..., 0], thd[..., 1]
    z = torch.zeros_like(cz)
    return torch.stack([torch.stack([z, -cz * zd, -sz * zd * cy - cz * sy * yd], -1),
                        torch.stack([z, -sz * zd, cz * zd * cy - sz * sy * yd], -1),
                        torch.stack([z, z, -cy * yd], -1)], -2)


def _consts(model, dtype):
    c = soa.build_consts(model)

    def t(x, *shape):
        return torch.tensor(x, dtype=dtype).reshape(*shape)

    anc = torch.zeros((L, NJ), dtype=dtype)
    for k, js in enumerate(c.joints_of_link):
        anc[k, list(js)] = 1.0
    return dict(opos=t(c.origin_pos, NJ, 3), orot=t(c.origin_rot, NJ, 3, 3),
                axis=t(c.axis, NJ, 3), rK=t(c.rod_K, NJ, 3, 3), rKK=t(c.rod_KK, NJ, 3, 3),
                coml=t(c.com_local, L, 3), mass=t(c.mass, L), iner=t(c.inertia, L, 3, 3),
                cpos=t(c.contact_pos, NC, 3), m=c.total_mass, cparent=c.contact_parent,
                parent=c.parent, child=c.child, anc=anc)


def _chains(C, q, vj, om0, vo0):
    """The base's pose, then each leg joint by joint from the base's frame:
    (trig, R (B, L, 3, 3), p, com, aw (B, NJ, 3), om, vo (B, L, 3))."""
    cz, sz = torch.cos(q[:, 3]), torch.sin(q[:, 3])
    cy, sy = torch.cos(q[:, 4]), torch.sin(q[:, 4])
    cx, sx = torch.cos(q[:, 5]), torch.sin(q[:, 5])
    R0 = torch.stack([cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
                      sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
                      -sy, cy * sx, cy * cx], -1).reshape(-1, 3, 3)
    p0 = q[:, 0:3]
    R, p, om, vo, aw = [R0] + [None] * NJ, [p0] + [None] * NJ, [om0] + [None] * NJ, \
        [vo0] + [None] * NJ, [None] * NJ
    eye = torch.eye(3, dtype=q.dtype)
    for g in range(2):
        Rc, pc, omc, voc = R0, p0, om0, vo0
        for n in range(NJ // 2):
            j = NJ // 2 * g + n
            Ror = Rc @ C["orot"][j]
            por = pc + _mv(Rc, C["opos"][j])
            a = _mv(Ror, C["axis"][j])
            cj, sj = torch.cos(q[:, 6 + j]), torch.sin(q[:, 6 + j])
            rod = eye + sj[:, None, None] * C["rK"][j] + (1.0 - cj)[:, None, None] * C["rKK"][j]
            Rc = Ror @ rod
            voc = voc + _cross(omc, por - pc)
            omc = omc + vj[:, j, None] * a
            pc = por
            R[j + 1], p[j + 1], om[j + 1], vo[j + 1], aw[j] = Rc, pc, omc, voc, a
    R, p = torch.stack(R, 1), torch.stack(p, 1)
    com = p + _mv(R, C["coml"])
    trig = torch.stack([cz, sz, cy, sy], -1)
    return trig, R, p, com, torch.stack(aw, 1), torch.stack(om, 1), torch.stack(vo, 1)


def _inv3(M):
    """The adjugate inverse (soa_model.cuh::inv3)."""
    c = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            r = [a for a in range(3) if a != i]
            k = [b for b in range(3) if b != j]
            c[i][j] = (-1) ** (i + j) * (M[:, r[0], k[0]] * M[:, r[1], k[1]]
                                         - M[:, r[0], k[1]] * M[:, r[1], k[0]])
    det = M[:, 0, 0] * c[0][0] + M[:, 0, 1] * c[0][1] + M[:, 0, 2] * c[0][2]
    adj = torch.stack([torch.stack([c[j][i] for j in range(3)], -1) for i in range(3)], -2)
    return adj * (1.0 / det)[:, None, None]


def _columns(C, st, x, xd, kl):
    """The 16 Jacobian columns (lin, ang, dlin, dang: (B, P, 16, 3)) of the
    points x (B, P, 3) on links kl, velocities xd."""
    B, P = x.shape[:2]
    E, Ed, v = st["E"], st["Ed"], st["v"]
    zero = torch.zeros((B, P, 3), dtype=x.dtype)
    lin, ang, dlin, dang = [], [], [], []
    for i in range(3):
        e = zero.clone()
        e[..., i] = 1.0
        lin.append(e)
        ang.append(zero)
        dlin.append(zero)
        dang.append(zero)
    r = x - st["p"][:, None, 0]
    rd = xd - v[:, None, 0:3]
    for c in range(3):
        Ec = E[:, None, :, c].expand(B, P, 3)
        Edc = Ed[:, None, :, c].expand(B, P, 3)
        lin.append(_cross(Ec, r))
        ang.append(Ec)
        dlin.append(_cross(Edc, r) + _cross(Ec, rd))
        dang.append(Edc)
    for j in range(NJ):
        mask = C["anc"][list(kl), j][None, :, None]
        aj = st["aw"][:, None, j].expand(B, P, 3)
        r = x - st["p"][:, None, C["child"][j]]
        rd = xd - st["vo"][:, None, C["child"][j]]
        ad = _cross(st["om"][:, None, C["parent"][j]].expand(B, P, 3), aj)
        lin.append(_cross(aj, r) * mask)
        ang.append(aj * mask)
        dlin.append((_cross(ad, r) + _cross(aj, rd)) * mask)
        dang.append(ad * mask)
    return [torch.stack(t, 2) for t in (lin, ang, dlin, dang)]


def _points(C, st):
    """Both states' points: the link CoMs and the contact points, their
    links, velocities and columns, and the columns' sums along v."""
    kl = list(range(L)) + list(C["cparent"])
    cpts = st["p"][:, list(C["cparent"])] + _mv(st["R"][:, list(C["cparent"])], C["cpos"])
    x = torch.cat([st["com"], cpts], 1)
    xd = st["vo"][:, kl] + _cross(st["om"][:, kl], x - st["p"][:, kl])
    lin, ang, dlin, dang = _columns(C, st, x, xd, kl)
    v = st["v"][:, None, :, None]
    return x, lin, ang, (lin * v).sum(2), (ang * v).sum(2), (dlin * v).sum(2), (dang * v).sum(2)


def _log3(R):
    c = 0.5 * (R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2] - 1.0)
    vee = 0.5 * torch.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                             R[:, 1, 0] - R[:, 0, 1]], -1)
    th = torch.atan2(vee.norm(dim=-1), c)
    scale = torch.where(th < 1e-6, 1.0 + th * th / 6.0, th / torch.sin(th))
    return scale[:, None] * vee


def kernel_order(model, params, x_des, u_des, rbd, flags, stance):
    """csrc/wbc_qp.cu's algebra in torch: (H, g, Aeq, beq, Ain, bin)."""
    dt = rbd.dtype
    C = _consts(model, dt)
    Bn = rbd.shape[0]
    m, inv_m = C["m"], 1.0 / C["m"]
    mass = C["mass"]
    # 1. the measured state: q, v in the Euler-rate form, the chains
    q = torch.cat([rbd[:, 3:6], rbd[:, 0:3], rbd[:, 6:16]], -1)
    cz, sz = torch.cos(rbd[:, 0]), torch.sin(rbd[:, 0])
    cy, sy = torch.cos(rbd[:, 1]), torch.sin(rbd[:, 1])
    ty = sy / cy
    z = torch.zeros_like(cz)
    Einv = torch.stack([cz * ty, sz * ty, torch.ones_like(cz), -sz, cz, z, cz / cy, sz / cy, z],
                       -1).reshape(-1, 3, 3)
    v = torch.cat([rbd[:, 19:22], _mv(Einv, rbd[:, 16:19]), rbd[:, 22:32]], -1)
    E_m = _euler_E(torch.stack([torch.cos(q[:, 3]), torch.sin(q[:, 3]), torch.cos(q[:, 4]),
                                torch.sin(q[:, 4])], -1))
    trig, R, p, com, aw, om, vo = _chains(C, q, v[:, 6:], _mv(E_m, v[:, 3:6]), v[:, 0:3])
    sm = dict(R=R, p=p, com=com, aw=aw, om=om, vo=vo, v=v, E=E_m, Ed=_euler_Edot(trig, v[:, 3:6]))
    # the desired state: the base-fixed pass, the base velocity from per-link sums
    qd = x_des[:, 6:22]
    zero3 = torch.zeros((Bn, 3), dtype=dt)
    trig_d, Rd, pd, comd, awd, omj, voj = _chains(C, qd, u_des[:, NF:], zero3, zero3)
    E_d = _euler_E(trig_d)
    Iw_d = Rd @ C["iner"] @ Rd.transpose(-1, -2)
    Iw_m = R @ C["iner"] @ R.transpose(-1, -2)
    mk = mass[None, :, None]
    pcom = inv_m * (mk * comd).sum(1)
    cdot = voj + _cross(omj, comd - pd)
    r = comd - pcom[:, None]
    hl = (mk * cdot).sum(1)
    ha = (_mv(Iw_d, omj) + mk * _cross(r, cdot)).sum(1)
    Itot = Iw_d.sum(1)
    W = (mass[None, :, None, None] * (comd - pd[:, None, 0])[..., :, None] * r[..., None, :]).sum(1)
    trW = W.diagonal(dim1=-2, dim2=-1).sum(-1)
    G = Itot + trW[:, None, None] * torch.eye(3, dtype=dt) - W
    GE = G @ E_d
    s_ = pcom - pd[:, 0]
    sk = torch.stack([z, -s_[:, 2], s_[:, 1], s_[:, 2], z, -s_[:, 0], -s_[:, 1], s_[:, 0], z],
                     -1).reshape(-1, 3, 3)
    A12 = -m * (sk @ E_d)
    iGE = _inv3(GE)
    x2 = _mv(iGE, m * x_des[:, 3:6] - ha)
    vb = torch.cat([inv_m * ((m * x_des[:, 0:3] - hl) - _mv(A12, x2)), x2], -1)
    w0 = _mv(E_d, vb[:, 3:6])
    om_d = w0[:, None] + omj
    vo_d = (vb[:, None, 0:3] + _cross(w0[:, None].expand(-1, L, -1), pd - pd[:, None, 0])) + voj
    v_d = torch.cat([vb, u_des[:, NF:]], -1)
    sd = dict(R=Rd, p=pd, com=comd, aw=awd, om=om_d, vo=vo_d, v=v_d, E=E_d,
              Ed=_euler_Edot(trig_d, vb[:, 3:6]))
    # 2. the columns
    x_m, lin_m, ang_m, jv_m, wv_m, djv_m, dwv_m = _points(C, sm)
    x_d, _, _, jv_d, wv_d, djv_d, dwv_d = _points(C, sd)
    Jl, Ja = lin_m[:, :L], ang_m[:, :L]                       # (B, L, 16, 3)
    Jc = lin_m[:, L:].permute(0, 1, 3, 2).reshape(Bn, NF, NQ)
    # 3. M (upper triangle, mirrored), nle, the desired base acceleration
    Mf = (mk[..., None] * Jl @ Jl.transpose(-1, -2)).sum(1) \
        + (Ja @ Iw_m @ Ja.transpose(-1, -2)).sum(1)
    M = torch.triu(Mf) + torch.triu(Mf, 1).transpose(-1, -2)
    ez = torch.tensor([0.0, 0.0, GRAVITY], dtype=dt)
    w_m, wd_m, cdd_m = wv_m[:, :L], dwv_m[:, :L], djv_m[:, :L]
    F = mk * (cdd_m + ez)
    Tq = _mv(Iw_m, wd_m) + _cross(w_m, _mv(Iw_m, w_m))
    h = ((Jl * F[:, :, None]).sum(-1) + (Ja * Tq[:, :, None]).sum(-1)).sum(1)
    w_d, wd_d, cdd_d = wv_d[:, :L], dwv_d[:, :L], djv_d[:, :L]
    f = u_des[:, :NF].reshape(Bn, NC, 3)
    parts_l = -(mk * cdd_d).sum(1) + f.sum(1)
    parts_a = -(_mv(Iw_d, wd_d) + _cross(w_d, _mv(Iw_d, w_d))
                + mk * _cross(comd - pcom[:, None], cdd_d)).sum(1) \
        + _cross(x_d[:, L:] - pcom[:, None], f).sum(1)
    rl = parts_l - m * ez
    x2a = _mv(iGE, parts_a)
    acc_b = torch.cat([inv_m * (rl - _mv(A12, x2a)), _mv(E_d, x2a) + _mv(sd["Ed"], vb[:, 3:6])],
                      -1)
    vel_b = torch.cat([vb[:, 0:3], _mv(E_d, vb[:, 3:6])], -1)
    # the measured base's angular dJ/dt v
    anc0 = C["anc"][0]
    dJbv = _mv(sm["Ed"], v[:, 3:6]) + (
        _cross(om[:, list(C["parent"])], aw) * anc0[None, :, None] * v[:, 6:, None]).sum(1)
    # 4. the rows
    walk = torch.where(stance, 0.0, 1.0).to(dt)
    w_sw, w_base, w_cf = (torch.sqrt(t) for t in (params.weight_swing, params.weight_base_accel,
                                                  params.weight_contact_force))
    wsw_rows = (walk[:, None] * ((1.0 - flags) * w_sw)).repeat_interleave(3, -1)   # (B, 12)
    wb_walk, wb_st, wcf_walk = walk * w_base, (1.0 - walk) * w_base, walk * w_cf
    weights = torch.cat([wsw_rows, wb_walk[:, None].expand(-1, 6), wcf_walk[:, None].expand(-1, 12),
                         wb_st[:, None].expand(-1, 6)], -1)                         # (B, 36)
    pc_m, pc_d = x_m[:, L:], x_d[:, L:]
    cmd = params.swing_kp * (pc_d - pc_m) + params.swing_kd * (jv_d[:, L:] - jv_m[:, L:])
    b_sw = ((cmd - djv_m[:, L:]).reshape(Bn, NF) * walk[:, None]) * wsw_rows
    b_xy = (acc_b[:, 0:2] * walk[:, None]) * w_base
    b_hz = ((acc_b[:, 2] + params.base_height_kp * (x_des[:, 8] - p[:, 0, 2])
             + params.base_height_kd * (vel_b[:, 2] - v[:, 2])) * walk) * w_base
    Rt = R[:, 0].transpose(-1, -2) @ Rd[:, 0]
    err = _mv(R[:, 0], _log3(Rt))
    b_ang = (((acc_b[:, 3:6] + params.base_angular_kp * err)
              + params.base_angular_kd * (vel_b[:, 3:6] - om[:, 0])) - dJbv) \
        * walk[:, None] * w_base
    b_cf = (u_des[:, :NF] * walk[:, None]) * w_cf
    b_st = 0.0 * wb_st[:, None].expand(-1, 6)
    rb = torch.cat([b_sw, b_xy, b_hz[:, None], b_ang, b_cf, b_st], -1)
    ang_rows = torch.cat([torch.zeros((Bn, 3, 3), dtype=dt), E_m,
                          (aw * anc0[None, :, None]).transpose(-1, -2)], -1)
    D = torch.cat([Jc * wsw_rows[..., None], ang_rows * wb_walk[:, None, None]], 1)  # (B, 15, 16)
    # 5. the poison terms, H, g
    pw = (0.0 * weights).sum(-1)
    pcol = torch.cat([pw[:, None] + (0.0 * D).sum(1), pw[:, None].expand(-1, NDEC - NQ)], -1)
    pb = (0.0 * rb).sum(-1)
    unit = torch.zeros((Bn, NDEC), dtype=dt)
    unit[:, 0:3] = (wb_walk * wb_walk)[:, None]
    unit[:, 0:6] = unit[:, 0:6] + (wb_st * wb_st)[:, None]
    unit[:, NQ:NQ + NF] = (wcf_walk * wcf_walk)[:, None]
    H = torch.zeros((Bn, NDEC, NDEC), dtype=dt)
    H[:, :NQ, :NQ] = D.transpose(-1, -2) @ D
    H = H + torch.diag_embed(unit + 1e-6) + pcol[:, :, None] + pcol[:, None, :]
    b_d = torch.cat([b_sw, b_ang], -1)
    gq = torch.zeros((Bn, NDEC), dtype=dt)
    gq[:, :NQ] = _mv(D.transpose(-1, -2), b_d)
    gq[:, 0:2] += wb_walk[:, None] * b_xy
    gq[:, 2] += wb_walk * b_hz
    gq[:, 0:6] += wb_st[:, None] * b_st
    gq[:, NQ:NQ + NF] = wcf_walk[:, None] * b_cf
    g = -((gq + pcol) + pb[:, None])
    # 6. the constraint rows
    Aeq = torch.zeros((Bn, NQ + NF, NDEC), dtype=dt)
    Aeq[:, :NQ, :NQ] = M
    Aeq[:, :NQ, NQ:NQ + NF] = -Jc.transpose(-1, -2)
    Aeq[:, 6:NQ, NQ + NF:] = -torch.eye(NJ, dtype=dt)
    Aeq[:, NQ:, NQ:NQ + NF] = torch.diag_embed((1.0 - flags).repeat_interleave(3, -1))
    beq = torch.cat([-h, torch.zeros((Bn, NF), dtype=dt)], -1)
    Ain = torch.zeros((Bn, 2 * NJ + 5 * NC, NDEC), dtype=dt)
    Ain[:, :NJ, NQ + NF:] = torch.eye(NJ, dtype=dt)
    Ain[:, NJ:2 * NJ, NQ + NF:] = -torch.eye(NJ, dtype=dt)
    mu = params.friction_coeff
    one, zero = torch.ones_like(mu), torch.zeros_like(mu)
    pyr = torch.stack([torch.stack(r) for r in ((zero, zero, -one), (one, zero, -mu),
                                                (-one, zero, -mu), (zero, one, -mu),
                                                (zero, -one, -mu))])
    for f_ in range(NC):
        Ain[:, 2 * NJ + 5 * f_:2 * NJ + 5 * f_ + 5, NQ + 3 * f_:NQ + 3 * f_ + 3] = \
            pyr * flags[:, f_, None, None]
    tl = params.torque_limits
    bin_ = torch.cat([tl.repeat(4)[None].expand(Bn, -1), torch.zeros((Bn, 5 * NC), dtype=dt)], -1)
    return H, g, Aeq, beq, Ain, bin_


@pytest.mark.parametrize("stance", list(STANCE))
def test_kernel_order_matches_jax(states, jax_data, stance):
    ref = jax_data(stance, jnp.float64)
    got = kernel_order(*port_args(states, stance, torch.float64))
    for name, a, b in zip(NAMES, got, ref):
        assert torch.isfinite(a).all(), name
        assert scaled_err(a, b) < TOL[torch.float64], name


# (argument of wbc_qp, column or gain field) of the non-finite value: the
# measurement's base position, a joint and a joint velocity; the desired
# momentum and a desired joint; a contact force and a joint velocity of
# u_des; a flag; a weight and a gain
NONFINITE_CASES = {"rbd_base_pos": (4, 3), "rbd_joint": (4, 8), "rbd_joint_vel": (4, 25),
                   "x_des_momentum": (2, 4), "x_des_joint": (2, 14), "u_des_force": (3, 7),
                   "u_des_joint_vel": (3, 15), "flag": (5, 1), "weight_swing": (1, "weight_swing"),
                   "swing_kd": (1, "swing_kd")}


@pytest.mark.parametrize("value", [float("nan"), float("inf")], ids=["nan", "inf"])
@pytest.mark.parametrize("case", list(NONFINITE_CASES))
def test_kernel_order_nonfinite_where_plain(states, case, value):
    """A NaN (an Inf) in one scenario's input, or in a gain, puts NaN (a
    non-finite value) at the entries of H and g where the dense product of
    ``wbc_qp_plain`` puts it, and NaN in the same rows of Aeq, beq, Ain and
    bin; the other scenarios stay finite."""
    arg, where = NONFINITE_CASES[case]
    args = list(port_args(states, "mixed", torch.float64))
    if arg == 1:
        args[1] = args[1]._replace(**{where: torch.tensor(value, dtype=torch.float64)})
    else:
        args[arg] = args[arg].clone()
        args[arg][1, where] = value
    got, ref = kernel_order(*args), twbc.wbc_qp_plain(*args)
    bad = torch.isnan if value != value else (lambda t: ~torch.isfinite(t))
    for name, a, b in zip(NAMES[:2], got[:2], ref[:2]):
        assert torch.equal(bad(a), bad(b)), name
    for name, a, b in zip(NAMES[2:], got[2:], ref[2:]):
        rows = (lambda t: torch.isnan(t).any(-1)) if a.dim() == 3 else torch.isnan
        assert torch.equal(rows(a), rows(b)), name
    assert any(bad(a).any() for a in got)
    if arg != 1:
        for name, a in zip(NAMES, got):
            assert torch.isfinite(a[[0, 2]]).all(), name


def test_params_buffer_kept_and_rebuilt():
    """One gains buffer per WbcParams: the same tensor again, a new one
    after a gain changes in place (its version counter) and for a WbcParams
    with a tensor replaced."""
    params = twbc.default_wbc_params("cpu")
    first = twbc.params_buffer(params)
    assert twbc.params_buffer(params) is first
    params.swing_kd.mul_(2.0)
    second = twbc.params_buffer(params)
    assert second is not first and second[twbc.GAIN_FIELDS.index("swing_kd") + 4] == 36.0
    other = params._replace(friction_coeff=torch.tensor(0.5))
    assert twbc.params_buffer(other)[5] == 0.5 and twbc.params_buffer(params)[5] == 0.7
    assert twbc.params_buffer(params) is second


@pytest.mark.parametrize("batch", [1, 3])
def test_qp_buffers_aligned_views(batch):
    """The six outputs: contiguous views of one buffer, each at a multiple of
    16 bytes from its start, in order and not overlapping."""
    outs = twbc.qp_buffers(batch, "cpu")
    base = outs[0].untyped_storage().data_ptr()
    end = base
    for t, shape in zip(outs, twbc.OUT_SHAPES):
        assert t.is_contiguous() and tuple(t.shape) == (batch, *shape)
        assert t.untyped_storage().data_ptr() == base
        off = t.data_ptr() - base
        assert off % 16 == 0 and t.data_ptr() >= end
        end = t.data_ptr() + 4 * t.numel()
