"""Scalarized structure-of-arrays (SoA) kinematics/dynamics core.

Port of ``hunter_bipedal_control_tpu/models/soa.py``: the FK / CMM /
constraint-row chain and its closed-form linearization with EVERY SCALAR AS
ITS OWN TENSOR of the batch shape (scenario x knot); vectors and matrices
are Python lists of such scalars.  Model constants are Python floats, so
exact 0.0 / +-1.0 constants fold away before any tensor op is issued (the
same skipping that keeps the JAX graph small keeps the CPU op count down).

This module is the plain version of kernel B1 (``csrc/soa_linearize.cu``,
wrapped by ``ocp/soa_kernel.py``): the CPU runs it, the card launches the
kernel.  Semantics are those of the dense forms (``ocp/problem.py``),
oracle-tested against them and against the JAX package
(tests/test_torch_soa.py).
"""
from __future__ import annotations

import hashlib
import weakref
from typing import NamedTuple

import numpy as np
import torch

from .robot import GRAVITY, RobotModel

# ---------------------------------------------------------------------------
# mini constant-folding algebra: entries are Python floats (constants) or
# tensors; exact 0.0/+-1.0 constants fold away
# ---------------------------------------------------------------------------


def _isf(a):
    return isinstance(a, float)


def mul(a, b):
    if _isf(a) and _isf(b):
        return a * b
    if (_isf(a) and a == 0.0) or (_isf(b) and b == 0.0):
        return 0.0
    if _isf(a) and a == 1.0:
        return b
    if _isf(b) and b == 1.0:
        return a
    if _isf(a) and a == -1.0:
        return -b
    if _isf(b) and b == -1.0:
        return -a
    return a * b


def add(*terms):
    live = [t for t in terms if not (_isf(t) and t == 0.0)]
    if not live:
        return 0.0
    out = live[0]
    for t in live[1:]:
        out = out + t
    return out


def sub(a, b):
    if _isf(b) and b == 0.0:
        return a
    if _isf(a) and a == 0.0:
        return -b
    return a - b


# vec3 = [x, y, z]; mat3 = [[a,b,c],[d,e,f],[g,h,i]] of scalars


def vadd(*vs):
    return [add(*[v[i] for v in vs]) for i in range(3)]


def vsub(a, b):
    return [sub(a[i], b[i]) for i in range(3)]


def vscale(s, v):
    return [mul(s, v[i]) for i in range(3)]


def vaxpy(s, x, y):
    """y + s*x"""
    return [add(y[i], mul(s, x[i])) for i in range(3)]


def vdot(a, b):
    return add(*[mul(a[i], b[i]) for i in range(3)])


def vcross(a, b):
    return [
        sub(mul(a[1], b[2]), mul(a[2], b[1])),
        sub(mul(a[2], b[0]), mul(a[0], b[2])),
        sub(mul(a[0], b[1]), mul(a[1], b[0])),
    ]


def mv(M, v):
    return [add(*[mul(M[i][j], v[j]) for j in range(3)]) for i in range(3)]


def mTv(M, v):
    return [add(*[mul(M[j][i], v[j]) for j in range(3)]) for i in range(3)]


def mm(A, B):
    return [
        [add(*[mul(A[i][k], B[k][j]) for k in range(3)]) for j in range(3)]
        for i in range(3)
    ]


def mmT(A, B):
    """A @ B^T"""
    return [
        [add(*[mul(A[i][k], B[j][k]) for k in range(3)]) for j in range(3)]
        for i in range(3)
    ]


def madd(*Ms):
    return [[add(*[M[i][j] for M in Ms]) for j in range(3)] for i in range(3)]


def mscale(s, M):
    return [[mul(s, M[i][j]) for j in range(3)] for i in range(3)]


def outer(a, b):
    return [[mul(a[i], b[j]) for j in range(3)] for i in range(3)]


def trace(M):
    return add(M[0][0], M[1][1], M[2][2])


def inv3(M):
    """Closed-form 3x3 inverse via adjugate (no guard: a singular M gives
    inf/NaN, as in the JAX package)."""
    c00 = sub(mul(M[1][1], M[2][2]), mul(M[1][2], M[2][1]))
    c01 = sub(mul(M[1][2], M[2][0]), mul(M[1][0], M[2][2]))
    c02 = sub(mul(M[1][0], M[2][1]), mul(M[1][1], M[2][0]))
    det = add(mul(M[0][0], c00), mul(M[0][1], c01), mul(M[0][2], c02))
    inv_det = 1.0 / det
    c10 = sub(mul(M[0][2], M[2][1]), mul(M[0][1], M[2][2]))
    c11 = sub(mul(M[0][0], M[2][2]), mul(M[0][2], M[2][0]))
    c12 = sub(mul(M[0][1], M[2][0]), mul(M[0][0], M[2][1]))
    c20 = sub(mul(M[0][1], M[1][2]), mul(M[0][2], M[1][1]))
    c21 = sub(mul(M[0][2], M[1][0]), mul(M[0][0], M[1][2]))
    c22 = sub(mul(M[0][0], M[1][1]), mul(M[0][1], M[1][0]))
    adj = [[c00, c10, c20], [c01, c11, c21], [c02, c12, c22]]
    return [[mul(inv_det, adj[i][j]) for j in range(3)] for i in range(3)]


# ---------------------------------------------------------------------------
# model constants, extracted once to Python floats
# ---------------------------------------------------------------------------


class SoaConsts(NamedTuple):
    nj: int
    n_links: int
    nc: int
    parent: tuple            # (nj,) parent link of joint j
    child: tuple             # (nj,) child link
    origin_pos: tuple        # (nj,) vec3 float
    origin_rot: tuple        # (nj,) mat3 float
    axis: tuple              # (nj,) vec3 float (child-frame)
    rod_K: tuple             # (nj,) mat3 float  skew(axis)
    rod_KK: tuple            # (nj,) mat3 float  skew(axis)^2
    com_local: tuple         # (L,) vec3 float
    mass: tuple              # (L,) float
    inertia: tuple           # (L,) mat3 float (about CoM, link axes)
    total_mass: float
    contact_parent: tuple    # (nc,) parent link of contact frame
    contact_pos: tuple       # (nc,) vec3 float (parent-frame offset)
    joints_of_link: tuple    # (L,) tuple of ancestor joint ids (ordered)
    subtree_links: tuple     # (nj,) tuple of link ids moved by joint j


_CONSTS_CACHE: dict = {}
# model identity -> (weakrefs of its tensors, their versions, fingerprint):
# a repeat call with the same tensors skips the content hash, whose reads
# would each copy (and on the card, synchronize) every model array
_IDENTITY_CACHE: dict = {}

_INDEX_ARRAYS = ("joint_parent", "joint_child", "ancestor_mask", "frame_parent",
                 "contact_frame_ids")
_FLOAT_ARRAYS = ("joint_axis", "joint_origin_pos", "joint_origin_rot", "link_com",
                 "link_mass", "link_inertia", "frame_pos", "frame_rot")


def _np(a, dtype=None):
    if torch.is_tensor(a):
        a = a.detach().cpu()
        a = (a.double() if a.is_floating_point() else a).numpy()
    else:
        a = np.asarray(a)
    return a if dtype is None else a.astype(dtype)


def _m3(a):
    return tuple(tuple(float(x) for x in row) for row in np.asarray(a))


def _v3(a):
    return tuple(float(x) for x in np.asarray(a))


def _model_fingerprint(model: RobotModel) -> bytes:
    """Content hash of every array build_consts reads: a stable cache key."""
    tensors = [getattr(model, f) for f in _INDEX_ARRAYS + _FLOAT_ARRAYS]
    key = (model.nj, model.n_links) + tuple(id(t) for t in tensors)
    hit = _IDENTITY_CACHE.get(key)
    if hit is not None:
        refs, versions, digest = hit
        if (all(r() is t for r, t in zip(refs, tensors))
                and versions == tuple(t._version for t in tensors)):
            return digest
    h = hashlib.sha1()
    h.update(np.int64([model.nj, model.n_links]).tobytes())
    for f in _INDEX_ARRAYS:
        a = getattr(model, f)
        # the JAX model keeps ancestor_mask as float64, the port in its dtype
        a = _np(a, np.float64) if f == "ancestor_mask" else _np(a, np.int64)
        h.update(np.ascontiguousarray(a).tobytes())
    for f in _FLOAT_ARRAYS:
        h.update(np.ascontiguousarray(_np(getattr(model, f), np.float64)).tobytes())
    digest = h.digest()
    _IDENTITY_CACHE[key] = (tuple(weakref.ref(t) for t in tensors),
                            tuple(t._version for t in tensors), digest)
    return digest


def build_consts(model: RobotModel) -> SoaConsts:
    key = _model_fingerprint(model)
    if key in _CONSTS_CACHE:
        return _CONSTS_CACHE[key]
    nj, L = model.nj, model.n_links
    anc = _np(model.ancestor_mask)  # (L, nj)
    j_axis = _np(model.joint_axis, np.float64)
    j_opos = _np(model.joint_origin_pos, np.float64)
    j_orot = _np(model.joint_origin_rot, np.float64)
    l_com = _np(model.link_com, np.float64)
    l_mass = _np(model.link_mass, np.float64)
    l_inertia = _np(model.link_inertia, np.float64)
    f_pos = _np(model.frame_pos, np.float64)
    rod_K, rod_KK = [], []
    for j in range(nj):
        a = j_axis[j]
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0.0]])
        rod_K.append(_m3(K))
        rod_KK.append(_m3(K @ K))
    fp = _np(model.frame_parent)
    cids = _np(model.contact_frame_ids)
    # contact frame rotation is identity for the hunter toe/heel frames;
    # keep only the position offset (assert to be safe)
    frot = _np(model.frame_rot, np.float64)[cids]
    assert np.allclose(frot, np.eye(3)[None], atol=1e-12), "non-identity contact frame"
    consts = SoaConsts(
        nj=nj,
        n_links=L,
        nc=int(cids.shape[0]),
        parent=tuple(int(x) for x in _np(model.joint_parent)),
        child=tuple(int(x) for x in _np(model.joint_child)),
        origin_pos=tuple(_v3(j_opos[j]) for j in range(nj)),
        origin_rot=tuple(_m3(j_orot[j]) for j in range(nj)),
        axis=tuple(_v3(j_axis[j]) for j in range(nj)),
        rod_K=tuple(rod_K),
        rod_KK=tuple(rod_KK),
        com_local=tuple(_v3(l_com[k]) for k in range(L)),
        mass=tuple(float(x) for x in l_mass),
        inertia=tuple(_m3(l_inertia[k]) for k in range(L)),
        total_mass=float(_np(model.total_mass, np.float64)),
        contact_parent=tuple(int(fp[c]) for c in cids),
        contact_pos=tuple(_v3(f_pos[c]) for c in cids),
        joints_of_link=tuple(
            tuple(int(j) for j in np.nonzero(anc[k])[0]) for k in range(L)
        ),
        subtree_links=tuple(
            tuple(int(k) for k in np.nonzero(anc[:, j])[0]) for j in range(nj)
        ),
    )
    _CONSTS_CACHE[key] = consts
    return consts


# ---------------------------------------------------------------------------
# forward kinematics (scalarized fk)
# ---------------------------------------------------------------------------


class SoaKin(NamedTuple):
    R: tuple          # (L,) mat3 world_R_link
    p: tuple          # (L,) vec3 link origin
    com: tuple        # (L,) vec3 link CoM world
    axis_w: tuple     # (nj,) vec3 joint axis world
    anchor: tuple     # (nj,) vec3 joint anchor world
    E: tuple          # mat3 euler-rate map (omega = E @ dtheta_zyx)
    cz: object        # trig caches for E/dE consumers
    sz: object
    cy: object
    sy: object


def fk(c: SoaConsts, q):
    """q: list of 6+nj scalars [pos(3), euler zyx(3), joints(nj)]."""
    z, y, x = q[3], q[4], q[5]
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    cx, sx = torch.cos(x), torch.sin(x)
    base_R = [
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
        [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
        [-sy, cy * sx, cy * cx],
    ]
    E = [[0.0, -sz, cz * cy], [0.0, cz, sz * cy], [1.0, 0.0, -sy]]

    R = [None] * c.n_links
    p = [None] * c.n_links
    R[0] = base_R
    p[0] = [q[0], q[1], q[2]]
    axis_w = [None] * c.nj
    anchor = [None] * c.nj
    for j in range(c.nj):
        par, ch = c.parent[j], c.child[j]
        Rp, pp = R[par], p[par]
        C = c.origin_rot[j]
        ident = all(C[i][k] == (1.0 if i == k else 0.0) for i in range(3) for k in range(3))
        R_or = Rp if ident else [
            [add(*[mul(Rp[i][k], C[k][m]) for k in range(3)]) for m in range(3)]
            for i in range(3)
        ]
        p_or = vadd(pp, mv(Rp, list(c.origin_pos[j])))
        aw = mv(R_or, list(c.axis[j]))
        cj, sj = torch.cos(q[6 + j]), torch.sin(q[6 + j])
        u = 1.0 - cj
        K, KK = c.rod_K[j], c.rod_KK[j]
        rod = [
            [
                add(1.0 if i == m else 0.0, mul(sj, K[i][m]), mul(u, KK[i][m]))
                for m in range(3)
            ]
            for i in range(3)
        ]
        R[ch] = mm(R_or, rod)
        p[ch] = p_or
        axis_w[j] = aw
        anchor[j] = p_or

    com = [vadd(p[k], mv(R[k], list(c.com_local[k]))) for k in range(c.n_links)]
    return SoaKin(R=tuple(R), p=tuple(p), com=tuple(com), axis_w=tuple(axis_w),
                  anchor=tuple(anchor), E=E, cz=cz, sz=sz, cy=cy, sy=sy)


def contact_points(c: SoaConsts, kin: SoaKin):
    """(nc,) vec3 world contact positions (toe/heel frames)."""
    return [
        vadd(kin.p[c.contact_parent[i]],
             mv(kin.R[c.contact_parent[i]], list(c.contact_pos[i])))
        for i in range(c.nc)
    ]


def com_position(c: SoaConsts, kin: SoaKin):
    acc = [0.0, 0.0, 0.0]
    for k in range(c.n_links):
        acc = vaxpy(c.mass[k], kin.com[k], acc)
    return vscale(1.0 / c.total_mass, acc)


def world_inertias(c: SoaConsts, kin: SoaKin):
    """(L,) mat3  I_k^w = R_k I_k R_k^T."""
    out = []
    for k in range(c.n_links):
        RI = [
            [add(*[mul(kin.R[k][i][a], c.inertia[k][a][m]) for a in range(3)])
             for m in range(3)]
            for i in range(3)
        ]
        out.append(mmT(RI, kin.R[k]))
    return out


# ---------------------------------------------------------------------------
# centroidal momentum: base block Ab and joint momentum Aj @ vj
# ---------------------------------------------------------------------------


def base_momentum_block(c: SoaConsts, kin: SoaKin, p_com, Iw):
    """Ab (6x6 scalars): h = Ab v_b for pure base motion.

    A_lin = [m I | -m skew(p_com - p_b) E]
    A_ang = [ 0  | G E],  G = I_tot + tr(W) I - W,
    W = sum_k m_k (c_k - p_b) (c_k - p_com)^T.
    """
    m = c.total_mass
    pb = kin.p[0]
    Itot = [[0.0] * 3 for _ in range(3)]
    W = [[0.0] * 3 for _ in range(3)]
    for k in range(c.n_links):
        d = vsub(kin.com[k], pb)
        r = vsub(kin.com[k], p_com)
        for i in range(3):
            for j in range(3):
                Itot[i][j] = add(Itot[i][j], Iw[k][i][j])
                W[i][j] = add(W[i][j], mul(c.mass[k], mul(d[i], r[j])))
    trW = trace(W)
    G = [[sub(add(Itot[i][j], trW if i == j else 0.0), W[i][j]) for j in range(3)]
         for i in range(3)]
    GE = mm(G, kin.E)
    # -m * skew(p_com - p_b) @ E
    s = vsub(p_com, pb)
    skew_s = [[0.0, -s[2], s[1]],
              [s[2], 0.0, -s[0]],
              [-s[1], s[0], 0.0]]
    A12 = mscale(-m, mm(skew_s, kin.E))
    return A12, GE  # A_lin translational block is m*I, A_ang translational 0


def joint_momentum(c: SoaConsts, kin: SoaKin, Iw, p_com, vj):
    """h_j = A_j @ v_j via a base-fixed velocity pass (no Aj assembly)."""
    L = c.n_links
    om = [[0.0, 0.0, 0.0] for _ in range(L)]
    vo = [[0.0, 0.0, 0.0] for _ in range(L)]
    for j in range(c.nj):
        par, ch = c.parent[j], c.child[j]
        dp = vsub(kin.anchor[j], kin.p[par])
        vo[ch] = vadd(vo[par], vcross(om[par], dp))
        om[ch] = vaxpy(vj[j], kin.axis_w[j], om[par])
    h_lin = [0.0, 0.0, 0.0]
    h_ang = [0.0, 0.0, 0.0]
    for k in range(L):
        cdot = vadd(vo[k], vcross(om[k], vsub(kin.com[k], kin.p[k])))
        h_lin = vaxpy(c.mass[k], cdot, h_lin)
        r = vsub(kin.com[k], p_com)
        h_ang = vadd(h_ang, mv(Iw[k], om[k]), vscale(c.mass[k], vcross(r, cdot)))
    return h_lin, h_ang, om, vo


def solve_base_velocity(c: SoaConsts, A12, GE, rhs_lin, rhs_ang):
    """Ab v_b = rhs with Ab = [[m I, A12], [0, GE]] block upper-triangular."""
    x2 = mv(inv3(GE), rhs_ang)
    x1 = vscale(1.0 / c.total_mass, vsub(rhs_lin, mv(A12, x2)))
    return x1, x2  # (dp_base, dtheta_zyx)


def base_velocity_from_momentum(c: SoaConsts, kin: SoaKin, h, vj,
                                p_com=None, Iw=None):
    """vb solving Ab vb = m h - Aj vj.
    Returns (vb_lin, theta_dot, om (per-link joint-only), vo, p_com, Iw)."""
    p_com = p_com or com_position(c, kin)
    Iw = Iw or world_inertias(c, kin)
    hj_lin, hj_ang, om_j, vo_j = joint_momentum(c, kin, Iw, p_com, vj)
    m = c.total_mass
    rhs_lin = [sub(mul(m, h[i]), hj_lin[i]) for i in range(3)]
    rhs_ang = [sub(mul(m, h[i + 3]), hj_ang[i]) for i in range(3)]
    A12, GE = base_momentum_block(c, kin, p_com, Iw)
    vb_lin, th_dot = solve_base_velocity(c, A12, GE, rhs_lin, rhs_ang)
    return vb_lin, th_dot, om_j, vo_j, p_com, Iw


def full_velocity_pass(c: SoaConsts, kin: SoaKin, vb_lin, th_dot, vj):
    """Per-link world angular velocity and origin velocity for the full
    generalized velocity [vb; vj] (v == q_dot in the euler parameterization)."""
    L = c.n_links
    om_b = mv(kin.E, th_dot)
    om = [None] * L
    vo = [None] * L
    om[0] = om_b
    vo[0] = vb_lin
    for j in range(c.nj):
        par, ch = c.parent[j], c.child[j]
        dp = vsub(kin.anchor[j], kin.p[par])
        vo[ch] = vadd(vo[par], vcross(om[par], dp))
        om[ch] = vaxpy(vj[j], kin.axis_w[j], om[par])
    return om, vo


def contact_velocities(c: SoaConsts, kin: SoaKin, p_c, om, vo):
    """(nc,) vec3 world contact-point velocities from the velocity pass."""
    out = []
    for i in range(c.nc):
        k = c.contact_parent[i]
        out.append(vadd(vo[k], vcross(om[k], vsub(p_c[i], kin.p[k]))))
    return out


# ---------------------------------------------------------------------------
# flow map (centroidal.flow_map), scalarized
# ---------------------------------------------------------------------------


def flow(c: SoaConsts, x, u):
    """x, u: lists of scalars.  Returns list of nx scalars [hdot(6); vb(6);
    vj(nj)]."""
    q = x[6:]
    kin = fk(c, q)
    h = x[0:6]
    vj = u[3 * c.nc:]
    vb_lin, th_dot, _, _, p_com, _ = base_velocity_from_momentum(c, kin, h, vj)
    p_c = contact_points(c, kin)
    m = c.total_mass
    f = [[u[3 * i], u[3 * i + 1], u[3 * i + 2]] for i in range(c.nc)]
    fsum = vadd(*f)
    hdot_lin = [mul(1.0 / m, fsum[0]), mul(1.0 / m, fsum[1]),
                add(mul(1.0 / m, fsum[2]), -GRAVITY)]
    ha = [0.0, 0.0, 0.0]
    for i in range(c.nc):
        ha = vadd(ha, vcross(vsub(p_c[i], p_com), f[i]))
    hdot_ang = vscale(1.0 / m, ha)
    return hdot_lin + hdot_ang + vb_lin + th_dot + list(vj)


# ---------------------------------------------------------------------------
# combined rows (ocp.problem.combined_rows), scalarized primal
# ---------------------------------------------------------------------------


class SoaRows(NamedTuple):
    flow: list       # nx scalars
    g_masked: list   # 16 scalars (eq rows * mask)
    eq_mask: list    # 16 scalars
    soft: list       # 4 + 2*nc + 2*nj + nc scalars
    kin: SoaKin
    p_c: list
    p_com: list
    v_c: list
    om: list
    vo: list
    Iw: list
    vb: list         # 6 scalars


def combined_rows(c: SoaConsts, pf, x, u, flags, fpr, fvr):
    """pf: dict of float OCP gains {xy_gain, z_ref, pos_gain, mu_c,
    cone_reg}.  flags: (nc,) scalars; fpr/fvr: (nc,) vec3 scalars."""
    nj, nc = c.nj, c.nc
    q = x[6:]
    kin = fk(c, q)
    h = x[0:6]
    vj = u[3 * nc:]
    vb_lin, th_dot, _, _, p_com, Iw = base_velocity_from_momentum(c, kin, h, vj)
    om, vo = full_velocity_pass(c, kin, vb_lin, th_dot, vj)
    p_c = contact_points(c, kin)
    v_c = contact_velocities(c, kin, p_c, om, vo)
    f = [[u[3 * i], u[3 * i + 1], u[3 * i + 2]] for i in range(nc)]

    m = c.total_mass
    fsum = vadd(*f)
    hdot_lin = [mul(1.0 / m, fsum[0]), mul(1.0 / m, fsum[1]),
                add(mul(1.0 / m, fsum[2]), -GRAVITY)]
    ha = [0.0, 0.0, 0.0]
    for i in range(nc):
        ha = vadd(ha, vcross(vsub(p_c[i], p_com), f[i]))
    hdot_ang = vscale(1.0 / m, ha)
    flow_rows = hdot_lin + hdot_ang + vb_lin + th_dot + list(vj)

    # equality rows (4 per foot) and masks
    g_rows, mask_rows = [], []
    for i in range(nc):
        stance = flags[i] > 0.5
        zv_z = add(v_c[i][2], mul(pf["xy_gain"], sub(p_c[i][2], pf["z_ref"])))
        zv = [v_c[i][0], v_c[i][1], zv_z]
        for a in range(3):
            g_rows.append(torch.where(stance, zv[a], f[i][a]))
            mask_rows.append(torch.ones_like(zv_z))
        nv = add(sub(v_c[i][2], fvr[i][2]),
                 mul(pf["pos_gain"], sub(p_c[i][2], fpr[i][2])))
        g_rows.append(torch.where(stance, torch.zeros_like(nv), nv))
        mask_rows.append(torch.where(stance, torch.zeros_like(nv), torch.ones_like(nv)))

    # soft rows: cone(nc), xy(2nc), qj(nj), vj(nj), fz(nc)
    soft = []
    for i in range(nc):
        s = torch.sqrt(f[i][0] ** 2 + f[i][1] ** 2 + pf["cone_reg"])
        soft.append(sub(mul(pf["mu_c"], f[i][2]), s))
    for i in range(nc):
        for a in range(2):
            soft.append(add(sub(v_c[i][a], fvr[i][a]),
                            mul(pf["xy_gain"], sub(p_c[i][a], fpr[i][a]))))
    soft += list(x[12:12 + nj])
    soft += list(vj)
    soft += [f[i][2] for i in range(nc)]

    return SoaRows(flow=flow_rows, g_masked=g_rows, eq_mask=mask_rows,
                   soft=soft, kin=kin, p_c=p_c, p_com=p_com, v_c=v_c,
                   om=om, vo=vo, Iw=Iw, vb=vb_lin + th_dot)


def _cols(arr):
    """(..., n) tensor -> list of n (...,)-scalars."""
    return [arr[..., i] for i in range(arr.shape[-1])]


def _stack(scalars, like):
    """list of scalars (floats or tensors) -> (..., n) tensor."""
    b = torch.broadcast_tensors(*[torch.full_like(like, s) if _isf(s) else s
                                  for s in scalars])
    return torch.stack(b, dim=-1)


def params_floats(params) -> dict:
    """Static gain dict from OcpParams (floats -> constant folding)."""
    return {
        "xy_gain": float(params.xy_position_gain),
        "z_ref": float(params.stance_z_ref),
        "pos_gain": float(params.position_error_gain),
        "mu_c": float(params.friction_coeff),
        "cone_reg": float(params.cone_regularization),
    }


def combined_rows_arrays(model: RobotModel, params, x, u, flags, fpr, fvr):
    """Tensor-in/tensor-out wrapper matching ocp.problem.combined_rows:
    x (..., nx), u (..., nu), flags (..., nc), fpr/fvr (..., nc, 3)
    -> (flow (..., nx), g_masked (..., 16), eq_mask (..., 16), soft (..., ns))."""
    c = build_consts(model)
    pf = params_floats(params)
    rows = combined_rows(
        c, pf, _cols(x), _cols(u), _cols(flags),
        [_cols(fpr[..., i, :]) for i in range(c.nc)],
        [_cols(fvr[..., i, :]) for i in range(c.nc)],
    )
    like = x[..., 0]
    g = _stack(rows.g_masked, like) * _stack(rows.eq_mask, like)
    return (_stack(rows.flow, like), g, _stack(rows.eq_mask, like),
            _stack(rows.soft, like))


def flow_arrays(model: RobotModel, x, u):
    """Tensor wrapper for the flow map alone (RK2 midpoint evaluations)."""
    c = build_consts(model)
    like = x[..., 0]
    return _stack(flow(c, _cols(x), _cols(u)), like)


# ---------------------------------------------------------------------------
# linearization ingredients (scalarized closed forms; oracle =
# ocp.problem.knot_linearization_fused, see the JAX package for the
# derivation: the mixed-partial symmetry gives D_q[J_lin v] as the time
# derivative of the Jacobian along the primal velocity, and the
# angular-momentum block D_q[A_ang v] factors per column via BAC-CAB into
# subtree-accumulated 3x3 moments)
# ---------------------------------------------------------------------------


def _subtree_sums(c: SoaConsts, kin: SoaKin, cdot):
    """Per-joint subtree accumulators over links k in subtree(j):
        M_j   = sum m_k                (float)
        S_j   = sum m_k c_k            (vec3)
        sd_j  = sum m_k cdot_k         (vec3)
        Q_j   = sum m_k c_k c_k^T      (mat3)
        Y_j   = sum m_k c_k cdot_k^T   (mat3)
    """
    M, S, sd, Q, Y = [], [], [], [], []
    for j in range(c.nj):
        links = c.subtree_links[j]
        Mj = float(sum(c.mass[k] for k in links))
        Sj, sdj = [0.0] * 3, [0.0] * 3
        Qj = [[0.0] * 3 for _ in range(3)]
        Yj = [[0.0] * 3 for _ in range(3)]
        for k in links:
            mk = c.mass[k]
            Sj = vaxpy(mk, kin.com[k], Sj)
            sdj = vaxpy(mk, cdot[k], sdj)
            for a in range(3):
                for b in range(3):
                    Qj[a][b] = add(Qj[a][b], mul(mk, mul(kin.com[k][a], kin.com[k][b])))
                    Yj[a][b] = add(Yj[a][b], mul(mk, mul(kin.com[k][a], cdot[k][b])))
        M.append(Mj)
        S.append(Sj)
        sd.append(sdj)
        Q.append(Qj)
        Y.append(Yj)
    return M, S, sd, Q, Y


def _ang_col(Isub, Hsub, W, Y, sd, S, Mj, pcom, vcom_m, inv_m, a, adot, o, odot, om_lo):
    """One angular column of [A_ang | D_q[A_ang v]] (primal, dual):
    primal = (Isub + tr(W) I - W) a
    dual   = a x Hsub - Isub (a x om_lo)
             + G a - a tr(G) - kappa x (m vcom)
             + adot tr(W) - W adot + a tr(V) - V a
    with G = Y - o sd^T, V = Y^T - sd pcom^T - odot (S - Mj pcom)^T,
    kappa = (a x (S - Mj o)) / m_total.
    """
    trW = trace(W)
    prim = [add(mv(Isub, a)[i], mul(trW, a[i]), -mv(W, a)[i]) for i in range(3)]

    G = [[sub(Y[i][j], mul(o[i], sd[j])) for j in range(3)] for i in range(3)]
    r_sum = [sub(S[i], mul(Mj, pcom[i])) for i in range(3)]
    V = [[sub(sub(Y[j][i], mul(sd[i], pcom[j])), mul(odot[i], r_sum[j]))
          for j in range(3)] for i in range(3)]
    kx = vcross(a, vsub(S, vscale(Mj, o)))
    dual = vadd(
        vcross(a, Hsub),
        vscale(-1.0, mv(Isub, vcross(a, om_lo))),
        vsub(mv(G, a), vscale(trace(G), a)),
        vscale(-inv_m, vcross(kx, vcom_m)),
        vsub(vscale(trW, adot), mv(W, adot)),
        vsub(vscale(trace(V), a), mv(V, a)),
    )
    return prim, dual


class SoaLin(NamedTuple):
    Aj_cols: list     # (nj,) of (lin vec3, ang vec3) primal CMM joint columns
    dA_cols: list     # (nq,) of (lin vec3, ang vec3): D_q[A v] columns
    Jc: list          # (nc,) list of (nq,) vec3 columns (linear rows only)
    Jcdot: list       # (nc,) list of (nq,) vec3 columns: d/dt Jc along v
    A12: list         # mat3
    GE: list          # mat3


def linearization_ingredients(c: SoaConsts, rows: SoaRows, x, u):
    """Everything knot linearization needs beyond the primal rows.

    Column index convention: nq = 6 + nj generalized coords
    [base pos(3) | euler(3) | joints(nj)].
    """
    nj, nc = c.nj, c.nc
    kin = rows.kin
    p_com = rows.p_com
    Iw = rows.Iw
    om, vo = rows.om, rows.vo
    m = c.total_mass
    pb, vb_lin = kin.p[0], rows.vb[0:3]
    th_dot = rows.vb[3:6]
    om_b = om[0]

    cdot = [vadd(vo[k], vcross(om[k], vsub(kin.com[k], kin.p[k])))
            for k in range(c.n_links)]
    vcom_m = [0.0, 0.0, 0.0]
    for k in range(c.n_links):
        vcom_m = vaxpy(c.mass[k], cdot[k], vcom_m)   # m * v_com
    hk = [mv(Iw[k], om[k]) for k in range(c.n_links)]

    M, S, sd, Q, Y = _subtree_sums(c, kin, cdot)
    Isub, Hsub = [], []
    for j in range(c.nj):
        Is = [[0.0] * 3 for _ in range(3)]
        Hs = [0.0] * 3
        for k in c.subtree_links[j]:
            Hs = vadd(Hs, hk[k])
            for a in range(3):
                for b in range(3):
                    Is[a][b] = add(Is[a][b], Iw[k][a][b])
        Isub.append(Is)
        Hsub.append(Hs)
    Itot = [[add(*[Iw[k][a][b] for k in range(c.n_links)]) for b in range(3)]
            for a in range(3)]
    Htot = [add(*[hk[k][i] for k in range(c.n_links)]) for i in range(3)]
    Q_all = [[add(*[mul(c.mass[k], mul(kin.com[k][a], kin.com[k][b]))
                    for k in range(c.n_links)]) for b in range(3)] for a in range(3)]
    Y_all = [[add(*[mul(c.mass[k], mul(kin.com[k][a], cdot[k][b]))
                    for k in range(c.n_links)]) for b in range(3)] for a in range(3)]
    S_all = vscale(m, p_com)
    sd_all = vcom_m

    # W_j = Q_j - S_j pcom^T - o_j (S_j - M_j pcom)^T
    def _W(Qj, Sj, Mj, o):
        rs = [sub(Sj[i], mul(Mj, p_com[i])) for i in range(3)]
        return [[sub(sub(Qj[i][j], mul(Sj[i], p_com[j])), mul(o[i], rs[j]))
                 for j in range(3)] for i in range(3)]

    # dual kinematics of axes / anchors and the euler-rate map
    adot = [vcross(om[c.parent[j]], kin.axis_w[j]) for j in range(nj)]
    odot = [vo[c.child[j]] for j in range(nj)]
    # E and Edot columns
    zd, yd = th_dot[0], th_dot[1]
    cz, sz, cy, sy = kin.cz, kin.sz, kin.cy, kin.sy
    E_cols = [[0.0, 0.0, 1.0],
              [-sz, cz, 0.0],
              [cz * cy, sz * cy, -sy]]
    Ed_cols = [[0.0, 0.0, 0.0],
               [-cz * zd, -sz * zd, 0.0],
               [-sz * zd * cy - cz * sy * yd, cz * zd * cy - sz * sy * yd,
                -cy * yd]]
    # dE_i @ th_dot: columns of dE/dtheta_i applied to th_dot
    # (i = 0: z, 1: y, 2: x -> zero)
    dE_z_v = [add(mul(-cz, th_dot[1]), mul(-sz * cy, th_dot[2])),
              add(mul(-sz, th_dot[1]), mul(cz * cy, th_dot[2])),
              0.0]
    dE_y_v = [mul(-cz * sy, th_dot[2]),
              mul(-sz * sy, th_dot[2]),
              mul(-cy, th_dot[2])]
    dE_x_v = [0.0, 0.0, 0.0]
    dE_v = [dE_z_v, dE_y_v, dE_x_v]

    # ---- CMM joint columns + D_q[A v] columns ----
    Aj_cols = []
    dA_cols = [None] * (6 + nj)
    # base position columns: A cols = [m e_i; 0] (not emitted), dAv = 0
    for i in range(3):
        dA_cols[i] = ([0.0] * 3, [0.0] * 3)
    # euler columns
    W_b = _W(Q_all, S_all, m, pb)
    for i in range(3):
        Ei, Edi = E_cols[i], Ed_cols[i]
        prim, dual = _ang_col(Itot, Htot, W_b, Y_all, sd_all, S_all, m,
                              p_com, vcom_m, 1.0 / m, Ei, Edi, pb, vb_lin, om_b)
        # extra euler term: Itot @ (dE_i th_dot) in the omega derivative
        dual = vadd(dual, mv(Itot, dE_v[i]))
        lin_d = vscale(m, vadd(vcross(Edi, vsub(p_com, pb)),
                               vcross(Ei, vsub(vscale(1.0 / m, vcom_m), vb_lin))))
        dA_cols[3 + i] = (lin_d, dual)
        # (primal euler block of A is recomputed by the caller from A12/GE)
    # joint columns
    for j in range(nj):
        aj, adj = kin.axis_w[j], adot[j]
        oj, odj = kin.anchor[j], odot[j]
        Wj = _W(Q[j], S[j], M[j], oj)
        om_lo = om[c.child[j]]
        prim, dual = _ang_col(Isub[j], Hsub[j], Wj, Y[j], sd[j], S[j], M[j],
                              p_com, vcom_m, 1.0 / m, aj, adj, oj, odj, om_lo)
        lin_p = vcross(aj, vsub(S[j], vscale(M[j], oj)))
        lin_d = vadd(vcross(adj, vsub(S[j], vscale(M[j], oj))),
                     vcross(aj, vsub(sd[j], vscale(M[j], odj))))
        Aj_cols.append((lin_p, prim))
        dA_cols[6 + j] = (lin_d, dual)

    # ---- contact Jacobians (linear rows) + their time derivatives ----
    p_c = rows.p_c
    v_c = rows.v_c
    Jc, Jcdot = [], []
    for i in range(nc):
        link = c.contact_parent[i]
        anc = c.joints_of_link[link]
        cols = [None] * (6 + nj)
        dcols = [None] * (6 + nj)
        for a in range(3):
            e = [1.0 if b == a else 0.0 for b in range(3)]
            cols[a] = e
            dcols[a] = [0.0, 0.0, 0.0]
        for a in range(3):
            cols[3 + a] = vcross(E_cols[a], vsub(p_c[i], pb))
            dcols[3 + a] = vadd(vcross(Ed_cols[a], vsub(p_c[i], pb)),
                                vcross(E_cols[a], vsub(v_c[i], vb_lin)))
        for j in range(nj):
            if j in anc:
                d = vsub(p_c[i], kin.anchor[j])
                cols[6 + j] = vcross(kin.axis_w[j], d)
                dcols[6 + j] = vadd(vcross(adot[j], d),
                                    vcross(kin.axis_w[j], vsub(v_c[i], odot[j])))
            else:
                cols[6 + j] = [0.0, 0.0, 0.0]
                dcols[6 + j] = [0.0, 0.0, 0.0]
        Jc.append(cols)
        Jcdot.append(dcols)

    A12, GE = base_momentum_block(c, kin, p_com, Iw)
    return SoaLin(Aj_cols=Aj_cols, dA_cols=dA_cols, Jc=Jc, Jcdot=Jcdot,
                  A12=A12, GE=GE)


def _stack_rows(rows, like):
    """list-of-rows of scalars (R x C) -> (..., R, C) tensor."""
    return torch.stack([_stack(r, like) for r in rows], dim=-2)


def linearization_arrays(model: RobotModel, params, xs, us, flags, fpr, fvr):
    """Tensor-in/tensor-out: everything ``ocp.knot_linearization_batch``
    needs.  xs (..., nx), us (..., nu), flags (..., nc), fpr/fvr (..., nc,
    3) -> dict of batch-leading tensors (see keys below)."""
    c = build_consts(model)
    pf = params_floats(params)
    xl, ul = _cols(xs), _cols(us)
    rows = combined_rows(
        c, pf, xl, ul, _cols(flags),
        [_cols(fpr[..., i, :]) for i in range(c.nc)],
        [_cols(fvr[..., i, :]) for i in range(c.nc)],
    )
    lin = linearization_ingredients(c, rows, xl, ul)
    like = xs[..., 0]
    m = c.total_mass
    nj, nq = c.nj, 6 + c.nj

    iGE = inv3(lin.GE)
    nA12iGE = mscale(-1.0, mm(lin.A12, iGE))
    # Vh = m * Ab^{-1} = [[I, -A12 iGE], [0, m iGE]]
    Vh_rows = [[1.0 if r == cc else 0.0 for cc in range(3)] + nA12iGE[r]
               for r in range(3)]
    Vh_rows += [[0.0] * 3 + [mul(m, iGE[r][cc]) for cc in range(3)]
                for r in range(3)]

    def _ab_solve_neg(lin_v, ang_v):
        """-Ab^{-1} [lin_v; ang_v] as 6 scalars."""
        t = mv(iGE, ang_v)
        top = vscale(-1.0 / m, vsub(lin_v, mv(lin.A12, t)))
        return top + vscale(-1.0, t)

    Vv_cols = [_ab_solve_neg(*lin.Aj_cols[j]) for j in range(nj)]
    dvb_cols = [_ab_solve_neg(*lin.dA_cols[i]) for i in range(nq)]
    Vv_rows = [[Vv_cols[j][r] for j in range(nj)] for r in range(6)]
    dvb_rows = [[dvb_cols[i][r] for i in range(nq)] for r in range(6)]

    Jc_arr = torch.stack(
        [_stack_rows([[lin.Jc[i][col][r] for col in range(nq)] for r in range(3)],
                     like) for i in range(c.nc)], dim=-3)          # (..., nc, 3, nq)
    Jcdot_arr = torch.stack(
        [_stack_rows([[lin.Jcdot[i][col][r] for col in range(nq)] for r in range(3)],
                     like) for i in range(c.nc)], dim=-3)

    # Jcom = dp_com/dq = [I | A12/m | Aj_lin/m]  (A12 = -m skew(p_com-p_b) E)
    inv_m = 1.0 / m
    Jcom_rows = [
        [1.0 if cc == r else 0.0 for cc in range(3)]
        + [mul(inv_m, lin.A12[r][cc]) for cc in range(3)]
        + [mul(inv_m, lin.Aj_cols[j][0][r]) for j in range(nj)]
        for r in range(3)
    ]

    g = _stack(rows.g_masked, like) * _stack(rows.eq_mask, like)
    return {
        "Jcom": _stack_rows(Jcom_rows, like),    # (..., 3, nq)
        "flow0": _stack(rows.flow, like),
        "g0": g,
        "eq_mask": _stack(rows.eq_mask, like),
        "soft0": _stack(rows.soft, like),
        "Vh": _stack_rows(Vh_rows, like),        # (..., 6, 6)
        "Vv": _stack_rows(Vv_rows, like),        # (..., 6, nj)
        "dvb": _stack_rows(dvb_rows, like),      # (..., 6, nq)
        "Jc": Jc_arr,
        "Jcdot": Jcdot_arr,
        "p_c": torch.stack([_stack(p, like) for p in rows.p_c], dim=-2),
        "p_com": _stack(rows.p_com, like),
    }
