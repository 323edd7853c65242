"""Kernel B8a's order (``csrc/leg_ik.cu``: eight lanes a leg, the joints'
transforms side by side, the 5x5 solves by shuffles) transcribed in torch
on CPU tensors, against the JAX package's two IK passes
(solver/mpc.py::_joint_reference over refs/ik.py::compute_ik).

``kernel_order`` follows the kernel leg by leg: the chain's eight elements
(the base from its ZYX angles; joint j's local factor R_origin + s KB + (1 -
c) KC, KB = R_origin skew(axis), KC = R_origin skew(axis)^2, and its origin
offset; the contact frame's offset; the identity) composed by the lanes'
inclusive shuffle scan at offsets 1, 2, 4 ((Ra, pa) o (Rb, pb) = (Ra Rb, pa
+ Ra pb)); each joint's Jacobian column (R_j axis_j x (p_toe - anchor_j);
R_j axis_j); row a of J'J + damp I and of J'e, each entry the dot of two
columns; Gauss-Jordan on [A | J'e] in the natural order, every other row
less the pivot row times A_ak / (A_kk + 1e-30), each right-hand side
divided by its own pivot + 1e-30 at the end; the rotation step's
local-frame columns, Jlin Jlin' + damp I summed over the joints in order,
the adjugate inverse, N's columns and rows, G = Jang N column by column,
the step -N w; log3; keep-if-improved with the toe at the best joints kept
for the next phase.

Held to JAX's two passes (trans_it=3, rot_it=2) in float64 within 1e-9 of
max(1, |JAX|) at S=6 and S=7 on seeded data along a walking target; in
float32 each pass's joints within 2x the float32 plain version's distance
from the float64 plain version, on their own scale, outside the legs whose
keep-if-improved tests went the other way from the float64 plain version's
in that pass or the one before (the transcription flips at most 2x the
float32 plain version's legs + 2); a NaN in a pose, a toe target or a warm
joint gives NaN where ``joint_reference_ik_plain`` has it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunter_bipedal_control_tpu.models.robot import load_model as jload
from hunter_bipedal_control_tpu.models.spatial import rotation_zyx as jrot
from hunter_bipedal_control_tpu.refs import ik as jik, targets as jtg
from hunter_bipedal_control_tpu_torch.models import soa
from hunter_bipedal_control_tpu_torch.models.robot import load_model
from hunter_bipedal_control_tpu_torch.models.spatial import rotation_zyx as trot
from hunter_bipedal_control_tpu_torch.ocp import soa_kernel
from hunter_bipedal_control_tpu_torch.refs import ik as tik

F64, F32 = torch.float64, torch.float32
NJ, LEG, NC = 10, 5, 4
GROUP, TOE = 8, LEG + 1
DJ = np.array([0.10, 0., 0.40, 0.93, 0.53, -0.10, 0., -0.40, 0.93, -0.53])
TOL64 = 1e-9


# ---------------------------------------------------------------------------
# the kernel's order
# ---------------------------------------------------------------------------


def _consts(model, dtype):
    """soa_kernel's constants buffer, split by the kernel's layout (the
    parts the IK reads)."""
    k = torch.as_tensor(soa_kernel.consts_values(soa.build_consts(model)), dtype=dtype)
    sizes = dict(opos=NJ * 3, orot=NJ * 9, axis=NJ * 3, rk=NJ * 9, rkk=NJ * 9, coml=33,
                 mass=11, iner=99, cpos=NC * 3)
    out, o = {}, 0
    for name, n in sizes.items():
        out[name] = k[o:o + n]
        o += n
    for name in ("orot", "rk", "rkk"):
        out[name] = out[name].reshape(NJ, 3, 3)
    for name in ("opos", "axis", "cpos"):
        out[name] = out[name].reshape(-1, 3)
    return out


def _mm(A, B):
    """soa_model.cuh::mm3: C_ij = A_i0 B_0j + A_i1 B_1j + A_i2 B_2j."""
    return (A[..., :, 0:1] * B[..., 0:1, :] + A[..., :, 1:2] * B[..., 1:2, :]
            + A[..., :, 2:3] * B[..., 2:3, :])


def _mv(A, v):
    """soa_model.cuh::mv3."""
    return A[..., :, 0] * v[..., 0:1] + A[..., :, 1] * v[..., 1:2] + A[..., :, 2] * v[..., 2:3]


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm3(v):
    return torch.sqrt(_dot3(v, v))


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _inv3(M):
    """soa_model.cuh::inv3 (the adjugate), row-major (..., 9)."""
    c00 = M[..., 4] * M[..., 8] - M[..., 5] * M[..., 7]
    c01 = M[..., 5] * M[..., 6] - M[..., 3] * M[..., 8]
    c02 = M[..., 3] * M[..., 7] - M[..., 4] * M[..., 6]
    det = M[..., 0] * c00 + M[..., 1] * c01 + M[..., 2] * c02
    inv_det = 1.0 / det
    c10 = M[..., 2] * M[..., 7] - M[..., 1] * M[..., 8]
    c11 = M[..., 0] * M[..., 8] - M[..., 2] * M[..., 6]
    c12 = M[..., 1] * M[..., 6] - M[..., 0] * M[..., 7]
    c20 = M[..., 1] * M[..., 5] - M[..., 2] * M[..., 4]
    c21 = M[..., 2] * M[..., 3] - M[..., 0] * M[..., 5]
    c22 = M[..., 0] * M[..., 4] - M[..., 1] * M[..., 3]
    return inv_det[..., None] * torch.stack([c00, c10, c20, c01, c11, c21, c02, c12, c22], -1)


def _rot_err(Rd, R):
    """leg_ik.cu::rot_err: log3 of Rd' R."""
    M = _mm(Rd.transpose(-1, -2), R)
    c = torch.clamp(0.5 * (M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2] - 1.0), -1.0, 1.0)
    theta = torch.arccos(c)
    scale = torch.where(theta < 1e-6, 1.0 + theta * theta / 6.0, theta / torch.sin(theta))
    return scale[..., None] * torch.stack([0.5 * (M[..., 2, 1] - M[..., 1, 2]),
                                           0.5 * (M[..., 0, 2] - M[..., 2, 0]),
                                           0.5 * (M[..., 1, 0] - M[..., 0, 1])], -1)


def _elements(k, poses, leg_of):
    """The eight chain elements of every leg: KA, KB, KC (P, 8, 3, 3) and
    the offsets and axes (P, 8, 3), P = (B, S, 2) flattened."""
    P, dt = leg_of.shape[0], poses.dtype
    eye = torch.eye(3, dtype=dt)
    KA = eye.expand(P, GROUP, 3, 3).clone()
    KB, KC = torch.zeros_like(KA), torch.zeros_like(KA)
    off = torch.zeros(P, GROUP, 3, dtype=dt)
    axis = torch.zeros_like(off)
    z, y, x = (poses[:, i] for i in (3, 4, 5))
    cz, sz, cy, sy = torch.cos(z), torch.sin(z), torch.cos(y), torch.sin(y)
    cx, sx = torch.cos(x), torch.sin(x)
    KA[:, 0] = torch.stack([cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
                            sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
                            -sy, cy * sx, cy * cx], -1).reshape(P, 3, 3)
    off[:, 0] = poses[:, 0:3]
    for a in range(LEG):
        j = LEG * leg_of + a
        KA[:, 1 + a] = k["orot"][j]
        KB[:, 1 + a] = _mm(k["orot"][j], k["rk"][j])
        KC[:, 1 + a] = _mm(k["orot"][j], k["rkk"][j])
        off[:, 1 + a] = k["opos"][j]
        axis[:, 1 + a] = k["axis"][j]
    off[:, TOE] = k["cpos"][leg_of]
    return KA, KB, KC, off, axis


def _toe(el, q):
    """A toe evaluation at the joint lanes' angles q (P, 5): the toe's
    position (P, 3) and rotation (P, 3, 3), the Jacobian's columns (P, 5, 6)."""
    KA, KB, KC, off, axis = el
    P = q.shape[0]
    ang = torch.cat([q.new_zeros(P, 1), q, q.new_zeros(P, GROUP - 1 - LEG)], dim=1)
    s, u = torch.sin(ang)[..., None, None], (1.0 - torch.cos(ang))[..., None, None]
    R = KA + s * KB + u * KC
    p = off.clone()
    d = 1
    while d < GROUP:
        Ra, pa = R[:, :-d], p[:, :-d]
        R = torch.cat([R[:, :d], _mm(Ra, R[:, d:])], dim=1)
        p = torch.cat([p[:, :d], pa + _mv(Ra, p[:, d:])], dim=1)
        d *= 2
    p_toe, R_toe = p[:, TOE], R[:, TOE]
    aw = _mv(R[:, 1:TOE], axis[:, 1:TOE])
    lin = _cross(aw, p_toe[:, None] - p[:, 1:TOE])
    return p_toe, R_toe, torch.cat([lin, aw], dim=-1)


def _gj_rows(A, b):
    """leg_ik.cu::gj_rows on every leg: A (P, 5, 5), b (P, 5) -> x (P, 5)."""
    A, b = A.clone(), b.clone()
    piv = torch.ones_like(b)
    for k in range(LEG):
        pk = A[:, k, k] + 1e-30
        rk, bk = A[:, k, k + 1:].clone(), b[:, k].clone()
        f = A[:, :, k] / pk[:, None]
        other = torch.arange(LEG) != k
        A[:, other, k + 1:] = A[:, other, k + 1:] - f[:, other, None] * rk[:, None]
        b[:, other] = b[:, other] - f[:, other] * bk[:, None]
        piv[:, k] = pk
    return b / piv


def _damped_solve(g, e, damp):
    """leg_ik.cu::damped_solve: g (P, 5, 3) the columns, e (P, 3)."""
    eye = torch.eye(LEG, dtype=g.dtype)
    A = _dot3(g[:, :, None], g[:, None, :]) + damp * eye
    return _gj_rows(A, _dot3(g, e[:, None]))


def _rotation_step(R, col, err, damp):
    """leg_ik.cu::rotation_step: d = -N w (P, 5)."""
    Rt = R.transpose(-1, -2)
    L, Ga = _mv(Rt[:, None], col[..., 0:3]), _mv(Rt[:, None], col[..., 3:6])   # (P, 5, 3)
    JJt = torch.zeros(L.shape[0], 3, 3, dtype=L.dtype)
    for c in range(LEG):
        JJt = JJt + L[:, c, :, None] * L[:, c, None, :]
    JJt = JJt + damp * torch.eye(3, dtype=L.dtype)
    iJ = _inv3(JJt.reshape(-1, 9)).reshape(-1, 3, 3)
    T = _mv(iJ[:, None], L)                                       # (P, 5, 3): T's columns
    N = torch.eye(LEG, dtype=L.dtype) - _dot3(L[:, :, None], T[:, None, :])  # N[b][a]
    G = torch.zeros_like(L)
    for c in range(LEG):
        G = G + Ga[:, c, None, :] * N[:, c, :, None]
    w = _damped_solve(G, err, damp)
    acc = torch.zeros_like(w)
    for c in range(LEG):
        acc = acc + N[:, :, c] * w[:, c, None]
    return -acc


def kernel_order(model, poses, warm, des, R_des, trans_it=3, rot_it=2, decisions=None):
    """csrc/leg_ik.cu's two passes in its order: poses (B, S, 6), warm (B,
    nj), des (B, S, 2, 3), R_des (B, 3, 3) -> (qj1, qref), both (B, S, nj).
    ``decisions`` receives, per pass, the steps' keep-if-improved tests (B,
    S, 2)."""
    Bn, S = poses.shape[:2]
    dt = poses.dtype
    k = _consts(model, dt)
    leg_of = torch.arange(2).repeat(Bn * S)
    el = _elements(k, poses.reshape(Bn * S, 6).repeat_interleave(2, 0), leg_of)
    lo = model.joint_lower.to(dt).reshape(2, LEG)[leg_of]
    hi = model.joint_upper.to(dt).reshape(2, LEG)[leg_of]
    target = des.reshape(-1, 3)
    Rd = R_des.repeat_interleave(2 * S, 0)
    q = warm.reshape(Bn, 1, 2, LEG).expand(Bn, S, 2, LEG).reshape(-1, LEG)
    best = _toe(el, q)
    outs = []
    for _ in range(2):
        per_pass = []
        # translation
        qc, cur = q, best
        err = cur[0] - target
        best_err = _norm3(err)
        for _ in range(trans_it):
            d = _damped_solve(cur[2][..., 0:3], err, tik.DAMP)
            qc = torch.clamp(qc + tik.STEP * (-d), lo, hi)
            cur = _toe(el, qc)
            err = cur[0] - target
            e = _norm3(err)
            better = e < best_err
            per_pass.append(better)
            q = torch.where(better[:, None], qc, q)
            best = tuple(torch.where(better.reshape(-1, *[1] * (a.dim() - 1)), a, b)
                         for a, b in zip(cur, best))
            best_err = torch.minimum(e, best_err)
        # rotation
        qc, cur = q, best
        w3 = _rot_err(Rd, cur[1])
        best_err = _norm3(w3)
        for _ in range(rot_it):
            d = _rotation_step(cur[1], cur[2], w3, tik.DAMP)
            qc = torch.clamp(qc + tik.STEP * d, lo, hi)
            cur = _toe(el, qc)
            w3 = _rot_err(Rd, cur[1])
            e = _norm3(w3)
            better = e < best_err
            per_pass.append(better)
            q = torch.where(better[:, None], qc, q)
            best = tuple(torch.where(better.reshape(-1, *[1] * (a.dim() - 1)), a, b)
                         for a, b in zip(cur, best))
            best_err = torch.minimum(e, best_err)
        outs.append(q.reshape(Bn, S, NJ))
        if decisions is not None:
            decisions.append([m.reshape(Bn, S, 2) for m in per_pass])
    return tuple(outs)


# ---------------------------------------------------------------------------
# against JAX and the plain version
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def walking_target():
    """tests/test_torch_refs.py's walking target (0.24 s horizon)."""
    horizon = 0.24
    x0 = np.concatenate([np.zeros(6), [0., 0., 0.63], np.zeros(3), DJ])
    target = jtg.cmd_vel_to_target(jnp.array([0.25, 0.1, 0., 0.3]), jnp.asarray(x0), 0.0,
                                   horizon, jtg.default_cmd_vel_config(dtype=jnp.float64))
    return horizon, target


def _ik_inputs(walking_target, B, S, seed):
    """tests/test_torch_refs.py::_ik_inputs: base poses sampled along the
    walking target, warm joints, toe targets and target ZYX angles, numpy
    float64."""
    horizon, target = walking_target
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, horizon, S)
    states = np.asarray(jax.vmap(lambda a: jtg.interp_state(target, a))(t))
    poses = states[None, :, 6:12] + np.concatenate(
        [rng.normal(0, 0.02, (B, S, 3)), rng.normal(0, 0.1, (B, S, 3))], axis=-1)
    warm = DJ + rng.normal(0, 0.1, (B, 10))
    des = (np.array([[0.03, 0.11, 0.0], [0.03, -0.11, 0.02]]) + poses[..., None, 0:3]
           - [0.0, 0.0, 0.63] + rng.normal(0, 0.04, (B, S, 2, 3)))
    return poses, warm, des, rng.normal(0, 0.1, (B, 3))


def _torch_inputs(arrays, dtype):
    poses, warm, des, zyx = (torch.tensor(a, dtype=F64) for a in arrays)
    return tuple(t.to(dtype) for t in (poses, warm, des, trot(zyx)))


IK_ROWS = 21


@pytest.mark.parametrize("S", [6, 7])
def test_kernel_order_matches_jax(walking_target, S):
    """Both passes in float64 against JAX's compute_ik run twice (every
    sample from the warm joints, then from its own pass-1 result)."""
    jm = jload(dtype=jnp.float64)
    ik = jax.jit(jax.vmap(lambda q, d, R: jik.compute_ik(jm, q, d, R, trans_it=3, rot_it=2)))
    arrays = _ik_inputs(walking_target, 3, S, S)
    poses, warm, des, zyx = arrays
    n = 3 * S

    def run(q, d, R):
        # rows past n repeat the first ones: one compiled shape for every S
        pad = lambda a: np.concatenate([a, a[:IK_ROWS - n]])  # noqa: E731
        return np.asarray(ik(pad(q), pad(d), pad(R)))[:n]

    flat = poses.reshape(n, 6), des.reshape(n, 2, 3)
    Rd = np.repeat(np.asarray(jax.vmap(jrot)(zyx)), S, axis=0)
    qj1 = run(np.concatenate([flat[0], np.repeat(warm, S, axis=0)], axis=1), flat[1], Rd)
    ref = [r.reshape(3, S, NJ) for r in (qj1, run(np.concatenate([flat[0], qj1], axis=1),
                                                    flat[1], Rd))]
    dec = []
    got = kernel_order(load_model(device="cpu", dtype=F64), *_torch_inputs(arrays, F64),
                       decisions=dec)
    for a, b in zip(got, ref):
        err = np.abs(a.numpy() - b).max() / max(1.0, np.abs(b).max())
        assert err <= TOL64, err
    assert not np.allclose(ref[0], ref[1])
    steps = torch.stack([torch.stack(d) for d in dec])
    assert steps.any() and not steps.all()   # the tests go both ways


def _flipped(d, d64):
    """(2, B, S, 2): legs with a test off float64's in this pass or the one before."""
    off = (torch.stack([torch.stack(x) for x in d]) != d64).any(1)
    return torch.stack([off[0], off[0] | off[1]])


def _leg_err(a, b, legs):
    """max |a - b| over the joints of ``legs``, over max |b|."""
    m = legs.repeat_interleave(LEG, dim=-1)
    return ((a - b).abs() * m).max().item() / b.abs().max().item()


def test_kernel_order_float32_within_plain_error(walking_target):
    """B=24, S=7 in float32: each pass's joints within 2x the float32 plain
    version's distance from the float64 plain version, on their own scale,
    outside the flipped legs."""
    arrays = _ik_inputs(walking_target, 24, 7, 7)
    m64, m32 = load_model(device="cpu", dtype=F64), load_model(device="cpu", dtype=F32)
    x64, x32 = _torch_inputs(arrays, F64), _torch_inputs(arrays, F32)
    d64, d32, dk = [], [], []
    ref64 = tik.joint_reference_ik_plain(m64, *x64, decisions=d64)
    ref32 = tik.joint_reference_ik_plain(m32, *x32, decisions=d32)
    got = kernel_order(m32, *x32, decisions=dk)
    d64 = torch.stack([torch.stack(x) for x in d64])
    flip_k, flip_32 = _flipped(dk, d64), _flipped(d32, d64)
    assert int(flip_k.sum()) <= 2 * int(flip_32.sum()) + 2
    for p in range(2):
        keep = ~(flip_k[p] | flip_32[p])
        assert keep.sum() >= 0.9 * keep.numel()
        assert got[p].dtype == F32 and torch.isfinite(got[p]).all()
        e = _leg_err(got[p].double(), ref64[p], keep)
        e32 = _leg_err(ref32[p].double(), ref64[p], keep)
        assert e <= 2.0 * e32, (p, e, e32)


@pytest.mark.parametrize("where", ["pose", "target", "warm"])
def test_kernel_order_nan_where_plain_has_it(walking_target, where):
    """A NaN in one sample's pose, one leg's toe target or one warm joint
    gives NaN in both passes where joint_reference_ik_plain has it: a NaN
    warm joint stays in its scenario's outputs; a NaN pose or target makes
    every error norm NaN, so no step of the sample's legs (of the leg's
    translation) is kept and the pose's sample keeps its warm joints."""
    poses, warm, des, R_des = _torch_inputs(_ik_inputs(walking_target, 3, 6, 3), F64)
    if where == "pose":
        poses[1, 2, 4] = float("nan")
    elif where == "target":
        des[2, 4, 1, 0] = float("nan")
    else:
        warm[0, 7] = float("nan")
    model = load_model(device="cpu", dtype=F64)
    dk, dp = [], []
    got = kernel_order(model, poses, warm, des, R_des, decisions=dk)
    ref = tik.joint_reference_ik_plain(model, poses, warm, des, R_des, decisions=dp)
    for a, b in zip(got, ref):
        assert torch.equal(a.isnan(), b.isnan()), where
        assert bool(a.isnan().any()) == (where == "warm")
    if where == "pose":
        for out in got + ref:
            assert torch.equal(out[1, 2], warm[1])
    if where == "target":
        for d in dk + dp:
            assert not torch.stack(d[:3])[:, 2, 4, 1].any()
