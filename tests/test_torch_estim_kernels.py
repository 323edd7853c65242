"""Port parity for the estimator kernels' plain versions and wrappers, on
the CPU in float64: B10 (``estim/contact.py::momentum_observer_update``,
``csrc/momentum_observer.cu``) and B12 (``estim/kalman.py::kalman_update``,
``csrc/kalman_update.cu``).

- The identity B10 computes the observer's C(q, v)' v - g(q) by:
  sum_k dJ_k' h_k - g, with h_k = (m_k c_dot_k, I_k w_k) link k's momentum
  at its CoM, dJ_k the time derivative of its CoM Jacobian along v and
  g_i = 9.81 sum_k m_k (J_lin,k)_z,i, formed here from the port's
  ``link_com_jacobians`` and ``torch.func.jvp``, held to JAX's
  ``coriolis_matrix(q, v)' v - gravity_vector(q)`` within 1e-9 of its scale
  on moving states (|v| ~ 1); and the kernel's p = sum_k J_k' h_k to JAX's
  ``mass_matrix(q) v``.
- ``momentum_observer_plain`` and ``kalman_update_plain`` against the JAX
  updates under ``vmap`` over three chained updates on walking states
  (``entry.estimator_batch``: fractional contact flags, moving joints),
  each output and carried state within 1e-9 of its own scale; the filter
  also from a loop's first tick (P = 100 I) and with every foot in swing or
  in stance.
- ``kernel_route``, B10's route transcribed in torch (the legs' chains in
  fk_dev's order, each link's w_k summed over the columns, each (link,
  column) pair's J' h, dJ' h and (J_lin)_z, p, C' v and g summed over the
  links in order k = 0..10, the filter, the 15 distinct entries of each
  leg's A A' + 1e-6 I, Gauss-Jordan on [A A' + 1e-6 I | b] in the natural
  pivot order with + 1e-30 and the inverse never formed, w = A' y and the
  norms), against JAX's ``momentum_observer_update`` in float64 within 1e-9
  of each output's scale on two seeded walking batches; on a state with a
  NaN its NaN pattern is ``momentum_observer_plain``'s.
- On CPU tensors the wrappers are the plain versions bit for bit and launch
  no kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp

from hunter_bipedal_control_tpu.estim import contact as jcon, kalman as jkf
from hunter_bipedal_control_tpu.models.dynamics import (coriolis_matrix as jcoriolis,
                                                        gravity_vector as jgravity,
                                                        mass_matrix as jmass)
from hunter_bipedal_control_tpu.models.robot import load_model as jload
from hunter_bipedal_control_tpu_torch import convert
from hunter_bipedal_control_tpu_torch.entry import WALK_FLAGS, estimator_batch
from hunter_bipedal_control_tpu_torch.estim import contact as tcon, kalman as tkf
from hunter_bipedal_control_tpu_torch.models.centroidal import rbd_to_q_v
from hunter_bipedal_control_tpu_torch.models import soa
from hunter_bipedal_control_tpu_torch.models.kinematics import fk, link_com_jacobians
from hunter_bipedal_control_tpu_torch.ocp import soa_kernel
from hunter_bipedal_control_tpu_torch.ops import linalg as tlinalg

F64 = torch.float64
B = 3
DT = 0.002
TOL = 1e-9


def scaled_err(got, ref):
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def np_state(st):
    return type(st)(*(t.numpy() for t in st))


@pytest.fixture(scope="module")
def models():
    jm = jload(dtype=jnp.float64)
    return jm, convert.from_numpy(to_np(jm), "cpu", F64)


def momentum_route(model, q, v):
    """(sum_k dJ_k' h_k - g, sum_k J_k' h_k) as B10 forms them."""
    kin = fk(model, q)
    J = link_com_jacobians(model, kin)                                 # (B, L, 6, 16)
    dJ = jvp(lambda q_: link_com_jacobians(model, fk(model, q_)), (q,), (v,))[1]
    Jv = (J @ v[:, None, :, None])[..., 0]                             # (B, L, 6): c_dot, w
    Iw = kin.R @ model.link_inertia @ kin.R.transpose(-1, -2)
    h = torch.cat([model.link_mass[:, None] * Jv[..., 0:3],
                   (Iw @ Jv[..., 3:6, None])[..., 0]], dim=-1)
    g = 9.81 * torch.einsum("k,bkv->bv", model.link_mass, J[:, :, 2, :])
    return torch.einsum("bkiv,bki->bv", dJ, h) - g, torch.einsum("bkiv,bki->bv", J, h)


@pytest.mark.parametrize("seed", [0, 1])
def test_coriolis_identity_matches_jax(models, seed):
    jm, tm = models
    eb = estimator_batch(B, "cpu", F64, seed=seed)
    q, v = rbd_to_q_v(eb.rbd)
    assert v.abs().max() > 1.0
    cv_g, p = momentum_route(tm, q, v)
    qn, vn = q.numpy(), v.numpy()
    ref = jax.vmap(lambda a, b: jcoriolis(jm, a, b).T @ b - jgravity(jm, a))(qn, vn)
    p_ref = jax.vmap(lambda a, b: jmass(jm, a) @ b)(qn, vn)
    assert scaled_err(cv_g, ref) < TOL
    assert scaled_err(p, p_ref) < TOL
    # the Coriolis term is not negligible on these states
    g = jax.vmap(lambda a: jgravity(jm, a))(qn)
    assert np.abs(np.asarray(ref) + np.asarray(g)).max() > 1.0


def test_momentum_observer_plain_matches_jax(models):
    jm, tm = models
    jp = jcon.default_contact_params(jnp.float64)
    tp = convert.from_numpy(to_np(jp), "cpu", F64)
    ts = estimator_batch(B, "cpu", F64, seed=10).observer
    js = jcon.ContactObserverState(*np_state(ts))
    step = jax.jit(jax.vmap(lambda st, r, tau: jcon.momentum_observer_update(jm, jp, st, r, tau,
                                                                             DT)))
    for k in range(3):
        eb = estimator_batch(B, "cpu", F64, seed=11 + k)
        js, jdist = step(js, eb.rbd.numpy(), eb.cmd_torque.numpy())
        ts, tdist = tcon.momentum_observer_plain(tm, tp, ts, eb.rbd, eb.cmd_torque, DT)
        for a, b in zip((*ts, tdist), (*js, jdist)):
            assert scaled_err(a, b) < TOL


# ---------------------------------------------------------------------------
# B10's route (csrc/momentum_observer.cu)
# ---------------------------------------------------------------------------

NJ, L, NQ, LEG = 10, 11, 16, 5


def _consts(model, dtype):
    """The constants buffer (soa_kernel.consts_values), split by its layout."""
    k = torch.as_tensor(soa_kernel.consts_values(soa.build_consts(model)), dtype=dtype)
    out, o = {}, 0
    for name, n, shape in (("opos", NJ * 3, (NJ, 3)), ("orot", NJ * 9, (NJ, 3, 3)),
                           ("axis", NJ * 3, (NJ, 3)), ("rk", NJ * 9, (NJ, 3, 3)),
                           ("rkk", NJ * 9, (NJ, 3, 3)), ("coml", L * 3, (L, 3)),
                           ("mass", L, (L,)), ("iner", L * 9, (L, 3, 3)), ("cpos", 12, (4, 3))):
        out[name] = k[o:o + n].reshape(shape)
        o += n
    return out


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _moves(j, k):
    """SOA_ANC[k][j]: joint j moves link k (the kernel's ``moves``)."""
    return 1.0 if k >= 1 and (k - 1) // LEG == j // LEG and j % LEG <= (k - 1) % LEG else 0.0


def kernel_route(model, params, state, rbd, tau, dt):
    """B10's update in the kernel's order: (new state, tau_dist)."""
    dtype, B = rbd.dtype, rbd.shape[0]
    C = _consts(model, dtype)
    zyx, p0, qj, om_w, v0, vj = (rbd[:, 0:3], rbd[:, 3:6], rbd[:, 6:16], rbd[:, 16:19],
                                 rbd[:, 19:22], rbd[:, 22:32])
    cz, sz, cy, sy, cx, sx = (torch.cos(zyx[:, 0]), torch.sin(zyx[:, 0]), torch.cos(zyx[:, 1]),
                              torch.sin(zyx[:, 1]), torch.cos(zyx[:, 2]), torch.sin(zyx[:, 2]))
    zero, one = torch.zeros_like(cz), torch.ones_like(cz)
    ty = sy / cy
    Einv = torch.stack([cz * ty, sz * ty, one, -sz, cz, zero, cz / cy, sz / cy, zero],
                       -1).reshape(B, 3, 3)
    thd = _mv(Einv, om_w)
    v = torch.cat([v0, thd, vj], -1)
    zd, yd = thd[:, 0], thd[:, 1]
    E = torch.stack([zero, -sz, cz * cy, zero, cz, sz * cy, one, zero, -sy], -1).reshape(B, 3, 3)
    Ed = torch.stack([zero, -cz * zd, -sz * zd * cy - cz * sy * yd,
                      zero, -sz * zd, cz * zd * cy - sz * sy * yd,
                      zero, zero, -cy * yd], -1).reshape(B, 3, 3)
    R0 = torch.stack([cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
                      sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
                      -sy, cy * sx, cy * cx], -1).reshape(B, 3, 3)
    eye = torch.eye(3, dtype=dtype)
    rod = (eye + torch.sin(qj)[..., None, None] * C["rk"]
           + (1.0 - torch.cos(qj))[..., None, None] * C["rkk"])
    # the legs side by side, fk_dev's order (R_parent R_origin, then rod), the velocity pass
    R, p, com, om, vo = [R0] * L, [p0] * L, [p0 + _mv(R0, C["coml"][0])] * L, [None] * L, [v0] * L
    om[0] = _mv(E, thd)
    aw, anchor, toe = [None] * NJ, [None] * NJ, [None] * 2
    for g in range(2):
        Rg, pg, omg, vog = R0, p0, om[0], v0
        for n in range(LEG):
            j = LEG * g + n
            Ror = Rg @ C["orot"][j]
            por = pg + _mv(Rg, C["opos"][j])
            a = _mv(Ror, C["axis"][j])
            Rg = Ror @ rod[:, j]
            vog = vog + _cross(omg, por - pg)
            omg = omg + vj[:, j, None] * a
            pg = por
            R[j + 1], p[j + 1], om[j + 1], vo[j + 1] = Rg, pg, omg, vog
            com[j + 1] = pg + _mv(Rg, C["coml"][j + 1])
            aw[j], anchor[j] = a, pg
        toe[g] = pg + _mv(Rg, C["cpos"][g])

    def column(i, k, x, xd, mask):
        """Column i of a point x (velocity xd) on link k: lin, ang, dlin, dang."""
        if i < 3:
            e = torch.zeros(B, 3, dtype=dtype)
            e[:, i] = 1.0
            return e, 0.0 * e, 0.0 * e, 0.0 * e
        if i < 6:
            ax, adv, ref, vref = E[..., i - 3], Ed[..., i - 3], p[0], v0
        else:
            j = i - 6
            ax, ref, vref = aw[j], anchor[j], vo[j + 1]
            adv = _cross(om[0 if j % LEG == 0 else j], ax)
        r, rd = x - ref, xd - vref
        return (_cross(ax, r) * mask, ax * mask, (_cross(adv, r) + _cross(ax, rd)) * mask,
                adv * mask)

    # a link's w_k = J_ang,k v over its columns, its CoM's velocity and h_k
    hl, ha, cd = [None] * L, [None] * L, [None] * L
    for k in range(L):
        Iw = (R[k] @ C["iner"][k]) @ R[k].transpose(-1, -2)
        w = torch.zeros(B, 3, dtype=dtype)
        for i in range(NQ):
            mask = _moves(i - 6, k) if i >= 6 else 1.0
            ang = (0.0 * E[..., 0] if i < 3 else E[..., i - 3] if i < 6 else aw[i - 6] * mask)
            w = w + ang * v[:, i, None]
        cd[k] = vo[k] + _cross(om[k], com[k] - p[k])
        hl[k], ha[k] = C["mass"][k] * cd[k], _mv(Iw, w)
    # the (link, column) pairs' terms, summed over the links in order
    pm = torch.zeros(B, NQ, dtype=dtype)
    cv, gz = torch.zeros_like(pm), torch.zeros_like(pm)
    for k in range(L):
        for i in range(NQ):
            mask = _moves(i - 6, k) if i >= 6 else 1.0
            lin, ang, dlin, dang = column(i, k, com[k], cd[k], mask)
            pm[:, i] = pm[:, i] + ((lin * hl[k]).sum(-1) + (ang * ha[k]).sum(-1))
            cv[:, i] = cv[:, i] + ((dlin * hl[k]).sum(-1) + (dang * ha[k]).sum(-1))
            gz[:, i] = gz[:, i] + C["mass"][k] * lin[:, 2]
    lam = params.cutoff_frequency.to(dtype)
    gama = torch.exp(-lam * dt)
    beta = (1.0 - gama) / (gama * dt)
    p_scg = ((beta * pm + torch.cat([torch.zeros(B, 6, dtype=dtype), tau], -1)) + cv) - 9.81 * gz
    p_scg_z = (1.0 - gama) * p_scg + gama * state.p_scg_z_last
    tau_dist = beta * pm - p_scg_z
    # the toes' A rows; the 15 distinct entries of A A' + 1e-6 I; Gauss-Jordan
    est = []
    for g in range(2):
        A = torch.stack([torch.cat(column(6 + LEG * g + n, LEG * (g + 1), toe[g],
                                          torch.zeros_like(toe[g]), 1.0)[:2], -1)
                         for n in range(LEG)], 1)                          # (B, 5, 6)
        T = torch.empty(B, LEG, LEG + 1, dtype=dtype)
        for r in range(LEG):
            for c in range(r, LEG):
                T[:, r, c] = T[:, c, r] = (A[:, r] * A[:, c]).sum(-1) + (1e-6 if r == c else 0.0)
        T[:, :, LEG] = tau_dist[:, 6 + LEG * g:6 + LEG * (g + 1)]
        for k in range(LEG):
            pval = T[:, k, k] + 1e-30
            prow = T[:, k, k + 1:] / pval[:, None]
            upd = T[:, :, k + 1:] - T[:, :, k, None] * prow[:, None, :]
            upd[:, k] = prow
            T = torch.cat([T[:, :, :k + 1], upd], -1)
        w = (A * T[:, :, LEG, None]).sum(1)                              # (B, 6)
        est.append(w)
    norms = [torch.sqrt((w[:, :n] * w[:, :n]).sum(-1)) for n in (3, 6) for w in est]
    est_forces = torch.cat(est + [torch.stack(norms, -1)], -1)
    return type(state)(p_scg_z_last=p_scg_z, est_forces=est_forces), tau_dist


@pytest.fixture(scope="module")
def observer_step(models):
    """JAX's observer update under vmap, jitted once (float64)."""
    jm, _ = models
    jp = jcon.default_contact_params(jnp.float64)
    return jp, jax.jit(jax.vmap(lambda st, r, tau: jcon.momentum_observer_update(jm, jp, st, r,
                                                                                tau, DT)))


@pytest.mark.parametrize("seed", [40, 41])
def test_kernel_route_matches_jax(models, observer_step, seed):
    _, tm = models
    jp, step = observer_step
    tp = convert.from_numpy(to_np(jp), "cpu", F64)
    eb = estimator_batch(B, "cpu", F64, seed=seed)
    js, jdist = step(jcon.ContactObserverState(*np_state(eb.observer)), eb.rbd.numpy(),
                     eb.cmd_torque.numpy())
    ts, tdist = kernel_route(tm, tp, eb.observer, eb.rbd, eb.cmd_torque, DT)
    for a, b in zip((*ts, tdist), (*js, jdist)):
        assert scaled_err(a, b) < TOL


def test_kernel_route_nan_where_plain_has_it(models):
    _, tm = models
    eb = estimator_batch(4, "cpu", F64, seed=42)
    rbd = eb.rbd.clone()
    rbd[1, 7] = float("nan")
    got = kernel_route(tm, eb.observer_params, eb.observer, rbd, eb.cmd_torque, DT)
    ref = tcon.momentum_observer_plain(tm, eb.observer_params, eb.observer, rbd, eb.cmd_torque,
                                       DT)
    for a, b in zip((*got[0], got[1]), (*ref[0], ref[1])):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.isnan(a[1]).any() and not torch.isnan(a[[0, 2, 3]]).any()


@pytest.fixture(scope="module")
def kalman_step(models):
    """JAX's update under vmap, jitted once for every case (B scenarios)."""
    jm, _ = models
    jp = jkf.default_kalman_params(jnp.float64)
    return jp, jax.jit(jax.vmap(lambda st, s: jkf.kalman_update(jm, jp, st, **s, dt=DT)))


@pytest.mark.parametrize("case", ["walking", "first_tick", "swing", "stance"])
def test_kalman_update_plain_matches_jax(models, kalman_step, case):
    """Three chained updates on ``entry.estimator_batch``'s walking inputs,
    from a loop's first tick (``init_kalman_state``: P = 100 I), and with
    every foot in swing (flags 0) or in stance (flags 1)."""
    _, tm = models
    jp, step = kalman_step
    tp = convert.from_numpy(to_np(jp), "cpu", F64)
    ts = (tkf.init_kalman_state(B, "cpu", F64) if case == "first_tick"
          else estimator_batch(B, "cpu", F64, seed=20).kalman)
    js = jkf.KalmanState(*np_state(ts))
    fractional = False
    for k in range(3):
        sensors = estimator_batch(B, "cpu", F64, seed=21 + k).sensors
        if case in ("swing", "stance"):
            flags = sensors["contact_flags"]
            sensors["contact_flags"] = (torch.zeros_like if case == "swing"
                                        else torch.ones_like)(flags)
        flags = sensors["contact_flags"]
        fractional |= bool(((flags > 0) & (flags < 1)).any())
        js, jpos, jvel = step(js, {n: t.numpy() for n, t in sensors.items()})
        ts, tpos, tvel = tkf.kalman_update_plain(tm, tp, ts, **sensors, dt=DT)
        for a, b in zip((*ts, tpos, tvel), (*js, jpos, jvel)):
            assert scaled_err(a, b) < TOL
    assert fractional == (case in ("walking", "first_tick"))


@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("which", ["observer", "kalman"])
def test_cpu_wrappers_are_plain_and_launch_nothing(which, dtype):
    eb = estimator_batch(4, "cpu", dtype, seed=30)
    counters = (tcon.momentum_observer_update, tkf.kalman_update, tlinalg.gj_inverse)
    before = [c.launches for c in counters]
    if which == "observer":
        args = (eb.model, eb.observer_params, eb.observer, eb.rbd, eb.cmd_torque, DT)
        got = tcon.momentum_observer_update(*args)
        ref = tcon.momentum_observer_plain(*args)
        got, ref = (*got[0], got[1]), (*ref[0], ref[1])
    else:
        args = (eb.model, eb.kalman_params, eb.kalman)
        got = tkf.kalman_update(*args, **eb.sensors, dt=DT)
        ref = tkf.kalman_update_plain(*args, **eb.sensors, dt=DT)
        got, ref = (*got[0], *got[1:]), (*ref[0], *ref[1:])
    for a, b in zip(got, ref):
        assert a.dtype == dtype and torch.equal(a, b)
    assert [c.launches for c in counters] == before == [0, 0, 0]


def test_params_buffers():
    kp = tkf.default_kalman_params()
    np.testing.assert_array_equal(tkf.params_buffer(kp).numpy(),
                                  np.array([float(t) for t in kp], np.float32))
    op = tcon.default_contact_params(dtype=F64)
    buf = tcon.params_buffer(op)
    assert buf.dtype == torch.float32 and buf.tolist() == [250.0]
    with pytest.raises(ValueError):
        tkf.params_buffer(kp._replace(foot_radius=torch.zeros(2)))
    with pytest.raises(ValueError):
        tcon.params_buffer(op._replace(cutoff_frequency=torch.zeros(1)))


def test_estimator_batch_covers_the_kernels_cases():
    """The seeded batch mixes walking and fractional contact flags, and the
    filter's xy conditioning goes both ways on it."""
    eb = estimator_batch(64, "cpu", F64, seed=0)
    flags = eb.sensors["contact_flags"]
    walk = torch.tensor(WALK_FLAGS, dtype=F64)
    is_walk = (flags[:, None, :] == walk[None]).all(-1).any(-1)
    assert is_walk.any() and (~is_walk).any()
    assert eb.rbd.shape == (64, 32) and eb.cmd_torque.shape == (64, 10)
    assert eb.kalman.P.shape == (64, 18, 18)
    assert torch.linalg.eigvalsh(eb.kalman.P).min() > 0
    st, _, _ = tkf.kalman_update(eb.model, eb.kalman_params, eb.kalman, **eb.sensors, dt=DT)
    conditioned = (st.P[:, 0:2, 2:] == 0).all(-1).all(-1)
    assert conditioned.any() and (~conditioned).any()
