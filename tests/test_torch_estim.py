"""Port parity: estim/ (Kalman filter, momentum observer, contact
classification, cheater estimate), runtime/safety.py and the 28 x 28
Gauss-Jordan inverse (kernel B6's plain version) against the JAX package
in float64 on the CPU.

The estimators run at B=2 against the JAX functions under ``vmap``: three
chained Kalman ticks (walking contact flags, one fractional) and three
chained observer updates, each output and carried state within 1e-9 of its
own scale.  ``gj_inverse_plain`` at n = 28 on the Kalman filter's own
innovation covariance and on random SPD matrices, both pivot modes, within
1e-9 of the JAX ``gj_inverse``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunter_bipedal_control_tpu.estim import cheater as jcheat, contact as jcon, kalman as jkf
from hunter_bipedal_control_tpu.models.centroidal import q_v_to_rbd_state
from hunter_bipedal_control_tpu.models.robot import load_model as jload
from hunter_bipedal_control_tpu.models.spatial import zyx_to_quat
from hunter_bipedal_control_tpu.ops.linalg import gj_inverse as jgj_inverse
from hunter_bipedal_control_tpu.runtime import safety as jsafety
from hunter_bipedal_control_tpu_torch import convert
from hunter_bipedal_control_tpu_torch.estim import cheater as tcheat, contact as tcon, kalman as tkf
from hunter_bipedal_control_tpu_torch.ops import linalg as tlinalg
from hunter_bipedal_control_tpu_torch.runtime import safety as tsafety

F64 = torch.float64
DJ = np.array([0.10, 0., 0.40, 0.93, 0.53, -0.10, 0., -0.40, 0.93, -0.53])
B = 2
DT = 0.002
TOL = 1e-9


def scaled_err(got, ref):
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    jm = jload(dtype=jnp.float64)
    return jm, convert.from_numpy(to_np(jm), "cpu", F64)


def _sensors(rng):
    zyx = 0.1 * rng.standard_normal((B, 3))
    return dict(zyx=zyx, joint_pos=DJ + 0.05 * rng.standard_normal((B, 10)),
                joint_vel=0.3 * rng.standard_normal((B, 10)),
                omega_world=0.2 * rng.standard_normal((B, 3)),
                quat_xyzw=np.asarray(jax.vmap(zyx_to_quat)(zyx)),
                linear_accel_local=np.array([0., 0., 9.81]) + 0.3 * rng.standard_normal((B, 3)),
                contact_flags=np.array([[1., 0., 1., 0.], [0.3, 1., 0., 1.]]))


def _kalman_pair(models):
    jm, tm = models
    jp = jkf.default_kalman_params(jnp.float64)
    tp = convert.from_numpy(to_np(jp), "cpu", F64)
    js = jkf.init_kalman_state(jnp.float64, base_z=0.6)
    js = jax.tree.map(lambda a: jnp.broadcast_to(a, (B, *jnp.shape(a))), js)
    ts = convert.from_numpy(to_np(js), "cpu", F64)
    return jp, tp, js, ts


def test_kalman_update_matches_jax(models):
    jm, tm = models
    jp, tp, js, ts = _kalman_pair(models)
    step = jax.jit(jax.vmap(lambda st, s: jkf.kalman_update(jm, jp, st, **s, dt=DT)))
    rng = np.random.default_rng(30)
    for _ in range(3):
        s = _sensors(rng)
        js, jpos, jvel = step(js, s)
        ts, tpos, tvel = tkf.kalman_update(tm, tp, ts, **{k: torch.tensor(v) for k, v in
                                                            s.items()}, dt=DT)
        for a, b in zip((*ts, tpos, tvel), (*js, jpos, jvel)):
            assert scaled_err(a, b) < TOL


def test_kalman_innovation_inverse_matches_jax_gj_inverse(models):
    """gj_inverse_plain on the filter's own 28 x 28 innovation covariance and
    on random SPD matrices, both modes, against the JAX gj_inverse."""
    jm, tm = models
    _, tp, _, ts = _kalman_pair(models)
    s = _sensors(np.random.default_rng(31))
    *_, Ssy, _ = tkf.innovation(tm, tp, ts, **{k: torch.tensor(v) for k, v in s.items()}, dt=DT)
    assert Ssy.shape == (B, 28, 28)
    X = np.random.default_rng(32).standard_normal((3, 28, 28))
    spd = X @ np.swapaxes(X, -1, -2) / 28 + 0.5 * np.eye(28)
    for A in (Ssy.numpy(), spd):
        for pivot in (True, False):
            ref = jax.vmap(lambda a: jgj_inverse(a, pivot=pivot))(A)
            got = tlinalg.gj_inverse_plain(torch.tensor(A), pivot)
            assert scaled_err(got, ref) < TOL
            # the CPU wrapper is the plain version
            np.testing.assert_array_equal(tlinalg.gj_inverse(torch.tensor(A), pivot).numpy(),
                                          got.numpy())


def test_fuse_external_position_and_reset(models):
    jm, tm = models
    jp, tp, js, ts = _kalman_pair(models)
    rng = np.random.default_rng(33)
    s = _sensors(rng)
    new_pos = rng.standard_normal((B, 3))
    ref = jax.vmap(lambda st, p, z, q, c: jkf.fuse_external_position(jm, st, jp, p, z, q, c))(
        js, new_pos, s["zyx"], s["joint_pos"], s["contact_flags"])
    got = tkf.fuse_external_position(tm, ts, tp, torch.tensor(new_pos), torch.tensor(s["zyx"]),
                                     torch.tensor(s["joint_pos"]),
                                     torch.tensor(s["contact_flags"]))
    for a, b in zip(got, ref):
        assert scaled_err(a, b) < TOL
    for a, b in zip(tkf.reset_kalman(1, "cpu", F64), jkf.reset_kalman(jnp.float64)):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))


def _rbd(models, rng):
    jm, _ = models
    q = np.concatenate([[0., 0., 0.63], np.zeros(3), DJ]) + np.concatenate(
        [0.01 * rng.standard_normal((B, 6)), 0.05 * rng.standard_normal((B, 10))], axis=1)
    v = 0.2 * rng.standard_normal((B, 16))
    return q, v, np.asarray(jax.vmap(lambda a, b: q_v_to_rbd_state(jm, a, b))(q, v))


def test_momentum_observer_matches_jax(models):
    jm, tm = models
    jp = jcon.default_contact_params(jnp.float64)
    tp = convert.from_numpy(to_np(jp), "cpu", F64)
    js = jax.tree.map(lambda a: jnp.broadcast_to(a, (B, *jnp.shape(a))),
                      jcon.init_contact_observer(jnp.float64))
    ts = convert.from_numpy(to_np(js), "cpu", F64)
    step = jax.jit(jax.vmap(lambda st, r, tau: jcon.momentum_observer_update(jm, jp, st, r, tau,
                                                                             DT)))
    rng = np.random.default_rng(34)
    for _ in range(3):
        _, _, rbd = _rbd(models, rng)
        tau = 5.0 * rng.standard_normal((B, 10))
        js, jdist = step(js, rbd, tau)
        ts, tdist = tcon.momentum_observer_update(tm, tp, ts, torch.tensor(rbd),
                                                  torch.tensor(tau), DT)
        for a, b in zip((*ts, tdist), (*js, jdist)):
            assert scaled_err(a, b) < TOL


def test_classify_contact_and_early_late_flags():
    rng = np.random.default_rng(35)
    jp = jcon.default_contact_params(jnp.float64)
    tp = convert.from_numpy(to_np(jp), "cpu", F64)
    est = rng.uniform(0.0, 150.0, (6, 16))
    cmd = (rng.random((6, 4)) > 0.5).astype(np.float64)
    start = rng.uniform(0.0, 0.3, (6, 4))
    start_stop = np.stack([start, start + 0.3], axis=-1)
    t = rng.uniform(0.0, 0.6, 6)
    ref = jax.vmap(lambda e, c, ss, tt: jcon.classify_contact(jp, e, c, ss, tt))(
        est, cmd, start_stop, t)
    got = tcon.classify_contact(tp, torch.tensor(est), torch.tensor(cmd),
                                torch.tensor(start_stop), torch.tensor(t))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    meas = rng.random((6, 4)) > 0.5
    frac, tts = rng.random((6, 4)), rng.uniform(0.0, 0.02, (6, 4))
    ref = jcon.early_late_contact_flags(None, meas, cmd, frac, tts)
    got = tcon.early_late_contact_flags(None, torch.tensor(meas), torch.tensor(cmd),
                                        torch.tensor(frac), torch.tensor(tts))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cheater_estimate_and_safety(models):
    jm, tm = models
    q, v, _ = _rbd(models, np.random.default_rng(36))
    ref = jax.vmap(lambda a, b: jcheat.cheater_estimate(jm, a, b))(q, v)
    got = tcheat.cheater_estimate(tm, torch.tensor(q), torch.tensor(v))
    for a, b in zip(got, ref):
        assert scaled_err(a, b) < TOL
    x = np.asarray(ref[1]).copy()
    x[0, 11] = 2.0
    x[1, 3] = np.nan
    for fn in ("check_orientation", "check_state_finite", "check"):
        np.testing.assert_array_equal(getattr(tsafety, fn)(torch.tensor(x)).numpy(),
                                      np.asarray(jax.vmap(getattr(jsafety, fn))(x)))
