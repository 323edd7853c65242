"""Port parity: models/ (spatial, kinematics, centroidal, robot) against the
JAX package in float64 on the CPU, rtol 1e-9 (atol 1e-9 x the array's
scale, for entries that cancel to ~0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunter_bipedal_control_tpu.models import centroidal as jc, kinematics as jk, spatial as jsp
from hunter_bipedal_control_tpu.models.robot import load_model as jload
from hunter_bipedal_control_tpu_torch import convert
from hunter_bipedal_control_tpu_torch.models import centroidal as tc, kinematics as tk, spatial as tsp
from hunter_bipedal_control_tpu_torch.models.robot import load_model as tload

F64 = torch.float64
DJ = np.array([0.10, 0., 0.40, 0.93, 0.53, -0.10, 0., -0.40, 0.93, -0.53])
RTOL = 1e-9


def close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(1.0, np.abs(ref).max()))


@pytest.fixture(scope="module")
def models():
    jm = jload(dtype=jnp.float64)
    tm = convert.from_numpy(jax.tree.map(np.asarray, jm), "cpu", F64)
    return jm, tm


def _rand_q(rng, n):
    return np.concatenate([0.1 * rng.standard_normal((n, 3)) + [0, 0, 0.63],
                           0.3 * rng.standard_normal((n, 3)),
                           DJ + 0.3 * rng.standard_normal((n, 10))], axis=1)


def _rand_xu(rng, n):
    x = np.concatenate([0.3 * rng.standard_normal((n, 6)), _rand_q(rng, n)], axis=1)
    u = rng.standard_normal((n, 22)) * np.r_[np.full(12, 30.0), np.full(10, 2.0)]
    return x, u


def test_load_model_matches_conversion(models):
    jm, tm = models
    own = tload(device="cpu", dtype=F64)
    for name in tm._fields:
        a, b = getattr(own, name), getattr(tm, name)
        if torch.is_tensor(a):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        else:
            assert a == b, name
    assert own.joint_parent.dtype == torch.int64


def test_spatial(models):
    rng = np.random.default_rng(0)
    zyx = rng.uniform(-1.2, 1.2, (7, 3))
    t = torch.tensor(zyx)
    close(tsp.rotation_zyx(t), jax.vmap(jsp.rotation_zyx)(zyx))
    close(tsp.euler_rate_map_zyx(t), jax.vmap(jsp.euler_rate_map_zyx)(zyx))
    close(tsp.euler_rate_map_zyx_jacobian(t),
          jax.vmap(jax.jacfwd(jsp.euler_rate_map_zyx))(zyx))
    close(tsp.skew(t), jax.vmap(jsp.skew)(zyx))
    close(tsp.zyx_to_quat(t), jax.vmap(jsp.zyx_to_quat)(zyx))
    # log3 on generic rotations and on one within the small-angle branch
    R = jax.vmap(jsp.rotation_zyx)(np.concatenate([zyx, 1e-8 * np.ones((1, 3))]))
    close(tsp.log3(torch.tensor(np.asarray(R))), jax.vmap(jsp.log3)(R))


def test_fk_and_jacobians(models):
    jm, tm = models
    q = _rand_q(np.random.default_rng(1), 6)
    tq = torch.tensor(q)
    jkin = jax.vmap(lambda a: jk.fk(jm, a))(q)
    tkin = tk.fk(tm, tq)
    for a, b in zip(tkin, jkin):
        close(a, b)
    R, p = tk.frame_placements(tm, tkin)
    jR, jp = jax.vmap(lambda k: jk.frame_placements(jm, k))(jkin)
    close(R, jR)
    close(p, jp)
    close(tk.contact_positions(tm, tkin), jax.vmap(lambda k: jk.contact_positions(jm, k))(jkin))
    close(tk.contact_jacobians(tm, tkin), jax.vmap(lambda k: jk.contact_jacobians(jm, k))(jkin))
    close(tk.link_com_jacobians(tm, tkin),
          jax.vmap(lambda k: jk.link_com_jacobians(jm, k))(jkin))
    v = np.random.default_rng(2).standard_normal((6, 3))
    close(tk._skew_batch(torch.tensor(v)), jk._skew_batch(v))


def test_fk_tangents_match_custom_jvp(models):
    """torch.func.jvp through the plain chain == the JAX closed-form custom JVP."""
    jm, tm = models
    rng = np.random.default_rng(3)
    q, v = _rand_q(rng, 4), rng.standard_normal((4, 16))

    def jf(a):
        kin = jk.fk(jm, a)
        return (jc.centroidal_momentum_matrix(jm, kin), jk.contact_jacobians(jm, kin),
                jk.link_com_jacobians(jm, kin))

    def tf(a):
        kin = tk.fk(tm, a)
        return (tc.centroidal_momentum_matrix(tm, kin), tk.contact_jacobians(tm, kin),
                tk.link_com_jacobians(tm, kin))

    ref = jax.jit(jax.vmap(lambda a, b: jax.jvp(jf, (a,), (b,))[1]))(q, v)
    got = torch.func.jvp(tf, (torch.tensor(q),), (torch.tensor(v),))[1]
    for a, b in zip(got, ref):
        close(a, b)


def test_centroidal(models):
    jm, tm = models
    x, u = _rand_xu(np.random.default_rng(4), 6)
    tx, tu = torch.tensor(x), torch.tensor(u)
    jkin = jax.vmap(lambda a: jk.fk(jm, a))(x[:, 6:])
    tkin = tk.fk(tm, tx[:, 6:])
    close(tc.com_position(tm, tkin), jax.vmap(lambda k: jc.com_position(jm, k))(jkin))
    A = tc.centroidal_momentum_matrix(tm, tkin)
    jA = jax.vmap(lambda k: jc.centroidal_momentum_matrix(jm, k))(jkin)
    close(A, jA)
    rhs = np.random.default_rng(5).standard_normal((6, 6, 4))
    close(tc.base_block_solve(tm, A[..., :6], torch.tensor(rhs)),
          jax.vmap(lambda a, b: jc.base_block_solve(jm, a[:, :6], b))(jA, rhs))
    close(tc.flow_map(tm, tx, tu), jax.vmap(lambda a, b: jc.flow_map(jm, a, b))(x, u))
    close(tc.base_velocity_from_momentum(tm, tkin, tx[:, :6], tu[:, 12:]),
          jax.vmap(lambda k, h, v: jc.base_velocity_from_momentum(jm, k, h, v))(
              jkin, x[:, :6], u[:, 12:]))
