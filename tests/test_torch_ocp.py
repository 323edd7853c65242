"""Port parity: ocp/ (penalties, OCP weights, dense knot linearization and
stage merit) against the JAX package in float64 on the CPU, rtol 1e-9, in
all four contact modes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunter_bipedal_control_tpu.models.robot import load_model as jload
from hunter_bipedal_control_tpu.ocp import penalties as jpen, problem as jocp
from hunter_bipedal_control_tpu_torch import convert
from hunter_bipedal_control_tpu_torch.ocp import penalties as tpen, problem as tocp

F64 = torch.float64
DJ = np.array([0.10, 0., 0.40, 0.93, 0.53, -0.10, 0., -0.40, 0.93, -0.53])
RTOL = 1e-9
FLAGS = ([1, 1, 1, 1], [0, 0, 0, 0], [1, 0, 1, 0], [0, 1, 0, 1])
DT = 0.015


def close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(1.0, np.abs(ref).max()))


def tnp(tree):
    return convert.from_numpy(jax.tree.map(np.asarray, tree), "cpu", F64)


@pytest.fixture(scope="module")
def setup():
    jm = jload(dtype=jnp.float64)
    qnom = jnp.asarray(np.concatenate([[0., 0., 0.63], np.zeros(3), DJ]))
    jp = jocp.make_input_cost(jm, jocp.default_ocp_params(jm, jnp.float64), qnom)
    return jm, jp, tnp(jm), tnp(jp), qnom


def _knots(flags, n=4, seed=0):
    """n random knots in one contact mode (the shapes of test_solver_wbc.py)."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(0, 0.2, (n, 6)), rng.normal(0, 0.05, (n, 3)) + [0, 0, 0.63],
                        rng.normal(0, 0.1, (n, 3)), DJ + rng.normal(0, 0.1, (n, 10))], axis=1)
    u = rng.normal(0, 20.0, (n, 22))
    fl = np.tile(np.asarray(flags, np.float64), (n, 1))
    fpr = rng.normal(0, 0.3, (n, 4, 3))
    fvr = rng.normal(0, 0.3, (n, 4, 3))
    return x, u, x + 0.01, fl, fpr, fvr


def test_penalties():
    h = np.linspace(-3.0, 8.0, 23)
    for mu, delta in ((0.1, 5.0), (1.0, 0.1)):
        for a, b in zip(tpen.relaxed_barrier(torch.tensor(h), mu, delta),
                        jpen.relaxed_barrier(h, mu, delta)):
            close(a, b)
        for a, b in zip(tpen.double_sided_relaxed_barrier(torch.tensor(h), -1.0, 2.0, mu, delta),
                        jpen.double_sided_relaxed_barrier(h, -1.0, 2.0, mu, delta)):
            close(a, b)
    for a, b in zip(tpen.quadratic(torch.tensor(h), 20.0), jpen.quadratic(h, 20.0)):
        close(a, b)


def test_params_and_input_cost(setup):
    jm, jp, tm, tp, qnom = setup
    own = tocp.make_input_cost(tm, tocp.default_ocp_params(tm, F64), torch.tensor(np.asarray(qnom)))
    for name in tp._fields[:-1]:
        close(getattr(own, name), getattr(jp, name))
        close(getattr(tp, name), getattr(jp, name))
    assert own.collision is None and tp.collision is None
    for flags in FLAGS:
        fl = np.asarray(flags, np.float64)
        close(tocp.weight_compensating_input(tm, torch.tensor(fl), 22, F64),
              jocp.weight_compensating_input(jm, fl, 22, jnp.float64))


@pytest.mark.parametrize("flags", FLAGS, ids=["stance", "fly", "left", "right"])
def test_knot_linearization_fused(setup, flags):
    jm, jp, tm, tp, _ = setup
    args = _knots(flags)
    ref = jax.jit(jax.vmap(lambda *a: jocp.knot_linearization_fused(jm, jp, *a, DT)))(*args)
    got = tocp.knot_linearization_fused(tm, tp, *map(torch.tensor, args), DT)
    assert len(got) == len(ref) == 13
    for a, b in zip(got, ref):
        close(a, b)


@pytest.mark.parametrize("flags", FLAGS, ids=["stance", "fly", "left", "right"])
def test_stage_merit_and_rows(setup, flags):
    jm, jp, tm, tp, _ = setup
    x, u, xn, fl, fpr, fvr = _knots(flags, seed=1)
    ref = jax.jit(jax.vmap(lambda *a: jocp.stage_merit_fused(jm, jp, *a, DT)))(
        x, u, xn, fl, fpr, fvr)
    t = [torch.tensor(a) for a in (x, u, xn, fl, fpr, fvr)]
    got = tocp.stage_merit_fused(tm, tp, *t, DT)
    for a, b in zip(got, ref):
        close(a, b)
    ref_rows = jax.jit(jax.vmap(lambda *a: jocp.combined_rows(jm, jp, *a)))(x, u, fl, fpr, fvr)
    got_rows = tocp.combined_rows(tm, tp, t[0], t[1], t[3], t[4], t[5])
    for a, b in zip(got_rows, ref_rows):
        close(a, b)
