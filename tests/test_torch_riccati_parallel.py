"""The port's parallel-in-time Riccati (B5's plain version) and the
``riccati_parallel=True`` solve against the JAX package, on the CPU.

- ``_stage_elements``, ``_combine``, ``backward_associative`` and
  ``forward_associative`` in float64 on tests/test_riccati.py's random LQ
  (N=25, nx=8, nu=5) and on a 22x22, N=53 one: the plain version is the JAX
  algorithm (Newton-Schulz solves, the same odd/even scan tree), so only
  roundoff separates them: max |port - JAX| <= 1e-9 max |JAX| per output.
- The ``exact`` variant (Cholesky and LU solves) against JAX
  ``backward_scan(use_ns=False)`` at tests/test_riccati.py's tolerances.
- ``sqp.solve`` through ``mpc_step`` with ``riccati_parallel=True`` against
  JAX (``lin_backend='dense'``) at B=3, N=8, cold and warm, float64, 1e-8,
  with the port's ``lin_backend`` 'soa' (default) and 'dense'.
- A 3-solve ``mpc_chain`` in each Riccati mode against a JAX loop of
  ``mpc_step`` at N=8, float64, 1e-8.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build
from hunter_bipedal_control_tpu.gait import mode_schedule as jms
from hunter_bipedal_control_tpu.solver import mpc as jmpc
from hunter_bipedal_control_tpu.solver import riccati as jric
from hunter_bipedal_control_tpu_torch.entry import build_flagship, mpc_chain
from hunter_bipedal_control_tpu_torch.gait import mode_schedule as tms
from hunter_bipedal_control_tpu_torch.solver import mpc as tmpc
from hunter_bipedal_control_tpu_torch.solver import riccati as tric

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_riccati import _random_lq  # noqa: E402

RTOL = 1e-9
B, N, HORIZON = 3, 8, 0.24


def close(got, ref, rtol=RTOL):
    """max |got - ref| <= rtol * max |ref| (the output's own scale)."""
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref))
    assert err <= rtol * max(np.max(np.abs(ref)), 1e-300), (err, np.max(np.abs(ref)))


def to_port(lq):
    """JAX StageLQ (knots leading) -> port StageLQ with a batch dim of 1."""
    return tric.StageLQ(*(torch.tensor(np.asarray(a))[None] for a in lq))


CASES = {"small": dict(N=25, nx=8, nu=5, seed=0), "product": dict(N=53, nx=22, nu=22, seed=2)}


@pytest.fixture(scope="module", params=list(CASES))
def lq(request):
    return _random_lq(**CASES[request.param])


@pytest.mark.parametrize("mm", ["mxu", "vpu"])
def test_stage_elements_match_jax(lq, mm):
    ref = jax.jit(lambda l: jric._stage_elements(l, 1e-6, mm=mm))(lq)
    got = tric._stage_elements(to_port(lq), 1e-6, mm=mm)
    for a, b in zip(got, ref):
        close(a[0], b)


def test_combine_matches_jax(lq):
    els = jric._stage_elements(lq, 1e-6, mm="vpu")
    e1 = jax.tree.map(lambda a: a[:-1], els)
    e2 = jax.tree.map(lambda a: a[1:], els)
    ref = jax.jit(jax.vmap(jric._combine))(e2, e1)
    t = [torch.tensor(np.asarray(a)) for a in els]
    got = tric._combine([a[1:] for a in t], [a[:-1] for a in t])
    for a, b in zip(got, ref):
        close(a, b)


@pytest.mark.parametrize("mm", ["mxu", "vpu"])
def test_backward_associative_matches_jax(lq, mm):
    nx = lq.A.shape[-1]
    S0, s0 = np.zeros((nx, nx)), np.zeros(nx)
    ref = jax.jit(lambda l: jric.backward_associative(l, S0, s0, 1e-6, mm=mm))(lq)
    got = tric.backward_associative(to_port(lq), torch.zeros(1, nx, nx, dtype=torch.float64),
                                    torch.zeros(1, nx, dtype=torch.float64), 1e-6, mm=mm)
    for a, b in zip(got, ref):
        close(a[0], b)


def test_forward_associative_matches_jax(lq):
    rng = np.random.default_rng(1)
    Nk, nx = lq.A.shape[0], lq.A.shape[-1]
    A_cl = np.asarray(lq.A) * 0.5
    b_cl = rng.standard_normal((Nk, nx))
    dx0 = rng.standard_normal(nx)
    ref = jax.jit(jric.forward_associative)(A_cl, b_cl, dx0)
    got = tric.forward_associative(*(torch.tensor(a)[None] for a in (A_cl, b_cl, dx0)))
    close(got[0], ref)


def test_exact_matches_sequential_lu():
    """The exact variant is the float64 yardstick: JAX's sequential scan with
    LU solves, at tests/test_riccati.py's tolerances."""
    lq = _random_lq()
    nx = lq.A.shape[1]
    K1, k1, S1, s1 = jric.backward_scan(lq, jnp.zeros((nx, nx)), jnp.zeros(nx), 0.0,
                                        use_ns=False)
    K2, k2, S2, s2 = tric.backward_associative(
        to_port(lq), torch.zeros(1, nx, nx, dtype=torch.float64),
        torch.zeros(1, nx, dtype=torch.float64), 0.0, exact=True)
    np.testing.assert_allclose(S2[0].numpy(), np.asarray(S1), atol=1e-9)
    np.testing.assert_allclose(s2[0].numpy(), np.asarray(s1), atol=1e-10)
    np.testing.assert_allclose(K2[0].numpy(), np.asarray(K1), atol=5e-4)
    np.testing.assert_allclose(k2[0].numpy(), np.asarray(k1), atol=5e-4)


def test_exact_gives_nan_on_indefinite_qww():
    """A failed Cholesky writes NaN, as JAX's NaN factor does: the element of
    the bad knot, every suffix composite that holds it, and the rollout."""
    lq = _random_lq(N=10)
    Qww = np.array(lq.Qww)
    Qww[6] = -np.eye(Qww.shape[-1])
    tlq = to_port(lq._replace(Qww=jnp.asarray(Qww)))
    nx, nu = lq.A.shape[-1], lq.B.shape[-1]
    z = torch.zeros
    E, P, e = z(1, 10, nu, nx, dtype=torch.float64), z(1, 10, nu, nu, dtype=torch.float64), \
        z(1, 10, nu, dtype=torch.float64)
    Ks, kffs, dxs, dus = tric.riccati_solve_parallel_plain(tlq, E, P, e, z(1, nx, dtype=torch.float64),
                                                           1e-6, exact=True)
    bad_k = torch.isnan(Ks[0]).any(-1).any(-1)
    assert bad_k[:6].all() and not bad_k[7:].any()
    assert torch.isnan(dxs[0, 1:]).all() and torch.isnan(dus).all()


# ---------------------------------------------------------------------------
# the riccati_parallel=True solve through mpc_step, and the chain
# ---------------------------------------------------------------------------


def _jax_setup(n_knots, horizon):
    m, settings, params, pcfg, dj, x0, _, target = _build(n_knots, horizon, jnp.float64,
                                                           lin_backend="dense")
    sched = jms.tile_template(jms.make_template(["L", "R"], [0.0, 0.3, 0.6], jnp.float64),
                              -horizon, 4 * horizon)
    return m, settings._replace(riccati_parallel=True), params, pcfg, dj, x0, sched, target


def _port_flagship(batch, n_knots, horizon, lin_backend="soa"):
    flag = build_flagship(n_knots, horizon, batch=batch, device="cpu", dtype=torch.float64,
                          lin_backend=lin_backend)
    return flag._replace(schedule=tms.tile_template(tms.TROT_GAIT("cpu", torch.float64),
                                                    -horizon, 4 * horizon))


@pytest.fixture(scope="module")
def parallel_steps():
    m, settings, params, pcfg, dj, x0, sched, target = _jax_setup(N, HORIZON)
    xs = jnp.tile(x0[None], (B, 1)) + 0.001 * jnp.arange(B, dtype=x0.dtype)[:, None]
    st0 = jmpc.init_mpc_state(m, settings, dtype=jnp.float64)
    st0 = jax.tree.map(lambda a: jnp.broadcast_to(a, (B, *jnp.shape(a))), st0)
    f = jax.jit(jax.vmap(lambda st, x: jmpc.mpc_step(m, settings, params, pcfg, st, sched,
                                                     target, 0.0, x, jnp.zeros(6, x.dtype),
                                                     dj)))
    jcold = f(st0, xs)
    jwarm = f(jcold[1], xs)

    port = {}
    for lin_backend in ("soa", "dense"):
        flag = _port_flagship(B, N, HORIZON, lin_backend)
        mpc = tmpc.Mpc(flag.model, flag.settings._replace(riccati_parallel=True), flag.params,
                       flag.planner_cfg)
        args = (flag.schedule, flag.target, 0.0, flag.x0, torch.zeros(6, dtype=torch.float64),
                flag.default_joints)
        tcold = mpc(flag.state, *args)
        twarm = mpc(tcold[1], *args)
        port[lin_backend] = (tcold, twarm)
    return (jcold, jwarm), port


@pytest.mark.parametrize("lin_backend", ["soa", "dense"])
@pytest.mark.parametrize("which", [0, 1], ids=["cold", "warm"])
def test_parallel_mpc_step_matches_jax_f64(parallel_steps, which, lin_backend):
    jsol = parallel_steps[0][which][0]
    tsol = parallel_steps[1][lin_backend][which][0]
    np.testing.assert_allclose(tsol.states.numpy(), np.asarray(jsol.states), atol=1e-8)
    np.testing.assert_allclose(tsol.inputs.numpy(), np.asarray(jsol.inputs), atol=1e-8,
                               rtol=1e-8)
    np.testing.assert_allclose(tsol.cost.numpy(), np.asarray(jsol.cost), atol=1e-8, rtol=1e-8)
    np.testing.assert_allclose(tsol.constraint_violation.numpy(),
                               np.asarray(jsol.constraint_violation), atol=1e-8)
    np.testing.assert_array_equal(tsol.step_size.numpy(), np.asarray(jsol.step_size))


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
def test_mpc_chain_matches_jax_loop(parallel):
    """bench.py's chained solve: each solve from the cold state, fed the
    previous solution's states[1]."""
    K = 3
    m, settings, params, pcfg, dj, x0, sched, target = _jax_setup(N, HORIZON)
    settings = settings._replace(riccati_parallel=parallel)
    st = jmpc.init_mpc_state(m, settings, dtype=jnp.float64)
    one = jax.jit(lambda x: jmpc.mpc_step(m, settings, params, pcfg, st, sched, target, 0.0, x,
                                          jnp.zeros(6, x.dtype), dj)[0])
    x, jcosts, jstates = x0, [], [x0]
    for _ in range(K):
        sol = one(x)
        x = sol.states[1]
        jcosts.append(sol.cost)
        jstates.append(x)

    chain = mpc_chain(_port_flagship(1, N, HORIZON), K, riccati_parallel=parallel)
    assert chain.costs.shape == (K, 1) and chain.states.shape == (K + 1, 1, 22)
    assert len(chain.seconds) == K
    np.testing.assert_allclose(chain.costs[:, 0].numpy(), np.asarray(jcosts), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(chain.states[:, 0].numpy(), np.asarray(jstates), atol=1e-8)


def test_cpu_parallel_solve_launches_no_kernel():
    before = (tric.riccati_solve.launches, tric.riccati_solve_parallel.launches)
    lq = to_port(_random_lq(N=6, nx=22, nu=22, seed=4))
    z = torch.zeros(1, 6, 22, 22, dtype=torch.float64)
    args = (lq, z, z, torch.zeros(1, 6, 22, dtype=torch.float64),
            torch.ones(1, 22, dtype=torch.float64), 1e-6)
    got = tric.riccati_solve_parallel(*args)
    ref = tric.riccati_solve_parallel_plain(*args)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert (tric.riccati_solve.launches, tric.riccati_solve_parallel.launches) == before == (0, 0)
