"""The port's MPC step as a whole, and the package boundary.

``mpc_step`` at the BENCH_QUICK shape (B=3 scenarios, N=8 knots, 0.24 s,
trot, 0.25 m/s) against the JAX ``mpc_step`` with ``lin_backend='dense'``
under ``jax.vmap``: a cold step, then a warm step from each side's own new
state.  float64: states, inputs and cost to 1e-8, step_size exactly, with
the port's ``lin_backend`` 'soa' (its default) and 'dense' (the two give
the same outputs in JAX, tests/test_soa.py).
float32: both sides in float32 as ``_build`` makes the problem; states to
2e-3, inputs to 0.1 (forces reach ~70 N), cost to 2e-3, step_size exactly
(measured on the CPU: 2.6e-4, 2.3e-2 and 7.4e-5 on the cold step).

``_build`` tiles the float32 TROT template even at float64, and JAX's weak
typing then keeps the swing windows in float32 while the rest runs in
float64.  The float64 comparison tiles a float64 template on both sides, so
that it compares the two algorithms at one precision.
"""
import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build
from hunter_bipedal_control_tpu.gait import mode_schedule as jms
from hunter_bipedal_control_tpu.solver import mpc as jmpc
from hunter_bipedal_control_tpu_torch import convert
from hunter_bipedal_control_tpu_torch.entry import build_flagship
from hunter_bipedal_control_tpu_torch.gait import mode_schedule as tms
from hunter_bipedal_control_tpu_torch.models.robot import load_model
from hunter_bipedal_control_tpu_torch.ocp import soa_kernel
from hunter_bipedal_control_tpu_torch.ops import linalg as tlinalg
from hunter_bipedal_control_tpu_torch.solver import mpc as tmpc, riccati as tric, sqp as tsqp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N, HORIZON = 3, 8, 0.24
F32_STATE_ATOL, F32_INPUT_ATOL, F32_COST_ATOL = 2e-3, 0.1, 2e-3


def _jax_steps(dtype, f64_template, B=B, N=N, HORIZON=HORIZON):
    """JAX cold and warm steps, one compile (state batched on both calls)."""
    m, settings, params, pcfg, dj, x0, sched, target = _build(
        N, HORIZON, dtype, lin_backend="dense")
    if f64_template:
        sched = jms.tile_template(jms.make_template(["L", "R"], [0.0, 0.3, 0.6], jnp.float64),
                                  -HORIZON, 4 * HORIZON)
    xs = jnp.tile(x0[None], (B, 1)) + 0.001 * jnp.arange(B, dtype=x0.dtype)[:, None]
    st0 = jmpc.init_mpc_state(m, settings, dtype=dtype)
    st0 = jax.tree.map(lambda a: jnp.broadcast_to(a, (B, *jnp.shape(a))), st0)

    def one(st, x):
        return jmpc.mpc_step(m, settings, params, pcfg, st, sched, target, 0.0, x,
                             jnp.zeros(6, x.dtype), dj)

    f = jax.jit(jax.vmap(one))
    cold = f(st0, xs)
    warm = f(cold[1], xs)
    return (m, params, pcfg, sched, target), cold, warm


@pytest.fixture(scope="module")
def jax_steps():
    return _jax_steps(jnp.float64, f64_template=True)


def port_steps(dtype, f64_template=False, B=B, N=N, HORIZON=HORIZON, lin_backend="soa"):
    flag = build_flagship(N, HORIZON, batch=B, device="cpu", dtype=dtype, lin_backend=lin_backend)
    if f64_template:
        flag = flag._replace(schedule=tms.tile_template(tms.TROT_GAIT("cpu", torch.float64),
                                                        -HORIZON, 4 * HORIZON))
    mpc = tmpc.Mpc(flag.model, flag.settings, flag.params, flag.planner_cfg)
    args = (flag.schedule, flag.target, 0.0, flag.x0, torch.zeros(6, dtype=dtype),
            flag.default_joints)
    cold = mpc(flag.state, *args)
    warm = mpc(cold[1], *args)
    return flag, cold, warm


def close(got, ref, atol, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def test_flagship_inputs_match_jax_build(jax_steps):
    (m, params, pcfg, _, target), _, _ = jax_steps
    sched = _build(N, HORIZON, jnp.float64, lin_backend="dense")[6]
    flag = build_flagship(N, HORIZON, batch=B, device="cpu", dtype=torch.float64)
    for tup, ref in ((flag.params, params), (flag.planner_cfg, pcfg), (flag.target, target),
                     (flag.schedule, sched)):
        conv = convert.from_numpy(jax.tree.map(np.asarray, ref), "cpu", torch.float64)
        for name in tup._fields:
            a, b = getattr(tup, name), getattr(conv, name)
            if torch.is_tensor(a):
                np.testing.assert_allclose(a.double().numpy(), b.double().numpy(), rtol=1e-12,
                                           atol=1e-15)


@pytest.mark.parametrize("lin_backend", ["soa", "dense"])
@pytest.mark.parametrize("which", ["cold", "warm"])
def test_mpc_step_matches_jax_f64(jax_steps, which, lin_backend):
    _, jcold, jwarm = jax_steps
    _, tcold, twarm = port_steps(torch.float64, f64_template=True, lin_backend=lin_backend)
    (jsol, _, jb), (tsol, _, tb) = (jcold, tcold) if which == "cold" else (jwarm, twarm)
    for name in tb._fields:
        close(getattr(tb, name), getattr(jb, name), atol=1e-8)
    close(tsol.states, jsol.states, atol=1e-8)
    close(tsol.inputs, jsol.inputs, atol=1e-8, rtol=1e-8)
    close(tsol.cost, jsol.cost, atol=1e-8, rtol=1e-8)
    close(tsol.constraint_violation, jsol.constraint_violation, atol=1e-8)
    np.testing.assert_array_equal(tsol.step_size.numpy(), np.asarray(jsol.step_size))


def test_mpc_step_matches_jax_product_shape():
    """The product shape (one scenario, 53 knots over 0.8 s: 6 IK samples)."""
    _, (jsol, _, _), _ = _jax_steps(jnp.float64, True, B=1, N=53, HORIZON=0.8)
    _, (tsol, _, _), _ = port_steps(torch.float64, True, B=1, N=53, HORIZON=0.8)
    close(tsol.states, jsol.states, atol=1e-8)
    close(tsol.inputs, jsol.inputs, atol=1e-8, rtol=1e-8)
    close(tsol.cost, jsol.cost, atol=1e-8, rtol=1e-8)
    np.testing.assert_array_equal(tsol.step_size.numpy(), np.asarray(jsol.step_size))


def test_warm_step_from_converted_jax_state(jax_steps):
    """convert.from_numpy carries the JAX MpcState (planner + warm start)
    across: the port's warm step from JAX's cold state is JAX's warm step."""
    _, (_, jstate, _), (jwarm, _, _) = jax_steps
    flag, _, _ = port_steps(torch.float64, f64_template=True)
    state = convert.from_numpy(jax.tree.map(np.asarray, jstate), "cpu", torch.float64)
    assert state.has_ws.dtype == torch.bool and bool(state.has_ws.all())
    sol, _, _ = tmpc.mpc_step(flag.model, flag.settings, flag.params, flag.planner_cfg, state,
                              flag.schedule, flag.target, 0.0, flag.x0,
                              torch.zeros(6, dtype=torch.float64), flag.default_joints)
    close(sol.states, jwarm.states, atol=1e-8)
    close(sol.inputs, jwarm.inputs, atol=1e-8, rtol=1e-8)
    close(sol.cost, jwarm.cost, atol=1e-8, rtol=1e-8)


def test_mpc_step_f32_matches_jax_f32():
    """The flagship exactly as _build makes it, in float32 on both sides."""
    _, jcold, jwarm = _jax_steps(jnp.float32, f64_template=False)
    _, tcold, twarm = port_steps(torch.float32)
    for (jsol, _, _), (tsol, _, _) in ((jcold, tcold), (jwarm, twarm)):
        close(tsol.states, jsol.states, atol=F32_STATE_ATOL)
        close(tsol.inputs, jsol.inputs, atol=F32_INPUT_ATOL)
        close(tsol.cost, jsol.cost, atol=F32_COST_ATOL)
        np.testing.assert_array_equal(tsol.step_size.numpy(), np.asarray(jsol.step_size))


def test_evaluate_policy_interpolates():
    _, (sol, _, _), _ = port_steps(torch.float64)
    t = sol.times[:, 2:4].clone()
    x, u = tmpc.evaluate_policy(sol, t)
    np.testing.assert_allclose(x.numpy(), sol.states[:, 2:4].numpy(), atol=1e-12)
    np.testing.assert_allclose(u.numpy(), sol.inputs[:, 2:4].numpy(), atol=1e-12)


# ---------------------------------------------------------------------------
# boundary
# ---------------------------------------------------------------------------


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import hunter_bipedal_control_tpu_torch as p\n"
        "for mod in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(mod.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'hunter_bipedal_control_tpu' or m.startswith('hunter_bipedal_control_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py drives the port only: no JAX and no JAX-package import."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    roots = {name.split(".")[0] for name in names}
    assert "hunter_bipedal_control_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "hunter_bipedal_control_tpu", "__graft_entry__"}


def test_asset_is_byte_identical():
    paths = [os.path.join(REPO, pkg, "assets", "hunter_model.json")
             for pkg in ("hunter_bipedal_control_tpu", "hunter_bipedal_control_tpu_torch")]
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: device=None is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_flagship(N, HORIZON, batch=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model()


def test_cpu_step_launches_no_kernel():
    counters = (tlinalg.gj_inverse, tsqp.project_knot, tric.riccati_solve,
                soa_kernel.soa_linearize, soa_kernel.soa_merit)
    before = [c.launches for c in counters]
    port_steps(torch.float32)
    assert [c.launches for c in counters] == before == [0, 0, 0, 0, 0]
