"""The SLQ/DDP solver (``solver/ddp.py``) and its rollout integrators
(``solver/rollout.py``, ``sqp.rk2_step``) on CPU tensors against the JAX
package's.

Integrators, float64 at 1e-10 (relative to max(1, |x|)): RK2, RK4 and
ODE45 (``rollout_step``; for ODE45 also the slots' accepted flags and the
end time of ``_dopri_substeps``) at tests/test_rollout.py's walking state
over four intervals: 0.1 s from the 0.015 s first step (three accepted
slots), 0.3 s from a 0.3 s first step (rejected slots), 0.5 s from a 0.5 s
first step (the slots end short of the interval, the RK4 finish covers the
rest; ODE45 there at 1e-7: one-ulp moves of x move JAX's own result by
2.1e-8), and the DDP's own 0.8 / 53 s.  float32: the accepted slots equal
JAX float32's on the rejecting case.

The DDP's pieces on its own data (the stance problem of tests/test_ddp.py
at 5 knots over 0.075 s, float64, warm-started from the port's SQP): the
projection (B2's plain version with d = 0, the pivoting Gram inverse and
hess_reg 1e-5) and ``backward_scan`` against ddp.py:118-153's formulas
assembled from JAX's ``gj_inverse`` and ``riccati.backward_scan`` at 1e-9;
``closed_rollout_plain`` (every integrator, closed and open loop) against
a loop of JAX ``rollout_step`` + ``stage_cost_value`` + ``eq_constraints``
per step size at 1e-10.

The slice as a whole: JAX ``ddp.solve`` under ``jax.disable_jit()`` (its
SoA linearization does not compile on the CPU in reasonable time), once,
n_iterations=2, alphas (1.0, 0.25), RK2, against the port's ``ddp.solve``
on the same inputs: states, inputs, cost and violation at 1e-8,
step_size exactly (~100 s of this file's time).  A float32 run of
``entry.ddp_solve`` on the CPU flagship (53 knots over 0.8 s, trot)
checks tests/test_ddp.py's properties.  The ``slow`` twin of
tests/test_rollout.py::test_ddp_solves_with_ode45 holds the port's ODE45
solve to JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build
from hunter_bipedal_control_tpu.models.centroidal import flow_map as jflow_map
from hunter_bipedal_control_tpu.models.robot import load_model as jload_model
from hunter_bipedal_control_tpu.ocp import problem as jocp
from hunter_bipedal_control_tpu.ops.linalg import gj_inverse as jgj_inverse
from hunter_bipedal_control_tpu.solver import ddp as jddp
from hunter_bipedal_control_tpu.solver import riccati as jric
from hunter_bipedal_control_tpu.solver import rollout as jro
from hunter_bipedal_control_tpu.solver import sqp as jsqp
from hunter_bipedal_control_tpu_torch import convert, entry
from hunter_bipedal_control_tpu_torch.gait import mode_schedule as tms
from hunter_bipedal_control_tpu_torch.models import centroidal as tcentroidal
from hunter_bipedal_control_tpu_torch.models.robot import load_model
from hunter_bipedal_control_tpu_torch.ocp import soa_kernel
from hunter_bipedal_control_tpu_torch.refs import targets as ttg
from hunter_bipedal_control_tpu_torch.solver import ddp as tddp
from hunter_bipedal_control_tpu_torch.solver import riccati as tric
from hunter_bipedal_control_tpu_torch.solver import rollout as tro
from hunter_bipedal_control_tpu_torch.solver import sqp as tsqp

F64 = torch.float64
N, HORIZON = 5, 0.075
DDP_SETTINGS = dict(n_intervals=N, horizon=HORIZON, n_iterations=2, alphas=(1.0, 0.25))
DJ = [0.10, 0., 0.40, 0.93, 0.53, -0.10, 0., -0.40, 0.93, -0.53]
# (interval, first step): three accepted slots; rejected slots (the first two, then
# every other); the 16 slots spent short of the interval (the RK4 finish covers the
# rest); the DDP's own
INTERVALS = {"walk": (0.1, 0.015), "rejections": (0.3, 0.3), "exhausted": (0.5, 0.5),
             "ddp_interval": (0.8 / 53, 0.8 / 53)}
INTEGRATORS = ("RK2", "RK4", "ODE45")
# the exhausted case's RK4 finish spans 0.19 s in one step: one-ulp moves of x
# move JAX's own ODE45 result by up to 2.1e-8 there (measured on the CPU)
INTEGRATOR_RTOL = {"exhausted": 1e-7}


def _walk(dtype):
    """tests/test_rollout.py's walking state and input (numpy)."""
    m = jload_model(dtype=dtype)
    q = jnp.concatenate([jnp.array([0., 0., 0.63], dtype), jnp.zeros(3, dtype),
                         jnp.array(DJ, dtype)])
    x = jnp.concatenate([jnp.array([0.3, 0.02, 0., 0., 0.01, 0.], dtype), q])
    u = jocp.weight_compensating_input(m, jnp.ones(4, dtype), 22, dtype).at[12:].set(0.3)
    return m, np.asarray(x), np.asarray(u)


def _close(got, ref, rtol):
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= rtol, err


def _jax_ode45(m, x, u, dt, s):
    f = lambda xk: jflow_map(m, xk, jnp.asarray(u))  # noqa: E731
    return jax.jit(lambda x_: (jro.ode45_step(m, x_, jnp.asarray(u), dt, s),
                               jro._dopri_substeps(f, x_, dt, s)))(jnp.asarray(x))


@pytest.mark.parametrize("integrator", INTEGRATORS)
@pytest.mark.parametrize("case", list(INTERVALS))
def test_integrator_matches_jax(case, integrator):
    dt, first = INTERVALS[case]
    jm, x, u = _walk(jnp.float64)
    tm = load_model(device="cpu", dtype=F64)
    js = jro.RolloutSettings(time_step=first, integrator=integrator)
    ts = tro.RolloutSettings(time_step=first, integrator=integrator)
    xt, ut = torch.tensor(x), torch.tensor(u)
    got = tro.rollout_step(tm, xt, ut, dt, ts)
    if integrator == "ODE45":
        ref, (_, t_end, accepted) = _jax_ode45(jm, x, u, dt, js)
        f = lambda xk: tcentroidal.flow_map(tm, xk, ut)  # noqa: E731
        _, t_got, acc_got = tro._dopri_substeps(f, xt, dt, ts)
        np.testing.assert_array_equal(acc_got.numpy(), np.asarray(accepted))
        _close(t_got, t_end, 1e-10)
        assert bool(accepted[0]) == (case in ("walk", "ddp_interval"))
        assert (float(t_end) < dt - 0.1) == (case == "exhausted")
    else:
        ref = jro.rollout_step(jm, jnp.asarray(x), jnp.asarray(u), dt, js)
    _close(got, ref, INTEGRATOR_RTOL.get(case, 1e-10) if integrator == "ODE45" else 1e-10)


def test_rollout_step_refuses_unknown_integrator():
    tm = load_model(device="cpu", dtype=F64)
    _, x, u = _walk(jnp.float64)
    with pytest.raises(ValueError):
        tro.rollout_step(tm, torch.tensor(x), torch.tensor(u), 0.015,
                         tro.RolloutSettings(integrator="EULER"))


def test_ode45_float32_accepted_slots_match_jax():
    dt, first = INTERVALS["rejections"]
    jm, x, u = _walk(jnp.float32)
    tm = load_model(device="cpu", dtype=torch.float32)
    ref, (_, _, accepted) = _jax_ode45(jm, x, u, dt, jro.RolloutSettings(time_step=first))
    got, n_acc = tro.ode45_step(tm, torch.tensor(x), torch.tensor(u), dt,
                                tro.RolloutSettings(time_step=first), with_accepted=True)
    assert int(n_acc) == int(np.asarray(accepted).sum()) and not bool(accepted[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the DDP on its own data
# ---------------------------------------------------------------------------


def _stance_flagship(dtype):
    """tests/test_ddp.py's problem on the port: standing at z = 0.63 on the
    nominal joints, the stance gait, a zero command."""
    flag = entry.build_flagship(N, HORIZON, device="cpu", dtype=dtype)
    x0 = flag.x0[0]
    target = ttg.cmd_vel_to_target(torch.zeros(4, dtype=dtype), x0, 0.0, HORIZON,
                                   ttg.default_cmd_vel_config(nj=10, device="cpu", dtype=dtype))
    return flag._replace(schedule=tms.tile_template(tms.STANCE_GAIT("cpu", dtype), -HORIZON,
                                                    3 * HORIZON), target=target)


@pytest.fixture(scope="module")
def port_run():
    """The port's DDP solve of the stance problem in float64, every
    iteration's data captured."""
    flag = _stance_flagship(F64)
    its = []
    run = entry.ddp_solve(flag, tddp.DdpSettings(**DDP_SETTINGS), on_iteration=its.append)
    return flag, run, its


@pytest.fixture(scope="module")
def jax_problem():
    m, _, params, *_ = _build(N, HORIZON, jnp.float64)
    return m, params


def _jax_refs(refs):
    return jsqp.ReferenceBundle(**{f: jnp.asarray(getattr(refs, f)[0].numpy())
                                   for f in jsqp.ReferenceBundle._fields})


@pytest.fixture(scope="module")
def jax_solution(port_run, jax_problem):
    """JAX ``ddp.solve`` from the port's warm start, eagerly, once."""
    flag, run, _ = port_run
    m, params = jax_problem
    with jax.disable_jit():
        return jddp.solve(m, jddp.DdpSettings(**DDP_SETTINGS), params, _jax_refs(run.refs),
                          jnp.asarray(flag.x0[0].numpy()), jnp.asarray(run.warm.states[0].numpy()),
                          jnp.asarray(run.warm.inputs[0, :-1].numpy()))


def test_ddp_projection_and_backward_pass_match_jax(port_run):
    """ddp.py:118-153 written from JAX's pieces on the first iteration's
    linearization: the port's B2 plain version (d = 0) and backward_scan."""
    _, _, its = port_run
    it = its[0]
    (_, A, B, _, qx, qu, Qxx, Quu, Qux, g, C, D, gmask) = (t[0].numpy() for t in it["lin"])
    st = jddp.DdpSettings(**DDP_SETTINGS)
    nu = 22
    eye_u = jnp.eye(nu)

    def project(A_, B_, qx_, qu_, Qxx_, Quu_, Qux_, g_, C_, D_, m_):
        DDt = D_ @ D_.T + jnp.diag(1.0 - m_) + st.proj_reg * jnp.eye(D_.shape[0])
        Dp = D_.T @ jgj_inverse(DDt)
        P = eye_u - Dp @ D_
        E = -Dp @ C_
        e = -Dp @ g_
        Qe = Quu_ @ e + qu_
        qx_t = qx_ + E.T @ Qe + Qux_.T @ e
        qw = P @ Qe
        Qxx_t = Qxx_ + E.T @ Quu_ @ E + E.T @ Qux_ + Qux_.T @ E
        sigma = 1.0 + jnp.trace(Quu_) / nu
        Qww = P @ Quu_ @ P + sigma * (eye_u - P) + st.hess_reg * eye_u
        Qwx = P @ (Quu_ @ E + Qux_)
        return A_ + B_ @ E, B_ @ P, qx_t, qw, Qxx_t, Qww, Qwx, E, e, P

    ref = jax.jit(jax.vmap(project))(A, B, qx, qu, Qxx, Quu, Qux, g, C, D, gmask)
    lq = it["lq"]
    got = (lq.A[0], lq.B[0], lq.qx[0], lq.qw[0], lq.Qxx[0], lq.Qww[0], lq.Qwx[0], it["E"][0],
           it["e"][0], it["P"][0])
    for a, b in zip(got, ref):
        _close(a, b, 1e-9)
    assert not lq.d.any()
    jlq = jric.StageLQ(A=ref[0], B=ref[1], d=jnp.zeros((N, 22)), Qxx=ref[4], Qww=ref[5],
                       Qwx=ref[6], qx=ref[2], qw=ref[3])
    Kw, kw, _, _ = jax.jit(lambda l: jric.backward_scan(l, jnp.zeros((22, 22)), jnp.zeros(22),
                                                        st.hess_reg))(jlq)
    _close(it["Kw"][0], Kw, 1e-9)
    _close(it["kw"][0], kw, 1e-9)
    _close(it["Ks"][0], ref[7] + jnp.einsum("kij,kjl->kil", ref[9], Kw), 1e-9)
    _close(it["kffs"][0], ref[8] + jnp.einsum("kij,kj->ki", ref[9], kw), 1e-9)


@pytest.mark.parametrize("loop", ["closed", "open"])
@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_closed_rollout_plain_matches_jax(port_run, jax_problem, integrator, loop):
    """ddp.py:78-96 (and the re-roll, :189-194) per step size: JAX's
    rollout_step, stage_cost_value and eq_constraints knot by knot."""
    flag, run, its = port_run
    m, params = jax_problem
    it = its[0]
    st = tddp.DdpSettings(**DDP_SETTINGS, integrator=integrator)
    rs = tddp.rollout_settings(st)
    alphas = torch.tensor(st.alphas, dtype=F64)
    Ks, kffs = (it["Ks"], it["kffs"]) if loop == "closed" else (None, None)
    got = tddp.closed_rollout_plain(flag.model, flag.params, run.refs, flag.x0, it["xs"],
                                    it["us"], Ks, kffs, alphas, rs)
    js = jro.RolloutSettings(**rs._asdict())
    refs = _jax_refs(run.refs)
    dt = HORIZON / N

    @jax.jit
    def knot(x, u, k):
        c = jocp.stage_cost_value(m, params, x, u, refs.x_nom[k], refs.contact_flags[k],
                                  refs.foot_pos_ref[k], refs.foot_vel_ref[k]) * dt
        g, mask = jocp.eq_constraints(m, params, x, u, refs.contact_flags[k],
                                      refs.foot_pos_ref[k], refs.foot_vel_ref[k])
        return c, jnp.abs(g * mask).sum(), jro.rollout_step(m, x, u, dt, js)

    xb, ub = it["xs"][0].numpy(), it["us"][0].numpy()
    for a, alpha in enumerate(st.alphas if loop == "closed" else (0.0,)):
        x = jnp.asarray(flag.x0[0].numpy())
        xs, us, cs, gs = [], [], [], []
        for k in range(N):
            u = jnp.asarray(ub[k])
            if loop == "closed":
                u = u + alpha * kffs[0, k].numpy() + Ks[0, k].numpy() @ (x - xb[k])
            c, gsum, x_next = knot(x, u, k)
            xs.append(x)
            us.append(u)
            cs.append(c)
            gs.append(gsum)
            x = x_next
        xs.append(x)
        _close(got[0][0, a], jnp.stack(xs), 1e-10)
        _close(got[1][0, a], jnp.stack(us), 1e-10)
        _close(got[2][0, a], jnp.stack(cs).sum(), 1e-10)
        _close(got[3][0, a], jnp.stack(gs).sum() / N, 1e-10)
    assert got[4].dtype == torch.int32 and (got[4] > 0).all() == (integrator == "ODE45")


def test_ddp_solve_matches_jax(port_run, jax_solution):
    """The slice as a whole: two SLQ iterations from the same warm start."""
    _, run, _ = port_run
    sol, ref = run.solution, jax_solution
    for f in ("states", "inputs", "cost", "constraint_violation"):
        _close(getattr(sol, f)[0], getattr(ref, f), 1e-8)
    assert float(sol.step_size[0]) == float(ref.step_size)
    assert float(sol.step_size[0]) == 1.0


def test_ddp_solve_flagship_float32():
    """tests/test_ddp.py's properties through ``entry.ddp_solve`` on the
    CPU flagship (trot, 0.25 m/s) in float32, two iterations."""
    flag = entry.build_flagship(53, 0.8, device="cpu")
    settings = tddp.DdpSettings(n_iterations=2)
    sol = entry.ddp_solve(flag, settings).solution
    assert torch.isfinite(sol.states).all()
    assert float(sol.step_size) >= 0.5
    assert float(sol.constraint_violation) < 1e-3
    dt = settings.horizon / settings.n_intervals
    defects = sol.states[:, 1:] - tsqp.rk2_step(flag.model, sol.states[:, :-1],
                                                sol.inputs[:, :-1], dt)
    assert float(defects.abs().max()) < 1e-4
    assert float((sol.states[..., 8] - 0.63).abs().max()) < 0.05
    fz = float(sol.inputs[0, 0, 2:12:3].sum())
    np.testing.assert_allclose(fz, 12.5869 * 9.81, rtol=0.15)


def test_cpu_ddp_launches_no_kernel(port_run):
    """On CPU tensors every wrapper of the path runs its plain version."""
    flag, run, its = port_run
    counters = (tddp.closed_rollout, tsqp.project_knot, tric.riccati_solve,
                soa_kernel.soa_linearize)
    before = [c.launches for c in counters]
    st = tddp.DdpSettings(**DDP_SETTINGS)
    it = its[0]
    args = (flag.model, flag.params, run.refs, flag.x0, it["xs"], it["us"], it["Ks"], it["kffs"],
            torch.tensor(st.alphas, dtype=F64), tddp.rollout_settings(st))
    for a, b in zip(tddp.closed_rollout(*args), tddp.closed_rollout_plain(*args)):
        assert torch.equal(a, b)
    tddp.solve(flag.model, st._replace(n_iterations=1), flag.params, run.refs, flag.x0,
               run.warm.states, run.warm.inputs[:, :-1])
    assert [c.launches for c in counters] == before


def test_ddp_refuses_bad_settings(port_run):
    flag, run, _ = port_run
    with pytest.raises(ValueError):
        entry.ddp_solve(flag, tddp.DdpSettings())          # 53 knots, the flagship has 5
    with pytest.raises(ValueError):
        tddp.solve(flag.model, tddp.DdpSettings(**DDP_SETTINGS, integrator="EULER"),
                   flag.params, run.refs, flag.x0, run.warm.states, run.warm.inputs[:, :-1])


def test_convert_ddp_settings():
    d = jddp.DdpSettings(alphas=(1.0, 0.25), integrator="ODE45", max_substeps=4)
    got = convert.from_numpy(jax.tree.map(np.asarray, d), "cpu")
    assert got == tddp.DdpSettings(alphas=(1.0, 0.25), integrator="ODE45", max_substeps=4)
    r = jro.RolloutSettings(time_step=0.02)
    assert convert.from_numpy(jax.tree.map(np.asarray, r), "cpu") == tro.RolloutSettings(
        time_step=0.02)


@pytest.mark.slow
def test_ddp_solves_with_ode45_matches_jax():
    """tests/test_rollout.py::test_ddp_solves_with_ode45 (float32, stance,
    from the initializer, ODE45 with 4 slots) on both sides, the JAX
    references converted: states, inputs and cost to 1e-3 of scale, step
    size equal.  slow tier: the JAX solve is a multi-minute CPU compile."""
    from hunter_bipedal_control_tpu.gait import mode_schedule as jms
    from hunter_bipedal_control_tpu.refs import swing_planner as jswp
    from hunter_bipedal_control_tpu.refs import targets as jtg
    from hunter_bipedal_control_tpu.solver import mpc as jmpc

    dtype = jnp.float32
    m = jload_model(dtype=dtype)
    settings = jsqp.SqpSettings(n_intervals=N, horizon=HORIZON, lin_backend="dense")
    dj = jnp.array(DJ, dtype)
    qnom = jnp.concatenate([jnp.array([0., 0., 0.63], dtype), jnp.zeros(3, dtype), dj])
    params = jocp.make_input_cost(m, jocp.default_ocp_params(m, dtype), qnom)
    x0 = jnp.concatenate([jnp.zeros(6, dtype), qnom])
    sched = jms.tile_template(jms.STANCE_GAIT(), -1.0, 4.0)
    target = jtg.cmd_vel_to_target(jnp.zeros(4, dtype), x0, 0.0, HORIZON,
                                   jtg.default_cmd_vel_config(dtype=dtype))
    bundle, _, _, _ = jmpc.prepare_references(
        m, settings, jswp.default_swing_config(dtype), jswp.init_planner_state(dtype), sched,
        target, 0.0, x0, jnp.zeros(6, dtype), dj)
    xs0, us0 = jsqp.initializer_trajectories(m, settings, bundle, x0)
    dset = jddp.DdpSettings(n_intervals=N, horizon=HORIZON, integrator="ODE45",
                            max_substeps=4, alphas=(1.0, 0.25))
    ref = jddp.solve(m, dset, params, bundle, x0, xs0, us0)

    tm = convert.from_numpy(jax.tree.map(np.asarray, m), "cpu")
    tp = convert.from_numpy(jax.tree.map(np.asarray, params), "cpu")
    trefs = tsqp.ReferenceBundle(*(torch.tensor(np.asarray(a))[None] for a in bundle))
    T = lambda a: torch.tensor(np.asarray(a))[None]  # noqa: E731
    sol = tddp.solve(tm, convert.from_numpy(jax.tree.map(np.asarray, dset), "cpu"), tp, trefs,
                     T(x0), T(xs0), T(us0))
    assert torch.isfinite(sol.states).all() and torch.isfinite(sol.cost).all()
    for f in ("states", "inputs", "cost"):
        _close(getattr(sol, f)[0], getattr(ref, f), 1e-3)
    assert float(sol.step_size[0]) == float(ref.step_size)
