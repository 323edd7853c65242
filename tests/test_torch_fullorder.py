"""The port's full-order plant (``backends/fullorder.py``) against the JAX
package's, on the CPU in float64.

- ``sim_step`` on CPU tensors (the command ring and ``substeps_plain``:
  the contact law, the PD motor, ``mass_matrix_and_nle``, the 16x16
  Gauss-Jordan solve, semi-implicit Euler over 8 substeps) chained tick by tick from the same state under the
  same commands as JAX's ``sim_step``: the standing robot of the sim loop;
  seeded sweep states with the feet on both sides of the contact surface
  (``entry.sim_step_batch``), with ``mass_scale`` / ``gravity_delta`` None
  and set per scenario; and a 9 ms delay (``delay_steps`` = 36 substeps)
  over 48 ticks of fresh commands, past the tick where the ring counts as
  filled and the read index wraps.  q, v, base_acc and the contact forces
  agree to 1e-9 on their own scale, t, the ring and its head exactly.
- ``synth_imu`` to 1e-12; a B=2 batch equals two B=1 runs; on CPU tensors
  ``sim_step`` is the ring plus ``substeps_plain`` and launches nothing;
  ``mass_matrix_and_nle`` equals ``mass_matrix`` and ``nle`` to 1e-12; the
  system matrix M + diag(armature + dt damping), which the kernel
  eliminates without pivoting, stays positive definite; the ring's
  reference behaviour (the current command for the first 36 ticks, then
  the one of 4 ticks before); ``convert.from_numpy`` carries SimParams and
  SimState across.

The kernel (B11) is held to ``substeps_plain`` on the card by
tests/test_torch_cuda.py (marker ``cuda``), which also checks that the
wrapper refuses CUDA tensors of the wrong dtype or shape.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunter_bipedal_control_tpu.backends import fullorder as jfo
from hunter_bipedal_control_tpu.runtime.controller import JointCommand as JCmd
from hunter_bipedal_control_tpu_torch import convert
from hunter_bipedal_control_tpu_torch.backends import fullorder as tfo
from hunter_bipedal_control_tpu_torch.entry import build_sim_loop, sim_step_batch
from hunter_bipedal_control_tpu_torch.models.dynamics import mass_matrix, mass_matrix_and_nle, nle
from hunter_bipedal_control_tpu_torch.runtime.controller import JointCommand

F64 = torch.float64
TOL = 1e-9
FIELDS = ("q", "v", "base_acc", "contact_forces")


def own_scale(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def jax_params(p: tfo.SimParams, **knobs):
    """JAX SimParams from the port's (0-d leaves; knobs given separately)."""
    vals = {f: (jnp.asarray(getattr(p, f).numpy()) if torch.is_tensor(getattr(p, f))
                else getattr(p, f)) for f in p._fields}
    vals.update(gravity_delta=None, mass_scale=None)
    vals.update(knobs)
    return jfo.SimParams(**vals)


def jax_state(st: tfo.SimState, b: int):
    arrays = {f: jnp.asarray(getattr(st, f)[b].numpy()) for f in
              ("q", "v", "t", "base_acc", "contact_forces", "cmd_buffer")}
    return jfo.SimState(**arrays, buf_head=jnp.asarray(int(st.buf_head[b]), jnp.int32))


def jax_cmd(c: JointCommand):
    return JCmd(*(jnp.asarray(t.numpy()) for t in c))


def stack_states(states):
    return jfo.SimState(*(jnp.stack(f) for f in zip(*states)))


def assert_state_matches(tst: tfo.SimState, jst, tick):
    """A batched port state against JAX states stacked on axis 0."""
    for f in FIELDS:
        err = own_scale(getattr(tst, f).numpy(), getattr(jst, f))
        assert err <= TOL, (tick, f, err)
    np.testing.assert_allclose(tst.t.numpy(), np.asarray(jst.t), rtol=1e-15, atol=0)
    np.testing.assert_array_equal(tst.buf_head.numpy(), np.asarray(jst.buf_head))
    np.testing.assert_array_equal(tst.cmd_buffer.numpy(), np.asarray(jst.cmd_buffer))


def standing_case():
    """The sim loop's cold plant at z = 0.624 under a PD hold at the nominal joints."""
    setup = build_sim_loop("cpu", F64)
    st = setup.state.plant
    zeros = torch.zeros((1, 10), dtype=F64)
    cmd = JointCommand(setup.default_joints[None].clone(), zeros, torch.full_like(zeros, 40.0),
                       torch.full_like(zeros, 2.0), zeros)
    return setup.model, setup.sim_params, st, cmd


def run_both(model, tparams, st, cmds, jparams_of, knobs=None):
    """Chain len(cmds) ticks through the port and through a vmapped JAX
    sim_step (per-scenario knobs as vmapped arguments), checking each tick."""
    jm = load_jax_model()
    B = st.q.shape[0]
    kn = knobs or {}

    def one(s, c, *k):
        return jfo.sim_step(jm, jparams_of(**dict(zip(kn, k))), s, c)

    step = jax.jit(jax.vmap(one))
    jst = stack_states([jax_state(st, b) for b in range(B)])
    kargs = [jnp.asarray(v.numpy()) for v in kn.values()]
    for i, cmd in enumerate(cmds):
        st = tfo.sim_step(model, tparams, st, cmd)
        jst = step(jst, jax_cmd(cmd), *kargs)
        assert_state_matches(st, jst, i)
    return st


_JM = {}


def load_jax_model():
    if "m" not in _JM:
        from hunter_bipedal_control_tpu.models.robot import load_model as jload

        _JM["m"] = jload(dtype=jnp.float64)
    return _JM["m"]


def test_standing_matches_jax():
    model, params, st, cmd = standing_case()
    run_both(model, params, st, [cmd] * 3, lambda: jax_params(params))


@pytest.mark.parametrize("knobs", [False, True], ids=["knobs_none", "mass_scale_gravity_delta"])
def test_sweep_states_match_jax(knobs):
    """Sweep states with the feet on both sides of the contact surface, no
    delay; the domain knobs None, or set per scenario."""
    sb = sim_step_batch(4, "cpu", F64, seed=11, delay_ms=0.0)
    params = sb.params
    if not knobs:
        params = params._replace(mass_scale=None, gravity_delta=None)
    dec = []
    active = tfo._push_command(params, sb.state, sb.command)[2]
    tfo.substeps_plain(sb.model, params, sb.state.q, sb.state.v, active, decisions=dec)
    contact = torch.stack(dec).any(0)
    assert contact.any() and not contact.all()
    kn = ({"mass_scale": sb.params.mass_scale, "gravity_delta": sb.params.gravity_delta}
          if knobs else None)
    run_both(sb.model, params, sb.state, [sb.command] * 3,
             lambda **k: jax_params(params, **k), kn)


def test_delay_ring_matches_jax_over_48_ticks():
    """delay_steps = 36 (9 ms at 0.25 ms substeps) over 48 ticks of fresh
    commands from an empty ring: the fill test flips at tick 36 and the read
    index wraps."""
    sb = sim_step_batch(2, "cpu", F64, seed=12, delay_ms=9.0)
    params = sb.params._replace(mass_scale=None, gravity_delta=None)
    assert params.delay_steps == 36
    st = tfo.init_sim_state(sb.state.q, sb.state.v)
    g = torch.Generator().manual_seed(7)
    cmds = [JointCommand(sb.command.pos_des + 0.02 * torch.randn(2, 10, generator=g, dtype=F64),
                         *sb.command[1:]) for _ in range(48)]
    run_both(sb.model, params, st, cmds, lambda: jax_params(params))


def test_delay_ring_reference_behaviour():
    """The ring advances once per tick and is read at (head - delay_steps)
    % 32 with delay_steps in substeps: with 36, the first 36 ticks act on
    the current command, then on the command of 4 ticks before (8 ms)."""
    params = tfo.default_sim_params("cpu", F64, delay_ms=9.0)
    st = tfo.init_sim_state(torch.zeros(1, 16, dtype=F64))
    seen = []
    for tick in range(48):
        c = torch.full((1, 10), float(tick), dtype=F64)
        buf, head, active = tfo._push_command(params, st, JointCommand(c, c, c, c, c))
        seen.append(int(active[0, 0, 0]))
        st = st._replace(cmd_buffer=buf, buf_head=head)
    assert seen == list(range(36)) + [t - 4 for t in range(36, 48)]


def test_synth_imu_matches_jax():
    sb = sim_step_batch(4, "cpu", F64, seed=13)
    st = sb.state._replace(base_acc=torch.randn(4, 6, generator=torch.Generator().manual_seed(1),
                                                dtype=F64))
    quat, om, acc = tfo.synth_imu(sb.model, st)
    jm = load_jax_model()
    for b in range(4):
        jq, jom, jacc = jfo.synth_imu(jm, jax_state(st, b))
        for a, r in ((quat[b], jq), (om[b], jom), (acc[b], jacc)):
            assert own_scale(a.numpy(), r) <= 1e-12


def test_batch_equals_single_runs():
    sb = sim_step_batch(2, "cpu", F64, seed=14)
    both = tfo.sim_step(sb.model, sb.params, sb.state, sb.command)
    for b in range(2):
        pick = lambda t: t[b:b + 1]
        params = sb.params._replace(mass_scale=pick(sb.params.mass_scale),
                                    gravity_delta=pick(sb.params.gravity_delta))
        one = tfo.sim_step(sb.model, params, tfo.SimState(*(pick(t) for t in sb.state)),
                                 JointCommand(*(pick(t) for t in sb.command)))
        for f in tfo.SimState._fields:
            a, r = getattr(both, f)[b:b + 1], getattr(one, f)
            assert torch.allclose(a, r, rtol=1e-13, atol=1e-13), f


def test_sim_step_takes_plain_version_on_cpu():
    sb = sim_step_batch(3, "cpu", torch.float32, seed=15)
    before = tfo.sim_step.launches
    got = tfo.sim_step(sb.model, sb.params, sb.state, sb.command)
    assert tfo.sim_step.launches == before
    buf, head, active = tfo._push_command(sb.params, sb.state, sb.command)
    q, v, acc, f_c = tfo.substeps_plain(sb.model, sb.params, sb.state.q, sb.state.v, active)
    ref = tfo._next_state(sb.params, sb.state, buf, head, q, v, acc, f_c)
    for f in tfo.SimState._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def test_mass_matrix_and_nle_matches_nle():
    sb = sim_step_batch(3, "cpu", F64, seed=16)
    M, h = mass_matrix_and_nle(sb.model, sb.state.q, sb.state.v)
    assert own_scale(M.numpy(), mass_matrix(sb.model, sb.state.q).numpy()) <= 1e-12
    assert own_scale(h.numpy(), nle(sb.model, sb.state.q, sb.state.v).numpy()) <= 1e-12


@pytest.mark.parametrize("delay_ms", [0.0, 9.0], ids=["no_delay", "delay_9ms"])
def test_system_matrix_stays_positive_definite(delay_ms):
    """A_sys = ms M + diag(armature + dt damping) over every substep of 6
    ticks from the sweep states (feet on both sides of the surface,
    mass_scale in [0.9, 1.1]): its smallest eigenvalue stays positive, so
    the natural-order elimination of the plain version and of B11 meets no
    zero pivot."""
    sb = sim_step_batch(4, "cpu", F64, seed=17, delay_ms=delay_ms)
    st, low = sb.state, math.inf
    for _ in range(6):
        buf, head, active = tfo._push_command(sb.params, st, sb.command)
        mats = []
        out = tfo.substeps_plain(sb.model, sb.params, st.q, st.v, active, a_sys=mats)
        st = tfo._next_state(sb.params, st, buf, head, *out)
        low = min(low, min(float(torch.linalg.eigvalsh(A).min()) for A in mats))
    assert len(mats) == sb.params.substeps
    assert low > 0.0


def test_sim_params_and_state_from_jax():
    jp = jfo.default_sim_params(jnp.float64, delay_ms=9.0)
    tp = convert.from_numpy(jax.tree.map(np.asarray, jp), "cpu", F64)
    own = tfo.default_sim_params("cpu", F64, delay_ms=9.0)
    assert isinstance(tp, tfo.SimParams)
    assert tp.substeps == own.substeps == 8 and tp.delay_steps == own.delay_steps == 36
    for f in tfo.SimParams._fields:
        a, b = getattr(tp, f), getattr(own, f)
        assert (a is None and b is None) or (a == b if isinstance(a, int) else torch.equal(a, b)), f
    q0 = np.concatenate([[0., 0., 0.624], np.zeros(3),
                         [0.10, 0., 0.40, 0.93, 0.53, -0.10, 0., -0.40, 0.93, -0.53]])
    js = jfo.init_sim_state(jnp.asarray(q0))
    ts = convert.from_numpy(jax.tree.map(lambda a: np.asarray(a)[None], js), "cpu", F64)
    mine = tfo.init_sim_state(torch.tensor(q0)[None])
    for f in tfo.SimState._fields:
        a, b = getattr(ts, f), getattr(mine, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
