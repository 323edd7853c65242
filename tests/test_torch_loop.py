"""The port's dummy closed loop and its gait upkeep, on the CPU.

- ``compact_schedule``, ``insert_template``, ``vel_abs_update``,
  ``walk_gait_switch`` and ``extend_schedule`` against the JAX package over a
  stance -> trot -> stance command sequence, float64, 0.25 s between
  updates so that the window compacts and re-tiles: event times, modes and
  gait levels equal (not close), the velocity history within 1e-12.  JAX
  runs op by op there (see the test).
- ``filter_cmd_vel`` and ``dummy_step`` against JAX, float64, 1e-10.
- ``convert.from_numpy`` carries a JAX loop state across.
- The port's float32 loop (``entry.build_loop`` + ``run_loop``, sequential
  Riccati, the plain versions: the JAX algorithm) held to the recorded
  40-period golden trace, tests/golden/stance_walk_40p.npz, with the checks
  of tests/test_golden.py:53-64.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunter_bipedal_control_tpu.backends import dummy as jdummy
from hunter_bipedal_control_tpu.gait import adaptive as jad, mode_schedule as jms
from hunter_bipedal_control_tpu.refs import targets as jtg
from hunter_bipedal_control_tpu.runtime import loop as jloop
from hunter_bipedal_control_tpu.solver import sqp as jsqp
from hunter_bipedal_control_tpu_torch import convert
from hunter_bipedal_control_tpu_torch.backends import dummy as tdummy
from hunter_bipedal_control_tpu_torch.entry import build_loop, run_loop
from hunter_bipedal_control_tpu_torch.gait import adaptive as tad, mode_schedule as tms
from hunter_bipedal_control_tpu_torch.models.robot import load_model
from hunter_bipedal_control_tpu_torch.refs import targets as ttg
from hunter_bipedal_control_tpu_torch.runtime import loop as tloop

F64 = torch.float64
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "stance_walk_40p.npz")
DJ = [0.10, 0., 0.40, 0.93, 0.53, -0.10, 0., -0.40, 0.93, -0.53]


def t64(a):
    return torch.tensor(np.asarray(a, np.float64))


def assert_schedule_equal(tsched, jsched):
    np.testing.assert_array_equal(tsched.event_times[0].numpy(), np.asarray(jsched.event_times))
    np.testing.assert_array_equal(tsched.modes[0].numpy(), np.asarray(jsched.modes))


@pytest.mark.parametrize("fixed", [False, True], ids=["adaptive", "fixed_flying_trot"])
def test_gait_upkeep_matches_jax(fixed):
    """The loop's per-period gait upkeep (vel_abs_update -> walk_gait_switch
    -> extend_schedule), with compact_schedule and insert_template also
    checked alone on each period's schedule.  ``fixed``: the /gait_type
    toggle analog, fixed_gait_switch and extend_schedule with the flying
    trot template (level 3)."""
    x0 = np.concatenate([np.zeros(6), [0., 0., 0.63], np.zeros(3), DJ])
    jcfg = jtg.default_cmd_vel_config(dtype=jnp.float64)
    tcfg = ttg.default_cmd_vel_config(device="cpu", dtype=F64)
    cmds = np.zeros((90, 4))
    cmds[10:30, 0] = 0.3
    cmds[20:30, 3] = 0.4

    jstate = jad.init_gait_run_state(jnp.float64)
    tstate = tad.init_gait_run_state(1, "cpu", F64)
    assert_schedule_equal(tstate.schedule, jstate.schedule)
    # JAX op by op: under jit, XLA folds chained constant additions (t + 0.13
    # + 0.1 -> t + 0.23) and moves some event times by an ulp
    j_vel, j_walk, j_ext = jad.vel_abs_update, jad.walk_gait_switch, jad.extend_schedule
    j_compact = jms.compact_schedule
    t_walk, t_ext = tad.walk_gait_switch, tad.extend_schedule
    walk_level = 1
    if fixed:
        jfly, tfly = jms.FLYING_TROT_GAIT(), tms.FLYING_TROT_GAIT("cpu")
        walk_level = 3

        def j_walk(st, v, t0, t1):
            return jad.fixed_gait_switch(st, v, t0, t1, jfly, 3)

        def t_walk(st, v, t0, t1):
            return tad.fixed_gait_switch(st, v, t0, t1, tfly, 3)

        def j_ext(st, t0, t1):
            return jad.extend_schedule(st, t0, t1, template=jfly)

        def t_ext(st, t0, t1):
            return tad.extend_schedule(st, t0, t1, template=tfly)

    def j_insert(s, t):
        return jad.insert_template(s, jms.TROT_GAIT(), t + 0.13, t + 5.0)

    jlast, tlast = jnp.zeros(4), torch.zeros(1, 4, dtype=F64)
    levels = []
    for k in range(cmds.shape[0]):
        t = jnp.asarray(0.25 * k, jnp.float64)  # a strong float64, as the loop's clock
        tt = torch.full((1,), 0.25 * k, dtype=F64)
        jcmd = jtg.filter_cmd_vel(jnp.asarray(cmds[k]), jlast, jcfg)
        tcmd = ttg.filter_cmd_vel(t64(cmds[k])[None], tlast, tcfg)
        jtgt = jtg.cmd_vel_to_target(jcmd, jnp.asarray(x0), t, 0.8, jcfg)
        ttgt = ttg.cmd_vel_to_target(tcmd, t64(x0)[None], tt, 0.8, tcfg)

        assert_schedule_equal(tms.compact_schedule(tstate.schedule, tt - 1.0),
                              j_compact(jstate.schedule, t - 1.0))
        assert_schedule_equal(
            tad.insert_template(tstate.schedule, tms.TROT_GAIT("cpu"), tt + 0.13, tt + 5.0),
            j_insert(jstate.schedule, t))

        jstate, jvel = j_vel(jstate, jcmd, jtgt.states[0])
        tstate, tvel = tad.vel_abs_update(tstate, tcmd, ttgt.states[:, 0])
        np.testing.assert_allclose(tvel.numpy(), [float(jvel)], rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(tstate.vel_history[0].numpy(), np.asarray(jstate.vel_history),
                                   rtol=1e-12, atol=1e-15)
        assert int(tstate.hist_count[0]) == int(jstate.hist_count)
        jstate = j_walk(jstate, jvel, t, t + 10.0)
        tstate = t_walk(tstate, tvel, tt, tt + 10.0)
        assert int(tstate.gait_level[0]) == int(jstate.gait_level)
        assert_schedule_equal(tstate.schedule, jstate.schedule)
        jstate = j_ext(jstate, t, t + 1.6)
        tstate = t_ext(tstate, tt, tt + 1.6)
        assert_schedule_equal(tstate.schedule, jstate.schedule)
        jlast, tlast = jcmd, tcmd
        levels.append(int(jstate.gait_level))
    # the sequence crosses stance -> walking -> stance
    assert levels[0] == 0 and walk_level in levels and levels[-1] == 0


def test_template_tools_match_jax():
    """tile_template with a lead phase, rotate_template and scale_template on
    every shipped gait."""
    for jt, tt in ((jms.STANCE_GAIT(), tms.STANCE_GAIT("cpu")),
                   (jms.TROT_GAIT(), tms.TROT_GAIT("cpu")),
                   (jms.STANDING_TROT_GAIT(), tms.STANDING_TROT_GAIT("cpu")),
                   (jms.FLYING_TROT_GAIT(), tms.FLYING_TROT_GAIT("cpu"))):
        for j in range(int(jt.n_modes)):
            jr = jms.scale_template(jms.rotate_template(jt, j), jnp.float64(1.3))
            tr = tms.scale_template(tms.rotate_template(tt, torch.tensor([j])),
                                    torch.tensor([1.3], dtype=F64))
            np.testing.assert_array_equal(tr.switching_times[0].numpy(),
                                          np.asarray(jr.switching_times))
            np.testing.assert_array_equal(tr.modes[0].numpy(), np.asarray(jr.modes))
            js = jms.tile_template(jr, 0.7, 6.0, lead_until=0.85)
            ts = tms.tile_template(tr, torch.tensor([0.7], dtype=F64),
                                   torch.tensor([6.0], dtype=F64),
                                   lead_until=torch.tensor([0.85], dtype=F64))
            assert_schedule_equal(ts, js)


def test_filter_cmd_vel_matches_jax():
    rng = np.random.default_rng(3)
    cmd, last = rng.standard_normal((2, 16, 4)) * 0.1
    jcfg = jtg.default_cmd_vel_config(dtype=jnp.float64)
    tcfg = ttg.default_cmd_vel_config(device="cpu", dtype=F64)
    ref = jax.vmap(lambda c, l_: jtg.filter_cmd_vel(c, l_, jcfg))(cmd, last)
    got = ttg.filter_cmd_vel(t64(cmd), t64(last), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-10)
    assert (got == 0).any()  # the deadband is exercised


def test_dummy_step_matches_jax(hunter_model):
    rng = np.random.default_rng(4)
    x0 = np.concatenate([np.zeros(6), [0., 0., 0.63], np.zeros(3), DJ])
    xs = x0 + 0.01 * rng.standard_normal((3, 22))
    us = rng.standard_normal((3, 22))
    us[:, 0:12] *= 30.0
    jst = jax.vmap(lambda x, u: jdummy.dummy_step(hunter_model, jdummy.init_dummy_plant(x, 0.1),
                                                  u, 0.002))(jnp.asarray(xs), jnp.asarray(us))
    tst = tdummy.dummy_step(load_model(device="cpu", dtype=F64),
                            tdummy.init_dummy_plant(t64(xs), 0.1), t64(us), 0.002)
    np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tst.t.numpy(), np.asarray(jst.t), rtol=1e-10, atol=1e-10)


def test_loop_state_from_jax(hunter_model_f32):
    """convert.from_numpy carries the JAX loop state across: the JAX cold
    state, batched to 1, equals the port's own."""
    x0 = jnp.concatenate([jnp.zeros(6), jnp.array([0., 0., 0.63]), jnp.zeros(3),
                          jnp.array(DJ)]).astype(jnp.float32)
    jst = jloop.init_loop_state(hunter_model_f32, jsqp.SqpSettings(), x0)
    conv = convert.from_numpy(jax.tree.map(lambda a: np.asarray(a)[None], jst), "cpu",
                              torch.float32)
    own = build_loop("cpu", torch.float32).state
    assert isinstance(conv, tloop.LoopState)
    flat_c, flat_o = [], []

    def leaves(tup, out):
        for v in tup:
            if hasattr(v, "_fields"):
                leaves(v, out)
            else:
                out.append(v)

    leaves(conv, flat_c)
    leaves(own, flat_o)
    assert len(flat_c) == len(flat_o)
    for a, b in zip(flat_c, flat_o):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def golden_run():
    ref = np.load(GOLDEN)
    _, telem = run_loop(build_loop("cpu", torch.float32), ref["cmds"])
    return ref, telem


def test_loop_holds_golden_trace(golden_run):
    """tests/test_golden.py's checks on the port's float32 CPU loop."""
    ref, telem = golden_run
    x = telem["x"][:, 0].numpy()
    assert x.shape == ref["x"].shape
    np.testing.assert_array_equal(telem["gait_level"][:, 0].numpy(), ref["gait_level"])
    np.testing.assert_allclose(x[:, 8], ref["x"][:, 8], atol=5e-3)
    np.testing.assert_allclose(x[:, 0:2], ref["x"][:, 0:2], atol=2e-2)
    np.testing.assert_allclose(x[:, 12:], ref["x"][:, 12:], atol=3e-2)
    assert np.median(telem["violation"].numpy()) <= 2 * max(np.median(ref["violation"]), 1e-4)


def test_loop_telemetry(golden_run):
    """Telemetry as the JAX loop's: per period t, base_z, cost, violation,
    alpha, gait_level and x, finite, the clock at 10 ms per period."""
    ref, telem = golden_run
    P = ref["x"].shape[0]
    assert sorted(telem) == sorted(["t", "base_z", "cost", "violation", "alpha", "gait_level",
                                    "x"])
    for k, v in telem.items():
        assert v.shape[:2] == (P, 1), k
        assert torch.isfinite(v.double()).all(), k
    np.testing.assert_allclose(telem["t"][:, 0].numpy(), 0.01 * np.arange(P), atol=1e-5)
    assert (telem["alpha"] > 0).all()
