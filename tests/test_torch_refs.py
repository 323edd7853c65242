"""Port parity: gait/ and refs/ (mode schedule, splines, targets, swing
planner, leg IK) against the JAX package in float64 on the CPU, rtol 1e-9."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunter_bipedal_control_tpu.gait import mode_schedule as jms
from hunter_bipedal_control_tpu.models.robot import load_model as jload
from hunter_bipedal_control_tpu.models.spatial import rotation_zyx as jrot
from hunter_bipedal_control_tpu.refs import ik as jik, splines as jspl
from hunter_bipedal_control_tpu.refs import swing_planner as jswp, targets as jtg
from hunter_bipedal_control_tpu_torch import convert
from hunter_bipedal_control_tpu_torch.gait import mode_schedule as tms
from hunter_bipedal_control_tpu_torch.models.spatial import rotation_zyx as trot
from hunter_bipedal_control_tpu_torch.refs import ik as tik, splines as tspl
from hunter_bipedal_control_tpu_torch.refs import swing_planner as tswp, targets as ttg

F64 = torch.float64
DJ = np.array([0.10, 0., 0.40, 0.93, 0.53, -0.10, 0., -0.40, 0.93, -0.53])
RTOL = 1e-9


def close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(1.0, np.abs(ref).max()))


def tnp(tree, dtype=F64):
    return convert.from_numpy(jax.tree.map(np.asarray, tree), "cpu", dtype)


@pytest.fixture(scope="module")
def problem():
    """Trot schedule + walking target as the flagship builds them."""
    horizon = 0.24
    x0 = np.concatenate([np.zeros(6), [0., 0., 0.63], np.zeros(3), DJ])
    sched = jms.tile_template(jms.TROT_GAIT(), -horizon, 4 * horizon)
    target = jtg.cmd_vel_to_target(jnp.array([0.25, 0.1, 0., 0.3]), jnp.asarray(x0), 0.0,
                                   horizon, jtg.default_cmd_vel_config(dtype=jnp.float64))
    return horizon, x0, sched, target


@pytest.mark.parametrize("gait", ["TROT_GAIT", "STANCE_GAIT"])
def test_tile_template_and_mode_queries(gait):
    # templates are float32 by default on both sides (as _build uses them)
    jt = getattr(jms, gait)()
    tt = getattr(tms, gait)("cpu")
    for a, b in zip(tt, jt):
        close(a, b)
    js = jms.tile_template(jt, -0.8, 3.2)
    ts = tms.tile_template(tt, -0.8, 3.2)
    close(ts.event_times, js.event_times)
    assert torch.equal(ts.modes, torch.tensor(np.asarray(js.modes), dtype=torch.int64))
    # query on both sides of every event and on the padded BIG_TIME tail
    ev = np.asarray(js.event_times)
    t = np.concatenate([ev[ev < 1e8] - 1e-4, ev[ev < 1e8], ev[ev < 1e8] + 1e-4, [-5.0, 7.0]])
    tq = torch.tensor(t)
    assert np.array_equal(tms.phase_index_at_time(ts, tq).numpy(),
                          np.asarray(jax.vmap(lambda a: jms.phase_index_at_time(js, a))(t)))
    ts = tms.ModeSchedule(ts.event_times.to(F64), ts.modes)
    close(tms.contact_flags_at_time(ts, tq, F64),
          jax.vmap(lambda a: jms.contact_flags_at_time(js, a, jnp.float64))(t))
    jw = jms.swing_windows(js, -1.0, 2.0)
    tw = tms.swing_windows(ts, torch.tensor(-1.0, dtype=F64), torch.tensor(2.0, dtype=F64))
    for a, b in zip(tw, jw):
        close(a, b)


def test_splines():
    rng = np.random.default_rng(0)
    times = np.cumsum(rng.uniform(0.05, 0.3, (5, 4)), axis=1)
    pos, vel = rng.standard_normal((5, 4)), rng.standard_normal((5, 4))
    t = np.concatenate([times[:, 0] - 0.1, times[:, 1] + 0.01, times[:, 3] + 0.2,
                        times[:, 2]])
    t = t.reshape(4, 5).T                                                 # (5, 4) queries
    for k in range(4):
        ref = jax.vmap(lambda a, b, c, d: jspl.eval_piecewise(jspl.PiecewiseCubic(a, b, c), d))(
            times, pos, vel, t[:, k])
        got = tspl.eval_piecewise(tspl.PiecewiseCubic(*map(torch.tensor, (times, pos, vel))),
                                  torch.tensor(t[:, k]))
        for a, b in zip(got, ref):
            close(a, b)


def test_targets(problem):
    horizon, x0, _, target = problem
    cfg = jtg.default_cmd_vel_config(dtype=jnp.float64)
    tcfg = tnp(cfg)
    assert np.allclose(tcfg.default_joints.numpy(), DJ)
    assert type(ttg.default_cmd_vel_config(device="cpu")).__name__ == "CmdVelConfig"
    got = ttg.cmd_vel_to_target(torch.tensor([0.25, 0.1, 0., 0.3], dtype=F64),
                                torch.tensor(x0), 0.0, horizon, tcfg)
    for a, b in zip(got, target):
        close(a, b)
    t = np.linspace(-0.1, 0.4, 9)
    tt = tnp(target)
    close(ttg.interp_state(tt, torch.tensor(t)),
          jax.vmap(lambda a: jtg.interp_state(target, a))(t))
    close(ttg.interp_input(tt, torch.tensor(t)),
          jax.vmap(lambda a: jtg.interp_input(target, a))(t))


def test_swing_planner(problem):
    horizon, x0, sched, target = problem
    rng = np.random.default_rng(1)
    B = 3
    init_t = np.array([0.0, 0.07, 0.31])
    feet = rng.normal(0, 0.1, (B, 4, 3)) + [0, 0, 0.02]
    latest = rng.normal(0, 0.1, (B, 4, 3))
    cmd = rng.normal(0, 0.2, (B, 6))
    vmeas = rng.normal(0, 0.2, (B, 3))
    cfg = jswp.default_swing_config(jnp.float64)._replace(
        foothold_vel_fb=jnp.asarray(0.3), foothold_yaw_lead=jnp.asarray(0.1))

    def jone(t0, f, lat, c, vm):
        return jswp.update_planner(cfg, jswp.PlannerState(lat), sched, target, t0,
                                   t0 + horizon, c, f, body_vel_meas=vm)

    jrefs, jst = jax.jit(jax.vmap(jone))(init_t, feet, latest, cmd, vmeas)
    tb = lambda a: torch.tensor(np.asarray(a)).expand(B, *np.shape(a))  # noqa: E731
    tsched = tms.ModeSchedule(*(tb(a) for a in tnp(sched)))
    ttarget = ttg.TargetTrajectories(*(tb(a) for a in tnp(target)))
    trefs, tst = tswp.update_planner(
        tnp(cfg), tswp.PlannerState(torch.tensor(latest)), tsched, ttarget,
        torch.tensor(init_t), torch.tensor(init_t + horizon), torch.tensor(cmd),
        torch.tensor(feet), body_vel_meas=torch.tensor(vmeas))
    for name in ("node_times", "node_pos", "node_vel", "event_times", "window_start",
                 "window_stop", "contact_seq"):
        close(getattr(trefs, name), getattr(jrefs, name))
    close(tst.latest_stance_position, jst.latest_stance_position)

    ts = init_t[:, None] + np.linspace(0.0, horizon, 7)[None]
    got = tswp.foot_reference(trefs, [0, 1, 2, 3], torch.tensor(ts))
    for leg in range(4):
        ref = jax.jit(jax.vmap(jax.vmap(lambda r, t: jswp.foot_reference(r, leg, t),
                                        (None, 0))))(jrefs, ts)
        for a, b in zip(got, ref):
            close(a[..., leg, :], b)
    one = tswp.foot_reference(trefs, 2, torch.tensor(ts))
    close(one[0], got[0][..., 2, :])


def test_compute_ik(problem):
    jm = jload(dtype=jnp.float64)
    tm = tnp(jm)
    rng = np.random.default_rng(3)
    n = 5
    q = np.concatenate([rng.normal(0, 0.02, (n, 3)) + [0, 0, 0.63], rng.normal(0, 0.1, (n, 3)),
                        DJ + rng.normal(0, 0.15, (n, 10))], axis=1)
    des = np.stack([[0.03, 0.11, 0.0], [0.03, -0.11, 0.02]])[None] + rng.normal(0, 0.05, (n, 2, 3))
    zyx = rng.normal(0, 0.1, (n, 3))
    Rd = jax.vmap(jrot)(zyx)
    ref = jax.jit(jax.vmap(lambda a, b, c: jik.compute_ik(jm, a, b, c, trans_it=3, rot_it=2)))(
        q, des, Rd)
    got = tik.compute_ik(tm, torch.tensor(q), torch.tensor(des), trot(torch.tensor(zyx)),
                         trans_it=3, rot_it=2)
    close(got, ref)


def _ik_inputs(problem, B, S, seed):
    """Base poses sampled along the fixture's walking target, warm joints,
    toe targets and target rotations: (poses (B, S, 6), warm (B, nj), des
    (B, S, 2, 3), zyx (B, 3)) as numpy float64."""
    horizon, _, _, target = problem
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, horizon, S)
    states = np.asarray(jax.vmap(lambda a: jtg.interp_state(target, a))(t))
    poses = states[None, :, 6:12] + np.concatenate(
        [rng.normal(0, 0.02, (B, S, 3)), rng.normal(0, 0.1, (B, S, 3))], axis=-1)
    warm = DJ + rng.normal(0, 0.1, (B, 10))
    des = (np.array([[0.03, 0.11, 0.0], [0.03, -0.11, 0.02]]) + poses[..., None, 0:3]
           - [0.0, 0.0, 0.63] + rng.normal(0, 0.04, (B, S, 2, 3)))
    return poses, warm, des, rng.normal(0, 0.1, (B, 3))


@pytest.fixture(scope="module")
def jax_ik():
    """One jit of the JAX IK (trans_it=3, rot_it=2), vmapped over IK_ROWS
    (scenario, sample) rows; both passes and both sample counts run it."""
    jm = jload(dtype=jnp.float64)
    return jm, jax.jit(jax.vmap(lambda q, d, R: jik.compute_ik(jm, q, d, R, trans_it=3,
                                                                 rot_it=2)))


IK_ROWS = 14


@pytest.mark.parametrize("S", [6, 7])
def test_joint_reference_ik_plain(problem, jax_ik, S):
    """The reference prep's two IK passes against the JAX package's
    (solver/mpc.py:89-91): every sample from the warm joints, then every
    sample from its own pass-1 result."""
    jm, ik = jax_ik
    poses, warm, des, zyx = _ik_inputs(problem, 2, S, S)
    n = 2 * S

    def run(q, d, R):
        # rows past n repeat the first ones: one compiled shape for every S
        pad = lambda a: np.concatenate([a, a[:IK_ROWS - n]])
        return np.asarray(ik(pad(q), pad(d), pad(R)))[:n]

    flat = poses.reshape(n, 6), des.reshape(n, 2, 3)
    Rd = np.repeat(np.asarray(jax.vmap(jrot)(zyx)), S, axis=0)
    qj1 = run(np.concatenate([flat[0], np.repeat(warm, S, axis=0)], axis=1), flat[1], Rd)
    ref = qj1, run(np.concatenate([flat[0], qj1], axis=1), flat[1], Rd)
    ref = [r.reshape(2, S, 10) for r in ref]
    got = tik.joint_reference_ik_plain(tnp(jm), torch.tensor(poses), torch.tensor(warm),
                                       torch.tensor(des), trot(torch.tensor(zyx)))
    for a, b in zip(got, ref):
        close(a, b)
    assert not np.allclose(ref[0], ref[1])


def test_joint_reference_ik_takes_plain_version_on_cpu(problem, monkeypatch):
    tm = tnp(jload(dtype=jnp.float64))
    poses, warm, des, zyx = (torch.tensor(a) for a in _ik_inputs(problem, 2, 6, 0))
    R_des = trot(zyx)
    plain = tik.joint_reference_ik_plain(tm, poses, warm, des, R_des)

    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor launched the leg_ik kernel")

    monkeypatch.setattr(tik, "leg_ik", no_kernel)
    got = tik.joint_reference_ik(tm, poses, warm, des, R_des)
    for a, b in zip(got, plain):
        assert a.dtype == F64 and torch.equal(a, b)
