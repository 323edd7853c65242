"""The reference prep (``solver/mpc.py::prepare_references``) on CPU tensors
against the JAX package's, and its routing.

The same numpy-seeded inputs (x_init, the command, the latest stance
positions, a cmd_vel target made at the init time, the swing configuration
with a yaw lead of 0.1 s and a velocity feedback of 0.3) go through JAX
``prepare_references`` under ``jax.jit(jax.vmap(...))`` and through the
port's plain B8b (``swing_plan_plain``, the IK's two passes,
``knot_refs_plain``) on stance, trot and flying-trot schedules, at three
init times: mid-swing, exactly on a gait event (the schedule's own event
time) and near t = 20 s (where the float32 ulp, 1.9e-6, exceeds the
planner's 1e-6 offset); the product shape (B=1, 53 knots over 0.8 s) one
scenario at a time, the bench shape (B=3, 66 knots over 1.0 s) with the
three gaits as three scenarios.  float64: the bundle, the planner state,
the swing node arrays and windows and the IK-modified target to rtol 1e-9
entry by entry (atol 1e-9: the padded phases carry 1e9 s window starts and
swing velocities far above the real ones), the contact flags and every knot's phase
exactly.  float32 against JAX float32 (B=9, the product shape): flags and
phases exactly; the rest absolutely within ~4x what was measured on the
CPU (F32_TOL): times 8e-6 (one float32 ulp at t = 20 s is 1.9e-6, measured
1.9e-6), foot positions 4e-6 (9.6e-7), foot velocities 1e-4 (2.6e-5: at
t = 20 s a 0.05 s spline segment's length carries ~4e-5 relative rounding),
the target's states 4e-6 (6.6e-7), the planner state 4e-6 (3.0e-8) and the
IK's joints 2e-2 (4.5e-3: the IK's rank-3 systems amplify float32
rounding, in x_nom's joints too).  The JAX compiles dominate this file's
time (~20-33 s each on the CPU, three of them).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build
from hunter_bipedal_control_tpu.gait import mode_schedule as jms
from hunter_bipedal_control_tpu.refs import swing_planner as jswp
from hunter_bipedal_control_tpu.refs import targets as jtg
from hunter_bipedal_control_tpu.solver import mpc as jmpc
from hunter_bipedal_control_tpu_torch import convert
from hunter_bipedal_control_tpu_torch.entry import build_flagship
from hunter_bipedal_control_tpu_torch.gait import mode_schedule as tms
from hunter_bipedal_control_tpu_torch.refs import ik as tik
from hunter_bipedal_control_tpu_torch.refs import swing_planner as tswp
from hunter_bipedal_control_tpu_torch.refs import targets as ttg
from hunter_bipedal_control_tpu_torch.solver import mpc as tmpc
from hunter_bipedal_control_tpu_torch.solver import reference_prep as trp

GAITS = {"stance": (["STANCE"], [0.0, 0.5]), "trot": (["L", "R"], [0.0, 0.3, 0.6]),
         "flying_trot": (["L", "FLY", "R", "FLY"], [0.0, 0.15, 0.2, 0.35, 0.4])}
# (base time the schedule is tiled around, offset of init_time; None: the
# first event after base + 0.1)
INITS = {"mid_swing": (0.0, 0.07), "on_event": (0.0, None), "t20": (20.0, 0.13)}
CASES = [(g, i) for i in INITS for g in GAITS]
SHAPES = {"product": (53, 0.8), "bench": (66, 1.0)}
RTOL = 1e-9
F32_TOL = {"times": 8e-6, "foot_pos": 4e-6, "foot_vel": 1e-4, "states": 4e-6, "latest": 4e-6,
           "joints": 2e-2}


def _inputs(n_knots, horizon, dtype, seed=0):
    """JAX-side inputs of every case, stacked over CASES: (model, settings,
    cfg, default joints, per-case (planner state, schedule, target,
    init_time, x_init, command))."""
    m, settings, _, pcfg, dj, x0, _, _ = _build(n_knots, horizon, dtype, lin_backend="dense")
    pcfg = pcfg._replace(foothold_yaw_lead=jnp.asarray(0.1, dtype),
                         foothold_vel_fb=jnp.asarray(0.3, dtype))
    rng = np.random.default_rng(seed)
    cfg = jtg.default_cmd_vel_config(dtype=dtype)
    per = []
    for gait, init in CASES:
        names, times = GAITS[gait]
        base, off = INITS[init]
        sched = jms.tile_template(jms.make_template(names, times, dtype), base - horizon,
                                  base + 4 * horizon)
        ev = np.asarray(sched.event_times)
        t0 = ev[ev > base + 0.1][0] if off is None else np.asarray(base + off, dtype)
        x = np.asarray(x0) + 0.02 * rng.standard_normal(22)
        cmd_vel = np.array([0.25, 0.1, 0.0, 0.3]) + 0.05 * rng.standard_normal(4)
        target = jtg.cmd_vel_to_target(jnp.asarray(cmd_vel, dtype), jnp.asarray(x, dtype),
                                       jnp.asarray(t0, dtype), horizon, cfg)
        per.append((jswp.PlannerState(jnp.asarray(0.1 * rng.standard_normal((4, 3)), dtype)),
                    sched, target, jnp.asarray(t0, dtype), jnp.asarray(x, dtype),
                    jnp.asarray(0.2 * rng.standard_normal(6), dtype)))
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *per)
    return m, settings, pcfg, dj, stacked


def _jax_prep(n_knots, horizon, dtype):
    m, settings, pcfg, dj, batch = _inputs(n_knots, horizon, dtype)

    def one(ps, sched, target, t0, x, cmd):
        return jmpc.prepare_references(m, settings, pcfg, ps, sched, target, t0, x, cmd, dj)

    out = jax.jit(jax.vmap(one))(*batch)
    phases = jax.vmap(lambda s, t: jms.phase_index_at_time(s, t))(batch[1], out[0].times)
    return (pcfg, dj, batch), jax.tree.map(np.asarray, out), np.asarray(phases)


@pytest.fixture(scope="module")
def jax_f64():
    return {name: _jax_prep(n, h, jnp.float64) for name, (n, h) in SHAPES.items()}


def _port_prep(shape, inputs, idx, dtype):
    """The port's plain B8b on cases ``idx`` (a list of indices into CASES):
    (bundle, refs, mod_target, planner state, decisions)."""
    n_knots, horizon = SHAPES[shape]
    pcfg, dj, batch = inputs
    flag = build_flagship(n_knots, horizon, batch=len(idx), device="cpu", dtype=dtype)
    sub = jax.tree.map(lambda a: np.asarray(a)[idx], batch)
    ps, sched, target = (convert.from_numpy(t, "cpu", dtype) for t in sub[:3])
    t0, x, cmd = (torch.as_tensor(a, dtype=dtype) for a in sub[3:])
    cfg = convert.from_numpy(jax.tree.map(np.asarray, pcfg), "cpu", dtype)
    djt = torch.as_tensor(np.array(dj), dtype=dtype).expand(len(idx), -1)
    S = int(horizon / tmpc.JOINT_REF_STEP) + 1
    dec = {}
    plan = tmpc.swing_plan_plain(flag.model, cfg, ps, sched, target, t0, x, cmd, djt, horizon, S,
                                 decisions=dec)
    _, jr = tik.joint_reference_ik_plain(flag.model, plan.poses.contiguous(),
                                         plan.warm.contiguous(), plan.des.contiguous(),
                                         plan.R_des.contiguous())
    bundle, mod = tmpc.knot_refs_plain(sched, plan, t0, horizon, n_knots, jr, decisions=dec)
    return bundle, plan.refs, mod, plan.planner, dec


def _close(got, ref, rtol=RTOL, atol=RTOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def _check_f64(port, ref, phases, idx):
    bundle, refs, mod, planner, dec = port
    rb, rrefs, rmod, rplanner = (jax.tree.map(lambda a: a[idx], r) for r in ref)
    for f in ("times", "x_nom", "foot_pos_ref", "foot_vel_ref"):
        _close(getattr(bundle, f), getattr(rb, f))
    assert np.array_equal(bundle.contact_flags.numpy(), rb.contact_flags)
    assert np.array_equal(dec["knot_phase"].numpy(), phases[idx])
    for f in ("node_times", "node_pos", "node_vel", "event_times", "window_start",
              "window_stop"):
        _close(getattr(refs, f), getattr(rrefs, f))
    assert np.array_equal(refs.contact_seq.numpy(), rrefs.contact_seq)
    for a, b in zip(mod, rmod):
        _close(a, b)
    _close(planner.latest_stance_position, rplanner.latest_stance_position)


@pytest.mark.parametrize("gait,init", CASES, ids=[f"{g}-{i}" for g, i in CASES])
def test_prepare_references_product_shape(jax_f64, gait, init):
    inputs, ref, phases = jax_f64["product"]
    idx = [CASES.index((gait, init))]
    _check_f64(_port_prep("product", inputs, idx, torch.float64), ref, phases, idx)


@pytest.mark.parametrize("init", list(INITS))
def test_prepare_references_bench_shape(jax_f64, init):
    inputs, ref, phases = jax_f64["bench"]
    idx = [CASES.index((g, init)) for g in GAITS]
    _check_f64(_port_prep("bench", inputs, idx, torch.float64), ref, phases, idx)


def test_prepare_references_float32():
    inputs, ref, phases = _jax_prep(*SHAPES["product"], jnp.float32)
    idx = list(range(len(CASES)))
    bundle, _, mod, planner, dec = _port_prep("product", inputs, idx, torch.float32)
    rb, _, rmod, rplanner = ref
    assert np.array_equal(bundle.contact_flags.numpy(), rb.contact_flags)
    assert np.array_equal(dec["knot_phase"].numpy(), phases)
    tol = F32_TOL
    joints = slice(12, 22)
    for got, want, t in ((bundle.times, rb.times, tol["times"]),
                         (mod.times, rmod.times, tol["times"]),
                         (bundle.foot_pos_ref, rb.foot_pos_ref, tol["foot_pos"]),
                         (bundle.foot_vel_ref, rb.foot_vel_ref, tol["foot_vel"]),
                         (bundle.x_nom[..., :12], rb.x_nom[..., :12], tol["states"]),
                         (mod.states[..., :12], rmod.states[..., :12], tol["states"]),
                         (mod.inputs, rmod.inputs, tol["states"]),
                         (planner.latest_stance_position, rplanner.latest_stance_position,
                          tol["latest"]),
                         (bundle.x_nom[..., joints], rb.x_nom[..., joints], tol["joints"]),
                         (mod.states[..., joints], rmod.states[..., joints], tol["joints"])):
        _close(got, want, 0.0, t)


def test_prepare_references_on_cpu_takes_plain_versions():
    """On CPU tensors prepare_references launches no kernel and equals the
    plain versions bit for bit, shared inputs broadcast by expand included;
    the kernel wrappers refuse CPU tensors."""
    flag = build_flagship(66, 1.0, batch=3, device="cpu")
    sched = tms.ModeSchedule(*(a.expand(3, *a.shape) for a in flag.schedule))
    target = ttg.TargetTrajectories(*(a.expand(3, *a.shape) for a in flag.target))
    t0 = torch.tensor(0.31).expand(3)
    cmd, dj = torch.full((6,), 0.1).expand(3, 6), flag.default_joints.expand(3, -1)
    x = flag.x0 + 0.01 * torch.arange(3.0)[:, None]
    args = (flag.planner_cfg, flag.state.planner, sched, target, t0, x, cmd, dj)
    before = (tmpc.swing_plan.launches, tik.leg_ik.launches, tmpc.knot_refs.launches)
    got = tmpc.prepare_references(flag.model, flag.settings, *args)
    assert (tmpc.swing_plan.launches, tik.leg_ik.launches, tmpc.knot_refs.launches) == before
    plan = tmpc.swing_plan_plain(flag.model, *args, 1.0, 7)
    _, jr = tik.joint_reference_ik_plain(flag.model, plan.poses.contiguous(),
                                         plan.warm.contiguous(), plan.des.contiguous(),
                                         plan.R_des.contiguous())
    bundle, mod = tmpc.knot_refs_plain(sched, plan, t0, 1.0, 66, jr)
    flat = [t for tup in (bundle, plan.refs, mod, plan.planner) for t in tup]
    assert all(torch.equal(a, b) for a, b in zip([t for tup in got for t in tup], flat))
    with pytest.raises(ValueError, match="CUDA"):
        tmpc.swing_plan(flag.model, *args, 1.0, 7)
    with pytest.raises(ValueError, match="CUDA"):
        tmpc.knot_refs(sched, plan, t0, 1.0, 66, jr)


def test_plain_decisions_match_the_outputs():
    """The plain versions' decisions are the choices their outputs show:
    the flags are MODE_CONTACTS of the knots' phases' modes, the fresh
    windows are swing windows ahead of init_time, the samples' phases and
    segments lie in range."""
    flag = build_flagship(53, 0.8, batch=2, device="cpu", dtype=torch.float64)
    tmpl = tms.FLYING_TROT_GAIT("cpu", torch.float64)
    sched = tms.tile_template(tmpl, 19.2, 24.0)
    sched = tms.ModeSchedule(*(a.expand(2, *a.shape) for a in sched))
    target = ttg.TargetTrajectories(*(a.expand(2, *a.shape) for a in flag.target))
    t0 = torch.tensor([20.0, 20.13], dtype=torch.float64)
    dec = {}
    plan = tmpc.swing_plan_plain(flag.model, flag.planner_cfg, flag.state.planner, sched, target,
                                 t0, flag.x0, torch.zeros(2, 6, dtype=torch.float64),
                                 flag.default_joints.expand(2, -1), 0.8, 6, decisions=dec)
    _, jr = tik.joint_reference_ik_plain(flag.model, plan.poses.contiguous(),
                                         plan.warm.contiguous(), plan.des.contiguous(),
                                         plan.R_des.contiguous())
    bundle, _ = tmpc.knot_refs_plain(sched, plan, t0, 0.8, 53, jr, decisions=dec)
    modes = torch.gather(sched.modes, -1, dec["knot_phase"])
    assert torch.equal(bundle.contact_flags, tms.mode_contacts(torch.float64, "cpu")[modes])
    swing = plan.refs.contact_seq < 0.5
    assert not (dec["fresh"] & ~(swing & (plan.refs.window_stop > t0[:, None, None]))).any()
    assert dec["fresh"].any(-1).all()
    assert dec["cmd_phase"].shape == (2,) and dec["next_phase"].shape == (2, 4, 57)
    for name, hi in (("sample_seg", 6), ("sample_phase", 56), ("mid_seg", 6),
                     ("knot_seg", 4), ("knot_spline", 2), ("sample_spline", 2)):
        assert int(dec[name].min()) >= 0 and int(dec[name].max()) <= hi, name


def test_kernel_constants_match_the_plain_version():
    """csrc/reference_prep.cu repeats the plain version's constants: the
    swing splines' tuned shape (as float32, each product or complement
    formed in double as the plain code forms it), the padded event time and
    the capacity for target nodes that the wrapper checks."""
    src = (Path(trp.__file__).parents[1] / "csrc" / "reference_prep.cu").read_text()
    got = {n: float(np.float32(eval(e, {"__builtins__": {}})))
           for n, e in re.findall(r"(\w+) = static_cast<float>\(([-+*/ .0-9e]+)\)", src)}
    a1, l1, k1 = tswp.XY_SHAPE
    za1, zl1, zk1, za2, zl2, zk2, zk3 = tswp.Z_SHAPE
    want = {"XY_A1": a1, "XY_A1C": 1 - a1, "XY_L1": l1, "XY_L1C": 1 - l1, "XY_K1": k1,
            "Z_A1": za1, "Z_A1C": 1 - za1, "Z_L1": zl1, "Z_K1": zk1, "Z_A2": za2,
            "Z_A2C": 1 - za2, "Z_L2": zl2, "Z_L2C": 1 - zl2, "Z_K2L2": zk2 * zl2,
            "Z_K3L2": zk3 * zl2, "BIG": tms.BIG_TIME, "HALF_BIG": tms.BIG_TIME / 2}
    assert {n: got.get(n) for n in want} == {n: float(np.float32(v)) for n, v in want.items()}
    assert int(re.search(r"constexpr int MAX_T = (\d+);", src).group(1)) == trp.MAX_TARGET_NODES
