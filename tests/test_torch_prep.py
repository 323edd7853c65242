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


# ---- the swing planner's scan form (kernel B8b1's windows, next phase,
# tail and fresh tests and fresh phases' indices), mirrored in torch ----
#
# csrc/reference_prep.cu's swing_plan_kernel runs a leg's 57 phases on a
# warp's 32 lanes, two a lane (phase 2l + h on lane l, phantoms from 57
# on), and finds each phase's window bounds, the fresh test's running
# maximum and the last two fresh phases by prefix scans over the lanes
# (shuffles up or down by 1, 2, 4, 8, 16) instead of walks over the phases.
# ``_scan_form`` repeats those steps on the same layout in float32 with the
# plain version's operations; the tests hold it to ``swing_plan_plain``'s
# windows and decisions bit for bit, and its windows to B16's walk
# (``contact_window``), on seeded schedules and on ``entry.
# swing_plan_edge_batch``'s.
LANES = 32
BIG = tms.BIG_TIME


def _lanes(x, fill):
    """(..., P1) per-phase values -> (..., LANES, 2), phantoms ``fill``."""
    pad = torch.full((*x.shape[:-1], 2 * LANES - x.shape[-1]), fill, dtype=x.dtype)
    return torch.cat([x, pad], -1).reshape(*x.shape[:-1], LANES, 2)


def _phases(a, b):
    """Two lanes' values (..., LANES) -> (..., P1) per phase."""
    return torch.stack([a, b], -1).reshape(*a.shape[:-1], 2 * LANES)[..., :tswp.P1]


def _shfl(v, o):
    """__shfl_up_sync (o > 0) / __shfl_down_sync (o < 0) over the last dim:
    lane l reads lane l - o, a lane with no such source keeps its own."""
    lane = torch.arange(LANES)
    src = (lane - o).clamp(0, LANES - 1)
    got = v[..., src]
    return torch.where((lane - o >= 0) & (lane - o < LANES), got, v)


def _scan(v, op, up=True):
    """The kernel's inclusive scan over the lanes: prefix (up) or suffix."""
    lane = torch.arange(LANES)
    for o in (1, 2, 4, 8, 16):
        u = _shfl(v, o if up else -o)
        v = torch.where(lane >= o if up else lane + o < LANES, op(u, v), v)
    return v


def _excl(incl, first, up=True):
    """The exclusive scan: the neighbour's inclusive one, ``first`` at the end."""
    lane = torch.arange(LANES)
    return torch.where(lane == (0 if up else LANES - 1), torch.as_tensor(first, dtype=incl.dtype),
                       _shfl(incl, 1 if up else -1))


def _scan_form(schedule, init_time, horizon):
    """B8b1's scan form on CPU float32 tensors (B, ...): the windows (start,
    stop, contact flag), the next phase, the tail and fresh tests and the
    fresh phases' indices i1 / i2, each (B, 4, P1)."""
    ev, P1, M = schedule.event_times, tswp.P1, tms.MAX_PHASES
    final = init_time + horizon
    hz = final - init_time
    h_start, h_end = init_time - hz, final + hz
    cs = tms.contact_sequence(schedule, ev.dtype)                    # (B, 4, P1)
    lane = torch.arange(LANES)
    pa, pb = 2 * lane, 2 * lane + 1
    va, vb = pa < P1, pb < P1
    c2 = _lanes(cs, 0.0)
    ca, cb = c2[..., 0], c2[..., 1]
    fa = torch.where((pa == 0) | (ca != _shfl(cb, 1)), pa, -1)
    fb = torch.where(ca != cb, pb, fa)
    f_ex = _excl(_scan(fb, torch.maximum), -1)
    qfa, qfb = torch.maximum(f_ex, fa), torch.maximum(f_ex, fb)
    ba = (pa == P1 - 1) | (ca != cb)
    bb = vb & ((pb == P1 - 1) | (cb != _shfl(ca, -1)))
    bb_mark = torch.where(bb, pb, P1)
    b_lane = torch.where(~va, P1, torch.where(ba, pa, bb_mark))
    b_ex = _excl(_scan(b_lane, torch.minimum, up=False), P1, up=False)
    qba, qbb = torch.where(ba, pa, torch.minimum(b_ex, bb_mark)), torch.minimum(b_ex, bb_mark)
    qf, qb = _phases(qfa, qfb), _phases(qba, qbb)                     # (B, 4, P1)
    evx = ev[:, None, :].expand(*cs.shape[:-1], M)
    start = torch.where(qf == 0, h_start[:, None, None],
                        torch.gather(evx, -1, (qf - 1).clamp(0, M - 1)))
    stop = torch.minimum(torch.where(qb < M, torch.gather(evx, -1, qb.clamp(0, M - 1)),
                                     torch.tensor(BIG, dtype=ev.dtype)), h_end[:, None, None])
    nxt = torch.searchsorted(ev.contiguous(), (stop + 1e-6).reshape(len(ev), -1),
                             right=True).reshape(stop.shape).clamp(max=P1 - 1)
    last = torch.where(ev < BIG / 2, ev, torch.full_like(ev, -BIG)).amax(-1)
    tail = stop >= (last - 1e-9)[:, None, None]
    elig = (cs < 0.5) & (init_time[:, None, None] < stop)
    m2 = _lanes(torch.where(elig, stop, torch.full_like(stop, -BIG)), -BIG)
    e2, el2 = _lanes(stop, 0.0), _lanes(elig, False)
    ma, mb = m2[..., 0], m2[..., 1]
    m_ex = _scan(torch.maximum(ma, mb), torch.maximum)
    m_ex = torch.where(lane == 0, torch.tensor(-BIG), torch.maximum(torch.tensor(-BIG),
                                                                    _shfl(m_ex, 1)))
    fra = el2[..., 0] & (e2[..., 0] > m_ex + 1e-9)
    frb = el2[..., 1] & (e2[..., 1] > torch.maximum(m_ex, ma) + 1e-9)
    ka = torch.where(fra, pa, -1)
    kb = torch.where(frb, pb, ka)
    k_ex = _excl(_scan(kb, torch.maximum), -1)
    i1a, i1b = torch.maximum(k_ex, ka), torch.maximum(k_ex, kb)

    def second(i1):
        src = i1.clamp(min=0) // 2
        s1, sr = torch.gather(i1a, -1, src), torch.gather(k_ex, -1, src)
        return torch.where(i1 < 0, -1, torch.where(i1 % 2 == 1, s1, sr))

    return {"start": start, "stop": stop, "cs": cs, "next_phase": nxt, "tail": tail,
            "fresh": _phases(fra, frb), "i1": _phases(i1a, i1b),
            "i2": _phases(second(i1a), second(i1b))}


def _walks(cs, ev, h_start, h_end, fresh):
    """The walk forms, one (scenario, leg, phase) at a time: B16's
    contact_window and the first design's backward searches for i1 / i2."""
    cs, ev, fresh = cs.numpy(), ev.numpy(), fresh.numpy()
    Bn, L, P1 = cs.shape
    out = {k: np.zeros((Bn, L, P1), dtype=t) for k, t in
           (("start", np.float32), ("stop", np.float32), ("i1", np.int64), ("i2", np.int64))}
    for b in range(Bn):
        for g in range(L):
            c, fr = cs[b, g], fresh[b, g]
            for p in range(P1):
                qf = p
                while qf > 0 and c[qf - 1] == c[qf]:
                    qf -= 1
                qb = p
                while qb < P1 - 1 and c[qb + 1] == c[qb]:
                    qb += 1
                out["start"][b, g, p] = h_start[b] if qf == 0 else ev[b, qf - 1]
                out["stop"][b, g, p] = min(ev[b, qb] if qb < P1 - 1 else np.float32(BIG),
                                           h_end[b])
                i1 = next((q for q in range(p, -1, -1) if fr[q]), -1)
                out["i1"][b, g, p] = i1
                out["i2"][b, g, p] = next((q for q in range(i1 - 1, -1, -1) if fr[q]), -1)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _seeded_plan_args(batch, seed):
    """``swing_plan_plain``'s arguments on seeded schedules, float32 on the
    CPU: per scenario 1-40 real phases of 0.02-0.4 s from a start in
    [-1, 30] s (BIG_TIME beyond), each mode the previous one's with
    probability 0.4 (the modes beyond the real events kept or cycling), the
    init time on an event time, a float32 ulp off one, or uniform; the rest
    as ``entry.swing_plan_edge_batch`` makes it."""
    from hunter_bipedal_control_tpu_torch.entry import swing_plan_edge_batch

    base = swing_plan_edge_batch("cpu")
    g = torch.Generator().manual_seed(seed)
    P = tms.MAX_PHASES
    t0 = -1.0 + 31.0 * torch.rand(batch, generator=g)
    dur = 0.02 + 0.38 * torch.rand(batch, P, generator=g)
    ev = t0[:, None] + torch.cumsum(dur, -1)
    n_real = torch.randint(1, 41, (batch,), generator=g)
    ev = torch.where(torch.arange(P) < n_real[:, None], ev, torch.tensor(BIG))
    modes = torch.randint(0, 4, (batch, P + 1), generator=g)
    keep = torch.rand(batch, P + 1, generator=g) < 0.4
    hold = torch.rand(batch, generator=g) < 0.5
    for p in range(1, P + 1):
        same = keep[:, p] | (hold & (p > n_real))
        modes[:, p] = torch.where(same, modes[:, p - 1], modes[:, p])
    i = torch.minimum(torch.randint(0, 41, (batch,), generator=g), n_real - 1)
    e = torch.gather(ev, 1, i[:, None])[:, 0]
    kind = torch.arange(batch) % 4
    init = torch.where(kind == 1, torch.nextafter(e, torch.tensor(-np.inf)),
                       torch.where(kind == 2, torch.nextafter(e, torch.tensor(np.inf)), e))
    init = torch.where(kind == 3, t0 + 2.0 * torch.rand(batch, generator=g), init)
    x = base[6][:1].expand(batch, -1) + 0.02 * torch.randn(batch, 22, generator=g)
    target = ttg.cmd_vel_to_target(torch.full((batch, 4), 0.2), x, init, 0.8,
                                   ttg.default_cmd_vel_config(nj=10, device="cpu"))
    latest = tswp.PlannerState(0.1 * torch.randn(batch, 4, 3, generator=g))
    return (base[0], base[1], latest, tms.ModeSchedule(ev, modes), target, init, x,
            0.2 * torch.randn(batch, 6, generator=g), base[8][:1].expand(batch, -1), 0.8, 6)


@pytest.mark.parametrize("case", ["edges", "seeded_0", "seeded_1"])
def test_scan_form_equals_the_plain_decisions(case):
    """B8b1's scan form gives swing_plan_plain's windows, next phases, tail
    and fresh tests bit for bit (float32), and the walks' windows and fresh
    phases' indices."""
    from hunter_bipedal_control_tpu_torch.entry import swing_plan_edge_batch

    args = (swing_plan_edge_batch("cpu") if case == "edges"
            else _seeded_plan_args(24, int(case[-1])))
    sched, init, H = args[3], args[5], args[9]
    dec = {}
    plan = tmpc.swing_plan_plain(*args, decisions=dec)
    got = _scan_form(sched, init, H)
    refs = plan.refs
    for name, want in (("start", refs.window_start), ("stop", refs.window_stop),
                       ("cs", refs.contact_seq)):
        assert torch.equal(got[name].view(torch.int32), want.view(torch.int32)), name
    for name in ("next_phase", "tail", "fresh"):
        assert torch.equal(got[name], dec[name].to(got[name].dtype)), name
    final = init + H
    walk = _walks(refs.contact_seq, sched.event_times, init - (final - init),
                  final + (final - init), got["fresh"])
    for name in ("start", "stop", "i1", "i2"):
        assert torch.equal(got[name], walk[name].to(got[name].dtype)), name
    # the cases reach the edges: fresh windows and none, the tail, both indices
    assert got["fresh"].any() and not got["fresh"].all(-1).any()
    assert got["tail"].any() and (got["i2"] >= 0).any() and (got["i1"] < 0).any()
    if case == "edges":
        assert not got["fresh"][0].any() and got["tail"][3, :, 1:].all()


def test_scan_form_reaches_every_lane():
    """The scans carry a fresh phase or a contact change from lane 0 to lane
    28 (phase 56) and back: one change at phase 0 and one at 56."""
    args = _seeded_plan_args(2, 2)
    ev = torch.full((2, tms.MAX_PHASES), BIG)
    ev[:, 0], ev[:, -1] = 0.05, 0.1
    modes = torch.full((2, tswp.P1), 3)
    modes[:, 1:-1] = 1
    sched = tms.ModeSchedule(ev.contiguous(), modes)
    args = (*args[:3], sched, *args[4:5], torch.tensor([0.0, 0.07]), *args[6:])
    dec = {}
    plan = tmpc.swing_plan_plain(*args, decisions=dec)
    got = _scan_form(sched, args[5], args[9])
    assert torch.equal(got["stop"], plan.refs.window_stop)
    assert torch.equal(got["start"], plan.refs.window_start)
    assert torch.equal(got["fresh"], dec["fresh"]) and dec["fresh"][:, 0, 1].all()
    assert (got["i1"][:, 0, 1:] == 1).all() and (got["i2"][:, 0] == -1).all()
    assert (got["stop"][:, 0, 1:-1] == 0.1).all() and (got["start"][:, 0, 2:-1] == 0.05).all()
