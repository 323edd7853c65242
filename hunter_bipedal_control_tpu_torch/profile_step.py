"""Where the time of one batched MPC step, of the 500 Hz control tick, or
of a period of the dummy closed loop goes on the card.

    python -m hunter_bipedal_control_tpu_torch.profile_step [batch] [knots] [horizon]
    python -m hunter_bipedal_control_tpu_torch.profile_step tick [batch] [ticks]
    python -m hunter_bipedal_control_tpu_torch.profile_step loop [sequential|parallel] [periods]
    python -m hunter_bipedal_control_tpu_torch.profile_step phases [batch] [knots] [horizon]
    python -m hunter_bipedal_control_tpu_torch.profile_step tick_phases [batch] [ticks]
    python -m hunter_bipedal_control_tpu_torch.profile_step loop_phases [sequential|parallel] [periods]
    python -m hunter_bipedal_control_tpu_torch.profile_step sim_loop [sequential|parallel] [n]
    python -m hunter_bipedal_control_tpu_torch.profile_step sim_loop_phases [sequential|parallel] [n]
    python -m hunter_bipedal_control_tpu_torch.profile_step ddp [batch] [knots] [horizon] [RK2|ODE45] [iterations]

Any form takes ``--lin_backend=soa`` (the default: kernel B1) or
``--lin_backend=dense`` (the plain dense linearization and merit), so that
the launches per step can be read in both backends.

The first form builds the flagship problem (default B=128, 66 knots over
1.0 s), runs a cold and a warm step, then records one more warm step under
``torch.profiler``.  The second builds the product-shape policy (53 knots
over 0.8 s, one cold step, default B=1) and the tick's controller, runs two
warm-up ticks, then records ``ticks`` chained ticks (default 3) of
``entry.tick_chain``.  The third runs the golden scenario's closed loop
(``entry.build_loop``, either Riccati mode) for 15 standing and 7 walking
periods, past the gait switch, then records ``periods`` more walking
periods (default 2), each one MPC step and five ticks.  Each prints one
JSON line: the wall time (per step, tick or period), the device's busy time
(sum of kernel and copy durations) and idle share, the number of device
launches (per step, tick or period), and the device time of the heaviest
kernels.  ``phases`` splits one warm step's launch calls by phase,
``tick_phases`` one tick's and ``loop_phases`` one walking period's by the
tick's sub-phases (``TICK_PHASES``; the dummy loop's also by its policy
evaluation, state conversion and plant).  ``sim_loop`` runs the full-order
closed loop (``entry.build_sim_loop``: the real-time demonstration's 10
standing periods and 5 walking ones, past the gait switch) and records
``periods`` more walking periods; ``sim_loop_phases`` splits one such
period's launch calls by ``SIM_PHASES`` (the plant, sensing split into the
IMU, the centroidal conversion and the rest, the Kalman filter, the
observer, the contact classification, the MPC step, the control tick with
its QP assembly and PDIP).  ``ddp`` runs ``entry.ddp_solve`` on the
flagship (default B=1, 53 knots over 0.8 s, RK2, 2 iterations), then
records one more ``ddp.solve`` from the same warm start: its wall and
device-busy time, and its launch calls by ``DDP_PHASES`` (the
linearization, the projection, the backward pass, the rollouts with the
re-roll; 'selection' is the rest: the map back to u-space, the line
search's choice).
"""
from __future__ import annotations

import functools
import json
import sys
import time


def _profiled(run, per: int, top: int):
    """Profile ``run()`` (which ends synchronized); figures per ``per`` units."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t) * 1e3
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    heavy = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:top]
    return {
        "device": torch.cuda.get_device_name(0), "wall_ms": wall_ms / per,
        "device_busy_ms": busy_ms / per, "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_launches": sum(e.count for e in dev_events) / per,
        "top_kernels": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3 / per,
                         "count": e.count / per} for e in heavy],
    }


def profile_step(batch: int = 128, knots: int = 66, horizon: float = 1.0, top: int = 12,
                 lin_backend: str = "soa"):
    import torch

    from .entry import build_flagship
    from .solver.mpc import Mpc

    flag = build_flagship(knots, horizon, batch=batch, lin_backend=lin_backend)
    mpc = Mpc(flag.model, flag.settings, flag.params, flag.planner_cfg)
    args = (flag.schedule, flag.target, 0.0, flag.x0,
            torch.zeros(6, device=flag.x0.device), flag.default_joints)
    _, state, _ = mpc(flag.state, *args)
    mpc(state, *args)
    torch.cuda.synchronize()

    def run():
        mpc(state, *args)
        torch.cuda.synchronize()

    return {"phase": "profile", "batch": batch, "knots": knots, "lin_backend": lin_backend,
            **_profiled(run, 1, top)}


def _charged_launches(prof):
    """A profile's host launch calls: (their number, the number starting
    inside each host "phase:" range, charged to the innermost one, by
    name)."""
    import torch

    events = list(prof.events())
    # the host's ranges: the profiler also records each range on the device
    # timeline, from its first kernel's start to its last one's end, which
    # overlaps the host's later launch calls
    ranges = [(e.name[6:], e.time_range.start, e.time_range.end) for e in events
              if e.name.startswith("phase:") and e.device_type == torch.autograd.DeviceType.CPU]
    launches = [e for e in events if "LaunchKernel" in e.name]
    charged = {}
    for ev in launches:
        t = ev.time_range.start
        inside = [r for r in ranges if r[1] <= t <= r[2]]
        if inside:
            name = max(inside, key=lambda r: r[1])[0]
            charged[name] = charged.get(name, 0) + 1
    return len(launches), charged


PHASES = (("prepare_references", "mpc"), ("_warm_start", "mpc"),
          ("knot_linearization_all", "sqp"), ("project_knot", "sqp"),
          ("riccati_solve", "riccati"), ("riccati_solve_parallel", "riccati"),
          ("eval_merit", "sqp"))
# the reference prep's sub-phases, labelled only inside prepare_references:
# kernel B8b1 (or its plain version), the IK (B8a), kernel B8b2
PREP_PHASES = (("swing_plan", "mpc"), ("swing_plan_plain", "mpc"), ("joint_reference_ik", "ik"),
               ("knot_refs", "mpc"), ("knot_refs_plain", "mpc"))


def profile_phases(batch: int = 128, knots: int = 66, horizon: float = 1.0,
                   lin_backend: str = "soa"):
    """One warm MPC step with each phase of ``PHASES`` wrapped in a profiler
    range: per phase the host's kernel launches (runtime launch calls that
    start inside the range, charged to the innermost range); 'other' is the
    rest of the step (the line search's model, the solution).
    ``prepare_references_split`` splits the reference prep's launches by the
    sub-phases of ``PREP_PHASES`` (B8b1 ``swing_plan``: the current feet,
    the swing planner, the IK's inputs; the IK; B8b2 ``knot_refs``: the
    per-knot references; 'rest' is the prep's own code)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .entry import build_flagship
    from .refs import ik
    from .solver import mpc as mpc_mod, riccati, sqp

    mods = {"mpc": mpc_mod, "sqp": sqp, "riccati": riccati, "ik": ik}
    flag = build_flagship(knots, horizon, batch=batch, lin_backend=lin_backend)
    mpc = mpc_mod.Mpc(flag.model, flag.settings, flag.params, flag.planner_cfg)
    args = (flag.schedule, flag.target, 0.0, flag.x0,
            torch.zeros(6, device=flag.x0.device), flag.default_joints)
    _, state, _ = mpc(flag.state, *args)
    torch.cuda.synchronize()

    in_prep = [0]

    def labelled(name, fn, sub):
        # wraps copies the launch counters the kernel wrappers bump on themselves
        @functools.wraps(fn)
        def run(*a, **k):
            if sub and not in_prep[0]:
                return fn(*a, **k)
            in_prep[0] += name == "prepare_references"
            try:
                with record_function("phase:" + name):
                    return fn(*a, **k)
            finally:
                in_prep[0] -= name == "prepare_references"
        return run

    saved = [(mods[m], n, getattr(mods[m], n), sub) for sub, table in ((False, PHASES),
                                                                       (True, PREP_PHASES))
             for n, m in table]
    try:
        for mod, n, fn, sub in saved:
            setattr(mod, n, labelled(n, fn, sub))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            mpc(state, *args)
            torch.cuda.synchronize()
    finally:
        for mod, n, fn, _ in saved:
            setattr(mod, n, fn)
    total, charged = _charged_launches(prof)
    prep = {name: charged.get(name, 0) for name, _ in PREP_PHASES}
    out = {name: charged.get(name, 0) for name, _ in PHASES}
    out["prepare_references"] += sum(prep.values())
    prep["rest"] = out["prepare_references"] - sum(prep.values())
    out["other"] = total - sum(out.values())
    return {"phase": "profile_phases", "batch": batch, "knots": knots,
            "lin_backend": lin_backend, "device": torch.cuda.get_device_name(0),
            "launch_calls_per_step": total, "launch_calls_by_phase": out,
            "prepare_references_split": prep}


# the tick's sub-phases and the loop period's parts: (function, module);
# a launch call is charged to the innermost of these calls it starts in
TICK_PHASES = (("kalman_update", "kf"), ("momentum_observer_update", "obs"),
               ("control_tick", "ctrl"), ("control_tick", "loop"), ("_at", "ctrl"),
               ("wbc_solve", "ctrl"), ("wbc_qp", "wbc"), ("_measured_pipeline", "wbc"),
               ("_desired_pipeline", "wbc"), ("solve_qp", "wbc"), ("mpc_step", "mpc"),
               ("dummy_step", "loop"), ("state_input_to_v", "loop"), ("evaluate_policy", "mpc"))


def _launches_by_phase(run, table):
    """Run ``run()`` (which ends synchronized) under the profiler with each
    function of ``table`` wrapped in a range of its name: (the launch calls,
    the launch calls charged to the innermost range, per name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .estim import contact, kalman
    from .runtime import controller, loop
    from .solver import mpc as mpc_mod
    from .wbc import wbc

    from .runtime import sim_loop

    from .solver import ddp, riccati, sqp

    mods = {"kf": kalman, "obs": contact, "ctrl": controller, "loop": loop, "wbc": wbc,
            "mpc": mpc_mod, "sim": sim_loop, "ddp": ddp, "sqp": sqp, "riccati": riccati}

    def labelled(name, fn):
        # wraps copies the launch counters the kernel wrappers bump on themselves
        @functools.wraps(fn)
        def call(*a, **k):
            with record_function("phase:" + name):
                return fn(*a, **k)
        return call

    saved = [(mods[m], n, getattr(mods[m], n)) for n, m in table]
    try:
        for mod, n, fn in saved:
            setattr(mod, n, labelled(n, fn))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
    finally:
        for mod, n, fn in reversed(saved):
            setattr(mod, n, fn)
    total, charged = _charged_launches(prof)
    return total, {n: charged.get(n, 0) for n, _ in table}


def _tick_split(total, by_name, per):
    """Launch calls per unit by the tick's sub-phases, and ``wbc_qp``'s own
    split (its plain version's measured and desired pipelines, the rest).
    The dummy loop's own per-tick parts: its policy evaluation
    (``loop_policy``), its state conversion (``conversion``: x, u -> v and
    the rbd state) and its plant."""
    parts = {"kalman": by_name["kalman_update"], "observer": by_name["momentum_observer_update"],
             "policy": by_name["_at"], "loop_policy": by_name["evaluate_policy"],
             "conversion": by_name["state_input_to_v"],
             "wbc_qp": (by_name["wbc_qp"] + by_name["_measured_pipeline"]
                        + by_name["_desired_pipeline"]),
             "solve_qp": by_name["solve_qp"], "wbc_solve_rest": by_name["wbc_solve"],
             "control_tick_rest": by_name["control_tick"], "mpc_step": by_name["mpc_step"],
             "plant": by_name["dummy_step"]}
    parts["other"] = total - sum(parts.values())
    split = {"measured": by_name["_measured_pipeline"], "desired": by_name["_desired_pipeline"],
             "stacking_or_kernel": by_name["wbc_qp"]}
    return ({k: v / per for k, v in parts.items()}, {k: v / per for k, v in split.items()})


def _tick_policy(batch: int, lin_backend: str):
    """The product shape's flagship (53 knots over 0.8 s) and its cold policy."""
    import torch

    from .entry import build_flagship
    from .solver.mpc import Mpc

    flag = build_flagship(53, 0.8, batch=batch, lin_backend=lin_backend)
    mpc = Mpc(flag.model, flag.settings, flag.params, flag.planner_cfg)
    policy, _, _ = mpc(flag.state, flag.schedule, flag.target, 0.0, flag.x0,
                       torch.zeros(6, device=flag.x0.device), flag.default_joints)
    return flag, policy


def profile_tick_phases(batch: int = 1, ticks: int = 3, lin_backend: str = "soa"):
    """Launch calls per tick of ``entry.tick_chain`` (after two warm-up
    ticks) by sub-phase: the Kalman filter, the momentum observer, the
    policy evaluation (``_at``), the WBC's QP assembly (``wbc_qp``: kernel
    B9, or its plain version's pipelines and stacking), the PDIP
    (``solve_qp``), the rest of ``wbc_solve`` and of ``control_tick``."""
    import torch

    from .entry import build_controller, tick_chain

    flag, policy = _tick_policy(batch, lin_backend)
    setup = build_controller(batch)
    tick_chain(setup, policy, flag.schedule, 2)
    torch.cuda.synchronize()

    def run():
        tick_chain(setup, policy, flag.schedule, ticks)
        torch.cuda.synchronize()

    total, by_name = _launches_by_phase(run, TICK_PHASES)
    parts, split = _tick_split(total, by_name, ticks)
    return {"phase": "profile_tick_phases", "batch": batch, "ticks": ticks,
            "device": torch.cuda.get_device_name(0), "launch_calls_per_tick": total / ticks,
            "launch_calls_by_phase": parts, "wbc_qp_split": split}


def _walking_loop(riccati_parallel: bool, lin_backend: str):
    """The golden scenario's loop past the gait switch (15 standing and 7
    walking periods): (setup, the walking command)."""
    import torch

    from .entry import build_loop, run_loop

    setup = build_loop(riccati_parallel=riccati_parallel, lin_backend=lin_backend)
    walk = [0.3, 0.0, 0.0, 0.0]
    state, _ = run_loop(setup, [[0.0] * 4] * 15 + [walk] * 7)
    torch.cuda.synchronize()
    return setup._replace(state=state), walk


def profile_loop_phases(riccati_parallel: bool = False, periods: int = 2,
                        lin_backend: str = "soa"):
    """Launch calls per walking period of the dummy loop by part: the MPC
    step, the plant, each of the tick's sub-phases summed over the period's
    five ticks (the cheater state: no Kalman filter, no observer), and the
    rest (the gait upkeep, the loop's own code)."""
    import torch

    from .entry import run_loop

    setup, walk = _walking_loop(riccati_parallel, lin_backend)

    def run():
        run_loop(setup, [walk] * periods)
        torch.cuda.synchronize()

    total, by_name = _launches_by_phase(run, TICK_PHASES)
    parts, split = _tick_split(total, by_name, periods)
    return {"phase": "profile_loop_phases", "riccati_parallel": riccati_parallel,
            "periods": periods, "device": torch.cuda.get_device_name(0),
            "launch_calls_per_period": total / periods, "launch_calls_by_phase": parts,
            "wbc_qp_split": split}


# the full-order loop's parts, as sim_loop.py calls them
SIM_PHASES = (("sim_step", "sim"), ("_sense_and_estimate", "sim"), ("synth_imu", "sim"),
              ("rbd_state_to_centroidal", "sim"), ("kalman_update", "sim"),
              ("momentum_observer_update", "sim"), ("_classify_contacts", "sim"),
              ("swing_windows", "sim"), ("control_tick", "sim"), ("wbc_qp", "wbc"),
              ("solve_qp", "wbc"), ("mpc_step", "mpc"))


# the real-time demonstration's walking command
WALK = [0.3, 0.0, 0.0, 0.0]


def _walking_sim_loop(riccati_parallel: bool, lin_backend: str):
    """The real-time demonstration's loop past the gait switch (10 standing
    and 5 walking periods): the setup at that state."""
    import torch

    from .entry import build_sim_loop, rt_commands, run_sim_loop

    setup = build_sim_loop(riccati_parallel=riccati_parallel, lin_backend=lin_backend)
    state, _ = run_sim_loop(setup, rt_commands(15))
    torch.cuda.synchronize()
    return setup._replace(state=state)


def profile_sim_loop_phases(riccati_parallel: bool = False, periods: int = 2,
                            lin_backend: str = "soa", setup=None):
    """Launch calls per walking period of the full-order loop (from
    ``setup``, a ``SimLoopSetup`` whose state walks; by default one warmed
    up by ``_walking_sim_loop``) by part: the
    plant (``sim_step``: the ring and kernel B11), sensing: the IMU
    (``synth_imu``), the rbd -> centroidal conversion
    (``rbd_state_to_centroidal``) and the rest of ``_sense_and_estimate``
    but the filter (``sensing_rest``: the commanded contacts, the rbd
    state), the Kalman filter (six updates per period), the observer, the
    contact classification (with the period's swing windows), the MPC step,
    the control tick (the QP assembly and the PDIP apart), the rest (the gait
    upkeep, the command filter, the loop's own code)."""
    import torch

    from .entry import run_sim_loop

    if setup is None:
        setup = _walking_sim_loop(riccati_parallel, lin_backend)

    def run():
        run_sim_loop(setup, [WALK] * periods)
        torch.cuda.synchronize()

    total, by = _launches_by_phase(run, SIM_PHASES)
    parts = {"plant": by["sim_step"], "imu": by["synth_imu"],
             "centroidal": by["rbd_state_to_centroidal"],
             "sensing_rest": by["_sense_and_estimate"],
             "kalman": by["kalman_update"], "observer": by["momentum_observer_update"],
             "classification": by["_classify_contacts"] + by["swing_windows"],
             "mpc_step": by["mpc_step"], "wbc_qp": by["wbc_qp"], "solve_qp": by["solve_qp"],
             "control_tick_rest": by["control_tick"]}
    parts["other"] = total - sum(parts.values())
    return {"phase": "profile_sim_loop_phases", "riccati_parallel": riccati_parallel,
            "periods": periods, "device": torch.cuda.get_device_name(0),
            "launch_calls_per_period": total / periods,
            "launch_calls_by_phase": {k: v / periods for k, v in parts.items()}}


def profile_sim_loop(riccati_parallel: bool = False, periods: int = 2, top: int = 12,
                     lin_backend: str = "soa", setup=None):
    """``_profiled`` over walking periods of the full-order loop (from
    ``setup``, as ``profile_sim_loop_phases`` takes it)."""
    import torch

    from .entry import run_sim_loop

    if setup is None:
        setup = _walking_sim_loop(riccati_parallel, lin_backend)

    def run():
        run_sim_loop(setup, [WALK] * periods)
        torch.cuda.synchronize()

    return {"phase": "profile_sim_loop", "riccati_parallel": riccati_parallel,
            "periods": periods, "lin_backend": lin_backend, "per": "period",
            **_profiled(run, periods, top)}


def profile_tick(batch: int = 1, ticks: int = 3, top: int = 12, lin_backend: str = "soa"):
    import torch

    from .entry import build_controller, tick_chain

    flag, policy = _tick_policy(batch, lin_backend)
    setup = build_controller(batch)
    tick_chain(setup, policy, flag.schedule, 2)
    torch.cuda.synchronize()

    def run():
        tick_chain(setup, policy, flag.schedule, ticks)
        torch.cuda.synchronize()

    return {"phase": "profile_tick", "batch": batch, "ticks": ticks,
            "per": "tick", **_profiled(run, ticks, top)}


def profile_loop(riccati_parallel: bool = False, periods: int = 2, top: int = 12,
                 lin_backend: str = "soa"):
    import torch

    from .entry import run_loop

    setup, walk = _walking_loop(riccati_parallel, lin_backend)

    def run():
        run_loop(setup, [walk] * periods)
        torch.cuda.synchronize()

    return {"phase": "profile_loop", "riccati_parallel": riccati_parallel, "periods": periods,
            "lin_backend": lin_backend, "per": "period", **_profiled(run, periods, top)}


# a DDP solve's phases: (function, module), as ddp.solve calls them
DDP_PHASES = (("knot_linearization_all", "sqp"), ("project_knot", "sqp"),
              ("riccati_solve", "riccati"), ("closed_rollout", "ddp"))
DDP_PHASE_NAMES = {"knot_linearization_all": "linearize", "project_knot": "project",
                   "riccati_solve": "backward", "closed_rollout": "rollouts"}


def profile_ddp(batch: int = 1, knots: int = 53, horizon: float = 0.8, integrator: str = "RK2",
                iterations: int = 2, top: int = 12, lin_backend: str = "soa"):
    """One ``ddp.solve`` on the flagship after ``entry.ddp_solve`` (which
    warms up): wall and device-busy time, launches, the heaviest kernels,
    and the launch calls by phase."""
    import torch

    from .entry import build_flagship, ddp_solve
    from .solver import ddp

    flag = build_flagship(knots, horizon, batch=batch, lin_backend=lin_backend)
    settings = ddp.DdpSettings(n_intervals=knots, horizon=horizon, integrator=integrator,
                               n_iterations=iterations)
    run = ddp_solve(flag, settings)
    args = (flag.model, settings, flag.params, run.refs, flag.x0, run.warm.states,
            run.warm.inputs[:, :-1])

    def solve():
        ddp.solve(*args)
        torch.cuda.synchronize()

    prof = _profiled(solve, 1, top)
    total, by_name = _launches_by_phase(solve, DDP_PHASES)
    phases = {DDP_PHASE_NAMES[n]: v for n, v in by_name.items()}
    phases["selection"] = total - sum(phases.values())
    return {"phase": "profile_ddp", "batch": batch, "knots": knots, "horizon": horizon,
            "integrator": integrator, "iterations": iterations, "per": "solve",
            "entry_solve_ms": run.seconds * 1e3, **prof, "launch_calls": total,
            "launch_calls_by_phase": phases}


if __name__ == "__main__":
    lb = [x.split("=", 1)[1] for x in sys.argv[1:] if x.startswith("--lin_backend=")]
    kw = {"lin_backend": lb[-1]} if lb else {}
    a = [x for x in sys.argv[1:] if not x.startswith("--lin_backend=")]
    if a and a[0] == "phases":
        print(json.dumps(profile_phases(int(a[1]) if len(a) > 1 else 128,
                                        int(a[2]) if len(a) > 2 else 66,
                                        float(a[3]) if len(a) > 3 else 1.0, **kw)))
    elif a and a[0] == "tick_phases":
        print(json.dumps(profile_tick_phases(int(a[1]) if len(a) > 1 else 1,
                                             int(a[2]) if len(a) > 2 else 3, **kw)))
    elif a and a[0] == "loop_phases":
        print(json.dumps(profile_loop_phases(len(a) > 1 and a[1] == "parallel",
                                             int(a[2]) if len(a) > 2 else 2, **kw)))
    elif a and a[0] in ("sim_loop", "sim_loop_phases"):
        fn = profile_sim_loop if a[0] == "sim_loop" else profile_sim_loop_phases
        print(json.dumps(fn(len(a) > 1 and a[1] == "parallel", int(a[2]) if len(a) > 2 else 2,
                            **kw)))
    elif a and a[0] == "loop":
        print(json.dumps(profile_loop(len(a) > 1 and a[1] == "parallel",
                                      int(a[2]) if len(a) > 2 else 2, **kw)))
    elif a and a[0] == "ddp":
        print(json.dumps(profile_ddp(int(a[1]) if len(a) > 1 else 1,
                                     int(a[2]) if len(a) > 2 else 53,
                                     float(a[3]) if len(a) > 3 else 0.8,
                                     a[4] if len(a) > 4 else "RK2",
                                     int(a[5]) if len(a) > 5 else 2, **kw)))
    elif a and a[0] == "tick":
        print(json.dumps(profile_tick(int(a[1]) if len(a) > 1 else 1,
                                      int(a[2]) if len(a) > 2 else 3, **kw)))
    else:
        print(json.dumps(profile_step(int(a[0]) if a else 128, int(a[1]) if len(a) > 1 else 66,
                                      float(a[2]) if len(a) > 2 else 1.0, **kw)))
