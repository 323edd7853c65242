"""Where the time of one batched MPC step, of the 500 Hz control tick, or
of a period of the dummy closed loop goes on the card.

    python -m hunter_bipedal_control_tpu_torch.profile_step [batch] [knots] [horizon]
    python -m hunter_bipedal_control_tpu_torch.profile_step tick [batch] [ticks]
    python -m hunter_bipedal_control_tpu_torch.profile_step loop [sequential|parallel] [periods]
    python -m hunter_bipedal_control_tpu_torch.profile_step phases [batch] [knots] [horizon]

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
kernels.
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


PHASES = (("prepare_references", "mpc"), ("_warm_start", "mpc"),
          ("knot_linearization_all", "sqp"), ("project_knot", "sqp"),
          ("riccati_solve", "riccati"), ("riccati_solve_parallel", "riccati"),
          ("eval_merit", "sqp"))
# the reference prep's sub-phases, labelled only inside prepare_references
PREP_PHASES = (("joint_reference_ik", "ik"), ("update_planner", "swp"),
               ("_current_feet", "mpc"), ("foot_reference", "swp"), ("interp_state", "tg"))


def profile_phases(batch: int = 128, knots: int = 66, horizon: float = 1.0,
                   lin_backend: str = "soa"):
    """One warm MPC step with each phase of ``PHASES`` wrapped in a profiler
    range: per phase the host's kernel launches (runtime launch calls that
    start inside the range, charged to the innermost range); 'other' is the
    rest of the step (the line search's model, the solution).
    ``prepare_references_split`` splits the reference prep's launches by the
    sub-phases of ``PREP_PHASES`` (the IK, the swing planner, the current
    feet's FK, the foot references, the target interpolation; 'rest' is the
    prep's own code)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .entry import build_flagship
    from .refs import ik, swing_planner as swp, targets as tg
    from .solver import mpc as mpc_mod, riccati, sqp

    mods = {"mpc": mpc_mod, "sqp": sqp, "riccati": riccati, "ik": ik, "swp": swp, "tg": tg}
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
    events = list(prof.events())
    ranges = [(e.name[6:], e.time_range.start, e.time_range.end) for e in events
              if e.name.startswith("phase:")]
    launches = [e for e in events if "LaunchKernel" in e.name]
    out = {name: 0 for name, _ in PHASES}
    prep = {name: 0 for name, _ in PREP_PHASES}
    for ev in launches:
        t = ev.time_range.start
        inside = [r for r in ranges if r[1] <= t <= r[2]]
        if inside:
            name = max(inside, key=lambda r: r[1])[0]
            if name in prep:
                prep[name] += 1
                name = "prepare_references"
            out[name] += 1
    prep["rest"] = out["prepare_references"] - sum(prep.values())
    total = len(launches)
    out["other"] = total - sum(out.values())
    return {"phase": "profile_phases", "batch": batch, "knots": knots,
            "lin_backend": lin_backend, "device": torch.cuda.get_device_name(0),
            "launch_calls_per_step": total, "launch_calls_by_phase": out,
            "prepare_references_split": prep}


def profile_tick(batch: int = 1, ticks: int = 3, top: int = 12, lin_backend: str = "soa"):
    import torch

    from .entry import build_controller, build_flagship, tick_chain
    from .solver.mpc import Mpc

    flag = build_flagship(53, 0.8, batch=batch, lin_backend=lin_backend)
    mpc = Mpc(flag.model, flag.settings, flag.params, flag.planner_cfg)
    policy, _, _ = mpc(flag.state, flag.schedule, flag.target, 0.0, flag.x0,
                       torch.zeros(6, device=flag.x0.device), flag.default_joints)
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

    from .entry import build_loop, run_loop

    setup = build_loop(riccati_parallel=riccati_parallel, lin_backend=lin_backend)
    walk = [0.3, 0.0, 0.0, 0.0]
    state, _ = run_loop(setup, [[0.0] * 4] * 15 + [walk] * 7)
    setup = setup._replace(state=state)
    torch.cuda.synchronize()

    def run():
        run_loop(setup, [walk] * periods)
        torch.cuda.synchronize()

    return {"phase": "profile_loop", "riccati_parallel": riccati_parallel, "periods": periods,
            "lin_backend": lin_backend, "per": "period", **_profiled(run, periods, top)}


if __name__ == "__main__":
    lb = [x.split("=", 1)[1] for x in sys.argv[1:] if x.startswith("--lin_backend=")]
    kw = {"lin_backend": lb[-1]} if lb else {}
    a = [x for x in sys.argv[1:] if not x.startswith("--lin_backend=")]
    if a and a[0] == "phases":
        print(json.dumps(profile_phases(int(a[1]) if len(a) > 1 else 128,
                                        int(a[2]) if len(a) > 2 else 66,
                                        float(a[3]) if len(a) > 3 else 1.0, **kw)))
    elif a and a[0] == "loop":
        print(json.dumps(profile_loop(len(a) > 1 and a[1] == "parallel",
                                      int(a[2]) if len(a) > 2 else 2, **kw)))
    elif a and a[0] == "tick":
        print(json.dumps(profile_tick(int(a[1]) if len(a) > 1 else 1,
                                      int(a[2]) if len(a) > 2 else 3, **kw)))
    else:
        print(json.dumps(profile_step(int(a[0]) if a else 128, int(a[1]) if len(a) > 1 else 66,
                                      float(a[2]) if len(a) > 2 else 1.0, **kw)))
