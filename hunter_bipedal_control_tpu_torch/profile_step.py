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
    python -m hunter_bipedal_control_tpu_torch.profile_step qp_phases [batch] [iterations]
    python -m hunter_bipedal_control_tpu_torch.profile_step riccati_phases [batch] [knots] [horizon]
    python -m hunter_bipedal_control_tpu_torch.profile_step wbc_qp_phases [batch] [wbc_qp.cu]
    python -m hunter_bipedal_control_tpu_torch.profile_step wbc_qp_times [other/wbc_qp.cu]
    python -m hunter_bipedal_control_tpu_torch.profile_step backends_spread [moves] [riccati.cu]
    python -m hunter_bipedal_control_tpu_torch.profile_step ddp_rollout_phases [B] [N] [H] [RK2|ODE45] [ddp_rollout.cu]
    python -m hunter_bipedal_control_tpu_torch.profile_step ddp_rollout_times [other/ddp_rollout.cu]
    python -m hunter_bipedal_control_tpu_torch.profile_step soa_phases [B] [N] [soa_linearize.cu]
    python -m hunter_bipedal_control_tpu_torch.profile_step soa_times [other/soa_linearize.cu]
    python -m hunter_bipedal_control_tpu_torch.profile_step sim_step_phases [B] [sim_step.cu]
    python -m hunter_bipedal_control_tpu_torch.profile_step sim_step_times
    python -m hunter_bipedal_control_tpu_torch.profile_step leg_ik_phases [B] [S] [leg_ik.cu]
    python -m hunter_bipedal_control_tpu_torch.profile_step leg_ik_times [other/leg_ik.cu]
    python -m hunter_bipedal_control_tpu_torch.profile_step project_phases [B] [N] [project_knot.cu]
    python -m hunter_bipedal_control_tpu_torch.profile_step project_times [other/project_knot.cu]
    python -m hunter_bipedal_control_tpu_torch.profile_step kalman_phases [B] [kalman_update.cu]
    python -m hunter_bipedal_control_tpu_torch.profile_step kalman_times [other/kalman_update.cu]
    python -m hunter_bipedal_control_tpu_torch.profile_step observer_phases [B] [loop|batch] [momentum_observer.cu]
    python -m hunter_bipedal_control_tpu_torch.profile_step observer_times [other/momentum_observer.cu]
    python -m hunter_bipedal_control_tpu_torch.profile_step swing_plan_phases [B] [S] [reference_prep.cu]
    python -m hunter_bipedal_control_tpu_torch.profile_step swing_plan_times [other/reference_prep.cu]
    python -m hunter_bipedal_control_tpu_torch.profile_step own_times [solves] [periods]
    python -m hunter_bipedal_control_tpu_torch.profile_step rt_factor [periods]

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
search's choice).  ``qp_phases`` splits kernel B4's iteration on the WBC's
QP into its phases by the kernel's own clock (``profile_qp_phases``);
``riccati_phases`` splits kernel B3's knot on the flagship's cold-step LQ
data the same way (``profile_riccati_phases``: the copies' wait, SM, H,
the factor, the first knot's gains, S and s, the rollout; the back sweep's
own cycles apart, as they overlap the factor); ``wbc_qp_phases`` splits
kernel B9 on the standing and walking WBC batches the same way
(``profile_wbc_qp_phases``: scenario 0's cycles by WBC_QP_PHASE_NAMES), and
``wbc_qp_times`` times B9 around its wrapper and by its own device time,
beside another ``wbc_qp.cu`` if given (``profile_wbc_qp_times``).
``ddp_rollout_phases`` splits kernel B15 on the DDP's first
iteration's closed-loop rollouts the same way (``profile_ddp_rollout_phases``:
rollout 0's cycles per knot by DDP_ROLLOUT_PHASE_NAMES), beside the
kernel's time and own device time, optionally for another
``ddp_rollout.cu`` (e.g. a parent checkout's with the same clock marks);
``ddp_rollout_times`` times B15 on chip_smoke's three DDP cells
(``profile_ddp_rollout_times``), beside another ``ddp_rollout.cu`` if
given, with the two sources' outputs compared bit for bit.
``soa_phases`` splits both entry points of kernel B1 on the warm MPC
step's linearization and merit inputs (B=1, N=53 or B=128, N=66) the same
way (``profile_soa_phases``: the cycles by SOA_LIN_PHASE_NAMES and
SOA_MERIT_PHASE_NAMES), optionally for another ``soa_linearize.cu``;
``soa_times`` times both at both shapes, beside another
``soa_linearize.cu`` if given (``profile_soa_times``).
``sim_step_phases`` splits kernel B11 on
``entry.sim_step_batch``'s tick the same way (``profile_sim_step_phases``:
scenario 0's cycles per substep by SIM_STEP_PHASE_NAMES), beside the
kernel's time and own device time, optionally for another ``sim_step.cu``;
``sim_step_times`` times the package's B11 at B=1 and 1024
(``profile_sim_step_times``);
``leg_ik_phases`` splits kernel B8a on the warm MPC step's IK inputs
(B=1 with 6 samples, the product shape, or B=128 with 7, the bench shape)
the same way (``profile_leg_ik_phases``: problem 0's cycles per IK step by
LEG_IK_PHASE_NAMES), beside the kernel's time and own device time,
optionally for another ``leg_ik.cu``; ``leg_ik_times`` times the
package's B8a at both shapes, beside another ``leg_ik.cu`` if given
(``profile_leg_ik_times``);
``project_phases`` splits kernel B2 on the warm MPC step's projection
inputs and the DDP's first iteration's (B=1, N=53 or B=128, N=66) the
same way (``profile_project_phases``: block 0's cycles per knot by
PROJ_PHASE_NAMES), optionally for another ``project_knot.cu``;
``project_times`` times the package's B2 on those inputs at B=1, N=53 and
B=128, N=66 and on the DDP's at B=128, N=66, beside another
``project_knot.cu`` if given (``profile_project_times``);
``kalman_phases`` splits kernel B12 on a walking update of the full-order
loop (B=1) or on ``entry.estimator_batch(4096)`` the same way
(``profile_kalman_phases``: block 0's cycles per update by
KF_PHASE_NAMES), optionally for another ``kalman_update.cu``;
``kalman_times`` times B12 on both beside another ``kalman_update.cu`` if
given (``profile_kalman_times``);
``observer_phases`` splits kernel B10 on a walking update of the
full-order loop (B=1, "loop") or on ``entry.estimator_batch(B)``
("batch") the same way (``profile_observer_phases``: block 0's cycles per
update by OBS_PHASE_NAMES), optionally for another
``momentum_observer.cu``; ``observer_times`` times B10 on both at B=1 and
B=4096 beside another ``momentum_observer.cu`` if given, compares the two
sources' outputs, and splits the wrapper's host time
(``profile_observer_times``);
``swing_plan_phases`` splits kernel B8b1 on the warm MPC step's inputs
(B=1 with 6 samples, the product shape, or B=128 with 7, the bench shape)
the same way (``profile_swing_plan_phases``: block 0's cycles by
SP_PHASE_NAMES), optionally for another ``reference_prep.cu``;
``swing_plan_times`` times B8b1 at both shapes beside another
``reference_prep.cu`` if given, compares the two sources' outputs and
decisions, and splits the wrapper's host time (``profile_swing_plan_times``);
``own_times`` reads the own device time at B=1 of B5, B8b2, B16 and B11
on the chained solve and the full-order loop (``profile_own_times``);
``rt_factor`` times the full-order loop without the profiler
(``profile_rt_factor``).
``backends_spread`` measures
no time: it reads how far the flagship's warm step with the dense
linearization lands from the one with kernel B1, scenario by scenario, at
x_init as built and moved by one ulp (``profile_backends_spread``),
optionally with kernel B3 built from another ``riccati.cu``.
"""
from __future__ import annotations

import contextlib
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


def own_device_time(call, n_calls: int, kernel: str):
    """``call()`` n_calls times under the profiler: the kernel's own device
    time per launch the profiler recorded (ms), apart from its wrapper's
    host work (None when it recorded none; it may keep fewer launches than
    were made), and the launches it recorded."""
    import torch

    def calls():
        for _ in range(n_calls):
            call()
        torch.cuda.synchronize()

    own = [k for k in _profiled(calls, 1, 4)["top_kernels"] if kernel in k["name"]]
    recorded = sum(k["count"] for k in own)
    return (sum(k["ms"] for k in own) / recorded if recorded else None), recorded


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
              ("momentum_observer_update", "sim"), ("contact_class", "sim"),
              ("control_tick", "sim"), ("wbc_qp", "wbc"),
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
    contact classification (kernel B16, one launch a tick), the MPC step,
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
             "classification": by["contact_class"],
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


def _clock_phases(source: str, define: str, entry: str, reader: str, n: int, run):
    """``run()`` with ``csrc/<source>`` built once more with ``-D<define>``
    (``_build.measurement_library``) in place of the package's library:
    the ``n`` clock sums its ``reader`` returns (and zeroes) over one run
    after a warm-up, and the kernel's median time with the clocks in (CUDA
    events, 15 runs).  Returns (sums, ms)."""
    import ctypes

    import torch

    from .kernels import _build

    lib = _build.measurement_library(source, define, [entry])
    read = getattr(lib, reader)
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    cycles = (ctypes.c_ulonglong * n)()
    real_library = _build.library
    _build.library = lambda: lib
    try:
        run()
        torch.cuda.synchronize()
        read(cycles)
        run()
        torch.cuda.synchronize()
        if read(cycles) != 0:
            raise RuntimeError(f"{reader} failed")
        ms = _event_ms(run)
    finally:
        _build.library = real_library
    return list(cycles), ms


@contextlib.contextmanager
def _entry_from(lib, entry: str):
    """Within the block, the package's kernel library with its C entry point
    ``entry`` taken from ``lib`` (a measurement build, or ``_Stub()``)."""
    from .kernels import _build

    real_library = _build.library
    swapped = _WithEntry(lib, real_library(), entry)
    _build.library = lambda: swapped
    try:
        yield
    finally:
        _build.library = real_library


def _kernel_times(run, kernel: str, calls: int, entry: str | None = None):
    """A kernel through its wrapper ``run()``, with the library in place:
    its median time around the wrapper (``_event_ms``), its own device time
    per recorded launch (``own_device_time`` over ``calls`` calls, the
    device kernels whose name holds ``kernel``), the wrapper's host time per
    call with the calls enqueued back to back, their device time per call
    back to back (two events), and given the C ``entry`` point the
    wrapper's host time with that call stubbed out."""
    import torch

    kernel_ms = _event_ms(run)
    own, recorded = own_device_time(run, calls, kernel)
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    ev0.record()
    for _ in range(calls):
        run()
    host_ms = (time.perf_counter() - t) * 1e3 / calls
    ev1.record()
    ev1.synchronize()
    out = {"kernel_ms": kernel_ms, "kernel_device_ms": own, "profiled_launches": recorded,
           "profiled_calls": calls, "host_ms_per_call": host_ms,
           "back_to_back_ms": ev0.elapsed_time(ev1) / calls}
    if entry is not None:
        with _entry_from(_Stub(), entry):
            t = time.perf_counter()
            for _ in range(calls):
                run()
            out["host_ms_without_launch"] = (time.perf_counter() - t) * 1e3 / calls
    return out


def _ptxas(tag: str):
    """The ptxas lines (with the stack and spill lines) of the measurement
    builds whose library name holds ``tag``."""
    from .kernels import _build

    return {k.rsplit("/", 1)[-1]: [ln.strip() for ln in v.splitlines()
                                   if "ptxas" in ln or "spill" in ln]
            for k, v in _build.measurement_logs.items() if tag in k.rsplit("/", 1)[-1]}


def _kernel_phases(source: str, define: str, entry: str, names, run, kernel: str,
                   calls: int, extra=None):
    """``run()`` with ``csrc/<source>`` (or the file at the path ``source``)
    built with ``-D<define>`` (``_clock_phases``, the reader
    ``<entry>_phase_cycles``): the clock sums by ``names`` and the kernel's
    median time with the clocks in; then the source built without the
    clocks in place of ``entry``, timed by ``_kernel_times`` (and
    ``extra()``'s result under "extra", if given); the ptxas lines of both
    builds."""
    from .kernels import _build

    cycles, clocked_ms = _clock_phases(source, define, entry, f"{entry}_phase_cycles",
                                       len(names), run)
    with _entry_from(_build.measurement_library(source, None, [entry]), entry):
        times = _kernel_times(run, kernel, calls, entry)
        more = {} if extra is None else {"extra": extra()}
    tag = entry.removeprefix("hk_")
    return {"cycles": dict(zip(names, cycles)), "total_cycles": sum(cycles),
            "clocked_kernel_ms": clocked_ms, **times, **more, "ptxas": _ptxas(tag)}


def _compare_sources(cases, entry: str, other: str | None, measure):
    """``measure(args)`` on each of ``cases`` (name: args) with the
    package's library; given ``other`` (a source of the same C interface,
    e.g. a parent checkout's), with its ``entry`` built by
    ``_build.measurement_library`` in place of the package's too, in the
    order package, other, other, package.  Returns the order and, per
    source and case, the list of results in that order."""
    from .kernels import _build

    libs = {"package": None}
    if other is not None:
        libs[other] = _build.measurement_library(other, None, [entry])
    order = list(libs) + list(reversed(libs)) if other is not None else list(libs)
    out = {name: {case: [] for case in cases} for name in libs}
    for name in order:
        with (_entry_from(libs[name], entry) if libs[name] is not None
              else contextlib.nullcontext()):
            for case, args in cases.items():
                out[name][case].append(measure(args))
    return order, out


QP_PHASE_NAMES = ("mu", "residuals", "hbar_rbar", "chol_hbar", "forward_sweep", "schur",
                  "chol_schur", "dnu", "dx", "step")


def profile_qp_phases(batch: int = 1, iters: int = 10):
    """Kernel B4 on the WBC's QP (``entry.build_wbc_batch``'s first
    ``batch`` standing states, cold, ``iters`` iterations), built once more
    with ``-DQP_PHASE_CLOCKS`` (``_clock_phases``): QP 0's clock64 cycles per
    iteration by phase and the kernel's median time with the clocks in."""
    import torch

    from .entry import build_wbc_batch
    from .ops import qp
    from .wbc import wbc

    wb = build_wbc_batch(batch, torch.device("cuda"))
    data = [t.contiguous() for t in wbc.wbc_qp(wb.model, wb.params, wb.x_des, wb.u_des, wb.rbd,
                                               wb.contact_flags, wb.stance_mode)]
    cycles, ms = _clock_phases("solve_qp.cu", "QP_PHASE_CLOCKS", "hk_solve_qp",
                               "hk_qp_phase_cycles", len(QP_PHASE_NAMES),
                               lambda: qp.solve_qp(*data, n_iters=iters))
    return {"phase": "profile_qp_phases", "batch": batch, "iterations": iters,
            "device": torch.cuda.get_device_name(0),
            "cycles_per_iteration": {p: c / iters for p, c in zip(QP_PHASE_NAMES, cycles)},
            "total_cycles_per_iteration": sum(cycles) / iters, "kernel_ms": ms}


# the last is the back sweep's own cycles (warp 1), which overlap the factor:
# not in the total
RICCATI_PHASE_NAMES = ("loads", "sm", "h", "factor", "gains", "s_update", "rollout",
                       "gains_off_chain")


def profile_riccati_phases(batch: int = 1, knots: int = 53, horizon: float = 0.8):
    """Kernel B3 on the flagship's cold-step LQ data (``entry.projected_lq``),
    built once more with ``-DRICCATI_PHASE_CLOCKS`` (``_clock_phases``):
    scenario 0's clock64 cycles per knot by phase (the rollout's over the
    knots too) and the kernel's median time with the clocks in."""
    import torch

    from .entry import build_flagship, projected_lq
    from .solver import riccati

    flag = build_flagship(knots, horizon, batch=batch, device="cuda")
    args = (*projected_lq(flag), flag.settings.hess_reg)
    cycles, ms = _clock_phases("riccati.cu", "RICCATI_PHASE_CLOCKS", "hk_riccati_solve",
                               "hk_riccati_phase_cycles", len(RICCATI_PHASE_NAMES),
                               lambda: riccati.riccati_solve(*args))
    return {"phase": "profile_riccati_phases", "batch": batch, "knots": knots,
            "horizon": horizon, "device": torch.cuda.get_device_name(0),
            "cycles_per_knot": {p: c / knots for p, c in zip(RICCATI_PHASE_NAMES, cycles)},
            "total_cycles_per_knot": sum(cycles[:-1]) / knots, "kernel_ms": ms}


# kernel B9's phases (csrc/wbc_qp.cu, -DWBC_QP_PHASE_CLOCKS): the inputs'
# loads, the two states' chains (with the desired base velocity), the
# Jacobian columns, M / nle / the desired base acceleration, the task rows,
# H and g, the constraint rows' stores
WBC_QP_PHASE_NAMES = ("loads", "chains", "columns", "dynamics", "rows", "h_g", "stores")
# kernel calls under the profiler for B9's own device time
WBC_QP_PROFILED_CALLS = 20


def _wbc_qp_cases(batch: int):
    """B9's argument tuples at ``batch``: bench.py's standing batch and
    ``entry.walking_wbc_batch`` (seed 0), on the card."""
    import torch

    from .entry import build_wbc_batch, walking_wbc_batch

    dev = torch.device("cuda")
    return {name: (wb.model, wb.params, wb.x_des, wb.u_des, wb.rbd, wb.contact_flags,
                   wb.stance_mode)
            for name, wb in (("standing", build_wbc_batch(batch, dev)),
                             ("walking", walking_wbc_batch(batch, dev, seed=0)))}


def _tick_wbc_inputs(ticks: int = 50):
    """B9's arguments on the last of ``ticks`` chained ticks of the tick path
    (B=1, the product shape's cold policy), as chip_smoke's phase 4b runs it."""
    import torch

    from .entry import build_controller, tick_chain
    from .runtime import controller as ctrl_mod

    flag, policy = _tick_policy(1, "soa")
    setup = build_controller(1)
    seen, real = [], ctrl_mod.wbc_solve

    def keep(model, params, state, *a):
        seen.append((model, params, *(t.contiguous() for t in a)))
        return real(model, params, state, *a)

    ctrl_mod.wbc_solve = keep
    try:
        tick_chain(setup, policy, flag.schedule, ticks)
    finally:
        ctrl_mod.wbc_solve = real
    torch.cuda.synchronize()
    return seen[-1]


def profile_wbc_qp_phases(batch: int = 1, source: str = "wbc_qp.cu"):
    """Kernel B9 (``csrc/<source>``, or the file at the path ``source``)
    built once more with ``-DWBC_QP_PHASE_CLOCKS`` (``_clock_phases``) on
    bench.py's standing batch and on ``entry.walking_wbc_batch`` at
    ``batch``: scenario 0's clock64 cycles by phase (WBC_QP_PHASE_NAMES) and
    the kernel's median time with the clocks in; and the ptxas lines of the
    package's build of csrc/wbc_qp.cu."""
    import torch

    from .kernels import _build
    from .wbc import wbc

    out = {}
    for name, args in _wbc_qp_cases(batch).items():
        wbc.wbc_qp(*args)  # the constants and gains on the card, by the package's library
        cycles, ms = _clock_phases(source, "WBC_QP_PHASE_CLOCKS", "hk_wbc_qp",
                                   "hk_wbc_qp_phase_cycles", len(WBC_QP_PHASE_NAMES),
                                   lambda: wbc.wbc_qp(*args))
        out[name] = {"cycles": dict(zip(WBC_QP_PHASE_NAMES, cycles)),
                     "total_cycles": sum(cycles), "kernel_ms": ms}
    log = _build.build_log.split("== wbc_qp.cu", 1)[-1].split("\n== ", 1)[0]
    return {"phase": "profile_wbc_qp_phases", "batch": batch, "source": source,
            "device": torch.cuda.get_device_name(0), **out,
            "ptxas": [ln.strip() for ln in log.splitlines() if "ptxas" in ln]}


def profile_wbc_qp_times(other: str | None = None):
    """Kernel B9 timed by ``_kernel_times`` (WBC_QP_PROFILED_CALLS calls) on
    the tick path's last tick (B=1) and at B=4096 on bench.py's standing
    batch and ``entry.walking_wbc_batch``, beside another ``wbc_qp.cu`` of
    the same C interface if given (``_compare_sources``)."""
    import torch

    from .wbc import wbc

    cases = {"tick_b1": _tick_wbc_inputs()}
    cases.update({f"{k}_b4096": v for k, v in _wbc_qp_cases(4096).items()})
    order, out = _compare_sources(
        cases, "hk_wbc_qp", other,
        lambda args: _kernel_times(lambda: wbc.wbc_qp(*args), "wbc_qp_kernel",
                                   WBC_QP_PROFILED_CALLS, "hk_wbc_qp"))
    return {"phase": "profile_wbc_qp_times", "device": torch.cuda.get_device_name(0),
            "profiled_calls": WBC_QP_PROFILED_CALLS, "order": order, "times": out}


# kernel B15's phases (csrc/ddp_rollout.cu, -DDDP_ROLLOUT_PHASE_CLOCKS): the
# knot's loads and the outputs' stores, the feedback, the row pass's FK, base
# velocity (world inertias, momentum, the base block), full velocities and
# contact points and velocities, the rows' terms (flow rows, equality and
# soft rows, |g|_1), the stage cost, the integrator's further flows, and
# the integrator's own work (axpys, stage sums, ODE45's error norm and
# decisions)
DDP_ROLLOUT_PHASE_NAMES = ("loads", "feedback", "fk", "base_velocity", "velocity_contacts",
                           "row_terms", "stage_cost", "flows", "integrator")
# kernel calls under the profiler for B15's own device time
DDP_ROLLOUT_PROFILED_CALLS = 10


# chip_smoke's DDP cells: (name, B, N, horizon, integrator)
DDP_ROLLOUT_CELLS = (("product_rk2", 1, 53, 0.8, "RK2"), ("product_ode45", 1, 53, 0.8, "ODE45"),
                     ("bench_rk2", 128, 66, 1.0, "RK2"))


def _ddp_rollout_args(batch: int, knots: int, horizon: float, integrator: str):
    """``ddp.closed_rollout``'s arguments on the first iteration of
    ``entry.ddp_solve`` on the flagship (six step sizes, one iteration after
    three SQP solves), on the card."""
    import torch

    from .entry import build_flagship, ddp_solve
    from .solver import ddp

    flag = build_flagship(knots, horizon, batch=batch, device="cuda")
    settings = ddp.DdpSettings(n_intervals=knots, horizon=horizon, integrator=integrator,
                               n_iterations=1)
    its = []
    run = ddp_solve(flag, settings, on_iteration=its.append)
    it = its[0]
    return (flag.model, flag.params, run.refs, flag.x0, it["xs"], it["us"],
            it["Ks"].contiguous(), it["kffs"].contiguous(),
            torch.tensor(settings.alphas, device=flag.x0.device), ddp.rollout_settings(settings))


def _event_ms(fn, reps: int = 15):
    """Median time of one ``fn()`` between two CUDA events."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _outputs_apart(a, b):
    """Per output of two runs: whether they agree bit for bit (NaN where
    NaN), how many entries do not, their largest absolute difference where
    both are finite and the first run's largest finite magnitude."""
    import torch

    out = {}
    for i, (x, y) in enumerate(zip(a, b)):
        bits = (x.view(torch.int32), y.view(torch.int32)) if x.dtype == torch.float32 else (x, y)
        fin = torch.isfinite(x.double()) & torch.isfinite(y.double())
        diff = (x.double() - y.double()).abs()[fin]
        out[str(i)] = {"bit_equal": bool(torch.equal(*bits)),
                       "entries_apart": int((bits[0] != bits[1]).sum()),
                       "max_abs_diff": float(diff.max()) if diff.numel() else 0.0,
                       "scale": float(x.double()[fin].abs().max()) if diff.numel() else 0.0,
                       "finite_equal": bool(torch.equal(torch.isfinite(x.double()),
                                                        torch.isfinite(y.double())))}
    return out


def profile_ddp_rollout_times(other: str | None = None):
    """Kernel B15 on each of chip_smoke's DDP cells (DDP_ROLLOUT_CELLS, the
    first iteration's closed-loop rollouts), timed by ``_kernel_times``
    (DDP_ROLLOUT_PROFILED_CALLS calls).  Given ``other`` (another
    ``ddp_rollout.cu`` of the same C interface, e.g. a parent checkout's),
    the same beside it (package, other, other, package: "times") and each
    cell's outputs of the two compared ("outputs_vs_other").  chip_smoke
    runs this in a process of its own, whose profiler records every launch."""
    import torch

    from .kernels import _build
    from .solver import ddp

    cells = {name: (batch, knots, integrator,
                    _ddp_rollout_args(batch, knots, horizon, integrator))
             for name, batch, knots, horizon, integrator in DDP_ROLLOUT_CELLS}

    def measure(args):
        return _kernel_times(lambda: ddp.closed_rollout(*args), "ddp_rollout",
                             DDP_ROLLOUT_PROFILED_CALLS, "hk_ddp_rollout")

    order, times = _compare_sources({n: c[3] for n, c in cells.items()}, "hk_ddp_rollout",
                                    other, measure)
    out = {n: {"batch": b, "knots": k, "integrator": i, **times["package"][n][0]}
           for n, (b, k, i, _) in cells.items()}
    res = {"phase": "profile_ddp_rollout_times", "device": torch.cuda.get_device_name(0),
           "profiled_calls": DDP_ROLLOUT_PROFILED_CALLS, "cells": out}
    if other is not None:
        lib = _build.measurement_library(other, None, ["hk_ddp_rollout"])
        apart = {}
        for n, (_, _, _, args) in cells.items():
            mine = [t.clone() for t in ddp.closed_rollout(*args)]
            with _entry_from(lib, "hk_ddp_rollout"):
                theirs = [t.clone() for t in ddp.closed_rollout(*args)]
            torch.cuda.synchronize()
            apart[n] = _outputs_apart(mine, theirs)
        res.update(other=other, order=order, times=times, outputs_vs_other=apart,
                   ptxas=_ptxas("ddp_rollout"))
    return res


def profile_ddp_rollout_phases(batch: int = 1, knots: int = 53, horizon: float = 0.8,
                               integrator: str = "RK2", source: str = "ddp_rollout.cu"):
    """Kernel B15 (``csrc/<source>``, or the file at the path ``source``) on
    the first iteration's closed-loop rollouts of ``entry.ddp_solve`` on the
    flagship (six step sizes, one iteration after three SQP solves),
    measured by ``_kernel_phases`` with ``-DDDP_ROLLOUT_PHASE_CLOCKS``:
    rollout 0's clock64 cycles per knot by DDP_ROLLOUT_PHASE_NAMES, the
    kernel's times with and without the clocks, the accepted slots of the
    build without them, and the ptxas lines of both builds."""
    import torch

    from .solver import ddp

    args = _ddp_rollout_args(batch, knots, horizon, integrator)
    run = lambda: ddp.closed_rollout(*args)  # noqa: E731
    run()  # the constants on the card, by the package's library
    m = _kernel_phases(source, "DDP_ROLLOUT_PHASE_CLOCKS", "hk_ddp_rollout",
                       DDP_ROLLOUT_PHASE_NAMES, run, "ddp_rollout", DDP_ROLLOUT_PROFILED_CALLS,
                       extra=lambda: int(run()[4].sum()))
    cycles = m.pop("cycles")
    return {"phase": "profile_ddp_rollout_phases", "batch": batch, "knots": knots,
            "horizon": horizon, "integrator": integrator, "source": source,
            "step_sizes": args[8].shape[0], "accepted_slots": m.pop("extra"),
            "device": torch.cuda.get_device_name(0),
            "cycles_per_knot": {p: c / knots for p, c in cycles.items()},
            "total_cycles_per_knot": m.pop("total_cycles") / knots, **m}


# kernel B11's phases (csrc/sim_step.cu, -DSIM_STEP_PHASE_CLOCKS): the chain
# (FK, world inertias, the velocity pass), the Jacobian columns, the dynamics
# (M, nle with the field, the contact law, the motors), the tableau
# [A_sys | rhs], its solve, the semi-implicit Euler update
SIM_STEP_PHASE_NAMES = ("chain", "columns", "dynamics", "tableau", "solve", "euler")
# kernel calls under the profiler for B11's own device time
SIM_STEP_PROFILED_CALLS = 20


def _sim_step_args(batch: int):
    """``fullorder.substeps``' arguments on ``entry.sim_step_batch(batch,
    seed=0)``'s tick (a 9 ms delay ring, feet on both sides of the contact
    surface, per-scenario mass scale and field), on the card."""
    import torch

    from .backends import fullorder
    from .entry import sim_step_batch

    sb = sim_step_batch(batch, torch.device("cuda"), seed=0, delay_ms=9.0)
    active = fullorder._push_command(sb.params, sb.state, sb.command)[2].contiguous()
    return (sb.model, sb.params, sb.state.q, sb.state.v, active)


def profile_sim_step_phases(batch: int = 1, source: str = "sim_step.cu"):
    """Kernel B11 (``csrc/<source>``, or the file at the path ``source``) on
    ``_sim_step_args(batch)``, measured by ``_kernel_phases`` with
    ``-DSIM_STEP_PHASE_CLOCKS``: scenario 0's clock64 cycles per substep by
    SIM_STEP_PHASE_NAMES, the kernel's times with and without the clocks,
    and the ptxas lines of both builds."""
    import torch

    from .backends import fullorder

    args = _sim_step_args(batch)
    n_sub = args[1].substeps
    run = lambda: fullorder.substeps(*args)  # noqa: E731
    run()  # the constants on the card, by the package's library
    m = _kernel_phases(source, "SIM_STEP_PHASE_CLOCKS", "hk_sim_step", SIM_STEP_PHASE_NAMES,
                       run, "sim_step", SIM_STEP_PROFILED_CALLS)
    cycles = m.pop("cycles")
    return {"phase": "profile_sim_step_phases", "batch": batch, "source": source,
            "substeps": n_sub, "device": torch.cuda.get_device_name(0),
            "cycles_per_substep": {p: c / n_sub for p, c in cycles.items()},
            "total_cycles_per_substep": m.pop("total_cycles") / n_sub, **m}


def profile_sim_step_times():
    """Kernel B11 as the package builds it, timed by ``_kernel_times`` at
    B=1 and B=1024 (``_sim_step_args``).  chip_smoke runs this in a process
    of its own, whose profiler records every launch."""
    import torch

    from .backends import fullorder

    def times(args):
        return _kernel_times(lambda: fullorder.substeps(*args), "sim_step",
                             SIM_STEP_PROFILED_CALLS, "hk_sim_step")

    return {"phase": "profile_sim_step_times", "device": torch.cuda.get_device_name(0),
            "batches": {str(b): times(_sim_step_args(b)) for b in (1, 1024)}}


# kernel B8a's phases (csrc/leg_ik.cu, -DLEG_IK_PHASE_CLOCKS): the base,
# the targets and the constants; a toe evaluation's local transforms, its
# chain and its Jacobian columns; the translation step's damped solve; the
# rotation step's projector (local frame, N, Jang N) and its damped solve
# with the step; the error (log3 for the rotation), the keep-if-improved
# test; the output stores
LEG_IK_PHASE_NAMES = ("setup", "local", "chain", "jacobian", "trans_solve", "rot_projector",
                      "rot_solve", "error_keep", "store")
# kernel calls under the profiler for B8a's own device time
LEG_IK_PROFILED_CALLS = 20
# the MPC step's shapes by the IK's sample count: (knots, horizon)
LEG_IK_SHAPES = {6: (53, 0.8), 7: (66, 1.0)}


def _leg_ik_args(batch: int, samples: int):
    """``ik.leg_ik``'s arguments as the flagship's warm MPC step gives them
    at ``batch`` (the product shape's 53 knots over 0.8 s for 6 samples,
    the bench shape's 66 over 1.0 s for 7), captured on the card."""
    import torch

    from .entry import build_flagship
    from .refs import ik as ik_mod
    from .solver.mpc import Mpc

    knots, horizon = LEG_IK_SHAPES[samples]
    flag = build_flagship(knots, horizon, batch=batch)
    mpc = Mpc(flag.model, flag.settings, flag.params, flag.planner_cfg)
    args = (flag.schedule, flag.target, 0.0, flag.x0,
            torch.zeros(6, device=flag.x0.device), flag.default_joints)
    _, state, _ = mpc(flag.state, *args)
    seen, real = [], ik_mod.joint_reference_ik

    def keep(*a, **k):
        seen.append((a, k))
        return real(*a, **k)

    ik_mod.joint_reference_ik = keep
    try:
        mpc(state, *args)
    finally:
        ik_mod.joint_reference_ik = real
    torch.cuda.synchronize()
    (model, *arrays), kw = seen[-1]
    assert arrays[0].shape[:2] == (batch, samples), arrays[0].shape
    return (model, *(a.contiguous() for a in arrays)), kw


def _leg_ik_times(case):
    """Kernel B8a through its wrapper on ``case`` = (args, kw), timed by
    ``_kernel_times`` (LEG_IK_PROFILED_CALLS calls)."""
    from .refs import ik as ik_mod

    args, kw = case
    return _kernel_times(lambda: ik_mod.leg_ik(*args, **kw), "leg_ik", LEG_IK_PROFILED_CALLS,
                         "hk_leg_ik")


def profile_leg_ik_phases(batch: int = 1, samples: int = 6, source: str = "leg_ik.cu"):
    """Kernel B8a (``csrc/<source>``, or the file at the path ``source``) on
    ``_leg_ik_args(batch, samples)``, measured by ``_kernel_phases`` with
    ``-DLEG_IK_PHASE_CLOCKS``: problem 0's clock64 cycles per IK step (both
    passes' trans_it + rot_it steps) by LEG_IK_PHASE_NAMES, the kernel's
    times with and without the clocks, and the ptxas lines of both builds."""
    import torch

    from .refs import ik as ik_mod

    args, kw = _leg_ik_args(batch, samples)
    steps = 2 * (kw["trans_it"] + kw["rot_it"])
    run = lambda: ik_mod.leg_ik(*args, **kw)  # noqa: E731
    run()  # the constants on the card, by the package's library
    m = _kernel_phases(source, "LEG_IK_PHASE_CLOCKS", "hk_leg_ik", LEG_IK_PHASE_NAMES, run,
                       "leg_ik", LEG_IK_PROFILED_CALLS)
    cycles = m.pop("cycles")
    return {"phase": "profile_leg_ik_phases", "batch": batch, "samples": samples,
            "source": source, "steps": steps, "device": torch.cuda.get_device_name(0),
            "cycles_per_step": {p: c / steps for p, c in cycles.items()},
            "total_cycles_per_step": m["total_cycles"] / steps, **m}


def profile_leg_ik_times(other: str | None = None):
    """Kernel B8a as the package builds it, timed by ``_leg_ik_times`` on
    the warm MPC step's inputs at B=1, S=6 (the product shape) and B=128,
    S=7 (the bench shape), beside another ``leg_ik.cu`` of the same C
    interface if given (``_compare_sources``).  chip_smoke runs this in a
    process of its own, whose profiler records every launch."""
    import torch

    cases = {f"b{b}_s{s}": _leg_ik_args(b, s) for b, s in ((1, 6), (128, 7))}
    order, out = _compare_sources(cases, "hk_leg_ik", other, _leg_ik_times)
    return {"phase": "profile_leg_ik_times", "device": torch.cuda.get_device_name(0),
            "order": order, "times": out, "ptxas": _ptxas("leg_ik")}


# kernel B1's phases (csrc/soa_linearize.cu, -DSOA_PHASE_CLOCKS).  The
# linearization: block 0's cycles (thread 0) by the loads, the primal chain,
# the RK2 midpoint flow (beside the per-link velocity terms), the per-link
# whole-body sums, the columns (CMM, euler and contact Jacobian columns,
# Vh, Vv, dvb, Jcom), H / W / dvc / dhdot, the assembly of Jx, Ju, C, D and
# the soft rows' Jacobians, the penalties, the dense tail (A, B, the GGN
# quadratics) and the stores with the cost.  The merit: the cycles of the
# thread (lane) that runs scenario 0, candidate 0's first knot, summed over
# the knots it runs, by the loads, the rows at x, the stage cost with
# |g mask|_1, the RK2 midpoint flow, the defect and the reduction of that
# candidate's sums.
SOA_LIN_PHASE_NAMES = ("load", "chain", "midpoint_flow", "per_link", "columns", "h_w_dvc",
                       "assembly", "penalties", "dense_tail", "store_cost")
SOA_MERIT_PHASE_NAMES = ("load", "rows", "stage_cost", "midpoint_flow", "defect", "reduction")
# kernel calls under the profiler for B1's own device time
SOA_PROFILED_CALLS = 20
# the MPC step's shapes: (batch, knots, horizon)
SOA_SHAPES = ((1, 53, 0.8), (128, 66, 1.0))
SOA_ENTRIES = {"linearize": ("hk_soa_linearize", "soa_linearize", SOA_LIN_PHASE_NAMES),
               "merit": ("hk_soa_merit", "soa_merit", SOA_MERIT_PHASE_NAMES)}


def _soa_args(batch: int, knots: int, horizon: float):
    """The arguments ``sqp.knot_linearization_all`` ("linearize") and
    ``sqp.eval_merit`` ("merit": two candidates) get on the flagship's warm
    MPC step at (batch, knots, horizon), captured on the card."""
    import torch

    from .entry import build_flagship
    from .solver import sqp
    from .solver.mpc import Mpc

    flag = build_flagship(knots, horizon, batch=batch)
    mpc = Mpc(flag.model, flag.settings, flag.params, flag.planner_cfg)
    args = (flag.schedule, flag.target, 0.0, flag.x0,
            torch.zeros(6, device=flag.x0.device), flag.default_joints)
    _, state, _ = mpc(flag.state, *args)
    seen, real = {}, (sqp.knot_linearization_all, sqp.eval_merit)

    def keep(name, fn):
        def run(*a):
            seen.setdefault(name, a)
            return fn(*a)
        return run

    sqp.knot_linearization_all, sqp.eval_merit = keep("linearize", real[0]), keep("merit", real[1])
    try:
        mpc(state, *args)
    finally:
        sqp.knot_linearization_all, sqp.eval_merit = real
    torch.cuda.synchronize()
    return seen


def _soa_call(name: str, args):
    from .solver import sqp

    fn = sqp.knot_linearization_all if name == "linearize" else sqp.eval_merit
    return lambda: fn(*args)


def profile_soa_phases(batch: int = 1, knots: int = 53, source: str = "soa_linearize.cu"):
    """Both entry points of kernel B1 (``csrc/<source>``, or the file at the
    path ``source``, e.g. a parent checkout's with the same clock marks) on
    ``_soa_args(batch, knots)``, measured by ``_kernel_phases`` with
    ``-DSOA_PHASE_CLOCKS``: the clock64 cycles by SOA_LIN_PHASE_NAMES and
    SOA_MERIT_PHASE_NAMES, the kernels' times with and without the clocks,
    and the ptxas lines of both builds."""
    import torch

    horizon = dict((n, h) for _, n, h in SOA_SHAPES).get(knots, knots / 66.0)
    cap = _soa_args(batch, knots, horizon)
    out = {}
    for name, (entry, kernel, names) in SOA_ENTRIES.items():
        run = _soa_call(name, cap[name])
        run()  # the constants on the card, by the package's library
        out[name] = _kernel_phases(source, "SOA_PHASE_CLOCKS", entry, names, run, kernel,
                                   SOA_PROFILED_CALLS)
    return {"phase": "profile_soa_phases", "batch": batch, "knots": knots, "horizon": horizon,
            "candidates": cap["merit"][-1].shape[1], "source": source,
            "device": torch.cuda.get_device_name(0), **out}


def profile_soa_times(other: str | None = None):
    """Both entry points of kernel B1 as the package builds them, timed by
    ``_kernel_times`` (SOA_PROFILED_CALLS calls) on the warm MPC step's
    inputs at B=1, N=53 (the product shape) and B=128, N=66 (the bench
    shape), beside another ``soa_linearize.cu`` of the same C interface if
    given (``_compare_sources``: package, other, other, package).  chip_smoke
    runs this in a process of its own, whose profiler records every launch."""
    import torch

    caps = {f"b{b}_n{n}": _soa_args(b, n, h) for b, n, h in SOA_SHAPES}
    out, order = {}, None
    for name, (entry, kernel, _) in SOA_ENTRIES.items():
        order, out[name] = _compare_sources(
            {case: _soa_call(name, cap[name]) for case, cap in caps.items()}, entry, other,
            lambda run, kernel=kernel, entry=entry: _kernel_times(run, kernel, SOA_PROFILED_CALLS,
                                                                  entry))
    return {"phase": "profile_soa_times", "device": torch.cuda.get_device_name(0),
            "order": order, "times": out, "ptxas": _ptxas("soa_linearize")}


# kernel B2's phases (csrc/project_knot.cu, -DPROJ_PHASE_CLOCKS): block 0's
# cycles (thread 0) summed over the knots it runs, by the wait for the
# inputs, the Gram, its elimination, D+, X and U, YQ and BU, T, and the
# stores left at the end; the last counter is the knots block 0 ran
PROJ_PHASE_NAMES = ("load", "gram", "elimination", "dplus", "x_u", "yq_bu", "t", "stores")
# kernel calls under the profiler for B2's own device time
PROJ_PROFILED_CALLS = 20
# the MPC step's and the DDP's shapes: (batch, knots, horizon)
PROJ_SHAPES = {(1, 53): 0.8, (128, 66): 1.0}


def _project_args(batch: int, knots: int, horizon: float):
    """The arguments ``sqp.project_knot`` gets on the flagship's warm MPC
    step ("mpc") and on the first iteration of ``ddp.solve`` (RK2, from
    ``entry.ddp_solve``'s warm start: "ddp") at (batch, knots, horizon),
    captured on the card."""
    import torch

    from .entry import build_flagship, ddp_solve
    from .solver import ddp, sqp
    from .solver.mpc import Mpc

    flag = build_flagship(knots, horizon, batch=batch)
    mpc = Mpc(flag.model, flag.settings, flag.params, flag.planner_cfg)
    args = (flag.schedule, flag.target, 0.0, flag.x0,
            torch.zeros(6, device=flag.x0.device), flag.default_joints)
    _, state, _ = mpc(flag.state, *args)
    dset = ddp.DdpSettings(n_intervals=knots, horizon=horizon, integrator="RK2",
                           n_iterations=2)
    run = ddp_solve(flag, dset)
    seen, real = [], sqp.project_knot

    def keep(*a):
        seen.append(a)
        return real(*a)

    keep.launches = 0  # the wrapper counts on the name it is called by
    sqp.project_knot = keep
    try:
        mpc(state, *args)
        n_mpc = len(seen)
        ddp.solve(flag.model, dset, flag.params, run.refs, flag.x0, run.warm.states,
                  run.warm.inputs[:, :-1])
    finally:
        sqp.project_knot = real
    torch.cuda.synchronize()
    return {"mpc": seen[0], "ddp": seen[n_mpc]}


def _project_call(args):
    from .solver import sqp

    return lambda: sqp.project_knot(*args)


def profile_project_phases(batch: int = 1, knots: int = 53, source: str = "project_knot.cu"):
    """Kernel B2 (``csrc/<source>``, or the file at the path ``source``, e.g.
    a parent checkout's with the same clock marks) on ``_project_args(batch,
    knots)``: the warm MPC step's projection and the DDP's first one,
    measured by ``_kernel_phases`` with ``-DPROJ_PHASE_CLOCKS``: block 0's
    clock64 cycles per knot by PROJ_PHASE_NAMES, the kernel's times with
    and without the clocks, and the ptxas lines of both builds."""
    import torch

    horizon = PROJ_SHAPES.get((batch, knots), knots / 66.0)
    cap = _project_args(batch, knots, horizon)
    out = {}
    for name, args in cap.items():
        m = _kernel_phases(source, "PROJ_PHASE_CLOCKS", "hk_project_knot",
                           PROJ_PHASE_NAMES + ("knots",), _project_call(args), "project_knot",
                           PROJ_PROFILED_CALLS)
        cycles = m.pop("cycles")
        ran = max(cycles.pop("knots"), 1)
        m.pop("total_cycles")
        out[name] = {"pivot": args[0].proj_pivot, "block0_knots": ran,
                     "inputs_mod16": [t.data_ptr() % 16 for t in args[1:]],
                     "cycles_per_knot": {p: c / ran for p, c in cycles.items()},
                     "total_cycles_per_knot": sum(cycles.values()) / ran, **m}
    return {"phase": "profile_project_phases", "batch": batch, "knots": knots,
            "horizon": horizon, "source": source, "device": torch.cuda.get_device_name(0),
            **out}


def profile_project_times(other: str | None = None):
    """Kernel B2 as the package builds it, timed by ``_kernel_times``
    (PROJ_PROFILED_CALLS calls) on the warm MPC step's projection inputs at
    B=1, N=53 (the product shape) and B=128, N=66 (the bench shape) and on
    the DDP's first iteration's at B=128, N=66, beside another
    ``project_knot.cu`` of the same C interface if given
    (``_compare_sources``: package, other, other, package; and each case's
    outputs of the two compared).  chip_smoke runs this in a process of its
    own, whose profiler records every launch."""
    import torch

    from .kernels import _build
    from .solver import sqp

    caps = {(b, n): _project_args(b, n, h) for (b, n), h in PROJ_SHAPES.items()}
    cases = {"b1_n53": caps[1, 53]["mpc"], "b128_n66": caps[128, 66]["mpc"],
             "ddp_b128_n66": caps[128, 66]["ddp"]}
    order, out = _compare_sources(
        cases, "hk_project_knot", other,
        lambda args: _kernel_times(_project_call(args), "project_knot", PROJ_PROFILED_CALLS,
                                   "hk_project_knot"))
    res = {"phase": "profile_project_times", "device": torch.cuda.get_device_name(0),
           "profiled_calls": PROJ_PROFILED_CALLS, "order": order, "times": out}
    if other is not None:
        lib = _build.measurement_library(other, None, ["hk_project_knot"])
        apart = {}
        for n, args in cases.items():
            mine = [t.clone() for t in sqp.project_knot(*args)]
            with _entry_from(lib, "hk_project_knot"):
                theirs = [t.clone() for t in sqp.project_knot(*args)]
            torch.cuda.synchronize()
            apart[n] = _outputs_apart(mine, theirs)
        res["outputs_vs_other"] = apart
    res["ptxas"] = _ptxas("project_knot")
    return res


# kernel B12's phases (csrc/kalman_update.cu, -DKF_PHASE_CLOCKS): block 0's
# cycles (thread 0) by the loads, the chain at a zero base (with the world
# acceleration and the gates), the contact points and their J v, Pm and
# x_pred, ey / Ssy / Pm C', the elimination, x_new (and G), P_new, the
# symmetrization, conditioning and stores
KF_PHASE_NAMES = ("load", "chain", "contacts_jv", "pm_xpred", "innovation", "elimination",
                  "xnew_g", "pnew", "stores")
# kernel calls under the profiler for B12's own device time
KF_PROFILED_CALLS = 20
# walking periods of the full-order loop whose filter updates are captured
KF_WALK_PERIODS = 2


def _kalman_args(batch: int):
    """``kalman.kalman_update``'s arguments on the card: at B=1 the last
    of the full-order loop's filter updates over KF_WALK_PERIODS walking
    periods (past ``_walking_sim_loop``'s gait switch, captured as
    chip_smoke 4i captures them), else ``entry.estimator_batch(batch,
    seed=0)``."""
    import torch

    from .entry import TICK_DT, estimator_batch, run_sim_loop
    from .runtime import sim_loop as sim_loop_mod

    if batch > 1:
        eb = estimator_batch(batch, torch.device("cuda"), seed=0)
        return (eb.model, eb.kalman_params, eb.kalman,
                *(eb.sensors[k] for k in ("zyx", "joint_pos", "joint_vel", "omega_world",
                                          "quat_xyzw", "linear_accel_local", "contact_flags")),
                TICK_DT)
    setup = _walking_sim_loop(False, "soa")
    seen, real = [], sim_loop_mod.kalman_update

    def keep(*a):
        seen.append(a)
        return real(*a)

    sim_loop_mod.kalman_update = keep
    try:
        run_sim_loop(setup, [WALK] * KF_WALK_PERIODS)
    finally:
        sim_loop_mod.kalman_update = real
    torch.cuda.synchronize()
    return seen[-1]


def _kalman_call(args):
    from .estim import kalman

    return lambda: kalman.kalman_update(*args)


def profile_kalman_phases(batch: int = 1, source: str = "kalman_update.cu"):
    """Kernel B12 (``csrc/<source>``, or the file at the path ``source``,
    e.g. a parent checkout's with the same clock marks) on
    ``_kalman_args(batch)``, measured by ``_kernel_phases`` with
    ``-DKF_PHASE_CLOCKS``: block 0's clock64 cycles per update by
    KF_PHASE_NAMES, the kernel's times with and without the clocks, and the
    ptxas lines of both builds."""
    import torch

    run = _kalman_call(_kalman_args(batch))
    run()  # the constants on the card, by the package's library
    m = _kernel_phases(source, "KF_PHASE_CLOCKS", "hk_kalman_update", KF_PHASE_NAMES, run,
                       "kalman_update", KF_PROFILED_CALLS)
    return {"phase": "profile_kalman_phases", "batch": batch, "source": source,
            "device": torch.cuda.get_device_name(0), **m}


def profile_kalman_times(other: str | None = None):
    """Kernel B12 as the package builds it, timed by ``_kernel_times``
    (KF_PROFILED_CALLS calls) at B=1 (a walking update of the full-order
    loop) and B=4096 (``entry.estimator_batch``), beside another
    ``kalman_update.cu`` of the same C interface if given
    (``_compare_sources``: package, other, other, package; and each case's
    outputs of the two compared).  chip_smoke runs this in a process of its
    own, whose profiler records every launch."""
    import torch

    from .estim import kalman
    from .kernels import _build

    cases = {"b1_sim_loop": _kalman_args(1), "b4096_estimator_batch": _kalman_args(4096)}
    order, out = _compare_sources(
        cases, "hk_kalman_update", other,
        lambda args: _kernel_times(_kalman_call(args), "kalman_update", KF_PROFILED_CALLS,
                                   "hk_kalman_update"))
    res = {"phase": "profile_kalman_times", "device": torch.cuda.get_device_name(0),
           "profiled_calls": KF_PROFILED_CALLS, "order": order, "times": out}
    if other is not None:
        lib = _build.measurement_library(other, None, ["hk_kalman_update"])
        apart = {}
        for n, args in cases.items():
            mine = [t.clone() for t in kalman.kalman_update(*args)[0][:2]]
            with _entry_from(lib, "hk_kalman_update"):
                theirs = [t.clone() for t in kalman.kalman_update(*args)[0][:2]]
            torch.cuda.synchronize()
            apart[n] = _outputs_apart(mine, theirs)
        res["outputs_vs_other"] = apart
    res["ptxas"] = _ptxas("kalman_update")
    return res


# kernel B10's phases (csrc/momentum_observer.cu, -DMO_PHASE_CLOCKS): block
# 0's cycles on thread 0 (scenario 0's lane 0) by the loads, the chain, the
# links' columns and momenta, the (link, column) terms and the toes' A
# rows, the sums and the filter, A A' and the tableau, the two solves, the
# wrenches, their norms and the stores
OBS_PHASE_NAMES = ("load", "chain", "columns", "terms", "sums_filter", "aat", "solve",
                   "wrench_stores")
# kernel calls under the profiler for B10's own device time
OBS_PROFILED_CALLS = 20


def _observer_args(batch: int = 1, mode: str | None = None):
    """``contact.momentum_observer_update``'s arguments on the card: in
    mode "loop" (B=1) the last of the full-order loop's observer updates
    over KF_WALK_PERIODS walking periods (past ``_walking_sim_loop``'s gait
    switch, captured as chip_smoke 4i captures them), in mode "batch"
    ``entry.estimator_batch(batch, seed=0)``; the mode by default "loop" at
    B=1, else "batch"."""
    import torch

    from .entry import TICK_DT, estimator_batch, run_sim_loop
    from .runtime import sim_loop as sim_loop_mod

    mode = mode or ("loop" if batch == 1 else "batch")
    if mode == "batch":
        eb = estimator_batch(batch, torch.device("cuda"), seed=0)
        return (eb.model, eb.observer_params, eb.observer, eb.rbd, eb.cmd_torque, TICK_DT)
    if batch != 1:
        raise ValueError(f"observer: the loop's updates are at B=1, not {batch}")
    setup = _walking_sim_loop(False, "soa")
    seen, real = [], sim_loop_mod.momentum_observer_update

    def keep(*a):
        seen.append(a)
        return real(*a)

    sim_loop_mod.momentum_observer_update = keep
    try:
        run_sim_loop(setup, [WALK] * KF_WALK_PERIODS)
    finally:
        sim_loop_mod.momentum_observer_update = real
    torch.cuda.synchronize()
    return seen[-1]


def _observer_call(args):
    from .estim import contact

    return lambda: contact.momentum_observer_update(*args)


def _observer_outputs(args):
    """B10's three outputs on ``args``: p_scg_z, est_forces, tau_dist."""
    from .estim import contact

    st, dist = contact.momentum_observer_update(*args)
    return [st.p_scg_z_last.clone(), st.est_forces.clone(), dist.clone()]


def _observer_host(args, calls: int = 200):
    """The host time of one ``momentum_observer_update`` call, the calls
    enqueued back to back, and of its parts alone: the checks with the
    inputs made contiguous (``observer_inputs``), the constants' lookup
    (``soa_kernel.consts_buffer``), the cutoff's checked buffer
    (``observer_params``), the output allocations (``observer_buffers``), the
    whole wrapper with its C call stubbed out; the C call is the wrapper
    less the stubbed wrapper."""
    import torch

    from .estim import contact
    from .ocp import soa_kernel

    model, params, state, rbd, tau, _ = args
    dev = rbd.device

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        ms = (time.perf_counter() - t) * 1e3 / calls
        torch.cuda.synchronize()
        return ms

    out = {"wrapper": per_call(_observer_call(args)),
           "checks": per_call(lambda: contact.observer_inputs(rbd, tau, state.p_scg_z_last)),
           "consts_buffer": per_call(lambda: soa_kernel.consts_buffer(model, dev)),
           "params_buffer": per_call(lambda: contact.observer_params(params, dev)),
           "outputs": per_call(lambda: contact.observer_buffers(rbd.shape[0], dev))}
    with _entry_from(_Stub(), "hk_momentum_observer"):
        out["wrapper_without_launch"] = per_call(_observer_call(args))
    out["c_call"] = out["wrapper"] - out["wrapper_without_launch"]
    out["calls"] = calls
    return out


def profile_observer_phases(batch: int = 1, mode: str | None = None,
                            source: str = "momentum_observer.cu"):
    """Kernel B10 (``csrc/<source>``, or the file at the path ``source``,
    e.g. a parent checkout's with the same clock marks) on
    ``_observer_args(batch, mode)``, measured by ``_kernel_phases`` with
    ``-DMO_PHASE_CLOCKS``: block 0's clock64 cycles per update by
    OBS_PHASE_NAMES, the kernel's times with and without the clocks, and
    the ptxas lines of both builds."""
    import torch

    args = _observer_args(batch, mode)
    run = _observer_call(args)
    run()  # the constants on the card, by the package's library
    m = _kernel_phases(source, "MO_PHASE_CLOCKS", "hk_momentum_observer", OBS_PHASE_NAMES, run,
                       "momentum_observer", OBS_PROFILED_CALLS)
    return {"phase": "profile_observer_phases", "batch": batch,
            "mode": mode or ("loop" if batch == 1 else "batch"), "source": source,
            "device": torch.cuda.get_device_name(0), **m}


def profile_observer_times(other: str | None = None):
    """Kernel B10 as the package builds it, timed by ``_kernel_times``
    (OBS_PROFILED_CALLS calls) at B=1 (a walking update of the full-order
    loop) and B=4096 (``entry.estimator_batch``), beside another
    ``momentum_observer.cu`` of the same C interface if given
    (``_compare_sources``: package, other, other, package; and each case's
    outputs of the two compared, "outputs_vs_other", and once more with
    both sources built with ``-fmad=false``, "outputs_vs_other_unfused":
    no multiply and add contracted into an FMA); the wrapper's host time by
    part (``_observer_host``).  chip_smoke runs this in a process of its
    own, whose profiler records every launch."""
    import torch

    from .kernels import _build

    entry = "hk_momentum_observer"
    cases = {"b1_sim_loop": _observer_args(1), "b4096_estimator_batch": _observer_args(4096)}
    order, out = _compare_sources(
        cases, entry, other,
        lambda args: _kernel_times(_observer_call(args), "momentum_observer",
                                   OBS_PROFILED_CALLS, entry))
    res = {"phase": "profile_observer_times", "device": torch.cuda.get_device_name(0),
           "profiled_calls": OBS_PROFILED_CALLS, "order": order, "times": out,
           "host_ms": {n: _observer_host(a) for n, a in cases.items()}}

    def apart(mine_lib, their_lib):
        got = {}
        for n, args in cases.items():
            with (_entry_from(mine_lib, entry) if mine_lib is not None
                  else contextlib.nullcontext()):
                mine = _observer_outputs(args)
            with _entry_from(their_lib, entry):
                theirs = _observer_outputs(args)
            torch.cuda.synchronize()
            got[n] = {name: v for name, v in zip(("p_scg_z", "est_forces", "tau_dist"),
                                                 _outputs_apart(mine, theirs).values())}
        return got

    if other is not None:
        unfused = ("-fmad=false",)
        res["outputs_vs_other"] = apart(None, _build.measurement_library(other, None, [entry]))
        res["outputs_vs_other_unfused"] = apart(
            _build.measurement_library("momentum_observer.cu", None, [entry], unfused),
            _build.measurement_library(other, None, [entry], unfused))
    res["ptxas"] = _ptxas("momentum_observer")
    return res


# kernel B8b1's phases (csrc/reference_prep.cu, -DSP_PHASE_CLOCKS): block 0's
# cycles on thread 0 (leg 0's lane 0) by the loads, the waits for the FK of
# x_init and for update_planner's head, the windows, the candidates, the
# fresh test, the fresh phases' indices, the swing nodes, the wait for the
# other warps (the samples) and the leg's stores (the first SP_CRITICAL sum
# to the block's time); then the FK's and the head's own cycles
SP_PHASE_NAMES = ("load", "fk", "head", "windows", "candidates", "fresh", "fresh_idx",
                  "nodes", "samples", "stores", "fk_own", "head_own")
SP_CRITICAL = 10
# kernel calls under the profiler for B8b1's own device time
SP_PROFILED_CALLS = 20
# the warm MPC step's shapes by samples: (knots, horizon) and the batch
SWING_PLAN_SHAPES = {6: (53, 0.8, 1), 7: (66, 1.0, 128)}
# B8b1's outputs in the wrapper's order (``SwingPlan``), then its decisions
SWING_PLAN_OUTPUTS = ("latest", "node_times", "node_pos", "node_vel", "window_start",
                      "window_stop", "contact_seq", "times", "states", "inputs", "poses", "des",
                      "R_des", "warm")


def _swing_plan_args(samples: int, batch: int | None = None):
    """``swing_plan``'s arguments as the flagship's warm MPC step gives them
    (the product shape's 53 knots over 0.8 s for 6 samples at B=1, the
    bench shape's 66 over 1.0 s for 7 at B=128, or ``batch``), captured on
    the card."""
    import torch

    from .entry import build_flagship
    from .solver import mpc as mpc_mod

    knots, horizon, b = SWING_PLAN_SHAPES[samples]
    flag = build_flagship(knots, horizon, batch=batch or b)
    mpc = mpc_mod.Mpc(flag.model, flag.settings, flag.params, flag.planner_cfg)
    args = (flag.schedule, flag.target, 0.0, flag.x0,
            torch.zeros(6, device=flag.x0.device), flag.default_joints)
    _, state, _ = mpc(flag.state, *args)
    seen, real = [], mpc_mod.swing_plan

    def keep(*a, **k):
        seen.append(a)
        return real(*a, **k)

    mpc_mod.swing_plan = keep
    try:
        mpc(state, *args)
    finally:
        mpc_mod.swing_plan = real
    torch.cuda.synchronize()
    assert seen[-1][-1] == samples, seen[-1][-1]
    return seen[-1]


def _swing_plan_outputs(args):
    """B8b1's outputs on ``args`` with its decisions, as one list
    (SWING_PLAN_OUTPUTS, then the decisions by name) and their names."""
    from .solver import reference_prep as rp

    plan, dec = rp.swing_plan(*args, with_decisions=True)
    outs = [plan.planner.latest_stance_position, *plan.refs[:3], *plan.refs[4:], *plan[2:]]
    return ([t.clone() for t in outs] + [dec[n].clone() for n in sorted(dec)],
            list(SWING_PLAN_OUTPUTS) + sorted(dec))


def _swing_plan_host(args, calls: int = 200):
    """The host time of one ``swing_plan`` call, the calls enqueued back to
    back, and of its parts alone: the checks (``plan_strides``), the
    constants' lookup (``soa_kernel.consts_buffer``), the output
    allocations (``plan_buffers``), the whole wrapper with its C call
    stubbed out; the C call is the wrapper less the stubbed wrapper."""
    import torch

    from .ocp import soa_kernel
    from .solver import reference_prep as rp

    model, cfg, ps, sch, tgt, init, x, cmd, dj, _, S = args
    Bn, nx = x.shape

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        ms = (time.perf_counter() - t) * 1e3 / calls
        torch.cuda.synchronize()
        return ms

    out = {"wrapper": per_call(lambda: rp.swing_plan(*args)),
           "checks": per_call(lambda: rp.plan_strides(model, cfg, ps, sch, tgt, init, x, cmd,
                                                      dj, S)),
           "consts_buffer": per_call(lambda: soa_kernel.consts_buffer(model, x.device)),
           "outputs": per_call(lambda: rp.plan_buffers(Bn, S, nx, model.nj, x.device, False))}
    with _entry_from(_Stub(), "hk_swing_plan"):
        out["wrapper_without_launch"] = per_call(lambda: rp.swing_plan(*args))
    out["c_call"] = out["wrapper"] - out["wrapper_without_launch"]
    out["calls"] = calls
    return out


def profile_swing_plan_phases(batch: int = 1, samples: int = 6,
                              source: str = "reference_prep.cu"):
    """Kernel B8b1 (``csrc/<source>``, or the file at the path ``source``,
    e.g. a parent checkout's with the same clock marks) on the warm MPC
    step's inputs (``_swing_plan_args``), measured by ``_kernel_phases``
    with ``-DSP_PHASE_CLOCKS``: block 0's clock64 cycles by SP_PHASE_NAMES
    (the first SP_CRITICAL sum to ``total_cycles``), the kernel's times
    with and without the clocks, and the ptxas lines of both builds."""
    import torch

    from .solver import reference_prep as rp

    args = _swing_plan_args(samples, batch)
    run = lambda: rp.swing_plan(*args)  # noqa: E731
    run()  # the constants on the card, by the package's library
    m = _kernel_phases(source, "SP_PHASE_CLOCKS", "hk_swing_plan", SP_PHASE_NAMES, run,
                       "swing_plan", SP_PROFILED_CALLS)
    m["total_cycles"] = sum(list(m["cycles"].values())[:SP_CRITICAL])
    m["ptxas"] = _ptxas("reference_prep")
    return {"phase": "profile_swing_plan_phases", "batch": batch, "samples": samples,
            "source": source, "device": torch.cuda.get_device_name(0), **m}


def profile_swing_plan_times(other: str | None = None):
    """Kernel B8b1 as the package builds it, timed by ``_kernel_times``
    (SP_PROFILED_CALLS calls) on the warm MPC step's inputs at B=1, N=53,
    S=6 and B=128, N=66, S=7, beside another ``reference_prep.cu`` of the
    same C interface if given (``_compare_sources``: package, other, other,
    package; and each case's outputs and decisions of the two compared);
    the wrapper's host time by part (``_swing_plan_host``).  chip_smoke runs
    this in a process of its own, whose profiler records every launch."""
    import torch

    from .kernels import _build
    from .solver import reference_prep as rp

    cases = {f"b{SWING_PLAN_SHAPES[s][2]}_s{s}": _swing_plan_args(s) for s in (6, 7)}
    order, out = _compare_sources(
        cases, "hk_swing_plan", other,
        lambda args: _kernel_times(lambda: rp.swing_plan(*args), "swing_plan",
                                   SP_PROFILED_CALLS, "hk_swing_plan"))
    res = {"phase": "profile_swing_plan_times", "device": torch.cuda.get_device_name(0),
           "profiled_calls": SP_PROFILED_CALLS, "order": order, "times": out,
           "host_ms": {n: _swing_plan_host(a) for n, a in cases.items()}}
    if other is not None:
        lib = _build.measurement_library(other, None, ["hk_swing_plan"])
        apart = {}
        for n, args in cases.items():
            mine, names = _swing_plan_outputs(args)
            with _entry_from(lib, "hk_swing_plan"):
                theirs, _ = _swing_plan_outputs(args)
            torch.cuda.synchronize()
            apart[n] = {names[int(k)]: v for k, v in _outputs_apart(mine, theirs).items()}
        res["outputs_vs_other"] = apart
    res["ptxas"] = _ptxas("reference_prep")
    return res


def _device_by_name(run):
    """``run()`` (which ends synchronized) under the profiler: per device
    kernel name, (its device ms summed, its recorded launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    return {e.key: (e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def profile_rt_factor(periods: int = 40):
    """The full-order loop of bench.py's real-time demonstration
    (``entry.build_sim_loop``, ``entry.rt_commands(periods)``: 10 standing
    periods, then 0.3 m/s) run twice from its cold state in this process:
    the first run builds and warms up, the second is timed (host clock,
    synchronized): ms per 10 ms period and rt_factor = simulated s / wall s.
    No profiler."""
    import torch

    from .entry import build_sim_loop, rt_commands, run_sim_loop

    setup = build_sim_loop()
    cmds = rt_commands(periods)
    t = time.perf_counter()
    run_sim_loop(setup, cmds)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    t = time.perf_counter()
    run_sim_loop(setup, cmds)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    return {"phase": "profile_rt_factor", "device": torch.cuda.get_device_name(0),
            "periods": periods, "first_run_s": first_s, "seconds": wall_s,
            "ms_per_period": wall_s / periods * 1e3, "rt_factor": periods * 0.01 / wall_s}


# B5's kernels (csrc/riccati_assoc.cu): one riccati_solve_parallel call
# launches them 15 times at N=53
B5_KERNELS = ("elements_kernel", "combine_kernel", "gains_kernel", "affine_kernel",
              "rollout_kernel")


def profile_own_times(solves: int = 10, periods: int = 2):
    """Own device times at B=1 of the kernels whose launches run at B=1 on
    the main paths, from the profiler's device records: B5
    (``riccati_solve_parallel``, all its launches of a call) and B8b2
    (``knot_refs``) over ``solves`` chained product-shape solves (N=53, 0.8 s,
    the parallel Riccati, after two warm-up solves); B16 (``contact_class``)
    and B11 (``sim_step``) over ``periods`` walking periods of the
    full-order loop.  Per kernel: the device ms per launch and per call over
    the launches the profiler recorded, and those counts."""
    import torch

    from .entry import build_flagship, mpc_chain, run_sim_loop

    flag = build_flagship(53, 0.8, batch=1)
    mpc_chain(flag, 2, riccati_parallel=True)
    torch.cuda.synchronize()
    chain = _device_by_name(lambda: (mpc_chain(flag, solves, riccati_parallel=True),
                                     torch.cuda.synchronize()))
    setup = _walking_sim_loop(False, "soa")
    loop = _device_by_name(lambda: (run_sim_loop(setup, [WALK] * periods),
                                    torch.cuda.synchronize()))

    def pick(table, names, calls, exclude=()):
        hits = [(ms, n) for k, (ms, n) in table.items()
                if any(x in k for x in names) and not any(x in k for x in exclude)]
        ms, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
        return {"device_ms": ms, "recorded_launches": n, "calls": calls,
                "ms_per_launch": ms / n if n else None, "ms_per_call": ms / calls}

    ticks = 5 * periods
    return {"phase": "profile_own_times", "device": torch.cuda.get_device_name(0),
            "riccati_solve_parallel": pick(chain, B5_KERNELS, solves, ("ddp_rollout",)),
            "knot_refs": pick(chain, ("knot_refs_kernel",), solves),
            "contact_class": pick(loop, ("contact_class_kernel",), ticks),
            "sim_step": pick(loop, ("sim_step_kernel",), ticks)}


class _Stub:
    """A kernel entry point that launches nothing and returns success."""

    def __getattr__(self, n):
        return lambda *a: 0


class _WithEntry:
    """The package's kernel library with one entry point taken from another
    library."""

    def __init__(self, lib, real, name):
        self._lib, self._real, self._name = lib, real, name

    def __getattr__(self, n):
        return getattr(self._lib if n == self._name else self._real, n)


def profile_backends_spread(moves: int = 8, riccati_source: str | None = None,
                            batch: int = 128, knots: int = 66, horizon: float = 1.0):
    """The flagship's warm step (B=128, 66 knots over 1.0 s) with
    ``lin_backend='dense'`` against the same step with 'soa', both on the
    card from the 'soa' cold step's state, scenario by scenario as
    chip_smoke's ``backends`` phase reads them (max |states|, max |inputs|,
    |cost| relative to max(1, |cost|)): at x_init as built, then moved by one
    ulp in each of the seeded patterns 0 .. moves - 1 (chip_smoke's
    MAIN_ULP_SEEDS moves: each entry up, down or kept).  ``riccati_source``:
    a ``riccati.cu`` (the same C interface) built with
    ``_build.measurement_library`` and run as kernel B3 in place of the
    package's.  Per run: the three scenarios farthest apart in cost and the
    largest distance of each quantity over the batch.  On the first run's
    warm 'soa' LQ (kernel B3's inputs), the package's B3 and, given one,
    the other: each output's error on its own scale against the float64
    exact plain solve (riccati_solver='gj'), on the scenarios listed and
    over the batch."""
    import torch

    from .entry import build_flagship
    from .kernels import _build
    from .solver import riccati
    from .solver.mpc import Mpc

    flag = build_flagship(knots, horizon, batch=batch)
    dev = flag.x0.device
    soa = Mpc(flag.model, flag.settings, flag.params, flag.planner_cfg)
    dense = Mpc(flag.model, flag.settings._replace(lin_backend="dense"), flag.params,
                flag.planner_cfg)
    real_library, solve = _build.library, riccati.riccati_solve
    other = None
    if riccati_source is not None:
        other = _WithEntry(_build.measurement_library(riccati_source, None,
                                                      ["hk_riccati_solve"]),
                           real_library(), "hk_riccati_solve")
        _build.library = lambda: other
    runs, lq = [], []

    def keep(*a):
        lq.append(a)
        return solve(*a)

    keep.launches = 0
    try:
        for seed in [None] + list(range(moves)):
            x0 = flag.x0.cpu()
            if seed is not None:
                g = torch.Generator().manual_seed(seed)
                step = torch.randint(-1, 2, x0.shape, generator=g).to(x0.dtype)
                x0 = torch.where(step != 0, torch.nextafter(x0, x0 + step * 1e3), x0)
            args = (flag.schedule, flag.target, 0.0, x0.to(dev), torch.zeros(6, device=dev),
                    flag.default_joints)
            _, st1, _ = soa(flag.state, *args)
            riccati.riccati_solve = keep if seed is None else solve
            try:
                warm, _, _ = soa(st1, *args)
            finally:
                riccati.riccati_solve = solve
            warm_dense, _, _ = dense(st1, *args)
            gap = {"states": (warm_dense.states - warm.states).abs().flatten(1).amax(1),
                   "inputs": (warm_dense.inputs - warm.inputs).abs().flatten(1).amax(1),
                   "cost_rel": ((warm_dense.cost.double() - warm.cost.double()).abs()
                                / warm.cost.double().abs().clamp(min=1.0))}
            gap = {q: v.double().cpu() for q, v in gap.items()}
            top = gap["cost_rel"].argsort(descending=True)[:3].tolist()
            runs.append({"ulp_seed": seed,
                         "top_cost": [{"scenario": b, **{q: v[b].item() for q, v in gap.items()}}
                                      for b in top],
                         "max": {q: v.max().item() for q, v in gap.items()},
                         "step_size_equal": bool(torch.equal(warm_dense.step_size,
                                                             warm.step_size))})
    finally:
        _build.library = real_library
    shown = sorted({r["scenario"] for r in runs[0]["top_cost"]})
    lq_args = lq[0]
    host = [riccati.StageLQ(*(t.cpu().double() for t in lq_args[0]))] + [
        t.cpu().double() for t in lq_args[1:5]]
    exact = riccati.riccati_solve_plain(*host, lq_args[5], solver="gj")

    def errors():
        got = riccati.riccati_solve(*lq_args)
        out = {}
        for name, g, e in zip(("K", "kff", "dxs", "dus"), got, exact):
            err = ((g.cpu().double() - e).abs().flatten(1).amax(1)
                   / e.abs().flatten(1).amax(1).clamp(min=1e-30))
            out[name] = {"max": err.max().item(), **{str(b): err[b].item() for b in shown}}
        return out

    vs_exact = {"package": errors()}
    if other is not None:
        _build.library = lambda: other
        try:
            vs_exact[riccati_source] = errors()
        finally:
            _build.library = real_library
    return {"phase": "profile_backends_spread", "batch": batch, "knots": knots,
            "horizon": horizon, "riccati_source": riccati_source or "package",
            "device": torch.cuda.get_device_name(0), "runs": runs,
            "b3_vs_exact_f64_on_first_warm_lq": vs_exact}


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
    elif a and a[0] == "qp_phases":
        print(json.dumps(profile_qp_phases(int(a[1]) if len(a) > 1 else 1,
                                           int(a[2]) if len(a) > 2 else 10)))
    elif a and a[0] == "riccati_phases":
        print(json.dumps(profile_riccati_phases(int(a[1]) if len(a) > 1 else 1,
                                                int(a[2]) if len(a) > 2 else 53,
                                                float(a[3]) if len(a) > 3 else 0.8)))
    elif a and a[0] == "wbc_qp_phases":
        print(json.dumps(profile_wbc_qp_phases(int(a[1]) if len(a) > 1 else 1,
                                               a[2] if len(a) > 2 else "wbc_qp.cu")))
    elif a and a[0] == "wbc_qp_times":
        print(json.dumps(profile_wbc_qp_times(a[1] if len(a) > 1 else None)))
    elif a and a[0] == "backends_spread":
        print(json.dumps(profile_backends_spread(int(a[1]) if len(a) > 1 else 8,
                                                 a[2] if len(a) > 2 else None)))
    elif a and a[0] == "sim_step_phases":
        print(json.dumps(profile_sim_step_phases(int(a[1]) if len(a) > 1 else 1,
                                                 a[2] if len(a) > 2 else "sim_step.cu")))
    elif a and a[0] == "sim_step_times":
        print(json.dumps(profile_sim_step_times()))
    elif a and a[0] == "leg_ik_phases":
        print(json.dumps(profile_leg_ik_phases(int(a[1]) if len(a) > 1 else 1,
                                               int(a[2]) if len(a) > 2 else 6,
                                               a[3] if len(a) > 3 else "leg_ik.cu")))
    elif a and a[0] == "leg_ik_times":
        print(json.dumps(profile_leg_ik_times(a[1] if len(a) > 1 else None)))
    elif a and a[0] == "own_times":
        print(json.dumps(profile_own_times(int(a[1]) if len(a) > 1 else 10,
                                           int(a[2]) if len(a) > 2 else 2)))
    elif a and a[0] == "rt_factor":
        print(json.dumps(profile_rt_factor(int(a[1]) if len(a) > 1 else 40)))
    elif a and a[0] == "ddp_rollout_times":
        print(json.dumps(profile_ddp_rollout_times(a[1] if len(a) > 1 else None)))
    elif a and a[0] == "soa_phases":
        print(json.dumps(profile_soa_phases(int(a[1]) if len(a) > 1 else 1,
                                            int(a[2]) if len(a) > 2 else 53,
                                            a[3] if len(a) > 3 else "soa_linearize.cu")))
    elif a and a[0] == "soa_times":
        print(json.dumps(profile_soa_times(a[1] if len(a) > 1 else None)))
    elif a and a[0] == "project_phases":
        print(json.dumps(profile_project_phases(int(a[1]) if len(a) > 1 else 1,
                                                int(a[2]) if len(a) > 2 else 53,
                                                a[3] if len(a) > 3 else "project_knot.cu")))
    elif a and a[0] == "project_times":
        print(json.dumps(profile_project_times(a[1] if len(a) > 1 else None)))
    elif a and a[0] == "kalman_phases":
        print(json.dumps(profile_kalman_phases(int(a[1]) if len(a) > 1 else 1,
                                               a[2] if len(a) > 2 else "kalman_update.cu")))
    elif a and a[0] == "observer_phases":
        print(json.dumps(profile_observer_phases(int(a[1]) if len(a) > 1 else 1,
                                                 a[2] if len(a) > 2 else None,
                                                 a[3] if len(a) > 3 else "momentum_observer.cu")))
    elif a and a[0] == "observer_times":
        print(json.dumps(profile_observer_times(a[1] if len(a) > 1 else None)))
    elif a and a[0] == "swing_plan_phases":
        print(json.dumps(profile_swing_plan_phases(int(a[1]) if len(a) > 1 else 1,
                                                   int(a[2]) if len(a) > 2 else 6,
                                                   a[3] if len(a) > 3 else "reference_prep.cu")))
    elif a and a[0] == "swing_plan_times":
        print(json.dumps(profile_swing_plan_times(a[1] if len(a) > 1 else None)))
    elif a and a[0] == "kalman_times":
        print(json.dumps(profile_kalman_times(a[1] if len(a) > 1 else None)))
    elif a and a[0] == "ddp_rollout_phases":
        print(json.dumps(profile_ddp_rollout_phases(int(a[1]) if len(a) > 1 else 1,
                                                    int(a[2]) if len(a) > 2 else 53,
                                                    float(a[3]) if len(a) > 3 else 0.8,
                                                    a[4] if len(a) > 4 else "RK2",
                                                    a[5] if len(a) > 5 else "ddp_rollout.cu")))
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
