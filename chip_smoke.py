#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the hand-written kernels (csrc/*.cu, nvcc for sm_90a);
  3. each kernel against its plain PyTorch version on the card, at its
     paths' shapes: B6 gj_inverse (IK-shaped 5x5, the use B8a absorbed,
     projection 16x16, the Kalman filter's 28x28 innovation and the
     momentum observer's 5x5 leg systems, the uses B12 and B10 absorbed),
     B2 project_knot, B3 riccati_solve, B4 solve_qp on the WBC's own QPs at
     B=4096, cold and warm (errors against the float32 and float64 plain
     versions; kernel / plain / library times by CUDA events, medians of 15);
  4. the MPC path: the flagship problem (B=128 scenarios, 66 knots over
     1.0 s, trot, 0.25 m/s) through ``Mpc`` with ``lin_backend='soa'`` (the
     default: kernel B1), one cold and one warm step, with every kernel's
     launch count read around it (one swing_plan, one leg_ik, one knot_refs
     and no gj_inverse launch per step, here and on every MPC path), held
     against the port's own CPU runs (plain versions: float32, and float64
     with the exact Huu solve, scenario by scenario, the scenarios where
     one-ulp moves of x_init spread float32 past the limit held to their
     own spread); the same warm step with
     ``lin_backend='dense'`` on the card held to the 'soa' one, launches per
     step (and per phase, the reference prep split into its sub-phases) of
     both backends, the launches per tick and per walking loop period by the
     tick's sub-phases (``profile_step.profile_tick_phases``,
     ``profile_loop_phases``); then the product shape (B=1, 53 knots over
     0.8 s), its launches read around its seven steps;
  4a. B1 (soa_linearize, soa_merit) on the inputs the warm steps of the
     bench shape (B=128, N=66) and the product shape (B=1, N=53) gave the
     linearization and the line search's merit: every output against the
     float64 plain SoA version and the float64 dense plain version, within
     max(tol, 2x the float32 plain SoA version's error), bfloat16 landing
     above the limit; kernel, plain and dense plain times;
  4a2. B8a (leg_ik) on the inputs the same warm steps gave
     ``joint_reference_ik``, and on those inputs moved by a seeded offset
     (the keep-if-improved tests then go both ways): both passes' joints
     against the float64 plain version within max(tol, 2x the float32 plain
     version's error), bfloat16 landing above the limit, the decisions of
     the plain versions counted per pass; kernel and plain times;
  4a3. B8b (swing_plan, knot_refs) on the inputs the same warm steps gave
     the reference prep's two kernels, and again with every shared input
     made contiguous (the outputs bit for bit the same): every output
     against the float64 plain version within max(tol, 2x the float32
     plain version's error), outside the scenarios where a decision of the
     float32 plain version went the other way from the float64 one's, the
     per-phase outputs' phases with empty windows held apart;
     the kernels' decisions (phases, segments, the windows' tests) equal
     the float32 plain version's; bfloat16 landing above the limit on the
     outputs that are not exact in every precision; kernel and plain
     times, the bounds (``swing_plan_cost``, ``knot_refs_cost``); the
     launch calls of one whole ``prepare_references`` (at most
     PREP_MAX_LAUNCH_CALLS);
  4b. the tick path: TICKS (50) chained 500 Hz ticks (``entry.tick_chain``: Kalman
     update, momentum observer, WBC, gains) on the product shape's cold
     policy, launch counts read around it, every tick's command and WBC
     solution and the final estimator and WBC states held against the
     port's CPU float32 and float64 runs; B4 on every tick's own QP (B=1)
     against its plain versions, with its time and bound; every tick counts
     one kalman_update (B12), one momentum_observer (B10), one wbc_qp (B9)
     and one solve_qp launch, and no gj_inverse (B6);
  4b2. B9 (wbc_qp) on every tick's own inputs (B=1), on bench.py's standing
     batch and on seeded walking states (mixed contact flags, both stance
     modes) at B=4096: the six QP arrays against the float64 plain version
     within max(tol, 2x the float32 plain version's error), bfloat16 landing
     above the limit; kernel and plain times, the bound (``wbc_qp_cost``);
  4c. the batched WBC (``entry.wbc_chain``): B=4096 standing states, one
     cold tick, then a 6-tick warm chain, solves/s, solutions and accepted
     QPs per tick held against CPU float32 and float64 runs of every 16th
     scenario; one wbc_qp and one solve_qp launch per tick;
  4d. B5 riccati_solve_parallel on the real LQ data of the product shape
     (B=1, N=53) and of N=66 (the card's projection output): each output
     against the float64 exact plain version on the CPU, bfloat16 landing
     above the limit, the gap to the float32 NS plain version (the JAX
     algorithm), and B3's time on the same data in the same call;
  4e. the chained B=1 solve (``entry.mpc_chain``, K_CHAIN solves at N=53,
     'soa') in both Riccati modes: ms per solve, launches, costs held against the
     port's CPU float64 chain with exact solves;
  4f. the dummy closed loop (``entry.build_loop`` + ``run_loop``, 'soa') over
     the golden trace's 40 periods in both Riccati modes, held to
     tests/golden/stance_walk_40p.npz with tests/test_golden.py's checks,
     ms per 10 ms period; one wbc_qp, one solve_qp, one dummy_step (B14a,
     the plant's RK2 step) and one state_input_to_v (B14b, the tick's state
     conversion) launch per tick (five per period);
  4g. the full-order closed loop (``entry.build_sim_loop`` +
     ``run_sim_loop``: the plant's substeps by B11, sensing, the Kalman
     filter and momentum observer in the loop, the MPC, the WBC; bench.py's
     rt_factor configuration) over 40 periods in the default Riccati mode,
     held to tests/golden/sim_stance_walk_40p.npz with tests/test_golden.py's
     checks, its first 3 periods to the port's CPU float64 run; ms per 10 ms
     period, rt_factor; one sim_step, momentum_observer, wbc_qp and
     solve_qp launch per tick, six kalman_update, synth_imu (B13a) and
     rbd_to_centroidal (B13b) launches per period (the period's own sensing
     and one per tick) and no gj_inverse; launches per walking period by part
     (``profile_sim_loop_phases``: sensing split into the IMU, the
     conversion and the rest) and its device busy time
     (``profile_sim_loop``);
  4h. B11 (sim_step) on every tick's inputs of 4g's loop (B=1, one launch
     each) and on a sweep-shaped batch (``entry.sim_step_batch``, B=1024: a
     9 ms delay ring, feet on both sides of the contact surface, per-scenario
     mass scale and field): q, v, the last acceleration and the contact
     forces against the float64 plain version within max(tol, 2x the
     float32 plain version's error), outside the scenarios whose in-contact
     decisions flipped, the flips counted, bfloat16 landing above the
     limit; A_sys = M + diag(armature + dt damping), which the kernel
     eliminates without pivoting, positive definite on every substep (its
     smallest eigenvalue and largest condition number from the float64
     plain version); kernel and plain times, the bound (``sim_step_cost``);
  4i. B10 (momentum_observer) and B12 (kalman_update) on every update's
     inputs of 4g's loop (B=1, one launch each: 200 and 240) and on a
     seeded walking batch (``entry.estimator_batch``, B=4096): the
     observer's p_scg_z, est_forces and tau_dist and the filter's x_hat, P,
     position and velocity against the float64 plain version within
     max(tol, 2x the float32 plain version's error), bfloat16 landing above
     the limit; kernel and plain times, the bounds (``observer_cost``,
     ``kalman_cost``);
  4j. B13a (synth_imu), B13b (rbd_to_centroidal), B14a (dummy_step) and
     B14b (state_input_to_v) on every call's inputs of 4g's and 4f's loops
     (B=1: 240 sensings, 200 ticks) and on a seeded walking batch
     (``entry.centroidal_batch``, B=4096): each output against the float64
     plain version within max(tol, 2x the float32 plain version's error),
     bfloat16 landing above the limit on the outputs that are not copies;
     kernel and plain times, each kernel's own device time per call
     (profiled over CF_PROFILED_CALLS calls), the bounds (``imu_cost``,
     ``centroidal_cost``, ``dummy_cost``, ``state_v_cost``);
  4k. the DDP path (``entry.ddp_solve``: the flagship's references, DDP_WARM
     SQP solves, then ``ddp.solve``) at the product shape with RK2 and with
     ODE45 and at the bench shape with RK2 (DDP_CELLS): launches (one
     soa_linearize, project_knot, riccati_solve and ddp_rollout per
     iteration, one more ddp_rollout per solve for the re-roll), ms per
     ``ddp.solve`` (median of 5), tests/test_ddp.py's properties on the
     product shape's RK2 solve, the card's solve held to the CPU float64 one
     scenario by scenario; B15 (ddp_rollout) on the first iteration's
     rollouts (and the product shape's re-roll) against its plain versions,
     ODE45's accepted slots equal the float32 plain version's, kernel and
     plain times, the bound (``ddp_rollout_cost``) and the serial chain's
     floor; B2 and B3 on the product shape's DDP data (d = 0, hess_reg 1e-5,
     the pivoting Gram inverse) against the plain projection and backward
     pass;
  5. the kernels line: launches, error, times and bound of each kernel, B6
     with one row per use (IK, absorbed into B8a on the MPC path; Kalman,
     absorbed into B12; observer, absorbed into B10).
The last line is {"ok": true, "device": {...}}.  Any failed check raises.
Exits non-zero without a card, and outside the repository.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
REPS = 15

# Stated tolerances.  Each output of a kernel is checked on its own, with
# its error relative to its own scale, max |a - b| / max |b|.  An output
# passes when its error against the float64 plain version is within TOL, or
# at most TOL_FACTOR times the float32 plain version's own error on that
# output against float64: the projection's Gram and the Riccati's Huu come
# from the main path with condition numbers up to ~1e6 (toe and heel rows of
# one leg are nearly dependent, proj_reg = 1e-6), where float32 itself
# carries errors of ~1e-2 in some outputs (P, Qww, Qwx) and ~1e-4 in others.
# B6 has two float32 plain versions: torch's separate multiply and subtract
# (gj_inverse_plain), and the same elimination with each update rounded
# once, as the kernel's fused multiply-add rounds it (gj_inverse_fma); its
# float32 error is the larger of the two.  The Kalman filter's 28x28
# innovation covariance mixes the covariance's 100 m^2 start with the
# feet-height noise of 1e-2, so float32 carries ~1e-5 relative error in its
# inverse either way.  A bfloat16 run of the plain version must land above
# the limit: a check that cannot tell it from float32 is blind.  The QP's
# primal residual is compared on the scale of the WBC's acceptance test,
# 1 + max |b|, floored at 1 (float32 leaves ~1e-4 where float64 reaches
# ~1e-11).  B5 is held to its exact plain version (Cholesky and LU solves),
# whose float32 run sits ~1e-6 from float64 on the main path's data, under
# a floor of 1e-4: the JAX algorithm's Newton-Schulz solves (not converged
# there, ~1e-3 to 1e-2 from the exact solve in float64 too) would not pass.
TOL = {"gj_inverse": 1e-5, "project_knot": 1e-4, "riccati_solve": 2e-3, "solve_qp": 1e-4,
       "riccati_solve_parallel": 1e-4, "soa_linearize": 1e-4, "soa_merit": 1e-4,
       "leg_ik": 1e-4, "wbc_qp": 1e-4, "sim_step": 1e-4, "momentum_observer": 1e-4,
       "kalman_update": 1e-4, "synth_imu": 1e-6, "rbd_to_centroidal": 1e-4, "dummy_step": 1e-4,
       "state_input_to_v": 1e-4, "swing_plan": 1e-4, "knot_refs": 1e-4, "ddp_rollout": 1e-4}
# B8a (leg_ik) is held, on each pass's joints on their own scale, to the
# float64 plain version within max(tol, TOL_FACTOR x the float32 plain
# version's error).  The damped 5x5 systems have rank 3 (translation) plus
# the 1e-6 damping, so float32 rounding in their null space is amplified
# ~1e6 and the float32 plain version itself sits ~1e-4-1e-2 from float64 on
# the main path; a keep-if-improved test that goes the other way moves a
# leg by a whole step.  So both errors are taken leg by leg outside the
# legs where a test of that pass or the one before went the other way from
# the float64 plain version's (the kernel reports its tests), and the
# kernel may flip at most IK_FLIP_FACTOR times the float32 plain version's
# flipped legs plus IK_FLIP_FLOOR: a flip needs two error norms within
# rounding of each other, which float32 meets on a few legs of any data.
# Held over every leg, one float32 plain flip can put its error, and the
# limit, above bfloat16's (on an H100: 1.37 against 1.36 on the moved B=128
# inputs), and the check goes blind.
IK_FLIP_FACTOR, IK_FLIP_FLOOR = 2, 2
# The moved inputs of 4a2: base positions, Euler angles and toe targets
# plus seeded normal offsets of these sizes (m, rad, m) per shape; the
# bench shape's scenarios already spread far from the nominal pose, the
# product shape's one scenario needs the larger offset before its
# keep-if-improved tests reject a step in each pass.
IK_OFFSET = {128: (0.02, 0.1, 0.03), 1: (0.05, 0.3, 0.08)}
# B8b (swing_plan, knot_refs) is held, output by output, to the float64 plain
# version within max(tol, TOL_FACTOR x the float32 plain version's error),
# each entry's error taken relative to max(1, |entry|): the padded phases
# beyond the schedule carry window starts of 1e9 s and, in their swing
# splines, velocities many orders above the real ones, which would hide
# every real time and position on one output-wide scale.  Every decision (phases, segments, the
# windows' tests) compares float32 times, which the kernels compute with one
# rounding per operation in the order and with the reciprocals torch uses on
# the card: the kernels' decisions must equal the float32 plain version's.
# The errors are taken outside the scenarios where a decision that moves the
# values (a phase, the tail and fresh-window tests: PREP_FLIP_DECISIONS) of
# the float32 plain version went the other way from the float64 one's: a
# flipped phase moves a whole spline.  A
# segment (the target's, the samples', a spline's) is chosen by a time that
# may equal a node time, in one precision and not the other (knot k of 66
# and sample i of 7 meet at k = 11 i), but the interpolations are continuous
# there, so those decisions are counted, not excluded.
# Outputs exact in every precision on the main path's data (the contact
# sequence and flags; the cmd_vel target's inputs, all zero; R_des at
# x_init's zero Euler angles) are left out of the bfloat16-above-the-limit
# rule.
PREP_PLAN_NAMES = ("latest", "node_times", "node_pos", "node_vel", "window_start",
                   "window_stop", "contact_seq", "times", "states", "inputs", "poses", "des",
                   "R_des", "warm")
PREP_KNOT_NAMES = ("times", "x_nom", "contact_flags", "foot_pos_ref", "foot_vel_ref",
                   "mod_states")
PREP_EXACT = ("contact_seq", "contact_flags", "inputs", "R_des")
PREP_FLIP_DECISIONS = ("cmd_phase", "next_phase", "tail", "fresh", "sample_phase", "knot_phase")
# B8b1's per-phase outputs, (B, 4, P1, ...).  A phase whose window is empty
# (stop <= start in the float64 plain version: the phases that begin at or
# after the end of the span the windows are clipped to, the padded ones
# among them, and a zero-length first window) is never sampled, and its
# swing spline divides by the 1e-6 s clamp on the window's length, so its
# velocities carry a position's rounding times 1e6 (5.3e-2 in float32 at
# B=1).  Those phases are held apart, under the output's name + "_empty",
# so that the live phases' limits come from their own float32 error; the
# empty ones' windows sit on the clip's bounds, exact in some precisions,
# so they are left out of the bfloat16-above-the-limit rule.
PREP_PHASE_NAMES = ("node_times", "node_pos", "node_vel", "window_start", "window_stop",
                    "contact_seq")
# the launch calls of one prepare_references on the card: B8b1, B8a, B8b2
PREP_MAX_LAUNCH_CALLS = 10
# B1 (soa_linearize, soa_merit) is held, output by output on its own scale,
# to two float64 yardsticks that share no code: the plain SoA version and the
# dense plain version, each within max(tol, TOL_FACTOR x the float32 plain
# SoA version's own error).  The mask is exact in every precision, so only
# the other outputs must put bfloat16 above the limit.
LIN_NAMES = ("xnext", "A", "B", "cost", "qx", "qu", "Qxx", "Quu", "Qux", "g", "C", "D", "mask")
# B9 (wbc_qp) is held, array by array on its own scale, to the float64 plain
# version within max(tol, TOL_FACTOR x the float32 plain version's error),
# over every tick's QP of the tick path (B=1) and over B=4096 batches; bin is
# a copy of the torque limits, exact in every precision, so only the other
# arrays must put bfloat16 above the limit.
WBC_QP_NAMES = ("H", "g", "Aeq", "beq", "Ain", "bin")
# B11 (sim_step) is held, output by output on its own scale, to the float64
# plain version within max(tol, TOL_FACTOR x the float32 plain version's
# error), one tick's inputs at a time (eight semi-implicit substeps at
# 2e4 N/m compound any difference along a trajectory).  The contact law
# branches on the penetration's sign: near touchdown float32 and float64
# take different branches, and one flipped contact moves the scenario's
# whole step.  So the errors are taken outside the scenarios where the
# kernel's or the float32 plain version's in-contact decisions in some
# substep differ from the float64 plain version's (the kernel reports its
# decisions), and the kernel may flip at most SIM_FLIP_FACTOR times the
# float32 plain version's scenarios plus SIM_FLIP_FLOOR.
SIM_NAMES = ("q", "v", "acc", "contact_forces")
# B10 (momentum_observer) and B12 (kalman_update) are held, output by output
# on its own scale, to the float64 plain version within max(tol, TOL_FACTOR
# x the float32 plain version's error), over every update of the full-order
# loop (B=1) and over a seeded B=4096 batch.  The observer's tau_dist is
# beta p - p_scg_z with beta ~324 at 500 Hz, a difference of terms ~10x its
# size; the filter's 28x28 innovation covariance mixes covariances of up to
# 100 m^2 with the feet-height noise of 1e-2.
OBS_NAMES = ("p_scg_z", "est_forces", "tau_dist")
KF_NAMES = ("x_hat", "P", "pos", "vel")
EST_BATCH = 4096
# B13a (synth_imu), B13b (rbd_to_centroidal), B14a (dummy_step) and B14b
# (state_input_to_v) are held, output by output on its own scale, to the
# float64 plain version within max(tol, TOL_FACTOR x the float32 plain
# version's error), over every call of the loop that runs them (B=1) and
# over a seeded B=4096 batch (``entry.centroidal_batch``).  Outputs that
# are copies of inputs (the centroidal state's configuration, v's joint
# velocities) are exact in every precision of the kernel, so only the
# others must put bfloat16 above the limit.  The IMU is ~100 elementwise
# operations (float32 errs ~1e-7 of each output's scale), and the loop's
# base stays near level, so its quaternion sits near (0, 0, 0, 1), where
# bfloat16 errs only ~3e-6 of its scale: its tolerance is 1e-6.
CF_NAMES = {"synth_imu": ("quat", "omega_local", "accel_local", "omega_world"),
            "rbd_to_centroidal": ("h", "q"),
            "dummy_step": ("h", "base_pose", "joints"),
            "state_input_to_v": ("v_b", "v_j", "rbd")}
CF_COPIES = ("q", "v_j")
CF_BATCH = 4096
# kernel calls under the profiler for B13/B14's own device time per call
CF_PROFILED_CALLS = 50
SIM_FLIP_FACTOR, SIM_FLIP_FLOOR = 2, 2
SIM_BATCH = 1024
MERIT_NAMES = ("cost", "metric")
TOL_FACTOR = 2.0
# Card main path vs the port's CPU runs, on states, inputs and cost relative
# to max(1, |cost|).  The Riccati kernel solves Huu exactly (Cholesky); the
# plain version is the JAX algorithm, 20 Newton-Schulz iterations, which
# has not converged on the warm step of the scenarios farthest from the
# nominal state: there the two algorithms differ by up to ~0.05 in states,
# ~2.5 in inputs and ~8% in cost in float64 alone.  So:
#  - against the CPU float32 run (plain, NS): within ALGO_TOL;
#  - against the CPU float64 run with the exact solve (riccati_solver='gj'),
#    scenario by scenario: within MAIN_FACTOR times the CPU float32 'gj'
#    run's own distance to it over the batch, or the floor MAIN_FLOOR.
#    A backward-stable float32 step is the exact step of an input about an
#    ulp away, and on the warm step's scenarios farthest from the nominal
#    state the IK's rank-3 systems and the projection turn an ulp into
#    percents of cost: there one float32 run's distance is no bound on
#    another's.  So the CPU float32 'gj' run is repeated with x_init moved
#    by one ulp in the seeded patterns MAIN_ULP_SEEDS (each entry up, down
#    or kept); a scenario where one of those runs lands past the batch's
#    limit is ill-conditioned, reported, and held instead to MAIN_FACTOR
#    times the largest of its own float32 runs' distances (or the floor).
#    At most MAIN_MAX_ILL scenarios of a step may be so (the port's CPU
#    finds 2 of 128 on the warm step, scenarios 83 and 84, none on the cold).
# The accepted step sizes must equal the CPU float32 run's.
ALGO_TOL = {"states": 0.1, "inputs": 5.0, "cost_rel": 0.15}
MAIN_FACTOR = 3.0
MAIN_FLOOR = {"states": 1e-3, "inputs": 0.1, "cost_rel": 1e-4}
MAIN_ULP_SEEDS = tuple(range(8))
MAIN_MAX_ILL = 4
# The tick path: each tick's tau_ff, pos_des and WBC solution, and the
# final Kalman, observer and WBC states, max |card - CPU float64| / max(1,
# max |CPU float64|), within MAIN_FACTOR times the CPU float32 run's own
# distance to the float64 run, or TICK_FLOOR; the WBC's acceptance flags
# equal the CPU float32 run's tick by tick.  The batched WBC: every tick's
# solution on every WBC_CPU_STRIDE-th scenario by the same rule, and the
# accepted counts equal the CPU float32 run's.
TICKS = 50
TICK_FLOOR = 1e-4
WBC_BATCH, WBC_TICKS, WBC_CPU_STRIDE = 4096, 6, 16
# The chained B=1 solve (bench.py:112-178): K_CHAIN solves at N=53, each
# from the cold state, fed the previous solution's states[1]; the card's
# costs and states within MAIN_FACTOR times the CPU float32 chain's own
# distance to the CPU float64 chain (both with exact solves), or TICK_FLOOR,
# each on its own scale over the chain (max(1, max |CPU float64|)).  The
# costs run from ~-48 down to ~-1 along the chain: a cost near -1 is the
# small remainder of terms of the first solves' size, so its error is
# measured on the chain's scale, not its own magnitude.
K_CHAIN = 20
# The closed loop against the golden trace (tests/test_golden.py:53-64):
# gait levels equal, base z within 5e-3, planar momentum within 2e-2,
# joints within 3e-2, median violation at most twice the golden's.
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                      "stance_walk_40p.npz")
GOLDEN_BAND = {"z": 5e-3, "planar": 2e-2, "joints": 3e-2}
# The full-order loop (bench.py's rt_factor scenario, 40 periods) against
# the golden trace of the JAX package's loop, with the same checks (planar:
# the base's linear velocity); its first SIM_CPU_PERIODS periods against the
# port's CPU float64 run within MAIN_FACTOR times the CPU float32 run's
# distance (or TICK_FLOOR), on each quantity's scale max(1, max |CPU f64|).
SIM_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                          "sim_stance_walk_40p.npz")
SIM_CPU_PERIODS = 3
# The DDP path (4k): entry.ddp_solve on the flagship after DDP_WARM SQP
# solves (tests/test_ddp.py's use), per cell (name, B, N, horizon,
# integrator, iterations): the product shape with RK2 and two iterations
# (tests/test_ddp.py's settings), with ODE45 as task.info sets it (one
# iteration), the bench shape with RK2.  The card's ddp.solve is held to the
# CPU float64 one (exact Huu solves) from the same warm start (the CPU
# float64 SQP's, rounded to float32), scenario by scenario on every
# DDP_CPU_STRIDE-th scenario: states, inputs and cost (relative to max(1,
# |cost|)) within MAIN_FACTOR times the CPU float32 run's own distance in
# that scenario, or MAIN_FLOOR; a scenario past that is held instead to
# MAIN_FACTOR times the largest distance of its float32 runs with x_init
# moved by one ulp (DDP_ULP_SEEDS), and reported as ill-conditioned (at the
# bench shape the single-shooting rollouts over 1.0 s diverge in most
# scenarios, in float64 too).  The step sizes of the scenarios not so
# reported must equal the CPU float32 run's.
DDP_CELLS = (("product_rk2", 1, 53, 0.8, "RK2", 2), ("product_ode45", 1, 53, 0.8, "ODE45", 1),
             ("bench_rk2", 128, 66, 1.0, "RK2", 2))
DDP_WARM = 3
DDP_CPU_STRIDE = 32
# B15 (ddp_rollout) is held, output by output on its own scale, to the
# float64 plain version within max(tol, TOL_FACTOR x the float32 plain
# version's error) on one iteration's closed-loop rollouts; ODE45's
# accepted slots per knot equal the float32 plain version's.  The re-roll
# (open loop, the product shape) amplifies rounding along the unstable
# open-loop dynamics, so there the float32 plain error is the largest over
# runs with x_init moved by one ulp (DDP_OPEN_SEEDS).  So is B2's on the
# product shape's DDP data, with every input but the mask moved: the Gram's toe and heel
# rows are nearly dependent, and one float32 run's error does not bound
# another's (on an H100 one float32 run read 1.0e-3 in A_t, the kernel
# 2.1e-3).
# Each rollout (scenario, step size) is measured on its own scale, max(1,
# max |float64 plain|), over the rollouts whose float64 states stay finite
# and within ROLL_BOUND: at the bench shape the first iteration's step
# sizes drive many rollouts far off (|x| up to ~1e9 in float64, overflow in
# float32); they only serve to be rejected by the line search, and the
# solve's check covers that.
ROLL_NAMES = ("xs", "us", "cost", "eq")
ROLL_BOUND = 1e3
DDP_OPEN_SEEDS = tuple(range(2))
# the DDP solve's ill-conditioned scenarios are held to the spread of these
# one-ulp moves of x_init (the main path's rule, with a quarter of its seeds)
DDP_ULP_SEEDS = MAIN_ULP_SEEDS[:2]
# one lane's issue rate for the serial chain's floor (H100 SXM boost clock)
SM_CLOCK_HZ = 1.98e9


T_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line is stamped with the seconds since the start."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T_START, 3)}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps=REPS):
    """Median device time of one call (CUDA events around each call)."""
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


def rel_err(got, ref, floor=1e-30):
    """(max |got - ref|, that over max(floor, max |ref|))."""
    diff = (got.double() - ref.double()).abs().max().item()
    return diff, diff / max(ref.double().abs().max().item(), floor)


def errors(names, got, plain32, plain64, floors=None):
    """Per output: the kernel against the float32 plain version, the kernel
    against the float64 plain version, float32 plain against float64 plain.
    ``floors`` may floor an output's scale."""
    floors = floors or {}
    return {n: (rel_err(a, b, floors.get(n, 1e-30)), rel_err(a, c, floors.get(n, 1e-30)),
                rel_err(b, c, floors.get(n, 1e-30)))
            for n, a, b, c in zip(names, got, plain32, plain64)}


def check(name, errs, tol):
    """Raise unless every output is within max(tol, TOL_FACTOR x the float32
    plain version's error on it) of the float64 plain version (a NaN error
    is not within)."""
    bad = {n: {"vs_f64": e64[1], "limit": max(tol, TOL_FACTOR * p64[1])}
           for n, (_, e64, p64) in errs.items() if not e64[1] <= max(tol, TOL_FACTOR * p64[1])}
    if bad:
        raise AssertionError(f"{name}: outputs off the float64 plain version: {bad}")


def as64(ts):
    return [t.double() for t in ts]


def bound(n_bytes, n_flops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FP32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gj_cost(batch, n):
    """Bytes (A in, inverse out) and flops of n Gauss-Jordan steps on [A | I]."""
    return batch * n * n * 4 * 2, batch * n * (2 * n + 4 * n * (n - 1))


def project_cost(knots, nx=22, nu=22, m=16):
    n_in = 5 * nx * nx + 2 * m * nx + 3 * nx + 2 * m
    n_out = 7 * nx * nx + 4 * nx
    nc, nt = 1 + nx + nu, 1 + 2 * nx + nu
    flops = (2 * m * m * nu + m * (2 * m + 4 * m * (m - 1)) + 2 * nu * m * m
             + 2 * nu * nc * m + 2 * 2 * nu * nc * nu + 2 * (nx + nu) * nt * nu
             + 2 * nu * nx + 6 * nx * nx)
    return knots * (n_in + n_out) * 4, knots * flops


def riccati_cost(batch, N, nx=22, nu=22):
    n_in = N * (5 * nx * nx + 2 * nu * nu + 2 * nx + 2 * nu) + nx
    n_out = N * (nu * nx + nu + nx + nu) + nx
    nm, nh = nx + nu + 1, nx + nu
    per_knot = (2 * nx * nm * nx + 2 * nh * nm * nx + nu ** 3 // 3
                + 2 * (nx + 1) * nu * nu + 2 * nx * (nx + 1) * nu + 3 * nx * nx
                + 2 * (2 * nu + nx) * nx + 2 * (nu + nx) * nu)
    return batch * (n_in + n_out) * 4, batch * N * per_knot


def assoc_cost(batch, N, nx=22, nu=22):
    """Bytes (as riccati_cost: the same inputs and outputs) and flops of the
    associative Riccati as csrc/riccati_assoc.cu runs it: N elements,
    Hillis-Steele star products over N+1 elements, N gains, affine
    products over N maps, N+1 rollout knots."""
    n_bytes, _ = riccati_cost(batch, N, nx, nu)
    mm = 2 * nx ** 3
    nr = 2 * nx + 1
    element = nu ** 3 // 3 + 2 * nu * nu * nr + 3 * 2 * nx * nx * nu + 4 * nx * nu
    combine = 8 * mm + 2 * nx * 2 * nx * nx + 6 * 2 * nx * nx
    gains = (2 * 2 * nx * nx * (nx + nu + 1) + nu ** 3 // 3 + 2 * nu * nu * (nx + 1)
             + 2 * nx * nu * (nx + 1))
    affine = mm + 2 * nx * nx
    rollout = 2 * nx * nx + 2 * nu * nx * 2 + 2 * nu * nu
    combines = sum(N + 1 - d for d in (2 ** i for i in range(8)) if d < N + 1)
    affines = sum(N - d for d in (2 ** i for i in range(8)) if d < N)
    flops = N * (element + gains) + combines * combine + affines * affine + (N + 1) * rollout
    return n_bytes, batch * flops


def soa_chain_ops():
    """Elementwise operations of one knot's scalar chain (combined rows plus
    the RK2 midpoint flow), counted as the plain SoA version issues them on a
    one-element batch (each op on a batch-shaped scalar is one operation per
    knot; stacking and constant fills are not counted)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from hunter_bipedal_control_tpu_torch.models import soa
    from hunter_bipedal_control_tpu_torch.models.robot import load_model
    from hunter_bipedal_control_tpu_torch.ocp import problem as ocp

    skip = ("stack", "cat", "full", "ones_like", "zeros_like", "empty", "expand", "clone",
            "copy", "broadcast", "unsqueeze", "view", "select", "slice", "detach", "lift")

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not any(k in func.__name__ for k in skip):
                Count.n += 1
            return func(*args, **(kwargs or {}))

    m = load_model(device="cpu", dtype=torch.float64)
    params = ocp.default_ocp_params(m, torch.float64)
    x = torch.zeros(1, 22, dtype=torch.float64)
    x[:, 8] = 0.63
    u = torch.ones(1, 22, dtype=torch.float64)
    fl = torch.ones(1, 4, dtype=torch.float64)
    f3 = torch.zeros(1, 4, 3, dtype=torch.float64)
    soa.build_consts(m)
    with Count():
        soa.combined_rows_arrays(m, params, x, u, fl, f3, f3)
        soa.flow_arrays(m, x, u)
    return Count.n


def soa_lin_cost(knots, chain_ops, nx=22, nu=22, neq=16, ns=36):
    """Bytes (x, u, x_nom, flags, foot refs in: 94 floats; 13 outputs out:
    3,207 floats per knot) and operations (the scalar chain, the dense
    tail's A = I + dt J + dt^2/2 J J and B, the three weighted Gram
    products over the soft rows, qx and qu)."""
    n_in = 3 * nx + 4 + 24
    n_out = nx + 5 * nx * nx + 1 + nx + nu + neq + 2 * neq * nx + neq
    tail = (2 * 2 * nx ** 3 + 3 * (ns * nx + 2 * ns * nx * nx)
            + 2 * (2 * nx * nx + 2 * ns * nx))
    return knots * (n_in + n_out) * 4, knots * (chain_ops + tail)


def soa_merit_cost(batch, n_cand, N, chain_ops, nx=22, nu=22):
    """Bytes (every candidate's states and inputs, the references once per
    scenario, cost and metric out) and operations (the scalar chain, the
    stage cost's two quadratic forms and the defect per knot)."""
    n_in = batch * n_cand * ((N + 1) * nx + N * nu) + batch * (N + 1) * (nx + 28)
    ops = batch * n_cand * N * (chain_ops + 2 * (2 * nx * nx + 2 * nx) + 4 * nx)
    return (n_in + 2 * batch * n_cand) * 4, ops


def cast(tup, dev, dtype):
    """A NamedTuple with its floating tensors on ``dev`` in ``dtype`` (index
    tensors and other fields as they are)."""
    import torch

    return type(tup)(*(t.to(dev, dtype) if torch.is_tensor(t) and t.is_floating_point() else t
                       for t in tup))


def golden_check(telem, ref):
    """tests/test_golden.py's checks of a loop's telemetry (B=1) against the
    golden trace: the errors, the limits and whether all hold."""
    import numpy as np

    x = telem["x"][:, 0].double().cpu().numpy()
    levels = telem["gait_level"][:, 0].cpu().numpy()
    out = {"gait_level_equal": bool(np.array_equal(levels, ref["gait_level"])),
           "z": float(np.abs(x[:, 8] - ref["x"][:, 8]).max()),
           "planar": float(np.abs(x[:, 0:2] - ref["x"][:, 0:2]).max()),
           "joints": float(np.abs(x[:, 12:] - ref["x"][:, 12:]).max()),
           "violation_median": float(np.median(telem["violation"].double().cpu().numpy())),
           "violation_limit": float(2 * max(np.median(ref["violation"]), 1e-4)),
           "band": GOLDEN_BAND}
    out["ok"] = (out["gait_level_equal"] and all(out[q] <= GOLDEN_BAND[q] for q in GOLDEN_BAND)
                 and out["violation_median"] <= out["violation_limit"])
    return out


def sim_golden_check(telem, ref):
    """tests/test_golden.py's checks of the full-order loop's telemetry
    (B=1) against its golden trace: gait levels, base z, the base's planar
    velocity, joints, median violation."""
    import numpy as np

    q = telem["q"][:, 0].double().cpu().numpy()
    v = telem["v"][:, 0].double().cpu().numpy()
    levels = telem["gait_level"][:, 0].cpu().numpy()
    out = {"gait_level_equal": bool(np.array_equal(levels, ref["gait_level"])),
           "z": float(np.abs(q[:, 2] - ref["q"][:, 2]).max()),
           "planar": float(np.abs(v[:, 0:2] - ref["v"][:, 0:2]).max()),
           "joints": float(np.abs(q[:, 6:] - ref["q"][:, 6:]).max()),
           "violation_median": float(np.median(telem["violation"].double().cpu().numpy())),
           "violation_limit": float(2 * max(np.median(ref["violation"]), 1e-4)),
           "band": GOLDEN_BAND}
    out["ok"] = (out["gait_level_equal"] and all(out[k] <= GOLDEN_BAND[k] for k in GOLDEN_BAND)
                 and out["violation_median"] <= out["violation_limit"])
    return out


def sim_step_cost(batch, substeps, scaled, field, nq=16, nc=4, nj=10,
                  parent=(0, 1, 2, 3, 4, 0, 6, 7, 8, 9), contact_link=(5, 10, 5, 10)):
    """Bytes (q, v, the active command, the mass scale and field in: 86
    floats per scenario; the model's 497 constants, the 8 plant scalars and
    the effort limits once; q, v, the acceleration and the contact forces
    out, 60 floats) and the operations one physics substep needs per
    scenario, counting only the Jacobian columns that are not identically
    zero (a link's 3 translation and 3 Euler-rate columns and those of its
    ancestor joints, ``parent`` giving each joint's parent link, joint j
    moving link j + 1; soa_kernel.check_topology holds the model to it):
    FK (per joint two 3x3 products, three 3x3-vector products, the
    Rodrigues matrix; the link CoMs), the world inertias (one product and
    the 6 distinct entries of R I R'), the velocity pass; per link its
    CoM's columns with their time derivatives and J v, dJ/dt v; per
    contact its point, its linear columns and its velocity from the
    velocity pass (its dJ/dt v is not needed); the links' wrench terms;
    M's 136 distinct entries, I_k J_k formed once per angular column, each
    link adding to the pairs of its nonzero columns; nle; the field term
    and the mass scale only where the run gives them (``field``,
    ``scaled``); the contact law, the motors, Jc' f, the right-hand side;
    the solve of the positive definite A_sys by Cholesky (n^3/3 + 2 n^2,
    where csrc/sim_step.cu's Gauss-Jordan spends ~n^3); the Euler update."""
    n_in = batch * (2 * nq + 5 * nj + 4) + (497 + 8 + nj)
    n_out = batch * (3 * nq + 3 * nc)
    depth = [0] * (nj + 1)
    for j, par in enumerate(parent):
        depth[j + 1] = depth[par] + 1
    chain = 22 + nj * 162 + (nj + 1) * 18 + (nj + 1) * 75 + 15 + nj * 21 + 20
    # per link: its CoM's velocity and offsets (21); per Euler column the
    # linear column and its derivative (30) and three sums against v (18);
    # per ancestor joint the column and its derivative (45) and the sums (18)
    links = sum(21 + 3 * 48 + 63 * d for d in depth)
    contacts = sum(18 + 15 + 3 + 3 * 9 + 12 * depth[k] for k in contact_link)
    wrench = (nj + 1) * 46
    mass = sum(7 * (6 + d) * (7 + d) // 2 + 6 * (3 + d) * (4 + d) // 2 + 15 * (3 + d)
               for d in depth)
    nle = sum(3 * 6 + 12 * (3 + d) for d in depth)
    extra = (7 * sum(6 + d for d in depth) + nq if field else 0) + (136 + nq if scaled else 0)
    law_motor = nc * 20 + nj * 8
    jtf = sum(6 * (6 + depth[k]) for k in contact_link) + nj
    rhs = nj + 3 * nq
    solve = nq ** 3 // 3 + 2 * nq * nq + nq
    per_substep = (chain + links + contacts + wrench + mass + nle + extra + law_motor + jtf
                   + rhs + solve + 4 * nq)
    return (n_in + n_out) * 4, batch * substeps * per_substep


def _rbd_ops(nj=10, parent=(0, 1, 2, 3, 4, 0, 6, 7, 8, 9)):
    """Operations of one state's chain and its link CoMs' Jacobian columns
    with their time derivatives, as ``sim_step_cost`` counts them: (the
    chain, the columns, each link's depth in the tree)."""
    depth = [0] * (nj + 1)
    for j, par in enumerate(parent):
        depth[j + 1] = depth[par] + 1
    chain = 22 + nj * 162 + (nj + 1) * 18 + (nj + 1) * 75 + 15 + nj * 21 + 20
    links = sum(21 + 3 * 48 + 63 * d for d in depth)
    return chain, links, depth


def observer_cost(batch, nq=16, nj=10):
    """Bytes (rbd, the torques and the filter state in: 58 floats per
    scenario; the model's 497 constants and the cutoff once; p_scg_z,
    est_forces and tau_dist out, 48 floats) and the operations one observer
    update needs per scenario: rbd -> q, v; the chain and the link CoMs'
    columns with their time derivatives (``_rbd_ops``); per link its
    momentum h_k (the CoM's velocity, I_k w_k, m_k c_dot); per link and
    nonzero column p += J' h, C' v += dJ' h (11 each) and g's mass-weighted
    z entry (2); the filter (exp, beta, 16 x 9); per leg A A' (15 distinct
    entries of 6 products), its Cholesky solve (n^3/3 + 2 n^2), w = A' y
    and the two norms."""
    chain, links, depth = _rbd_ops()
    n_in = batch * (2 * nq + nj + nq) + 497 + 1
    n_out = batch * 3 * nq
    momenta = len(depth) * (9 + 3 + 15 + 3)
    sums = sum((6 + d) * 24 for d in depth)
    filt = 20 + nq * 9
    legs = 2 * (15 * 11 + 5 + 125 // 3 + 50 + 6 * 9 + 3 * 2 + 6 * 2 + 2)
    return (n_in + n_out) * 4, batch * (30 + chain + links + momenta + sums + filt + legs)


def kalman_cost(batch, ns=18, nm=28, nc=4, nj=10, contact_link=(5, 10, 5, 10)):
    """Bytes (the sensors, contact flags, x_hat, P and the feet heights in:
    383 floats per scenario; the model's 497 constants and the 8 filter
    scalars once; x_hat and P out, 342 floats) and the operations one filter
    update needs per scenario: the chain at a zero base (``_rbd_ops``); per
    contact its point and linear columns (as ``sim_step_cost``) and J v;
    quaternion -> R (~60) and the world acceleration; the gates; Pm =
    A P A' + Q on A's three dt rows and columns; x_pred; y and ey; Ssy =
    C Pm C' + R (406 distinct entries of up to four terms) and Pm C' (504
    entries of up to two); Ssy's Cholesky (n^3/3) and its solves against
    ey and C Pm (2 n^2 each, 19 right-hand sides); x_new; the symmetric
    P_new = Pm - (Pm C') (Ssy^-1 C Pm) (171 entries of nm products); the
    conditioning."""
    chain, _, depth = _rbd_ops()
    n_in = batch * (3 + 2 * nj + 3 + 4 + 3 + nc + ns + ns * ns + nc) + 497 + 8
    n_out = batch * (ns + ns * ns)
    contacts = sum(18 + 15 + 3 + 3 * 9 + 12 * depth[k] + 6 * (6 + depth[k])
                   for k in contact_link)
    small = 60 + 18 + 4 * 4 + 234 + 18 + nm * 3
    forms = 406 * 4 + nm + (ns * nm) * 2
    solve = nm ** 3 // 3 + (1 + ns) * 2 * nm * nm
    update = ns * nm * 2 + (ns * (ns + 1) // 2) * 2 * nm + ns * ns + 10
    return (n_in + n_out) * 4, batch * (chain + contacts + small + forms + solve + update)


def _kin_ops(nj=10, links=11, nc=4):
    """Operations of one state's kinematics as soa_model.cuh issues them:
    FK (per joint two 3x3 products, three 3x3-vector products, the
    Rodrigues matrix; the base rotation; the link CoMs), the CoM, the world
    inertias (R I R'), a velocity pass, the momentum about the CoM (per
    link its CoM's velocity, m c_dot, the offset, I w, the cross product
    and the sums), the CMM base block and its closed-form solve (Itot and
    W per link, G, G E, skew(s) E, the 3x3 inverse, the two solves), the
    contact points and the flow rows."""
    fk = 20 + nj * 162 + links * 18
    com = links * 6 + 3
    inertias = links * 75
    vpass = nj * 21 + 15
    momentum = links * 57
    base_block = links * 33 + 2 + 18 + 5 + 45 + 45 + 9 + 40 + 12 + 30 + 6
    contacts = nc * 18
    flow_rows = 9 + nc * 15 + 7
    return {"fk": fk, "com": com, "inertias": inertias, "vpass": vpass, "momentum": momentum,
            "base_block": base_block, "contacts": contacts, "flow_rows": flow_rows}


def imu_cost(batch):
    """Bytes (the entries the readings need in: the Euler angles, their
    rates and the linear acceleration, 9 floats per scenario; the
    quaternion, both angular velocities and the specific force out: 13) and
    operations: 12 sines and cosines, R (~20), the quaternion (~20), E
    theta_dot (~10), R' w and R' (a + g) (15 each, +1)."""
    return batch * (9 + 13) * 4, batch * (12 + 20 + 20 + 10 + 15 + 1 + 15)


def centroidal_cost(batch):
    """Bytes (the rbd state in: 32 floats per scenario, the model's 497
    constants once; x out: 22) and operations: rbd -> q, v (22), FK, the
    CoM, the world inertias, the velocity pass, the momentum about the CoM
    (``_kin_ops``), h / m (6)."""
    k = _kin_ops()
    ops = 22 + k["fk"] + k["com"] + k["inertias"] + k["vpass"] + k["momentum"] + 6
    return (batch * (32 + 22) + 497) * 4, batch * ops


def state_v_cost(batch):
    """Bytes (x and u's joint velocities in: 32 floats per scenario, the
    constants once; v out: 16, and the rbd state: 32) and operations: FK,
    the CoM, the world inertias, the joint-only velocity pass, its momentum,
    the base block and its solve (``_kin_ops``), and for the rbd state
    E(theta) theta_dot (15)."""
    k = _kin_ops()
    ops = (k["fk"] + k["com"] + k["inertias"] + k["vpass"] + k["momentum"] + k["base_block"]
           + 15)
    return (batch * (32 + 16 + 32) + 497) * 4, batch * ops


def dummy_cost(batch, nx=22):
    """Bytes (x and u in: 44 floats per scenario, the constants and dt once;
    x out: 22) and operations: two flow evaluations (FK, the CoM, the world
    inertias, the joint-only pass, its momentum, the base block, the contact
    points, the flow rows; ``_kin_ops``), the midpoint (2 nx) and the RK2
    update (3 nx)."""
    k = _kin_ops()
    flow = (k["fk"] + k["com"] + k["inertias"] + k["vpass"] + k["momentum"] + k["base_block"]
            + k["contacts"] + k["flow_rows"])
    return (batch * (44 + 22) + 497 + 1) * 4, batch * (2 * flow + 5 * nx)


def _flow_ops():
    """Operations of one centroidal flow evaluation (``_kin_ops``): FK, the
    CoM, the world inertias, the joint-only pass, its momentum, the base
    block, the contact points, the flow rows."""
    k = _kin_ops()
    return (k["fk"] + k["com"] + k["inertias"] + k["vpass"] + k["momentum"] + k["base_block"]
            + k["contacts"] + k["flow_rows"])


def ddp_rollout_cost(batch, n_alpha, N, integrator, accepted_slots, closed, nx=22, nu=22,
                     ns=36, neq=16):
    """Bytes and operations of B15's rollouts.  Bytes: per scenario x_init,
    xs_bar, us_bar, the policy (K, kff; closed loop only) and the references
    (x_nom, flags, foot position and velocity: 50 floats per knot) read
    once, the step sizes, constants, parameters, Q and R once; per rollout
    xs, us, cost, eq and the slot counts out.  Operations per rollout and
    knot (``_kin_ops``): the feedback (2 nu nx + 3 nu), the rows (a flow, a
    velocity pass, the contact velocities, 16 equality and 36 soft rows,
    ~252), the stage cost (two quadratic forms, the penalties), |g|_1; then
    the integrator's further flows: RK2 one (+ 5 nx), RK4 three (+ 14 nx),
    ODE45 seven per accepted slot of this run (+ 76 nx: the stage sums, the
    two candidates, the error norm; ``accepted_slots`` is their total over
    every rollout and knot; rejected slots, 6 flows each, are not counted)."""
    flow = _flow_ops()
    k = _kin_ops()
    n_in = batch * (nx + (N + 1) * nx + N * nu + (N * nu * (nx + 1) if closed else 0)
                    + (N + 1) * (nx + 4 + 24)) + n_alpha + 497 + 45 + nx * nx + nu * nu
    n_out = batch * n_alpha * ((N + 1) * nx + N * nu + 2 + N)
    per_knot = ((2 * nu * nx + 3 * nu if closed else 0) + flow + k["vpass"] + 252
                + 2 * (2 * nx * nx + 2 * nx) + 8 * ns + 2 * neq)
    rollouts = batch * n_alpha
    if integrator == "ODE45":
        ops = rollouts * N * per_knot + accepted_slots * (7 * flow + 76 * nx)
    else:
        extra = flow + 5 * nx if integrator == "RK2" else 3 * flow + 14 * nx
        ops = rollouts * N * (per_knot + extra)
    return (n_in + n_out) * 4, ops


def qp_cost(batch, iters, n=38, me=28, mi=40):
    """Bytes (QP data, start point and floors in; x, duals, residual out)
    and flops of ``iters`` PDIP iterations (see csrc/solve_qp.cu).  The
    symmetric products (Hbar, the Schur matrix) count one triangle."""
    n_in = n * n + n + me * n + me + mi * n + mi + n + mi + me + 2
    n_out = n + me + mi + 1
    per_iter = (2 * n * n + 4 * me * n + 4 * mi * n             # residuals
                + mi * n * (n + 1) + 3 * mi * n                 # Hbar, rbar
                + n ** 3 // 3 + 2 * n * n * (me + 1)            # Cholesky 38, 2 sweeps
                + me * (me + 1) * n + 2 * me * n                # Schur, its rhs
                + me ** 3 // 3 + 2 * me * me                    # Cholesky 28, 2 sweeps
                + 2 * n * me + 2 * mi * n + 20 * mi)            # dx, ds, dlam, step
    return batch * (n_in + n_out) * 4, batch * (iters * per_iter + 2 * (me + mi) * n)


def ik_cost(batch, n_samples, trans_it, rot_it, nj=10):
    """Bytes (poses, toe targets, warm joints, target rotations, the leg
    joints' constants and the contact offsets of both toes in; both passes'
    joints out) and operations of the two IK passes as csrc/leg_ik.cu runs
    them per (scenario, sample, leg): per joint of a toe evaluation two 3x3
    products, three 3x3-vector products, the Rodrigues matrix and its
    cosine and sine; the Jacobian's five cross products; per step the 5x5
    normal system, its Gauss-Jordan inverse (as ``gj_cost``) and the
    solution; the rotation step's local-frame Jacobians, the projector
    through the 3x3 adjugate inverse, and log3."""
    joint = 45 + 15 + 3 + 15 + 2 + 1 + 36 + 45
    toe = 5 * joint + 18 + 5 * 12
    solve5 = 5 * 26 + 25 + 5 * (2 * 5 + 4 * 5 * 4) + 45
    rot_err = 45 + 3 + 2 + 3 + 9 + 6
    trans_step = toe + solve5 + 20 + 12
    rot_step = toe + 150 + 84 + 42 + 75 + 150 + 135 + solve5 + 45 + 20 + rot_err + 7
    per_pass = toe + 12 + trans_it * trans_step + toe + rot_err + 7 + rot_it * rot_step
    legs = 2 * batch * n_samples
    n_in = batch * n_samples * (6 + 6) + batch * (nj + 9) + 2 * nj + nj * 33 + 2 * 3
    n_out = 2 * batch * n_samples * nj
    return (n_in + n_out) * 4, legs * (22 + 2 * per_pass)


def _rows_read(t):
    """Entries of a batched input the kernel reads: one scenario's for an
    input shared by ``expand`` (batch stride 0), else all."""
    return t[0].numel() if t.shape[0] > 1 and t.stride(0) == 0 else t.numel()


def swing_plan_cost(args, p1=57, nodes=4):
    """Bytes and operations of B8b1 on ``swing_plan``'s arguments: in, each
    input once (an input shared by the batch once: x_init, init time, the
    schedule's event times and int64 modes, the target, the command, the
    default joints, the planner state, the swing configuration, the FK's
    constants of 10 joints and 4 contacts); out, the planner state, the
    three node arrays, the windows, the samples' times, states, inputs,
    poses and toe targets, R_des and the warm joints.  Operations per
    (leg, phase): the window scans, the next phase's search, the target's
    interpolation, the rotation, the candidate, the fresh-window scans over
    the phases before it, and the spline nodes; per scenario the FK of
    x_init and the command's rotation; per sample the interpolation and
    two toe splines."""
    model, cfg, ps, sch, tgt, init, x, cmd, dj, _, S = args
    Bn, nj, T = x.shape[0], dj.shape[-1], tgt.times.shape[-1]
    n_in = (x.numel() + _rows_read(init) + _rows_read(sch.event_times)
            + 2 * _rows_read(sch.modes) + _rows_read(tgt.times) + _rows_read(tgt.states)
            + _rows_read(tgt.inputs) + _rows_read(cmd) + _rows_read(dj) + ps[0].numel()
            + 17 + nj * 33 + 4 * 3)
    n_out = Bn * (12 + 3 * 4 * p1 * 3 * nodes + 3 * 4 * p1 + S * (1 + 22 + 22 + 6 + 6)
                  + 9 + nj)
    per_phase = 2 * p1 + 6 + 4 + 6 + 18 + 6 + 16 + 15 + 14 + 4 + 3 * 12
    scans = 4 * 2 * (p1 * (p1 - 1) // 2)
    fk = nj * (45 + 15 + 3 + 15 + 2 + 36 + 45 + 3) + 4 * 18
    per_sample = 2 + 5 + 3 * 44 + 6 + 2 * 3 * (40 + 3 * 12)
    ops = Bn * (4 * p1 * per_phase + scans + fk + 120 + S * per_sample + 22)
    return (n_in + n_out) * 4, ops


def knot_refs_cost(args, knot_phase, nj=10):
    """Bytes and operations of B8b2 on ``knot_refs``' arguments: in, the
    init time, the schedule, the swing nodes of the (scenario, leg, phase)
    that this run's knots fall in (``knot_phase``, the kernel's decisions),
    the sample times, states and joint references; out, the knot times,
    x_nom, the flags, the foot positions and velocities and the modified
    target's states.  Operations per knot: the time, the phase's search,
    12 spline evaluations with their segment searches, x_nom's
    interpolation."""
    sch, plan, init, _, N, jr = args
    Bn, S, nx = plan.states.shape
    K1 = N + 1
    phases = sum(knot_phase[b].unique().numel() for b in range(Bn))
    n_in = (_rows_read(init) + _rows_read(sch.event_times) + 2 * _rows_read(sch.modes)
            + phases * 4 * 3 * 4 * 3 + Bn * S * (1 + nx + nj))
    n_out = Bn * (K1 * (1 + nx + 4 + 12 + 12) + S * nx)
    return (n_in + n_out) * 4, Bn * K1 * (2 + 6 + 12 * (40 + 3 * 2) + 5 + nx * 3)


def prep_err(got, ref, keep):
    """(max |got - ref|, max |got - ref| / max(1, |ref|)) over the scenarios
    ``keep`` (B,)."""
    a, b = got[keep].double(), ref[keep].double()
    if a.numel() == 0:
        return 0.0, 0.0
    d = (a - b).abs()
    return d.max().item(), (d / b.abs().clamp(min=1.0)).max().item()


def split_empty_windows(names, live, *runs):
    """Each run's outputs with every per-phase output (PREP_PHASE_NAMES)
    split in two: its live phases (the empty ones zeroed) under its name,
    its empty ones (the live ones zeroed) under name + "_empty".  ``live``:
    (B, 4, P1) bool.  Returns (names, runs)."""
    import torch

    out_names = [m for n in names for m in ((n, n + "_empty") if n in PREP_PHASE_NAMES else (n,))]
    out_runs = []
    for run in runs:
        r = []
        for n, t in zip(names, run):
            if n not in PREP_PHASE_NAMES:
                r.append(t)
                continue
            m = live.to(t.device).reshape(*live.shape, *([1] * (t.dim() - 3)))
            zero = torch.zeros((), dtype=t.dtype, device=t.device)
            r += [torch.where(m, t, zero), torch.where(m, zero, t)]
        out_runs.append(r)
    return out_names, out_runs


def prep_compare(names, got, p32, p64, bf16, dec_k, dec32, dec64):
    """One B8b kernel's outputs against its plain versions: the errors as
    ``errors`` gives them, outside the scenarios where the float32 plain
    version's decisions went the other way from the float64 one's; the
    decisions the kernel took otherwise than the float32 plain version (to
    be 0); the flipped scenarios; bfloat16's errors on the same scenarios."""
    import torch

    Bn = got[0].shape[0]

    def off(d, ref):
        m = torch.zeros(Bn, dtype=torch.bool, device=got[0].device)
        for n in ref:
            if n in PREP_FLIP_DECISIONS:
                m |= (d[n].long() != ref[n].long()).reshape(Bn, -1).any(-1)
        return m

    flip32 = off(dec32, dec64)
    keep = ~flip32
    err = {n: (prep_err(a, b, keep), prep_err(a, c, keep), prep_err(b, c, keep))
           for n, a, b, c in zip(names, got, p32, p64)}
    e_bf16 = {n: prep_err(b, c, keep)[1] for n, b, c in zip(names, bf16, p64)}
    kernel_off = {n: int((dec_k[n].long() != dec32[n].long()).sum()) for n in dec32}
    return err, e_bf16, {"kernel_vs_plain_f32": kernel_off,
                         "plain_f32_vs_f64": {n: int((dec32[n].long() != dec64[n].long()).sum())
                                              for n in dec32},
                         "scenarios_f32_vs_f64": int(flip32.sum()),
                         "scenarios_kernel_vs_f64": int(off(dec_k, dec64).sum()),
                         "scenarios": Bn}


def wbc_qp_cost(batch, n=38, me=28, mi=40, rows=36, nq=16, links=11, nc=4):
    """Bytes (x_des, u_des, rbd, flags in, 79 floats and the stance flag per
    scenario; the model's 497 constants and the 17 gains once; the six QP
    arrays out, 4,134 floats per scenario) and operations of csrc/wbc_qp.cu
    per scenario: two FK chains (10 joints: two 3x3 products, two 3x3-vector
    products, the Rodrigues matrix), the desired base velocity (the world
    inertias, the CMM base block and its 3x3 inverse), two velocity passes,
    per (state, link or contact) 16 Jacobian columns with their time
    derivatives (~60 each) summed against v, M (16 x 16 entries over 11
    links), nle, the desired base acceleration, the task rows, H (38 x 38
    over 36 rows) and g."""
    n_in = batch * (79 * 4 + 1) + (497 + 17) * 4
    n_out = batch * (n * n + n + me * n + me + mi * n + mi) * 4
    fk = 10 * (45 + 15 + 15 + 27 + 45 + 6) + 11 * 18 + 20
    base_vel = 11 * 90 + 11 * 60 + 150 + 10 * 30
    columns = 2 * (links + nc) * nq * 60
    mass = nq * nq * links * 28
    nle = nq * links * 12 + links * 40
    acc = links * 60 + nc * 20 + 60
    tasks = rows * n + 150
    gram = n * n * rows * 2 + n * rows * 2
    ops = 2 * fk + base_vel + 2 * 10 * 20 + columns + mass + nle + acc + tasks + gram
    return n_in + n_out, batch * ops


def gj_inverse_fma(A, pivot):
    """The plain Gauss-Jordan inverse (natural-order pivots) in float32 with
    the kernel's rounding: each update M - col prow rounded once, as a fused
    multiply-add rounds it (the product of two float32 values is exact in
    float64)."""
    import torch

    n = A.shape[-1]
    M = torch.cat([A, torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)], dim=-1)
    for k in range(n):
        pval = M[..., k, k:k + 1]
        if pivot:
            pval = pval + 1e-30
        prow = M[..., k, :] / pval
        col = M[..., :, k].clone()
        col[..., k] = 0.0
        M = (M.double() - col.double()[..., :, None] * prow.double()[..., None, :]).float()
        M[..., k, :] = prow
    return M[..., :, n:]


def scaled(a, b):
    """max |a - b| / max(1, max |b|)."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return (a - b).abs().max().item() / max(1.0, b.abs().max().item())


def run_ticks(setup, policy, schedule, after_tick=None):
    """``tick_chain`` over TICKS ticks; returns (outputs, final states, the
    observer's state after every tick, stacked (B, K, ...)).
    ``after_tick()``, if given, is called after each tick."""
    import torch

    from hunter_bipedal_control_tpu_torch.entry import tick_chain

    obs = []

    def on_tick(i, out, states):
        obs.append(states[1])
        if after_tick is not None:
            after_tick()

    outs, final = tick_chain(setup, policy, schedule, TICKS, on_tick=on_tick)
    return outs, final, type(obs[0])(*(torch.stack(f, dim=1) for f in zip(*obs)))


def tick_compare(card, cpu32, cpu64):
    """``run_ticks``' results on the card and in the CPU float32 and float64
    runs: per tick the command, the WBC solution and the observer's state
    (its est_forces is that tick's 5x5 solve); at the end the Kalman and WBC
    states.  Per quantity its distance to the float64 run, the float32
    run's, and the limit."""
    picks = {"tau_ff": lambda r: r[0].command.tau_ff,
             "pos_des": lambda r: r[0].command.pos_des,
             "wbc_solution": lambda r: r[0].wbc_solution}
    for fld in card[2]._fields:
        picks[f"observer.{fld}"] = lambda r, fld=fld: getattr(r[2], fld)
    for i, st in ((0, "kalman"), (2, "wbc")):
        for fld in card[1][i]._fields:
            if getattr(card[1][i], fld).is_floating_point():
                picks[f"{st}.{fld}"] = lambda r, i=i, fld=fld: getattr(r[1][i], fld)
    out = {}
    for name, pick in picks.items():
        noise = scaled(pick(cpu32), pick(cpu64))
        out[name] = {"vs_cpu_f64": scaled(pick(card), pick(cpu64)), "cpu_f32_vs_f64": noise,
                     "limit": max(TICK_FLOOR, MAIN_FACTOR * noise)}
    return out


def to_device(tup, dev, dtype):
    """A NamedTuple of tensors on another device / float dtype."""
    return type(tup)(*(t.to(dev, dtype) if t.is_floating_point() else t.to(dev) for t in tup))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs a GPU", file=sys.stderr)
        return 2

    import numpy as np

    from hunter_bipedal_control_tpu_torch.backends import dummy as dummy_mod, fullorder
    from hunter_bipedal_control_tpu_torch.entry import (TICK_DT, build_controller, build_flagship,
                                                        build_loop, build_sim_loop,
                                                        build_wbc_batch, centroidal_batch,
                                                        estimator_batch,
                                                        ddp_solve, mpc_chain, run_loop,
                                                        run_sim_loop,
                                                        sim_step_batch, standing_sensors,
                                                        walking_wbc_batch, wbc_chain)
    from hunter_bipedal_control_tpu_torch.estim import contact, kalman
    from hunter_bipedal_control_tpu_torch.kernels import _build
    from hunter_bipedal_control_tpu_torch.models import centroidal as cen_mod
    from hunter_bipedal_control_tpu_torch.ocp import soa_kernel
    from hunter_bipedal_control_tpu_torch.ops import linalg, qp
    from hunter_bipedal_control_tpu_torch.profile_step import (_charged_launches, _profiled,
                                                               profile_loop_phases,
                                                               profile_phases, profile_sim_loop,
                                                               profile_sim_loop_phases,
                                                               profile_tick_phases)
    from hunter_bipedal_control_tpu_torch.refs import ik as ik_mod
    from hunter_bipedal_control_tpu_torch.runtime import controller as ctrl_mod
    from hunter_bipedal_control_tpu_torch.runtime import loop as loop_mod
    from hunter_bipedal_control_tpu_torch.runtime import sim_loop as sim_loop_mod
    from hunter_bipedal_control_tpu_torch.solver import ddp as ddp_mod
    from hunter_bipedal_control_tpu_torch.solver import mpc as mpc_mod, riccati, sqp
    from hunter_bipedal_control_tpu_torch.wbc import wbc as wbc_mod

    # ---- 1. the card ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})

    # ---- 2. build ----
    secs = _build.build()
    _build.library()
    # per source, the resources ptxas reports for each kernel (registers, spills)
    ptxas, src = {}, None
    for ln in _build.build_log.splitlines():
        if ln.startswith("== "):
            src = ln[3:].strip()
        elif src and ("Used" in ln or "spill" in ln or "entry function" in ln):
            ptxas.setdefault(src, []).append(ln.strip().replace("ptxas info    : ", "")[:100])
    emit({"phase": "build", "seconds": round(secs, 3), "library": _build.LIB_PATH,
          "ptxas": {f: lines[:18] for f, lines in ptxas.items()}})

    rows = {}

    def per_output(errs, tol):
        return {n: {"max_abs_err": e32[0], "rel_err_vs_f64": e64[1],
                    "plain_rel_err_vs_f64": p64[1], "limit": max(tol, TOL_FACTOR * p64[1])}
                for n, (e32, e64, p64) in errs.items()}

    def record(name, route, source, replaces, errs, tol, ms, plain_ms, lib_ms, cost, extra):
        max_abs = max(e32[0] for e32, _, _ in errs.values())
        b_ms, b_by = bound(*cost)
        rows[name] = {"name": name, "route": route, "source": source, "replaces": replaces,
                      "launches": None, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        emit({"phase": "kernel", "name": name, "max_abs_err": max_abs, "tol": tol,
              "tol_factor": TOL_FACTOR, "outputs": per_output(errs, tol), "kernel_ms": ms,
              "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
              **extra})
        check(name, errs, tol)

    def gj_case(A, pivot, row=None, use=None):
        """B6 on A against its plain versions: float64 (the reference),
        float32 by separate products and with the kernel's fused
        multiply-adds (the larger error of the two sets the limit), and
        bfloat16 (must land above the limit).  ``row`` names the kernels
        line's row that takes this shape's figures; else a kernel_extra line."""
        tol, n = TOL["gj_inverse"], A.shape[-1]
        got = linalg.gj_inverse(A, pivot)
        fma = gj_inverse_fma(A, pivot)
        p64 = linalg.gj_inverse_plain(A.double(), pivot)
        err = errors(["inverse"], [got], [linalg.gj_inverse_plain(A, pivot)], [p64])
        e32, e64, p32 = err["inverse"]
        e_fma = rel_err(fma, p64)[1]
        err["inverse"] = (e32, e64, (p32[0], max(p32[1], e_fma)))
        limit = max(tol, TOL_FACTOR * max(p32[1], e_fma))
        e_bf16 = rel_err(linalg.gj_inverse_plain(A.bfloat16(), pivot), p64)[1]
        info = {"use": use, "shape": list(A.shape), "pivot": pivot,
                "plain_f32_rel_err_vs_f64": p32[1], "plain_fma_rel_err_vs_f64": e_fma,
                "kernel_rel_err_vs_plain_fma": rel_err(got, fma)[1],
                "plain_bf16_rel_err_vs_f64": e_bf16}
        times = (cuda_ms(lambda: linalg.gj_inverse(A, pivot)),
                 cuda_ms(lambda: linalg.gj_inverse_plain(A, pivot)),
                 cuda_ms(lambda: torch.linalg.inv(A)))
        cost = gj_cost(A.numel() // (n * n), n)
        if row is not None:
            record(row, "cuda", "hunter_bipedal_control_tpu_torch/csrc/gj_inverse.cu",
                   "hunter_bipedal_control_tpu/ops/linalg.py:141", err, tol, *times, cost, info)
            rows[row]["use"] = use
        else:
            b_ms, b_by = bound(*cost)
            emit({"phase": "kernel_extra", "name": "gj_inverse", "tol": tol,
                  "outputs": per_output(err, tol), "kernel_ms": times[0], "plain_ms": times[1],
                  "library_ms": times[2], "bound_ms": b_ms, "bound_by": b_by, **info})
            check(f"gj_inverse {list(A.shape)}", err, tol)
        if not e_bf16 > limit:
            raise AssertionError(f"gj_inverse {list(A.shape)}: the bfloat16 plain version "
                                 f"({e_bf16}) is within the limit ({limit})")

    # ---- 3. kernels vs plain versions at the main path's shapes ----
    B, N, H = 128, 66, 1.0
    gen = torch.Generator(device="cpu").manual_seed(0)

    def spd(batch, n):
        X = torch.randn(batch, n, n, generator=gen)
        return (X @ X.transpose(1, 2) / n + 0.5 * torch.eye(n)).to(dev).contiguous()

    # B6, one kernels-line row per use: the IK's 5x5 damped normal systems
    # (2 legs x 7 samples per scenario; B8a's leg_ik solves them on the MPC
    # path now), the tick's two uses below; the projection's 16x16 Gram
    # shape as an extra line
    ik_use = "IK 5x5 (refs/ik.py:50-58): absorbed into B8a's leg_ik on the MPC path"
    gj_case(spd(B * 7 * 2, 5), True, "gj_inverse", ik_use)
    gj_case(spd(B * N, 16), False, use="projection Gram 16x16 shape (not on a path)")

    # B2 and B3 on the main path's own data: the first SQP iteration of the
    # flagship's cold step (reference prep, warm start, linearization)
    flag = build_flagship(N, H, batch=B, device=dev)
    z6 = torch.zeros(6, device=dev)
    model, settings, params = flag.model, flag.settings, flag.params
    sched = mpc_mod.ModeSchedule(*(a.expand(B, *a.shape) for a in flag.schedule))
    target = mpc_mod.tg.TargetTrajectories(*(a.expand(B, *a.shape) for a in flag.target))
    t0 = torch.zeros(B, device=dev)
    bundle, _, _, _ = mpc_mod.prepare_references(
        model, settings, flag.planner_cfg, flag.state.planner, sched, target, t0, flag.x0,
        z6.expand(B, 6), flag.default_joints.expand(B, -1))
    xs, us = mpc_mod._warm_start(model, settings, bundle, flag.state, flag.x0)
    lin = sqp.knot_linearization_all(model, settings, params, bundle, xs, us)
    xnext, A, Bm, _, qx, qu, Qxx, Quu, Qux, g, C, D, mask = lin
    pin = [t.contiguous() for t in (A, Bm, xnext - xs[:, 1:], qx, qu, Qxx, Quu, Qux, g, C, D,
                                     mask)]
    got = sqp.project_knot(settings, *pin)
    ref = sqp.project_knot_plain(settings, *pin)
    ref64 = sqp.project_knot_plain(settings, *as64(pin))
    names = ("A_t", "B_t", "d_t", "qx_t", "qw", "Qxx_t", "Qww", "Qwx", "E", "e", "P")
    record("project_knot", "cuda", "hunter_bipedal_control_tpu_torch/csrc/project_knot.cu",
           "hunter_bipedal_control_tpu/solver/sqp.py:146", errors(names, got, ref, ref64),
           TOL["project_knot"], cuda_ms(lambda: sqp.project_knot(settings, *pin)),
           cuda_ms(lambda: sqp.project_knot_plain(settings, *pin)), None, project_cost(B * N),
           {"knots": B * N})

    A_t, B_t, d_t, qx_t, qw, Qxx_t, Qww, Qwx, E, e0, P = [t.contiguous() for t in ref64]
    # the Riccati inputs: the float64 projection, rounded once to float32
    lq64 = riccati.StageLQ(A=A_t, B=B_t, d=d_t, Qxx=Qxx_t, Qww=Qww, Qwx=Qwx, qx=qx_t, qw=qw)
    lq = riccati.StageLQ(*(t.float() for t in lq64))
    E, P, e0 = E.float(), P.float(), e0.float()
    dx0 = (flag.x0 - xs[:, 0]).contiguous()
    reg = settings.hess_reg
    got = riccati.riccati_solve(lq, E, P, e0, dx0, reg)
    ref = riccati.riccati_solve_plain(lq, E, P, e0, dx0, reg)
    ref64 = riccati.riccati_solve_plain(riccati.StageLQ(*as64(lq)), *as64((E, P, e0, dx0)),
                                        reg)
    record("riccati_solve", "cuda", "hunter_bipedal_control_tpu_torch/csrc/riccati.cu",
           "hunter_bipedal_control_tpu/solver/riccati.py:60",
           errors(("K", "kff", "dxs", "dus"), got, ref, ref64), TOL["riccati_solve"],
           cuda_ms(lambda: riccati.riccati_solve(lq, E, P, e0, dx0, reg)),
           cuda_ms(lambda: riccati.riccati_solve_plain(lq, E, P, e0, dx0, reg)), None,
           riccati_cost(B, N), {"scenarios": B, "knots": N})
    del lin, pin, got, ref, ref64, lq, lq64

    # B4 on the WBC's own QPs: bench.py's batched-WBC standing states at
    # B=4096, 10 iterations, cold (x0 = 0, the WBC's first tick) and warm
    # from the kernel's cold solution
    wb = build_wbc_batch(WBC_BATCH, dev)
    qdata = [t.contiguous() for t in wbc_mod.wbc_qp(wb.model, wb.params, wb.x_des, wb.u_des,
                                                    wb.rbd, wb.contact_flags, wb.stance_mode)]
    qkw = {"n_iters": wb.params.qp_iters_warm, "x0": torch.zeros(WBC_BATCH, 38, device=dev),
           "lam0": torch.ones(WBC_BATCH, 40, device=dev),
           "nu0": torch.zeros(WBC_BATCH, 28, device=dev), "warm_margin": 1.0}
    qp_names = ("x", "eq_dual", "ineq_dual", "primal_residual")
    res_scale = 1.0 + torch.maximum(qdata[3].abs().amax(-1), qdata[5].abs().amax(-1))

    def qp_outputs(sol):
        return [sol.x, sol.eq_dual, sol.ineq_dual, sol.primal_residual / res_scale]

    qp_rows = {}
    for start in ("cold", "warm"):
        if start == "warm":
            qkw["x0"] = qp_rows["cold"]["x"].contiguous()
        kw64 = {k: (v.double() if torch.is_tensor(v) else v) for k, v in qkw.items()}
        got = qp.solve_qp(*qdata, **qkw)
        ref = qp.solve_qp_plain(*qdata, **qkw)
        ref64 = qp.solve_qp_plain(*as64(qdata), **kw64)
        err = errors(qp_names, qp_outputs(got), qp_outputs(ref), qp_outputs(ref64),
                     {"primal_residual": 1.0})
        qp_rows[start] = {"x": got.x, "err": err,
                          "ms": cuda_ms(lambda: qp.solve_qp(*qdata, **qkw)),
                          "plain_ms": cuda_ms(lambda: qp.solve_qp_plain(*qdata, **qkw))}
    extra = {"batch": WBC_BATCH, "iterations": qkw["n_iters"], "start": "cold",
             "warm": {"outputs": per_output(qp_rows["warm"]["err"], TOL["solve_qp"]),
                      "kernel_ms": qp_rows["warm"]["ms"], "plain_ms": qp_rows["warm"]["plain_ms"]}}
    record("solve_qp", "cuda", "hunter_bipedal_control_tpu_torch/csrc/solve_qp.cu",
           "hunter_bipedal_control_tpu/ops/qp.py:32", qp_rows["cold"]["err"], TOL["solve_qp"],
           qp_rows["cold"]["ms"], qp_rows["cold"]["plain_ms"], None,
           qp_cost(WBC_BATCH, qkw["n_iters"]), extra)
    check("solve_qp warm", qp_rows["warm"]["err"], TOL["solve_qp"])
    del qdata, qp_rows, got, ref, ref64

    # B6 on the Kalman filter's own 28x28 innovation covariance (the tick's
    # first update, B=1), and 4096 copies of it for timing; B12's
    # kalman_update eliminates it on the tick and loop paths now
    tsetup = build_controller(1, dev)
    *_, Ssy, _ = kalman.innovation(tsetup.controller.model, tsetup.kalman_params,
                                   tsetup.kalman, **standing_sensors(tsetup), dt=TICK_DT)
    kalman_use = ("Kalman 28x28 innovation (estim/kalman.py:158-159): absorbed into B12's "
                  "kalman_update on the tick and loop paths")
    gj_case(Ssy.contiguous(), True, "gj_inverse_kalman", kalman_use)
    gj_case(Ssy.expand(WBC_BATCH, 28, 28).contiguous(), True, use=kalman_use + ", x4096")
    # the momentum observer's two 5x5 leg systems: they depend on the joint
    # angles and the base orientation alone, which the standing tick holds
    # at q0; B10's momentum_observer solves them on the tick and loop paths
    _, AAt = contact.leg_systems(tsetup.controller.model, tsetup.q0[None])
    gj_case(AAt, True, "gj_inverse_observer",
            "momentum observer 2 x 5x5 (estim/contact.py:92-93): absorbed into B10's "
            "momentum_observer on the tick and loop paths")

    # ---- 4. the MPC path ----
    mpc = mpc_mod.Mpc(model, settings, params, flag.planner_cfg)
    args = (flag.schedule, flag.target, 0.0, flag.x0, z6, flag.default_joints)
    counters = {"gj_inverse": linalg.gj_inverse, "project_knot": sqp.project_knot,
                "riccati_solve": riccati.riccati_solve,
                "riccati_solve_parallel": riccati.riccati_solve_parallel, "solve_qp": qp.solve_qp,
                "soa_linearize": soa_kernel.soa_linearize, "soa_merit": soa_kernel.soa_merit,
                "leg_ik": ik_mod.leg_ik, "wbc_qp": wbc_mod.wbc_qp, "sim_step": fullorder.sim_step,
                "momentum_observer": contact.momentum_observer_update,
                "kalman_update": kalman.kalman_update, "synth_imu": fullorder.synth_imu,
                "rbd_to_centroidal": cen_mod.rbd_state_to_centroidal,
                "dummy_step": dummy_mod.dummy_step,
                "state_input_to_v": cen_mod.state_input_to_v, "swing_plan": mpc_mod.swing_plan,
                "knot_refs": mpc_mod.knot_refs, "ddp_rollout": ddp_mod.closed_rollout}
    b1 = ("soa_linearize", "soa_merit")

    # the inputs the linearization and the line search's merit get on a
    # main-path run: sqp.solve calls both through the module
    captured = {}

    def capture(run):
        lin, merit, ik = sqp.knot_linearization_all, sqp.eval_merit, ik_mod.joint_reference_ik
        prep = {n: getattr(mpc_mod, n) for n in ("prepare_references", "swing_plan",
                                                  "knot_refs")}

        def prep_cap(name):
            def run_(*a, **k):
                captured.setdefault(name, (a, k))
                return prep[name](*a, **k)
            return run_

        def lin_cap(*a):
            captured.setdefault("lin", a)
            return lin(*a)

        def merit_cap(*a):
            captured.setdefault("merit", a)
            return merit(*a)

        def ik_cap(*a, **k):
            captured.setdefault("ik", (a, k))
            return ik(*a, **k)

        captured.clear()
        sqp.knot_linearization_all, sqp.eval_merit = lin_cap, merit_cap
        ik_mod.joint_reference_ik = ik_cap
        for n in prep:
            setattr(mpc_mod, n, prep_cap(n))
        try:
            return run()
        finally:
            sqp.knot_linearization_all, sqp.eval_merit = lin, merit
            ik_mod.joint_reference_ik = ik
            for n, fn in prep.items():
                setattr(mpc_mod, n, fn)
        
    # the kernels line's B6 rows: each counts the launches of its matrix size
    # on its path (none: B8a solves the IK's systems on the MPC path, B12 and
    # B10 the estimators' on the tick; read_counts holds every path to no B6)
    gj_rows = {"gj_inverse": ("mpc_step", 5), "gj_inverse_kalman": ("tick", 28),
               "gj_inverse_observer": ("tick", 5)}
    path_launches, gj_by_n = {}, {}

    def zero_counts():
        for c in counters.values():
            c.launches = 0
        linalg.gj_inverse.launches_by_n.clear()

    def read_counts(path, kernels, absent=(), steps=0, ticks=0, plant_ticks=0, observer=0,
                    filter_updates=0, sensing=0, dummy_ticks=0, ddp=None):
        """The launches of the path's run; raise if one of its kernels had
        none, a kernel of ``absent`` had any, swing_plan, leg_ik or knot_refs
        was not launched exactly once per MPC step (``steps`` of them), wbc_qp
        not exactly once per control tick (``ticks`` of them), and solve_qp
        beside it, sim_step not once per tick of the full-order plant
        (``plant_ticks``), momentum_observer and kalman_update not once per
        observer and filter update (``observer``, ``filter_updates``),
        synth_imu and rbd_to_centroidal not once per sensing of the
        full-order loop (``sensing``), dummy_step and state_input_to_v
        not once per tick of the dummy loop (``dummy_ticks``), or, with
        ``ddp`` = (SQP solves, DDP iterations, DDP solves), soa_linearize,
        project_knot and riccati_solve not once per SQP solve and DDP
        iteration, soa_merit not once per SQP solve, and ddp_rollout not
        once per DDP iteration plus once per DDP solve (its re-roll); without
        ``ddp``, any ddp_rollout launch."""
        counts = {n: c.launches for n, c in counters.items()}
        path_launches[path] = counts
        gj_by_n[path] = dict(linalg.gj_inverse.launches_by_n)
        for n in kernels:
            if counts[n] <= 0:
                raise AssertionError(f"kernel {n} was not launched on the {path} path")
        for n in absent:
            if counts[n] != 0:
                raise AssertionError(f"kernel {n} was launched on the {path} path")
        for n in ("swing_plan", "leg_ik", "knot_refs"):
            if counts[n] != steps:
                raise AssertionError(f"{n}: {counts[n]} launches on the {path} path, "
                                     f"{steps} MPC steps")
        if counts["sim_step"] != plant_ticks:
            raise AssertionError(f"sim_step: {counts['sim_step']} launches on the {path} path, "
                                 f"{plant_ticks} plant ticks")
        if (counts["momentum_observer"], counts["kalman_update"]) != (observer, filter_updates):
            raise AssertionError(f"momentum_observer / kalman_update: "
                                 f"{counts['momentum_observer']} / {counts['kalman_update']} "
                                 f"launches on the {path} path, {observer} observer and "
                                 f"{filter_updates} filter updates")
        for names, n, what in ((("synth_imu", "rbd_to_centroidal"), sensing, "sensings"),
                               (("dummy_step", "state_input_to_v"), dummy_ticks,
                                "dummy-loop ticks")):
            if any(counts[k] != n for k in names):
                raise AssertionError(f"{' / '.join(names)}: "
                                     f"{' / '.join(str(counts[k]) for k in names)} launches on "
                                     f"the {path} path, {n} {what}")
        if ddp is None:
            if counts["ddp_rollout"] != 0:
                raise AssertionError(f"ddp_rollout was launched on the {path} path")
        else:
            sqp_solves, iters, solves = ddp
            want = {"soa_linearize": sqp_solves + iters, "project_knot": sqp_solves + iters,
                    "riccati_solve": sqp_solves + iters, "soa_merit": sqp_solves,
                    "ddp_rollout": iters + solves}
            if any(counts[n] != v for n, v in want.items()):
                raise AssertionError(f"{path}: launches {({n: counts[n] for n in want})}, "
                                     f"expected {want}")
        if counts["wbc_qp"] != ticks or (ticks and counts["solve_qp"] != ticks):
            raise AssertionError(f"wbc_qp / solve_qp: {counts['wbc_qp']} / "
                                 f"{counts['solve_qp']} launches on the {path} path, "
                                 f"{ticks} ticks")
        return {**counts, "gj_inverse_by_n": gj_by_n[path]}

    zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    cold, st1, _ = mpc(flag.state, *args)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t
    warm, _, _ = capture(lambda: mpc(st1, *args))
    torch.cuda.synchronize()
    bench_cap = dict(captured)
    launches = read_counts("mpc_step", ("leg_ik", "project_knot", "riccati_solve") + b1,
                           ("riccati_solve_parallel", "gj_inverse"), steps=2)
    for name, sol in (("cold", cold), ("warm", warm)):
        for f in ("states", "inputs", "cost", "constraint_violation", "step_size"):
            if not torch.isfinite(getattr(sol, f)).all():
                raise AssertionError(f"{name} step: non-finite {f}")
        if sol.states.shape != (B, N + 1, 22) or sol.inputs.shape != (B, N + 1, 22):
            raise AssertionError(f"{name} step: shapes {sol.states.shape}, {sol.inputs.shape}")

    step_times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        mpc(st1, *args)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t)
    step_ms = statistics.median(step_times) * 1e3

    # the port's own CPU runs of the same problem (plain versions)
    def cpu_steps(dtype, solver, ulp_seed=None):
        f = build_flagship(N, H, batch=B, device="cpu", dtype=dtype)
        m = mpc_mod.Mpc(f.model, settings._replace(riccati_solver=solver), f.params,
                        f.planner_cfg)
        x0 = f.x0
        if ulp_seed is not None:
            g = torch.Generator().manual_seed(ulp_seed)
            step = torch.randint(-1, 2, x0.shape, generator=g).to(dtype)
            x0 = torch.where(step != 0, torch.nextafter(x0, x0 + step * 1e3), x0)
        a = (f.schedule, f.target, 0.0, x0, torch.zeros(6, dtype=dtype), f.default_joints)
        s1, st, _ = m(f.state, *a)
        s2, _, _ = m(st, *a)
        return s1, s2

    t = time.perf_counter()
    cpu32 = cpu_steps(torch.float32, "ns")
    cpu_s = time.perf_counter() - t
    exact32 = cpu_steps(torch.float32, "gj")
    exact64 = cpu_steps(torch.float64, "gj")
    moved32 = [cpu_steps(torch.float32, "gj", seed) for seed in MAIN_ULP_SEEDS]

    def per_scenario(a, b):
        """Each scenario's distance of run a to run b: max |states|, max
        |inputs| and |cost| relative to max(1, |cost|), each (B,)."""
        return {"states": (a.states.cpu().double() - b.states.double()).abs().flatten(1).amax(1),
                "inputs": (a.inputs.cpu().double() - b.inputs.double()).abs().flatten(1).amax(1),
                "cost_rel": ((a.cost.cpu().double() - b.cost.double()).abs()
                             / b.cost.double().abs().clamp(min=1.0))}

    def dist(a, b):
        return {q: v.max().item() for q, v in per_scenario(a, b).items()}

    def f32_limits(k):
        """The float64 check's limits on step k: the batch's, from the CPU
        float32 run's distance; the ill-conditioned scenarios (B,), where a
        one-ulp move of x_init lands past the batch's limit; each scenario's
        own limit, from the largest distance of its float32 runs."""
        noise = dist(exact32[k], exact64[k])
        tol = {q: max(MAIN_FLOOR[q], MAIN_FACTOR * v) for q, v in noise.items()}
        runs = [per_scenario(r[k], exact64[k]) for r in [exact32] + moved32]
        ill = torch.zeros(B, dtype=torch.bool)
        for r in runs[1:]:
            for q in tol:
                ill |= r[q] > tol[q]
        own = {q: (MAIN_FACTOR * torch.stack([r[q] for r in runs]).amax(0)).clamp(
            min=MAIN_FLOOR[q]) for q in tol}
        moved = [{q: v.max().item() for q, v in r.items()} for r in runs[1:]]
        return noise, tol, ill, own, moved

    compare = {}
    for k, (name, g_) in enumerate((("cold", cold), ("warm", warm))):
        vs_cpu = dist(g_, cpu32[k])
        card = per_scenario(g_, exact64[k])
        noise, tol, ill, own, moved = f32_limits(k)
        vs_exact = {q: v[~ill].max().item() for q, v in card.items()}
        ill_rows = {int(b): {q: {"card": card[q][b].item(), "limit": own[q][b].item()}
                             for q in tol} for b in ill.nonzero().flatten().tolist()}
        same_alpha = bool(torch.equal(g_.step_size.cpu(), cpu32[k].step_size))
        compare[name] = {"vs_cpu_f32": vs_cpu, "vs_cpu_f32_tol": ALGO_TOL,
                         "vs_exact_f64": vs_exact, "vs_exact_f64_tol": tol,
                         "exact_f32_vs_exact_f64": noise,
                         "moved_f32_vs_exact_f64": moved, "ill_conditioned": ill_rows,
                         "ill_conditioned_limit": MAIN_MAX_ILL, "step_size_equal": same_alpha,
                         "step_size": sorted(set(g_.step_size.cpu().tolist()))}
        ok = (all(vs_cpu[q] <= ALGO_TOL[q] for q in ALGO_TOL)
              and all(vs_exact[q] <= tol[q] for q in tol) and len(ill_rows) <= MAIN_MAX_ILL
              and all(r["card"] <= r["limit"] for row in ill_rows.values()
                      for r in row.values()) and same_alpha)
        if not ok:
            raise AssertionError(f"{name} step: card vs CPU: {compare[name]}")
    emit({"phase": "main_path", "batch": B, "knots": N, "horizon": H, "lin_backend": "soa",
          "launches": launches, "cold_step_s": cold_s, "step_ms": step_ms,
          "solves_per_s": B / (step_ms / 1e3), "cost_mean": warm.cost.mean().item(),
          "cpu_run_s": cpu_s, "card_vs_cpu": compare})

    # both backends on the card: the same warm step with lin_backend='dense',
    # held to the 'soa' one by the card-vs-exact rule of the warm step
    dense_mpc = mpc_mod.Mpc(model, settings._replace(lin_backend="dense"), params,
                            flag.planner_cfg)
    zero_counts()
    warm_dense, _, _ = dense_mpc(st1, *args)
    torch.cuda.synchronize()
    dense_counts = read_counts("mpc_step_dense", ("leg_ik", "project_knot", "riccati_solve"),
                               b1 + ("gj_inverse",), steps=1)
    dense_times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        dense_mpc(st1, *args)
        torch.cuda.synchronize()
        dense_times.append(time.perf_counter() - t)
    tol = f32_limits(1)[1]
    d_sd = dist(warm_dense, type(warm)(*(t.cpu() for t in warm)))
    same_alpha = bool(torch.equal(warm_dense.step_size, warm.step_size))

    def step_launches(m_):
        def run():
            m_(st1, *args)
            torch.cuda.synchronize()
        return _profiled(run, 1, 8)

    prof = {"soa": step_launches(mpc), "dense": step_launches(dense_mpc)}
    phases = {}
    for lb in ("soa", "dense"):
        ph = profile_phases(B, N, H, lin_backend=lb)
        phases[lb] = {**ph["launch_calls_by_phase"],
                      "prepare_references_split": ph["prepare_references_split"]}
    emit({"phase": "backends", "batch": B, "knots": N, "dense_vs_soa": d_sd, "tol": tol,
          "step_size_equal": same_alpha, "launches_dense": dense_counts,
          "step_ms": {"soa": step_ms, "dense": statistics.median(dense_times) * 1e3},
          "device_launches_per_step": {k: v["device_launches"] for k, v in prof.items()},
          "profiled": prof, "phases": phases, "tick_phases": profile_tick_phases(1, 3),
          "loop_phases": profile_loop_phases(False, 2)})
    if not (all(d_sd[q] <= tol[q] for q in tol) and same_alpha):
        raise AssertionError(f"warm step: 'dense' vs 'soa' on the card: {d_sd} (tol {tol}), "
                             f"step sizes equal: {same_alpha}")
    del dense_mpc, warm_dense

    # the product shape: one scenario, 53 knots over 0.8 s
    pflag = build_flagship(53, 0.8, batch=1, device=dev)
    pmpc = mpc_mod.Mpc(pflag.model, pflag.settings, pflag.params, pflag.planner_cfg)
    pargs = (pflag.schedule, pflag.target, 0.0, pflag.x0, z6, pflag.default_joints)
    zero_counts()
    p1, pst, _ = pmpc(pflag.state, *pargs)
    p2, _, _ = capture(lambda: pmpc(pst, *pargs))
    torch.cuda.synchronize()
    product_cap = dict(captured)
    if not all(torch.isfinite(s.states).all() and torch.isfinite(s.cost).all() for s in (p1, p2)):
        raise AssertionError("product shape: non-finite solution")
    ptimes = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pmpc(pst, *pargs)
        torch.cuda.synchronize()
        ptimes.append(time.perf_counter() - t)
    product_counts = read_counts("product_shape", ("leg_ik", "project_knot", "riccati_solve")
                                 + b1, ("riccati_solve_parallel", "gj_inverse"),
                                 steps=2 + len(ptimes))
    emit({"phase": "product_shape", "batch": 1, "knots": 53, "horizon": 0.8,
          "step_ms": statistics.median(ptimes) * 1e3, "cost": p2.cost.item(),
          "step_size": p2.step_size.item(), "launches": product_counts})

    # ---- 4a. B1 on the warm steps' own linearization and merit inputs ----
    chain_ops = soa_chain_ops()

    def b1_case(name, cap, row):
        """B1's entry point ``name`` on the captured main-path inputs against
        the float64 plain SoA and dense versions; ``row``: this shape fills
        the kernels line's row, else a kernel_extra line."""
        model_, st_, params_, refs_, xs_, us_ = cap
        lin = name == "soa_linearize"
        kernel_fn = sqp.knot_linearization_all if lin else sqp.eval_merit
        plain_fn = sqp.knot_linearization_all_plain if lin else sqp.eval_merit_plain
        names = LIN_NAMES if lin else MERIT_NAMES
        tol = TOL[name]

        def plain(dtype, backend="soa"):
            return plain_fn(cast(model_, dev, dtype), st_._replace(lin_backend=backend),
                            cast(params_, dev, dtype), cast(refs_, dev, dtype), xs_.to(dtype),
                            us_.to(dtype))

        got = kernel_fn(*cap)
        torch.cuda.synchronize()
        p32, p64, d64, bf16 = (plain(torch.float32), plain(torch.float64),
                               plain(torch.float64, "dense"), plain(torch.bfloat16))
        err = errors(names, got, p32, p64)
        limits = {n: max(tol, TOL_FACTOR * p64e[1]) for n, (_, _, p64e) in err.items()}
        vs_dense = {n: rel_err(a, d)[1] for n, a, d in zip(names, got, d64)}
        plain_vs_dense = {n: rel_err(a, d)[1] for n, a, d in zip(names, p64, d64)}
        e_bf16 = {n: rel_err(b, c)[1] for n, b, c in zip(names, bf16, p64)}
        Bn, N_ = us_.shape[0], us_.shape[-2]
        n_cand = us_.shape[1] if not lin else 1
        if lin:
            cost = soa_lin_cost(Bn * N_, chain_ops)
        else:
            cost = soa_merit_cost(Bn, n_cand, N_, chain_ops)
        times = (cuda_ms(lambda: kernel_fn(*cap)), cuda_ms(lambda: plain_fn(*cap), reps=3),
                 cuda_ms(lambda: plain_fn(model_, st_._replace(lin_backend="dense"), params_,
                                          refs_, xs_, us_), reps=3))
        info = {"scenarios": Bn, "knots": N_, "candidates": n_cand,
                "rel_err_vs_dense_f64": vs_dense, "plain_soa_f64_vs_dense_f64": plain_vs_dense,
                "plain_bf16_rel_err_vs_f64": e_bf16, "dense_plain_ms": times[2],
                "chain_ops_per_knot": chain_ops}
        if row:
            record(name, "cuda", "hunter_bipedal_control_tpu_torch/csrc/soa_linearize.cu",
                   ("hunter_bipedal_control_tpu/models/soa.py:866" if lin
                    else "hunter_bipedal_control_tpu/models/soa.py:605"),
                   err, tol, times[0], times[1], None, cost, info)
        else:
            b_ms, b_by = bound(*cost)
            emit({"phase": "kernel_extra", "name": name, "tol": tol,
                  "outputs": per_output(err, tol), "kernel_ms": times[0], "plain_ms": times[1],
                  "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, **info})
            check(f"{name} B={Bn} N={N_}", err, tol)
        bad = {n: (e, limits[n]) for n, e in vs_dense.items() if not e <= limits[n]}
        if bad:
            raise AssertionError(f"{name} B={Bn} N={N_}: outputs off the float64 dense plain "
                                 f"version: {bad}")
        low = {n: e for n, e in e_bf16.items() if n != "mask" and e <= limits[n]}
        if low:
            raise AssertionError(f"{name} B={Bn} N={N_}: the bfloat16 plain version is within "
                                 f"the limit on {low} (limits {limits})")

    for cap, row in ((bench_cap, True), (product_cap, False)):
        b1_case("soa_linearize", cap["lin"], row)
        b1_case("soa_merit", cap["merit"], row)

    # ---- 4a2. B8a on the warm steps' own IK inputs, and moved off them ----
    def ik_case(cap, row, offset_seed=None):
        """leg_ik on the captured main-path inputs of ``joint_reference_ik``
        (moved by a seeded offset of the base poses and toe targets if
        ``offset_seed``) against the float64 plain version, leg by leg
        outside the legs where a keep-if-improved test went the other way
        (IK_FLIP_FACTOR); ``row``: this case fills the kernels line's row,
        else a kernel_extra line."""
        (model_, poses, warm_j, des, R_des), kw = cap
        if offset_seed is not None:
            g = torch.Generator(device="cpu").manual_seed(offset_seed)
            d_pos, d_rot, d_toe = IK_OFFSET[poses.shape[0]]
            scale = torch.tensor([d_pos] * 3 + [d_rot] * 3)
            poses = (poses + (torch.randn(poses.shape, generator=g) * scale).to(dev)).contiguous()
            des = (des + d_toe * torch.randn(des.shape, generator=g).to(dev)).contiguous()
        arrays = (poses, warm_j, des, R_des)
        tol = TOL["leg_ik"]
        *got, kept = ik_mod.leg_ik(model_, *arrays, **kw, with_decisions=True)
        torch.cuda.synchronize()

        def plain(dtype, decisions=None):
            return ik_mod.joint_reference_ik_plain(cast(model_, dev, dtype),
                                                   *(a.to(dtype) for a in arrays), **kw,
                                                   decisions=decisions)

        dec32, dec64 = [], []
        p32, p64, bf16 = plain(torch.float32, dec32), plain(torch.float64, dec64), plain(
            torch.bfloat16)
        d64 = torch.stack([torch.stack(d) for d in dec64])            # (2, T, B, S, 2)

        def flipped(d):
            """(2, B, S, 2): legs with a test off float64's in this pass or
            the one before (pass 2 starts from pass 1's joints)."""
            off = (d != d64).any(1)
            return torch.stack([off[0], off[0] | off[1]])

        flip_k, flip_32 = flipped(kept), flipped(torch.stack([torch.stack(d) for d in dec32]))

        def leg_err(a, b, legs):
            """max |a - b| over the joints of ``legs`` (B, S, 2), and that
            over max |b|."""
            m = legs.repeat_interleave(5, dim=-1)
            diff = ((a.double() - b.double()).abs() * m).max().item()
            return diff, diff / max(b.double().abs().max().item(), 1e-30)

        names = ("qj1", "joint_refs")
        err = {n: (rel_err(got[p], p32[p]), leg_err(got[p], p64[p], ~flip_k[p]),
                   leg_err(p32[p], p64[p], ~flip_32[p])) for p, n in enumerate(names)}
        limits = {n: max(tol, TOL_FACTOR * p64e[1]) for n, (_, _, p64e) in err.items()}
        e_bf16 = {n: rel_err(b, c)[1] for n, b, c in zip(names, bf16, p64)}
        flips = {n: {"kernel": int(flip_k[p].sum()), "plain_f32": int(flip_32[p].sum()),
                     "legs": flip_k[p].numel()} for p, n in enumerate(names)}
        all_legs = {n: {"kernel": rel_err(got[p], p64[p])[1],
                        "plain_f32": rel_err(p32[p], p64[p])[1]} for p, n in enumerate(names)}
        decisions = [{"kept": int(d.sum()), "rejected": int((~d).sum())} for d in d64]
        Bn, S = poses.shape[0], poses.shape[1]
        cost = ik_cost(Bn, S, kw["trans_it"], kw["rot_it"])
        times = (cuda_ms(lambda: ik_mod.joint_reference_ik(model_, *arrays, **kw)),
                 cuda_ms(lambda: ik_mod.joint_reference_ik_plain(model_, *arrays, **kw), reps=3))
        info = {"scenarios": Bn, "samples": S, "offset_seed": offset_seed,
                "offset": None if offset_seed is None else IK_OFFSET[Bn],
                "flipped_legs": flips, "rel_err_vs_f64_all_legs": all_legs,
                "plain_f64_decisions_per_pass": decisions, "plain_bf16_rel_err_vs_f64": e_bf16}
        label = f"leg_ik B={Bn} S={S}" + ("" if offset_seed is None else " offset")
        if row:
            record("leg_ik", "cuda", "hunter_bipedal_control_tpu_torch/csrc/leg_ik.cu",
                   "hunter_bipedal_control_tpu/solver/mpc.py:56", err, tol, times[0], times[1],
                   None, cost, info)
        else:
            b_ms, b_by = bound(*cost)
            emit({"phase": "kernel_extra", "name": "leg_ik", "tol": tol,
                  "outputs": per_output(err, tol), "kernel_ms": times[0], "plain_ms": times[1],
                  "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, **info})
            check(label, err, tol)
        many = {n: f for n, f in flips.items()
                if f["kernel"] > IK_FLIP_FACTOR * f["plain_f32"] + IK_FLIP_FLOOR}
        if many:
            raise AssertionError(f"{label}: the kernel's keep-if-improved tests went the other "
                                 f"way on too many legs: {many}")
        low = {n: e for n, e in e_bf16.items() if e <= limits[n]}
        if low:
            raise AssertionError(f"{label}: the bfloat16 plain version is within the limit on "
                                 f"{low} (limits {limits})")
        if offset_seed is not None and not all(d["kept"] and d["rejected"] for d in decisions):
            raise AssertionError(f"{label}: the keep-if-improved tests did not go both ways in "
                                 f"each pass: {decisions}")

    for cap, row in ((bench_cap, True), (product_cap, False)):
        ik_case(cap["ik"], row)
        ik_case(cap["ik"], False, offset_seed=7)

    # ---- 4a3. B8b on the warm steps' own reference-prep inputs ----
    from torch.profiler import ProfilerActivity, profile

    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16

    def plan_args(a, dtype):
        """``swing_plan``'s arguments in ``dtype`` (None: every tensor
        contiguous, the shared ones copied out of their expand)."""
        model_, cfg_, ps_, sch_, tgt_, init_, x_, cmd_, dj_, H_, S_ = a
        if dtype is None:
            def c(tup):
                return type(tup)(*(t.contiguous() for t in tup))
            return (model_, cfg_, c(ps_), c(sch_), c(tgt_), init_.contiguous(), x_.contiguous(),
                    cmd_.contiguous(), dj_.contiguous(), H_, S_)
        return (cast(model_, dev, dtype), cast(cfg_, dev, dtype), cast(ps_, dev, dtype),
                cast(sch_, dev, dtype), cast(tgt_, dev, dtype), init_.to(dtype), x_.to(dtype),
                cmd_.to(dtype), dj_.to(dtype), H_, S_)

    def knot_args(a, dtype):
        sch_, plan_, init_, H_, N_, jr_ = a
        if dtype is None:
            return (type(sch_)(*(t.contiguous() for t in sch_)), plan_, init_.contiguous(), H_,
                    N_, jr_)
        plan_ = plan_._replace(refs=cast(plan_.refs, dev, dtype),
                               planner=cast(plan_.planner, dev, dtype),
                               **{f: getattr(plan_, f).to(dtype) for f in plan_._fields[2:]})
        return cast(sch_, dev, dtype), plan_, init_.to(dtype), H_, N_, jr_.to(dtype)

    def plan_outputs(plan):
        return (plan.planner.latest_stance_position, *plan.refs[:3], *plan.refs[4:],
                *plan[2:])

    def knot_outputs(out):
        return (*out[0], out[1].states)

    def prep_case(cap, row):
        """B8b1 and B8b2 on the captured main-path inputs of ``swing_plan``
        and ``knot_refs`` against their float64 plain versions; the launch
        calls of one whole ``prepare_references`` on the same step's inputs;
        ``row``: this shape fills the kernels line's rows, else kernel_extra
        lines."""
        out = {}
        for name, a, names, plain_fn, kernel_fn, outputs, to in (
                ("swing_plan", cap["swing_plan"][0], PREP_PLAN_NAMES, mpc_mod.swing_plan_plain,
                 mpc_mod.swing_plan, plan_outputs, plan_args),
                ("knot_refs", cap["knot_refs"][0], PREP_KNOT_NAMES, mpc_mod.knot_refs_plain,
                 mpc_mod.knot_refs, knot_outputs, knot_args)):
            *got, dec_k = kernel_fn(*a, with_decisions=True)
            bare = kernel_fn(*a)
            contig = kernel_fn(*to(a, None))
            torch.cuda.synchronize()
            got = outputs(got[0] if name == "swing_plan" else got)
            bare, contig = outputs(bare), outputs(contig)
            same = {n: bool(torch.equal(g, b) and torch.equal(g, c))
                    for n, g, b, c in zip(names, got, bare, contig)}
            if not all(same.values()):
                raise AssertionError(f"{name}: outputs differ with the decisions written or "
                                     f"with contiguous inputs: {same}")
            d32, d64 = {}, {}
            p32 = outputs(plain_fn(*to(a, f32), decisions=d32))
            p64 = outputs(plain_fn(*to(a, f64), decisions=d64))
            pbf = outputs(plain_fn(*to(a, bf16)))
            if name == "swing_plan":
                live = p64[names.index("window_stop")] > p64[names.index("window_start")]
                names, (got, p32, p64, pbf) = split_empty_windows(names, live, got, p32, p64, pbf)
            err, e_bf16, flips = prep_compare(names, got, p32, p64, pbf, dec_k, d32, d64)
            tol = TOL[name]
            limits = {n: max(tol, TOL_FACTOR * p64e[1]) for n, (_, _, p64e) in err.items()}
            Bn = got[0].shape[0]
            cost = (swing_plan_cost(a) if name == "swing_plan"
                    else knot_refs_cost(a, dec_k["knot_phase"]))
            times = (cuda_ms(lambda: kernel_fn(*a)), cuda_ms(lambda: plain_fn(*a), reps=3))
            shared = [n for n, t in zip(("init_time", "event_times", "target.times",
                                         "body_vel_cmd", "default_joints"),
                                        (a[5], a[3][0], a[4][0], a[7], a[8])
                                        if name == "swing_plan" else (a[2], a[0][0]))
                      if t.shape[0] > 1 and t.stride(0) == 0]
            info = {"scenarios": Bn, "decisions": flips, "plain_bf16_rel_err_vs_f64": e_bf16,
                    "shared_inputs_read_at_stride_0": shared, "bit_equal_contiguous": True}
            label = f"{name} B={Bn}"
            if row:
                record(name, "cuda", "hunter_bipedal_control_tpu_torch/csrc/reference_prep.cu",
                       ("hunter_bipedal_control_tpu/refs/swing_planner.py:202"
                        if name == "swing_plan"
                        else "hunter_bipedal_control_tpu/solver/mpc.py:112"),
                       err, tol, times[0], times[1], None, cost, info)
            else:
                b_ms, b_by = bound(*cost)
                emit({"phase": "kernel_extra", "name": name, "tol": tol,
                      "outputs": per_output(err, tol), "kernel_ms": times[0],
                      "plain_ms": times[1], "library_ms": None, "bound_ms": b_ms,
                      "bound_by": b_by, **info})
                check(label, err, tol)
            if any(flips["kernel_vs_plain_f32"].values()):
                raise AssertionError(f"{label}: decisions off the float32 plain version's: "
                                     f"{flips}")
            low = {n: e for n, e in e_bf16.items()
                   if n not in PREP_EXACT and not n.endswith("_empty") and e <= limits[n]}
            if low:
                raise AssertionError(f"{label}: the bfloat16 plain version is within the limit "
                                     f"on {low} (limits {limits})")
            out[name] = times[0]
        # one whole prepare_references: its launch calls
        pa, pk = cap["prepare_references"]
        mpc_mod.prepare_references(*pa, **pk)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            mpc_mod.prepare_references(*pa, **pk)
            torch.cuda.synchronize()
        calls = _charged_launches(prof)[0]
        emit({"phase": "prep_launches", "scenarios": pa[7].shape[0],
              "prepare_references_launch_calls": calls, "limit": PREP_MAX_LAUNCH_CALLS,
              "kernel_ms": out})
        if calls > PREP_MAX_LAUNCH_CALLS:
            raise AssertionError(f"prepare_references: {calls} launch calls, more than "
                                 f"{PREP_MAX_LAUNCH_CALLS}")

    for cap, row in ((bench_cap, True), (product_cap, False)):
        prep_case(cap, row)
    del bench_cap, product_cap, captured

    # ---- 4b. the tick path: TICKS chained ticks on the product shape's cold policy ----
    stamps = []

    def stamp():
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    # the WBC's QP of every tick, through the name wbc.py calls, for B4's
    # check at B=1
    # and the WBC's inputs of every tick, through the name controller.py
    # calls, for B9's check at B=1
    tick_qps, real_solve_qp = [], wbc_mod.solve_qp
    tick_wbc, real_wbc_solve = [], ctrl_mod.wbc_solve

    def qp_cap(*a, **k):
        tick_qps.append((a, k))
        return real_solve_qp(*a, **k)

    def wbc_cap(model_, params_, state_, *a):
        tick_wbc.append((model_, params_, *(t.contiguous() for t in a)))
        return real_wbc_solve(model_, params_, state_, *a)

    zero_counts()
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    wbc_mod.solve_qp, ctrl_mod.wbc_solve = qp_cap, wbc_cap
    try:
        tcard = run_ticks(tsetup, p1, pflag.schedule, stamp)
    finally:
        wbc_mod.solve_qp, ctrl_mod.wbc_solve = real_solve_qp, real_wbc_solve
    touts = tcard[0]
    tick_counts = read_counts("tick", ("solve_qp", "wbc_qp", "momentum_observer",
                                       "kalman_update"), ("gj_inverse",), ticks=TICKS,
                              observer=TICKS, filter_updates=TICKS)
    tick_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    for f in ("tau_ff", "pos_des"):
        if not torch.isfinite(getattr(touts.command, f)).all():
            raise AssertionError(f"tick path: non-finite {f}")

    def cpu_ticks(dtype):
        setup = build_controller(1, "cpu", dtype)
        sched = type(pflag.schedule)(*(a.cpu() for a in pflag.schedule))
        return run_ticks(setup, to_device(p1, "cpu", dtype), sched)

    t = time.perf_counter()
    tcpu32 = cpu_ticks(torch.float32)
    tick_cpu_s = time.perf_counter() - t
    tcpu64 = cpu_ticks(torch.float64)
    tick_cmp = tick_compare(tcard, tcpu32, tcpu64)
    same_flags = bool(torch.equal(touts.wbc_accepted.cpu(), tcpu32[0].wbc_accepted))
    emit({"phase": "tick_path", "batch": 1, "ticks": TICKS, "launches": tick_counts,
          "tick_ms_median": statistics.median(tick_ms), "tick_ms_first": tick_ms[0],
          "tick_ms_max": max(tick_ms), "accepted": int(touts.wbc_accepted.sum()),
          "accepted_equal_cpu_f32": same_flags, "card_vs_cpu": tick_cmp,
          "cpu_run_s": tick_cpu_s})
    bad = {n: c for n, c in tick_cmp.items() if c["vs_cpu_f64"] > c["limit"]}
    if bad or not same_flags:
        raise AssertionError(f"tick path: card vs CPU: {tick_cmp}, flags equal: {same_flags}")

    # B4 at B=1 on every tick's own QP (warm start, qp_iters_warm), one
    # launch per QP as the tick makes it, errors taken over all of them, as
    # the B=4096 check takes its batch: one QP's float32 dual error is a
    # single sample (on an H100 the last tick's QP alone put the kernel's
    # eq_dual at 1.2165e-4, 2.02x the float32 plain version's); times on the
    # last tick's QP
    runs = {"kernel": [], "plain32": [], "plain64": []}
    for qa, qk in tick_qps:
        qk64 = {k: (v.double() if torch.is_tensor(v) else v) for k, v in qk.items()}
        scale1 = 1.0 + torch.maximum(qa[3].abs().amax(-1), qa[5].abs().amax(-1))
        for key, sol in (("kernel", qp.solve_qp(*qa, **qk)),
                         ("plain32", qp.solve_qp_plain(*qa, **qk)),
                         ("plain64", qp.solve_qp_plain(*as64(qa), **qk64))):
            runs[key].append([sol.x, sol.eq_dual, sol.ineq_dual, sol.primal_residual / scale1])
    err = errors(qp_names, *([torch.cat(o) for o in zip(*runs[key])]
                             for key in ("kernel", "plain32", "plain64")),
                 {"primal_residual": 1.0})
    b_ms, b_by = bound(*qp_cost(1, qk["n_iters"]))
    emit({"phase": "kernel_extra", "name": "solve_qp", "tol": TOL["solve_qp"],
          "outputs": per_output(err, TOL["solve_qp"]), "batch": 1, "iterations": qk["n_iters"],
          "qps": len(tick_qps), "qp": "every tick of the tick path, one launch each",
          "kernel_ms": cuda_ms(lambda: qp.solve_qp(*qa, **qk)),
          "plain_ms": cuda_ms(lambda: qp.solve_qp_plain(*qa, **qk)), "library_ms": None,
          "bound_ms": b_ms, "bound_by": b_by})
    check("solve_qp B=1 ticks", err, TOL["solve_qp"])
    del tick_qps, runs

    # ---- 4b2. B9 on every tick's own inputs (B=1), and at B=4096 ----
    def wbc_qp_case(label, cases, row):
        """wbc_qp on each argument tuple of ``cases`` (one launch each)
        against its plain versions in float32, float64 and bfloat16 on the
        card, the errors taken over all of them; times on the last case.
        ``row``: these fill the kernels line's row, else a kernel_extra line."""
        tol = TOL["wbc_qp"]
        runs = {"kernel": [], "plain32": [], "plain64": [], "bf16": []}
        for a in cases:
            runs["kernel"].append(wbc_mod.wbc_qp(*a))
            runs["plain32"].append(wbc_mod.wbc_qp_plain(*a))
            for key, dt in (("plain64", torch.float64), ("bf16", torch.bfloat16)):
                runs[key].append(wbc_mod.wbc_qp_plain(cast(a[0], dev, dt), cast(a[1], dev, dt),
                                                      *(t.to(dt) for t in a[2:6]), a[6]))
        torch.cuda.synchronize()
        cat = {k: [torch.cat(o) for o in zip(*v)] for k, v in runs.items()}
        err = errors(WBC_QP_NAMES, cat["kernel"], cat["plain32"], cat["plain64"])
        limits = {n: max(tol, TOL_FACTOR * p64[1]) for n, (_, _, p64) in err.items()}
        e_bf16 = {n: rel_err(b.float(), c)[1]
                  for n, b, c in zip(WBC_QP_NAMES, cat["bf16"], cat["plain64"])}
        a = cases[-1]
        Bn = a[4].shape[0]
        times = (cuda_ms(lambda: wbc_mod.wbc_qp(*a)),
                 cuda_ms(lambda: wbc_mod.wbc_qp_plain(*a), reps=3))
        cost = wbc_qp_cost(Bn)
        info = {"label": label, "batch": Bn, "cases": len(cases),
                "stance_modes": sorted(set(torch.cat([c[6] for c in cases]).tolist())),
                "contact_modes": len(torch.unique(torch.cat([c[5] for c in cases]), dim=0)),
                "plain_bf16_rel_err_vs_f64": e_bf16}
        if row:
            record("wbc_qp", "cuda", "hunter_bipedal_control_tpu_torch/csrc/wbc_qp.cu",
                   "hunter_bipedal_control_tpu/wbc/wbc.py:123", err, tol, times[0], times[1],
                   None, cost, info)
        else:
            b_ms, b_by = bound(*cost)
            emit({"phase": "kernel_extra", "name": "wbc_qp", "tol": tol,
                  "outputs": per_output(err, tol), "kernel_ms": times[0], "plain_ms": times[1],
                  "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, **info})
            check(f"wbc_qp {label}", err, tol)
        low = {n: e for n, e in e_bf16.items() if n != "bin" and e <= limits[n]}
        if low:
            raise AssertionError(f"wbc_qp {label}: the bfloat16 plain version is within the "
                                 f"limit on {low} (limits {limits})")

    wbc_qp_case("every tick of the tick path, B=1", tick_wbc, True)
    for label, wbq in (("standing, bench.py's batch", build_wbc_batch(WBC_BATCH, dev)),
                       ("walking, seed 0", walking_wbc_batch(WBC_BATCH, dev, seed=0))):
        wbc_qp_case(f"{label}, B={WBC_BATCH}", [(wbq.model, wbq.params, wbq.x_des, wbq.u_des,
                                                 wbq.rbd, wbq.contact_flags, wbq.stance_mode)],
                    False)
    del tick_wbc, wbq

    # ---- 4c. the batched WBC: B=4096, one cold tick, then a 6-tick warm chain ----
    zero_counts()
    wxs, woks, _ = wbc_chain(wb, WBC_TICKS)
    torch.cuda.synchronize()
    wbc_counts = read_counts("wbc_batch", ("solve_qp", "wbc_qp"), ("gj_inverse",),
                             ticks=WBC_TICKS)
    if not torch.isfinite(wxs).all():
        raise AssertionError("batched WBC: non-finite solution")
    wtimes = {}
    for name, k in (("cold", 1), ("warm", WBC_TICKS)):
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            wbc_chain(wb, k)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        wtimes[name] = statistics.median(ts)
    sub = slice(0, WBC_BATCH, WBC_CPU_STRIDE)

    def cpu_wbc(dtype):
        w = build_wbc_batch(WBC_BATCH, "cpu", dtype)
        w = w._replace(**{f: getattr(w, f)[sub] for f in
                          ("x_des", "u_des", "rbd", "contact_flags", "stance_mode")})
        return wbc_chain(w, WBC_TICKS)

    t = time.perf_counter()
    cxs, coks, _ = cpu_wbc(torch.float32)
    wbc_cpu_s = time.perf_counter() - t
    cxs64 = cpu_wbc(torch.float64)[0]
    card_acc = woks[sub].sum(0).cpu().tolist()
    cpu_acc = coks.sum(0).tolist()
    wbc_x = {"vs_cpu_f64": scaled(wxs[sub], cxs64), "cpu_f32_vs_f64": scaled(cxs, cxs64)}
    wbc_x["limit"] = max(TICK_FLOOR, MAIN_FACTOR * wbc_x["cpu_f32_vs_f64"])
    emit({"phase": "wbc_batch", "batch": WBC_BATCH, "ticks": WBC_TICKS, "launches": wbc_counts,
          "cold_s": wtimes["cold"], "warm_chain_s": wtimes["warm"],
          "wbc_solves_per_s_cold": WBC_BATCH / wtimes["cold"],
          "wbc_solves_per_s_warm": WBC_BATCH * WBC_TICKS / wtimes["warm"],
          "accepted_per_tick": woks.sum(0).cpu().tolist(),
          "cpu_subset": {"stride": WBC_CPU_STRIDE, "card_accepted": card_acc,
                         "cpu_f32_accepted": cpu_acc, "x_vs_cpu_f32": scaled(wxs[sub], cxs),
                         "x": wbc_x, "cpu_run_s": wbc_cpu_s}})
    if card_acc != cpu_acc:
        raise AssertionError(f"batched WBC: accepted {card_acc} on the card, {cpu_acc} on CPU")
    if wbc_x["vs_cpu_f64"] > wbc_x["limit"]:
        raise AssertionError(f"batched WBC: solutions off the CPU float64 run: {wbc_x}")

    # ---- 4d. B5 on the real LQ data of B=1 at N=53 (product) and N=66 (bench) ----
    def projected_lq(n_knots, horizon):
        """The cold step's projected LQ data at B=1, from the card's own
        projection kernel: (lq, E, P, e, dx0) on the card."""
        f = build_flagship(n_knots, horizon, batch=1, device=dev)
        sch = mpc_mod.ModeSchedule(*(a[None] for a in f.schedule))
        tgt = mpc_mod.tg.TargetTrajectories(*(a[None] for a in f.target))
        bnd, _, _, _ = mpc_mod.prepare_references(
            f.model, f.settings, f.planner_cfg, f.state.planner, sch, tgt,
            torch.zeros(1, device=dev), f.x0, z6[None], f.default_joints[None])
        xs1, us1 = mpc_mod._warm_start(f.model, f.settings, bnd, f.state, f.x0)
        xn, A1, B1, _, qx1, qu1, Qxx1, Quu1, Qux1, g1, C1, D1, m1 = sqp.knot_linearization_all(
            f.model, f.settings, f.params, bnd, xs1, us1)
        pr = sqp.project_knot(f.settings, *(t.contiguous() for t in (
            A1, B1, xn - xs1[:, 1:], qx1, qu1, Qxx1, Quu1, Qux1, g1, C1, D1, m1)))
        A_t1, B_t1, d_t1, qx_t1, qw1, Qxx_t1, Qww1, Qwx1, E1, e1, P1 = [t.contiguous() for t in pr]
        lq1 = riccati.StageLQ(A=A_t1, B=B_t1, d=d_t1, Qxx=Qxx_t1, Qww=Qww1, Qwx=Qwx1, qx=qx_t1,
                              qw=qw1)
        return lq1, E1, P1, e1, (f.x0 - xs1[:, 0]).contiguous()

    assoc_names = ("K", "kff", "dxs", "dus")
    for n_knots, horizon in ((53, 0.8), (66, 1.0)):
        lqc, Ec, Pc, ec, dx0c = projected_lq(n_knots, horizon)
        tol = TOL["riccati_solve_parallel"]
        got = riccati.riccati_solve_parallel(lqc, Ec, Pc, ec, dx0c, reg)
        torch.cuda.synchronize()
        host = [riccati.StageLQ(*(t.cpu() for t in lqc))] + [t.cpu() for t in (Ec, Pc, ec, dx0c)]

        def plain(dtype, exact):
            lq_ = riccati.StageLQ(*(t.to(dtype) for t in host[0]))
            return riccati.riccati_solve_parallel_plain(lq_, *(t.to(dtype) for t in host[1:]),
                                                        reg, exact=exact)

        ref64, ref32 = plain(torch.float64, True), plain(torch.float32, True)
        ns32, bf16 = plain(torch.float32, False), plain(torch.bfloat16, False)
        err = errors(assoc_names, [t.cpu() for t in got], ref32, ref64)
        limits = {n: max(tol, TOL_FACTOR * p64[1]) for n, (_, _, p64) in err.items()}
        e_bf16 = {n: rel_err(b.float(), c)[1] for n, b, c in zip(assoc_names, bf16, ref64)}
        gap = {n: rel_err(a.cpu(), b)[1] for n, a, b in zip(assoc_names, got, ns32)}
        ns_vs64 = {n: rel_err(a, b)[1] for n, a, b in zip(assoc_names, ns32, ref64)}
        args = (lqc, Ec, Pc, ec, dx0c, reg)
        times = {"kernel_ms": cuda_ms(lambda: riccati.riccati_solve_parallel(*args)),
                 "b3_kernel_ms_same_data": cuda_ms(lambda: riccati.riccati_solve(*args)),
                 "plain_ms": cuda_ms(lambda: riccati.riccati_solve_parallel_plain(*args)),
                 "b3_plain_ms_same_data": cuda_ms(lambda: riccati.riccati_solve_plain(*args))}
        info = {"scenarios": 1, "knots": n_knots, "plain_bf16_rel_err_vs_f64": e_bf16,
                "kernel_rel_err_vs_plain_ns_f32": gap, "plain_ns_f32_rel_err_vs_f64": ns_vs64,
                "b3_kernel_ms_same_data": times["b3_kernel_ms_same_data"],
                "b3_plain_ms_same_data": times["b3_plain_ms_same_data"],
                "launches_per_call": 3 + math.ceil(math.log2(n_knots + 1))
                + math.ceil(math.log2(n_knots))}
        if n_knots == 53:
            record("riccati_solve_parallel", "cuda",
                   "hunter_bipedal_control_tpu_torch/csrc/riccati_assoc.cu",
                   "hunter_bipedal_control_tpu/solver/riccati.py:188", err, tol,
                   times["kernel_ms"], times["plain_ms"], None, assoc_cost(1, n_knots), info)
        else:
            b_ms, b_by = bound(*assoc_cost(1, n_knots))
            emit({"phase": "kernel_extra", "name": "riccati_solve_parallel", "tol": tol,
                  "outputs": per_output(err, tol), "kernel_ms": times["kernel_ms"],
                  "plain_ms": times["plain_ms"], "library_ms": None, "bound_ms": b_ms,
                  "bound_by": b_by, **info})
            check(f"riccati_solve_parallel N={n_knots}", err, tol)
        low = {n: e for n, e in e_bf16.items() if e <= limits[n]}
        if low:
            raise AssertionError(f"riccati_solve_parallel N={n_knots}: the bfloat16 plain version "
                                 f"is within the limit on {low} (limits {limits})")
    del lqc, got

    # ---- 4e. the chained B=1 solve in both Riccati modes ----
    riccati_kernel = {False: "riccati_solve", True: "riccati_solve_parallel"}
    chain_out = {}
    for par in (False, True):
        path = "chain_parallel" if par else "chain_sequential"
        cflag = build_flagship(53, 0.8, batch=1, device=dev)
        zero_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        card = mpc_chain(cflag, K_CHAIN, riccati_parallel=par)
        chain_s = time.perf_counter() - t
        counts = read_counts(path, ("leg_ik", "project_knot", riccati_kernel[par]) + b1,
                             (riccati_kernel[not par], "gj_inverse"), steps=K_CHAIN)
        if not (torch.isfinite(card.costs).all() and torch.isfinite(card.states).all()):
            raise AssertionError(f"{path}: non-finite chain")

        def cpu_chain(dtype):
            f = build_flagship(53, 0.8, batch=1, device="cpu", dtype=dtype)
            f = f._replace(settings=f.settings._replace(riccati_solver="gj"))
            return mpc_chain(f, K_CHAIN, riccati_parallel=par)

        c32, c64 = cpu_chain(torch.float32), cpu_chain(torch.float64)

        cmp = {}
        for q in ("costs", "states"):
            noise = scaled(getattr(c32, q), getattr(c64, q))
            cmp[q] = {"vs_cpu_f64_exact": scaled(getattr(card, q), getattr(c64, q)),
                      "cpu_f32_vs_f64": noise, "limit": max(TICK_FLOOR, MAIN_FACTOR * noise),
                      "per_solve_rel_vs_cpu_f64_exact": (
                          (getattr(card, q).cpu().double() - getattr(c64, q)).abs().flatten(1)
                          .amax(-1) / getattr(c64, q).abs().flatten(1).amax(-1).clamp(min=1.0)
                      ).tolist()}
        chain_out[par] = statistics.median(card.seconds) * 1e3
        emit({"phase": path, "batch": 1, "knots": 53, "solves": K_CHAIN, "launches": counts,
              "ms_per_solve_median": chain_out[par],
              "ms_per_solve_mean": chain_s / K_CHAIN * 1e3, "ms_first": card.seconds[0] * 1e3,
              "cost_last": card.costs[-1].item(), "card_vs_cpu": cmp})
        if not all(c["vs_cpu_f64_exact"] <= c["limit"] for c in cmp.values()):
            raise AssertionError(f"{path}: card chain off the CPU float64 chain: {cmp}")

    # ---- 4f. the dummy closed loop against the golden trace, both modes ----
    ref = np.load(GOLDEN)
    n_periods = ref["cmds"].shape[0]
    # every call's inputs of the dummy loop's plant and state conversion (the
    # sequential run), through the names loop.py calls, for 4j's checks at B=1
    cf_inputs = {"dummy_step": [], "state_input_to_v": [], "synth_imu": [],
                 "rbd_to_centroidal": []}
    real_cf = {"dummy_step": loop_mod.dummy_step,
               "state_input_to_v": loop_mod.state_input_to_v,
               "synth_imu": sim_loop_mod.synth_imu,
               "rbd_to_centroidal": sim_loop_mod.rbd_state_to_centroidal}

    def cf_capture(name):
        def run(*a, **k):
            cf_inputs[name].append(a)
            return real_cf[name](*a, **k)
        return run

    for par in (False, True):
        path = "loop_parallel" if par else "loop_sequential"
        lsetup = build_loop(dev, torch.float32, riccati_parallel=par)
        l_ticks = n_periods * lsetup.config.ticks_per_mpc
        zero_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        if not par:
            loop_mod.dummy_step = cf_capture("dummy_step")
            loop_mod.state_input_to_v = cf_capture("state_input_to_v")
        try:
            _, telem = run_loop(lsetup, ref["cmds"])
            torch.cuda.synchronize()
        finally:
            loop_mod.dummy_step = real_cf["dummy_step"]
            loop_mod.state_input_to_v = real_cf["state_input_to_v"]
        loop_s = time.perf_counter() - t
        # the plant's RK2 step (B14a) and the state conversion (B14b) once per tick
        counts = read_counts(path, ("leg_ik", "project_knot", riccati_kernel[par],
                                    "solve_qp", "wbc_qp", "dummy_step", "state_input_to_v") + b1,
                             (riccati_kernel[not par], "gj_inverse"), steps=n_periods,
                             ticks=l_ticks, dummy_ticks=l_ticks)
        gold = golden_check(telem, ref)
        emit({"phase": path, "batch": 1, "periods": n_periods, "launches": counts,
              "ms_per_period": loop_s / n_periods * 1e3, "seconds": loop_s, "golden": gold,
              "final_x": telem["x"][-1, 0].cpu().tolist()})
        if not gold["ok"]:
            raise AssertionError(f"{path}: off the golden trace: {gold}")

    # ---- 4g. the full-order closed loop (B11 for the plant) against its golden trace ----
    sref = np.load(SIM_GOLDEN)
    s_periods = sref["cmds"].shape[0]
    ssetup = build_sim_loop(dev)
    s_ticks = s_periods * ssetup.config.ticks_per_mpc
    plant_inputs, real_substeps = [], fullorder.substeps
    # every observer and filter update's inputs, through the names
    # sim_loop.py calls, for 4i's checks at B=1
    obs_inputs, real_observer = [], sim_loop_mod.momentum_observer_update
    kf_inputs, real_kalman = [], sim_loop_mod.kalman_update

    def substeps_cap(model_, params_, q_, v_, active_, **kw):
        plant_inputs.append((model_, params_, q_, v_, active_))
        return real_substeps(model_, params_, q_, v_, active_, **kw)

    def observer_cap(*a):
        obs_inputs.append(a)
        return real_observer(*a)

    def kalman_cap(*a):
        kf_inputs.append(a)
        return real_kalman(*a)

    zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fullorder.substeps = substeps_cap
    sim_loop_mod.momentum_observer_update, sim_loop_mod.kalman_update = observer_cap, kalman_cap
    sim_loop_mod.synth_imu = cf_capture("synth_imu")
    sim_loop_mod.rbd_state_to_centroidal = cf_capture("rbd_to_centroidal")
    try:
        sfin, stelem = run_sim_loop(ssetup, sref["cmds"])
        torch.cuda.synchronize()
    finally:
        fullorder.substeps = real_substeps
        sim_loop_mod.momentum_observer_update = real_observer
        sim_loop_mod.kalman_update = real_kalman
        sim_loop_mod.synth_imu = real_cf["synth_imu"]
        sim_loop_mod.rbd_state_to_centroidal = real_cf["rbd_to_centroidal"]
    sim_s = time.perf_counter() - t
    # five observer updates per period (one per tick), six filter updates
    # and sensings (the period's own and one per tick: the IMU by B13a, the
    # centroidal state by B13b); B6 nowhere, the plant's 16x16 is inside
    # B11, the estimators' systems inside B10 and B12
    counts = read_counts("sim_loop", ("leg_ik", "project_knot", "riccati_solve", "solve_qp",
                                      "wbc_qp", "sim_step", "momentum_observer",
                                      "kalman_update", "synth_imu", "rbd_to_centroidal") + b1,
                         ("riccati_solve_parallel", "gj_inverse"), steps=s_periods,
                         ticks=s_ticks, plant_ticks=s_ticks, observer=s_ticks,
                         filter_updates=s_periods + s_ticks, sensing=s_periods + s_ticks)
    if not all(torch.isfinite(v.double()).all() for v in stelem.values()):
        raise AssertionError("sim_loop: non-finite telemetry")
    sgold = sim_golden_check(stelem, sref)

    def cpu_sim(dtype):
        cs = build_sim_loop("cpu", dtype)
        return run_sim_loop(cs, sref["cmds"][:SIM_CPU_PERIODS])[1]

    t = time.perf_counter()
    c32 = cpu_sim(torch.float32)
    sim_cpu_s = time.perf_counter() - t
    c64 = cpu_sim(torch.float64)
    sim_cmp = {}
    for k in ("q", "v", "contact_fz", "est_force_norm", "cost"):
        noise = scaled(c32[k], c64[k])
        sim_cmp[k] = {"vs_cpu_f64": scaled(stelem[k][:SIM_CPU_PERIODS], c64[k]),
                      "cpu_f32_vs_f64": noise, "limit": max(TICK_FLOOR, MAIN_FACTOR * noise)}
    # one more walking period from the run's final state, profiled
    s_prof = profile_sim_loop(False, 1, setup=ssetup._replace(state=sfin))
    s_phases = profile_sim_loop_phases(False, 1, setup=ssetup._replace(state=sfin))
    emit({"phase": "sim_loop", "batch": 1, "periods": s_periods, "launches": counts,
          "ms_per_period": sim_s / s_periods * 1e3, "seconds": sim_s,
          "rt_factor": s_periods * 0.01 / sim_s, "golden": sgold,
          "card_vs_cpu_first_periods": sim_cmp, "cpu_f32_run_s": sim_cpu_s,
          "z_range": [stelem["base_z"].min().item(), stelem["base_z"].max().item()],
          "profiled": s_prof, "phases": s_phases["launch_calls_by_phase"],
          "launch_calls_per_period": s_phases["launch_calls_per_period"],
          "final_q": sfin.plant.q[0].cpu().tolist()})
    if not sgold["ok"]:
        raise AssertionError(f"sim_loop: off the golden trace: {sgold}")
    bad = {k: c for k, c in sim_cmp.items() if not c["vs_cpu_f64"] <= c["limit"]}
    if bad:
        raise AssertionError(f"sim_loop: first periods off the CPU float64 run: {bad}")
    if bool(sfin.emergency_stop.any()):
        raise AssertionError("sim_loop: emergency stop")

    # ---- 4h. B11 on every tick's inputs of the loop (B=1), and on a sweep batch ----
    def sim_case(label, cases, row):
        """sim_step's kernel on each argument tuple of ``cases`` (one launch
        each) against its plain versions in float32, float64 and bfloat16 on
        the card, the errors taken over all of them outside the flipped
        scenarios; times on the last case.  ``row``: these fill the kernels
        line's row, else a kernel_extra line."""
        tol = TOL["sim_step"]
        runs = {"kernel": [], "plain32": [], "plain64": [], "bf16": []}
        mats = []
        decs = {"kernel": [], "plain32": [], "plain64": []}
        for m_, p_, q_, v_, a_ in cases:
            *out, dk = real_substeps(m_, p_, q_, v_, a_, with_decisions=True)
            runs["kernel"].append(out)
            decs["kernel"].append(dk)
        for key, dt in (("plain32", torch.float32), ("plain64", torch.float64),
                        ("bf16", torch.bfloat16)):
            # the plain versions on all cases at once: the scenarios are independent
            m_, p_ = cases[0][0], cases[0][1]
            knobs = {f: (None if getattr(p_, f) is None else
                         torch.cat([getattr(c[1], f).expand(c[2].shape[0], *getattr(
                             p_, f).shape[1:]) for c in cases]).to(dt))
                     for f in ("mass_scale", "gravity_delta")}
            pp = fullorder.SimParams(*(a.to(dt) if torch.is_tensor(a) else a
                                       for a in p_))._replace(**knobs)
            dec = []
            out = fullorder.substeps_plain(cast(m_, dev, dt), pp,
                                           *(torch.cat([c[i] for c in cases]).to(dt)
                                             for i in (2, 3, 4)), dec,
                                           a_sys=mats if key == "plain64" else None)
            runs[key].append(list(out))
            if key in decs:
                decs[key].append(torch.stack(dec, 1))
        # the kernel eliminates A_sys without pivoting: it must stay positive
        # definite on every substep of these inputs (float64 plain version)
        eig = torch.linalg.eigvalsh(torch.stack(mats))
        a_sys = {"min_eig": eig[..., 0].min().item(),
                 "max_cond": (eig[..., -1] / eig[..., 0]).max().item()}
        del mats, eig
        torch.cuda.synchronize()
        cat = {k: [torch.cat(o) for o in zip(*v)] for k, v in runs.items()}
        dk, d32, d64 = (torch.cat(decs[k]) for k in ("kernel", "plain32", "plain64"))
        flip_k = (dk != d64).flatten(1).any(-1)
        flip_p = (d32 != d64).flatten(1).any(-1)
        keep = ~(flip_k | flip_p)
        err = errors(SIM_NAMES, *([t[keep] for t in cat[k]] for k in ("kernel", "plain32",
                                                                      "plain64")))
        limits = {n: max(tol, TOL_FACTOR * p64[1]) for n, (_, _, p64) in err.items()}
        e_bf16 = {n: rel_err(b[keep].float(), c[keep])[1]
                  for n, b, c in zip(SIM_NAMES, cat["bf16"], cat["plain64"])}
        flips = {"kernel": int(flip_k.sum()), "plain32": int(flip_p.sum()),
                 "limit": SIM_FLIP_FACTOR * int(flip_p.sum()) + SIM_FLIP_FLOOR,
                 "scenarios": int(keep.numel()), "held": int(keep.sum())}
        last = cases[-1]
        Bn, n_sub = last[2].shape[0], last[1].substeps
        times = (cuda_ms(lambda: real_substeps(*last)),
                 cuda_ms(lambda: fullorder.substeps_plain(*last), reps=3))
        cost = sim_step_cost(Bn, n_sub, last[1].mass_scale is not None,
                             last[1].gravity_delta is not None)

        def plain_tick():
            fullorder.substeps_plain(*last)
            torch.cuda.synchronize()

        info = {"label": label, "batch": Bn, "cases": len(cases), "substeps": n_sub,
                "delay_steps": last[1].delay_steps, "flips": flips,
                "in_contact_share": float(d64.double().mean()), "a_sys": a_sys,
                "plain_bf16_rel_err_vs_f64": e_bf16}
        if row:
            # the launches B11 takes away from each tick
            info["plain_device_launches_per_tick"] = _profiled(plain_tick, 1, 1)["device_launches"]
            record("sim_step", "cuda", "hunter_bipedal_control_tpu_torch/csrc/sim_step.cu",
                   "hunter_bipedal_control_tpu/backends/fullorder.py:126", err, tol, times[0],
                   times[1], None, cost, info)
        else:
            b_ms, b_by = bound(*cost)
            emit({"phase": "kernel_extra", "name": "sim_step", "tol": tol,
                  "outputs": per_output(err, tol), "kernel_ms": times[0], "plain_ms": times[1],
                  "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, **info})
            check(f"sim_step {label}", err, tol)
        if not a_sys["min_eig"] > 0.0:
            raise AssertionError(f"sim_step {label}: A_sys not positive definite: {a_sys}")
        if flips["kernel"] > flips["limit"]:
            raise AssertionError(f"sim_step {label}: {flips['kernel']} flipped scenarios, "
                                 f"limit {flips['limit']}")
        low = {n: e for n, e in e_bf16.items() if e <= limits[n]}
        if low:
            raise AssertionError(f"sim_step {label}: the bfloat16 plain version is within the "
                                 f"limit on {low} (limits {limits})")

    sim_case("every tick of the sim loop, B=1", plant_inputs, True)
    sb = sim_step_batch(SIM_BATCH, dev, seed=0, delay_ms=9.0)
    _, _, sb_active = fullorder._push_command(sb.params, sb.state, sb.command)
    sim_case(f"sweep batch (9 ms delay ring, mass scale, field), B={SIM_BATCH}",
             [(sb.model, sb.params, sb.state.q, sb.state.v, sb_active.contiguous())], False)
    del plant_inputs, sb

    # ---- 4i. B10 and B12 on every update's inputs of the loop (B=1), and at B=4096 ----
    def observer_run(a):
        st, dist = contact.momentum_observer_update(*a)
        return [st.p_scg_z_last, st.est_forces, dist]

    def observer_plain(a):
        st, dist = contact.momentum_observer_plain(*a)
        return [st.p_scg_z_last, st.est_forces, dist]

    def kalman_run(a):
        st, pos, vel = kalman.kalman_update(*a)
        return [st.x_hat, st.P, pos, vel]

    def kalman_plain(a):
        st, pos, vel = kalman.kalman_update_plain(*a)
        return [st.x_hat, st.P, pos, vel]

    est = {"momentum_observer": (OBS_NAMES, observer_run, observer_plain, observer_cost,
                                 "hunter_bipedal_control_tpu_torch/csrc/momentum_observer.cu",
                                 "hunter_bipedal_control_tpu/estim/contact.py:49"),
           "kalman_update": (KF_NAMES, kalman_run, kalman_plain, kalman_cost,
                             "hunter_bipedal_control_tpu_torch/csrc/kalman_update.cu",
                             "hunter_bipedal_control_tpu/estim/kalman.py:91")}

    def est_cast(a, dt_):
        """An update's arguments (model, params, state, tensors..., dt) in
        the float dtype dt_ on the card."""
        return (cast(a[0], dev, dt_), cast(a[1], dev, dt_), cast(a[2], dev, dt_),
                *(t.to(dt_) for t in a[3:-1]), a[-1])

    def est_cat(cases):
        """The cases' arguments concatenated along the batch (the scenarios
        are independent; model, params and dt are the first case's)."""
        a0 = cases[0]
        return (a0[0], a0[1], type(a0[2])(*(torch.cat([c[2][i] for c in cases])
                                            for i in range(len(a0[2])))),
                *(torch.cat([c[i] for c in cases]) for i in range(3, len(a0) - 1)), a0[-1])

    def est_case(name, label, cases, row):
        """The estimator kernel ``name`` on each argument tuple of ``cases``
        (one launch each) against its plain versions in float32, float64 and
        bfloat16 on the card (all cases at once), the errors taken over all
        of them; times on the last case.  ``row``: these fill the kernels
        line's row, else a kernel_extra line."""
        names, run, plain, cost_fn, source, replaces = est[name]
        tol = TOL[name]
        got = [run(a) for a in cases]
        torch.cuda.synchronize()
        got = [torch.cat(o) for o in zip(*got)]
        cat = est_cat(cases)
        p32, p64, pbf = (plain(est_cast(cat, dt_))
                         for dt_ in (torch.float32, torch.float64, torch.bfloat16))
        err = errors(names, got, p32, p64)
        limits = {n: max(tol, TOL_FACTOR * e[2][1]) for n, e in err.items()}
        e_bf16 = {n: rel_err(b.float(), c)[1] for n, b, c in zip(names, pbf, p64)}
        last = cases[-1]
        Bn = last[3].shape[0]
        times = (cuda_ms(lambda: run(last)), cuda_ms(lambda: plain(last), reps=3))
        info = {"label": label, "batch": Bn, "cases": len(cases),
                "plain_bf16_rel_err_vs_f64": e_bf16}
        if name == "kalman_update":
            info["xy_conditioned_share"] = float((p64[1][:, 0:2, 2:] == 0).flatten(1).all(-1)
                                                 .double().mean())

        def plain_update():
            plain(last)
            torch.cuda.synchronize()

        if row:
            # the launches the kernel takes away from each update
            info["plain_device_launches_per_update"] = _profiled(plain_update, 1, 1)[
                "device_launches"]
            record(name, "cuda", source, replaces, err, tol, times[0], times[1], None,
                   cost_fn(Bn), info)
        else:
            b_ms, b_by = bound(*cost_fn(Bn))
            emit({"phase": "kernel_extra", "name": name, "tol": tol,
                  "outputs": per_output(err, tol), "kernel_ms": times[0], "plain_ms": times[1],
                  "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, **info})
            check(f"{name} {label}", err, tol)
        low = {n: e for n, e in e_bf16.items() if e <= limits[n]}
        if low:
            raise AssertionError(f"{name} {label}: the bfloat16 plain version is within the "
                                 f"limit on {low} (limits {limits})")

    if (len(obs_inputs), len(kf_inputs)) != (s_ticks, s_periods + s_ticks):
        raise AssertionError(f"sim_loop: {len(obs_inputs)} observer and {len(kf_inputs)} "
                             f"filter updates captured")
    est_case("momentum_observer", "every update of the sim loop, B=1", obs_inputs, True)
    est_case("kalman_update", "every update of the sim loop, B=1", kf_inputs, True)
    eb = estimator_batch(EST_BATCH, dev, seed=0)
    est_case("momentum_observer", f"seeded walking batch, B={EST_BATCH}",
             [(eb.model, eb.observer_params, eb.observer, eb.rbd, eb.cmd_torque, TICK_DT)], False)
    est_case("kalman_update", f"seeded walking batch, B={EST_BATCH}",
             [(eb.model, eb.kalman_params, eb.kalman,
               *(eb.sensors[k] for k in ("zyx", "joint_pos", "joint_vel", "omega_world",
                                         "quat_xyzw", "linear_accel_local", "contact_flags")),
               TICK_DT)], False)
    del obs_inputs, kf_inputs, eb

    # ---- 4j. B13a, B13b, B14a, B14b on every call's inputs of the loops (B=1), and at B=4096 ----
    def ns_plant(q_, v_, a_):
        return SimpleNamespace(q=q_, v=v_, base_acc=a_)

    def cf_outs(name, res):
        """The outputs of kernel ``name`` as CF_NAMES lists them."""
        if name == "synth_imu":
            return list(res)
        if name == "rbd_to_centroidal":
            return [res[:, 0:6], res[:, 6:]]
        if name == "dummy_step":
            return [res.x[:, 0:6], res.x[:, 6:12], res.x[:, 12:]]
        return [res[0][:, 0:6], res[0][:, 6:], res[1]]

    def cf_call(name, a, plain):
        """Kernel ``name`` (or its plain version) on one argument tuple, as
        the loops call it."""
        if name == "synth_imu":
            fn = fullorder.synth_imu_plain if plain else fullorder.synth_imu
            return fn(*a, with_omega_world=True)
        if name == "rbd_to_centroidal":
            fn = cen_mod.rbd_state_to_centroidal_plain if plain else cen_mod.rbd_state_to_centroidal
            return fn(*a)
        if name == "dummy_step":
            return (dummy_mod.dummy_step_plain if plain else dummy_mod.dummy_step)(*a)
        if plain:
            v_ = cen_mod.state_input_to_v_plain(*a)
            return v_, cen_mod.q_v_to_rbd_state(a[0], cen_mod.state_to_q(a[1]), v_)
        return cen_mod.state_input_to_v(*a, with_rbd=True)

    def cf_cat(name, cases, dt_):
        """The cases' arguments concatenated along the batch (the scenarios
        are independent; the model and dt are the first case's), in the
        float dtype dt_ on the card."""
        m_ = cast(cases[0][0], dev, dt_)
        if name == "synth_imu":
            return (m_, ns_plant(*(torch.cat([getattr(c[1], f) for c in cases]).to(dt_)
                                   for f in ("q", "v", "base_acc"))))
        if name == "dummy_step":
            st = dummy_mod.DummyPlantState(*(torch.cat([c[1][i] for c in cases]).to(dt_)
                                             for i in range(2)))
            return (m_, st, torch.cat([c[2] for c in cases]).to(dt_), cases[0][3])
        return (m_, *(torch.cat([c[i] for c in cases]).to(dt_) for i in range(1, len(cases[0]))))

    cf_spec = {"synth_imu": (imu_cost, "sensing.cu", "backends/fullorder.py:199"),
               "rbd_to_centroidal": (centroidal_cost, "sensing.cu", "models/centroidal.py:198"),
               "dummy_step": (dummy_cost, "centroidal_flow.cu", "backends/dummy.py:28"),
               "state_input_to_v": (state_v_cost, "centroidal_flow.cu",
                                    "models/centroidal.py:113")}

    def cf_case(name, label, cases, row):
        """Kernel ``name`` on each argument tuple of ``cases`` (one launch
        each) against its plain versions in float32, float64 and bfloat16 on
        the card (all cases at once), the errors taken over all of them;
        times on the last case.  ``row``: these fill the kernels line's
        row, else a kernel_extra line."""
        names, tol = CF_NAMES[name], TOL[name]
        cost_fn, src, jax_line = cf_spec[name]
        got = [cf_outs(name, cf_call(name, a, False)) for a in cases]
        torch.cuda.synchronize()
        got = [torch.cat(o) for o in zip(*got)]
        p32, p64, pbf = (cf_outs(name, cf_call(name, cf_cat(name, cases, dt_), True))
                         for dt_ in (torch.float32, torch.float64, torch.bfloat16))
        err = errors(names, got, p32, p64)
        limits = {n: max(tol, TOL_FACTOR * e[2][1]) for n, e in err.items()}
        e_bf16 = {n: rel_err(b.float(), c)[1] for n, b, c in zip(names, pbf, p64)}
        last = cases[-1]
        Bn = got[0].shape[0] // len(cases)

        def kernel_calls():
            for _ in range(CF_PROFILED_CALLS):
                cf_call(name, last, False)
            torch.cuda.synchronize()

        # the kernel's own device time per call, apart from its wrapper's host
        # work (null when the profiler records no such kernel)
        own = [k["ms"] for k in _profiled(kernel_calls, CF_PROFILED_CALLS, 4)["top_kernels"]
               if f"{name}_kernel" in k["name"]]
        times = (cuda_ms(lambda: cf_call(name, last, False)),
                 cuda_ms(lambda: cf_call(name, last, True), reps=3))
        info = {"label": label, "batch": Bn, "cases": len(cases),
                "kernel_device_ms": sum(own) if own else None,
                "plain_bf16_rel_err_vs_f64": e_bf16}

        def plain_call():
            cf_call(name, last, True)
            torch.cuda.synchronize()

        if row:
            # the launches the kernel takes away from each call
            info["plain_device_launches_per_call"] = _profiled(plain_call, 1, 1)[
                "device_launches"]
            record(name, "cuda", f"hunter_bipedal_control_tpu_torch/csrc/{src}",
                   f"hunter_bipedal_control_tpu/{jax_line}", err, tol, times[0], times[1], None,
                   cost_fn(Bn), info)
        else:
            b_ms, b_by = bound(*cost_fn(Bn))
            emit({"phase": "kernel_extra", "name": name, "tol": tol,
                  "outputs": per_output(err, tol), "kernel_ms": times[0], "plain_ms": times[1],
                  "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, **info})
            check(f"{name} {label}", err, tol)
        low = {n: e for n, e in e_bf16.items() if n not in CF_COPIES and e <= limits[n]}
        if low:
            raise AssertionError(f"{name} {label}: the bfloat16 plain version is within the "
                                 f"limit on {low} (limits {limits})")

    want = {"dummy_step": n_periods * lsetup.config.ticks_per_mpc,
            "state_input_to_v": n_periods * lsetup.config.ticks_per_mpc,
            "synth_imu": s_periods + s_ticks, "rbd_to_centroidal": s_periods + s_ticks}
    got_n = {k: len(v) for k, v in cf_inputs.items()}
    if got_n != want:
        raise AssertionError(f"loops: {got_n} calls captured, expected {want}")
    cb = centroidal_batch(CF_BATCH, dev, seed=0)
    cb_cases = {"synth_imu": (cb.model, cb.plant), "rbd_to_centroidal": (cb.model, cb.rbd),
                "dummy_step": (cb.model, dummy_mod.init_dummy_plant(cb.x), cb.u, TICK_DT),
                "state_input_to_v": (cb.model, cb.x, cb.u)}
    for name in ("synth_imu", "rbd_to_centroidal", "dummy_step", "state_input_to_v"):
        loop = "the sim loop" if name in ("synth_imu", "rbd_to_centroidal") else "the dummy loop"
        cf_case(name, f"every call of {loop}, B=1", cf_inputs[name], True)
        cf_case(name, f"seeded walking batch, B={CF_BATCH}", [cb_cases[name]], False)
    del cf_inputs, cb, cb_cases

    # ---- 4k. the DDP path: entry.ddp_solve, B15 on its rollouts, B2 and B3 on its data ----
    def moved_x0(x0, seed):
        """x0 with each entry moved by one ulp up, down or not (seeded)."""
        g = torch.Generator().manual_seed(seed)
        step = torch.randint(-1, 2, x0.shape, generator=g).to(x0.dtype)
        return torch.where(step != 0, torch.nextafter(x0, x0 + step * 1e3), x0)

    def rollout_errs(got, p32, p64, held):
        """errors()'s triples for B15's outputs, each rollout (scenario, step
        size) on its own scale max(1, max |float64 plain|), the worst over
        the ``held`` rollouts (B, A)."""
        def one(a, c):
            a, c = a.cpu().double(), c.cpu().double()
            a, c = (a[..., None], c[..., None]) if a.dim() == 2 else (a, c)
            d = (a - c).abs().flatten(2).amax(-1)
            return d[held].max().item(), (d / c.abs().flatten(2).amax(-1).clamp(min=1.0))[
                held].max().item()
        return {n: (one(a, b_), one(a, c), one(b_, c))
                for n, a, b_, c in zip(ROLL_NAMES, got[:4], p32[:4], p64[:4])}

    def rollout_case(cell, dflag, dset, args, closed, row):
        """B15 on the rollouts ``args`` (refs, x_init, xs_bar, us_bar, Ks, kffs,
        alphas on the card) against its float32 plain version on the card and
        its float64 plain version on the CPU, over the rollouts whose float64
        states stay finite and within ROLL_BOUND (the others are counted)."""
        rs = ddp_mod.rollout_settings(dset)
        Bd, Nd, Ad = args[3].shape[0], args[3].shape[1], args[6].shape[0]
        f64 = build_flagship(Nd, dset.horizon, batch=1, device="cpu", dtype=torch.float64)
        got = ddp_mod.closed_rollout(dflag.model, dflag.params, *args, rs)
        # the float32 plain version runs once (~1e4-1e5 launch calls), timed
        # by CUDA events around that call
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        p32 = ddp_mod.closed_rollout_plain(dflag.model, dflag.params, *args, rs)
        ev[1].record()
        ev[1].synchronize()
        a64 = (cast(args[0], "cpu", torch.float64), args[1].cpu().double()) + tuple(
            None if t is None else t.cpu().double() for t in args[2:])
        p64 = ddp_mod.closed_rollout_plain(f64.model, f64.params, *a64, rs)
        xs64 = p64[0].flatten(2)
        held = torch.isfinite(xs64).all(-1) & (xs64.abs().amax(-1) <= ROLL_BOUND)
        if not held.any():
            raise AssertionError(f"ddp_rollout {cell}: no rollout within {ROLL_BOUND}")
        err = rollout_errs(got, p32, p64, held)
        info = {"cell": cell, "loop": "closed" if closed else "open (re-roll)",
                "scenarios": Bd, "step_sizes": Ad, "knots": Nd, "integrator": dset.integrator,
                "rollouts_held": int(held.sum()), "rollouts": held.numel(),
                "rollout_bound": ROLL_BOUND}
        if not closed:
            # the float32 plain error over one-ulp moves of x_init (on the CPU)
            f32c = build_flagship(Nd, dset.horizon, batch=1, device="cpu")
            a32 = [None if t is None else t.cpu() for t in args[2:]]
            for seed in DDP_OPEN_SEEDS:
                pm = ddp_mod.closed_rollout_plain(f32c.model, f32c.params, cast(args[0], "cpu",
                                                                                torch.float32),
                                                  moved_x0(args[1].cpu(), seed), *a32, rs)
                em = rollout_errs(pm, pm, p64, held)
                err = {n: (e[0], e[1], max(e[2], em[n][2], key=lambda v: v[1]))
                       for n, e in err.items()}
            info["plain_f32_rel_err_over"] = f"x_init and {len(DDP_OPEN_SEEDS)} one-ulp moves"
        slots_k, slots_32, slots_64 = (r[4].cpu() for r in (got, p32, p64))
        info["accepted_slots"] = {"kernel_total": int(slots_k.sum()),
                                  "max_per_knot": int(slots_k.max()),
                                  "kernel_vs_plain_f32_differ": int((slots_k != slots_32).sum()),
                                  "plain_f32_vs_f64_differ":
                                      (slots_32 != slots_64).nonzero().tolist()[:20]}
        cost = ddp_rollout_cost(Bd, Ad, Nd, dset.integrator, int(slots_k.sum()), closed)
        info["serial_chain_ms"] = cost[1] / (Bd * Ad) / SM_CLOCK_HZ * 1e3
        times = (cuda_ms(lambda: ddp_mod.closed_rollout(dflag.model, dflag.params, *args, rs)),
                 ev[0].elapsed_time(ev[1]))
        if row:
            record("ddp_rollout", "cuda", "hunter_bipedal_control_tpu_torch/csrc/ddp_rollout.cu",
                   "hunter_bipedal_control_tpu/solver/ddp.py:78", err, TOL["ddp_rollout"],
                   *times, None, cost, info)
        else:
            b_ms, b_by = bound(*cost)
            emit({"phase": "kernel_extra", "name": "ddp_rollout", "tol": TOL["ddp_rollout"],
                  "outputs": per_output(err, TOL["ddp_rollout"]), "kernel_ms": times[0],
                  "plain_ms": times[1], "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                  **info})
            check(f"ddp_rollout {cell} {info['loop']}", err, TOL["ddp_rollout"])
        if info["accepted_slots"]["kernel_vs_plain_f32_differ"]:
            raise AssertionError(f"ddp_rollout {cell}: accepted slots differ from the float32 "
                                 f"plain version's: {info['accepted_slots']}")

    def ddp_lq_case(cell, dset, it0):
        """B2 and B3 on the DDP's own data: the first iteration's
        linearization with d = 0, the DDP's projection settings."""
        sset = ddp_mod.sqp_settings(dset)
        (_, A_, B_, _, qx_, qu_, Qxx_, Quu_, Qux_, g_, C_, D_, m_) = it0["lin"]
        pin = [t.contiguous() for t in (A_, B_, torch.zeros_like(qx_), qx_, qu_, Qxx_, Quu_, Qux_,
                                         g_, C_, D_, m_)]
        names = ("A_t", "B_t", "d_t", "qx_t", "qw", "Qxx_t", "Qww", "Qwx", "E", "e", "P")
        got = sqp.project_knot(sset, *pin)
        ref64 = sqp.project_knot_plain(sset, *as64(pin))
        err = errors(names, got, sqp.project_knot_plain(sset, *pin), ref64)
        for seed in DDP_OPEN_SEEDS:
            moved = [moved_x0(t.cpu(), 100 * seed + i).to(dev) for i, t in enumerate(pin[:-1])]
            pm = sqp.project_knot_plain(sset, *moved, pin[-1])
            err = {n: (e[0], e[1], max(e[2], rel_err(a, c), key=lambda v: v[1]))
                   for (n, e), a, c in zip(err.items(), pm, ref64)}
        knots = pin[0].shape[0] * pin[0].shape[1]
        b_ms, b_by = bound(*project_cost(knots))
        emit({"phase": "kernel_extra", "name": "project_knot", "use": f"ddp {cell}",
              "tol": TOL["project_knot"], "outputs": per_output(err, TOL["project_knot"]),
              "kernel_ms": cuda_ms(lambda: sqp.project_knot(sset, *pin)),
              "plain_ms": cuda_ms(lambda: sqp.project_knot_plain(sset, *pin)), "library_ms": None,
              "bound_ms": b_ms, "bound_by": b_by, "knots": knots, "pivot": sset.proj_pivot,
              "hess_reg": sset.hess_reg,
              "plain_f32_rel_err_over": f"the inputs and {len(DDP_OPEN_SEEDS)} one-ulp moves"})
        check(f"project_knot ddp {cell}", err, TOL["project_knot"])
        # the backward pass on the float64 projection rounded once to float32
        # (d = 0, as the DDP's LQ data); the kernel's rollout is not used
        A_t, B_t, _, qx_t, qw, Qxx_t, Qww, Qwx, E, e0, P = [t.contiguous() for t in ref64]
        d0 = torch.zeros_like(qx_t)
        lq64 = riccati.StageLQ(A=A_t, B=B_t, d=d0, Qxx=Qxx_t, Qww=Qww, Qwx=Qwx, qx=qx_t, qw=qw)
        lq = riccati.StageLQ(*(t.float() for t in lq64))
        E, P, e0 = E.float(), P.float(), e0.float()
        Bd = lq.A.shape[0]
        zx = torch.zeros(Bd, 22, device=dev)
        zS = torch.zeros(Bd, 22, 22, device=dev)
        reg = dset.hess_reg
        got = riccati.riccati_solve(lq, E, P, e0, zx, reg)[:2]
        ref = riccati.backward_scan(lq, zS, zx, reg)[:2]
        ref64 = riccati.backward_scan(lq64, zS.double(), zx.double(), reg)[:2]
        exact64 = riccati.backward_scan(lq64, zS.double(), zx.double(), reg, solver="gj")[:2]
        err = errors(("Kw", "kw"), got, ref, ref64)
        b_ms, b_by = bound(*riccati_cost(Bd, lq.A.shape[1]))
        emit({"phase": "kernel_extra", "name": "riccati_solve", "use": f"ddp {cell}",
              "tol": TOL["riccati_solve"], "outputs": per_output(err, TOL["riccati_solve"]),
              "kernel_vs_exact_f64": {n: rel_err(a, c)[1] for n, a, c in
                                      zip(("Kw", "kw"), got, exact64)},
              "ns_vs_exact_f64": {n: rel_err(a, c)[1] for n, a, c in
                                  zip(("Kw", "kw"), ref64, exact64)},
              "kernel_ms": cuda_ms(lambda: riccati.riccati_solve(lq, E, P, e0, zx, reg)),
              "plain_ms": cuda_ms(lambda: riccati.backward_scan(lq, zS, zx, reg), reps=3),
              "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "hess_reg": reg})
        check(f"riccati_solve ddp {cell}", err, TOL["riccati_solve"])

    cpu_warm = {}
    for cell, Bd, Nd, Hd, integ, iters in DDP_CELLS:
        dflag = build_flagship(Nd, Hd, batch=Bd, device=dev)
        dset = ddp_mod.DdpSettings(n_intervals=Nd, horizon=Hd, integrator=integ,
                                   n_iterations=iters)
        its = []
        zero_counts()
        drun = ddp_solve(dflag, dset, DDP_WARM, its.append)
        torch.cuda.synchronize()
        d_counts = read_counts(f"ddp_{cell}", ("soa_linearize", "project_knot", "riccati_solve",
                                               "ddp_rollout", "soa_merit"),
                               ("riccati_solve_parallel", "gj_inverse"), steps=1,
                               ddp=(DDP_WARM, iters, 1))
        sol = drun.solution
        if sol.states.shape != (Bd, Nd + 1, 22) or sol.inputs.shape != (Bd, Nd + 1, 22):
            raise AssertionError(f"ddp {cell}: shapes {sol.states.shape}, {sol.inputs.shape}")
        solve_args = (dflag.model, dset, dflag.params, drun.refs, dflag.x0, drun.warm.states,
                      drun.warm.inputs[:, :-1])
        zero_counts()
        ddp_mod.solve(*solve_args)
        torch.cuda.synchronize()
        per_solve = {n: c.launches for n, c in counters.items() if c.launches}
        want = {"soa_linearize": iters, "project_knot": iters, "riccati_solve": iters,
                "ddp_rollout": iters + 1}
        if per_solve != want:
            raise AssertionError(f"ddp {cell}: launches per solve {per_solve}, expected {want}")
        solve_times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ddp_mod.solve(*solve_args)
            torch.cuda.synchronize()
            solve_times.append(time.perf_counter() - t)
        props = None
        if cell == "product_rk2":
            # tests/test_ddp.py's properties (the flagship trots at 0.25 m/s)
            dt_ = Hd / Nd
            defects = sol.states[:, 1:] - sqp.rk2_step(dflag.model, sol.states[:, :-1],
                                                       sol.inputs[:, :-1], dt_)
            props = {"finite": bool(torch.isfinite(sol.states).all()),
                     "step_size": sol.step_size.item(),
                     "constraint_violation": sol.constraint_violation.item(),
                     "max_defect": defects.abs().max().item(),
                     "max_abs_z_minus_0.63": (sol.states[..., 8] - 0.63).abs().max().item(),
                     "sum_fz_over_mg": sol.inputs[0, 0, 2:12:3].sum().item() / (12.5869 * 9.81)}
            if not (props["finite"] and props["step_size"] >= 0.5
                    and props["constraint_violation"] < 1e-3 and props["max_defect"] < 1e-4
                    and props["max_abs_z_minus_0.63"] < 0.05
                    and abs(props["sum_fz_over_mg"] - 1.0) <= 0.15):
                raise AssertionError(f"ddp {cell}: tests/test_ddp.py's properties: {props}")
        elif Bd == 1 and not bool(torch.isfinite(sol.states).all()):
            raise AssertionError(f"ddp {cell}: non-finite states")

        # the card's ddp.solve against the CPU's from the CPU float64 warm start
        # (one per shape: the product cells share it)
        sub = torch.arange(0, Bd, DDP_CPU_STRIDE)
        if (Bd, Nd, Hd) not in cpu_warm:
            c64 = build_flagship(Nd, Hd, batch=Bd, device="cpu", dtype=torch.float64)
            c64 = c64._replace(settings=c64.settings._replace(riccati_solver="gj"),
                               x0=c64.x0[sub], state=mpc_mod.init_mpc_state(
                                   c64.model, c64.settings, len(sub), device="cpu",
                                   dtype=torch.float64))
            w64 = ddp_solve(c64, dset._replace(n_iterations=1), DDP_WARM, riccati_solver="gj")
            cpu_warm[(Bd, Nd, Hd)] = (c64, w64.refs, w64.warm)
        c64, refs64, warm64 = cpu_warm[(Bd, Nd, Hd)]
        w64_args = (c64.model, dset, c64.params, refs64, c64.x0, warm64.states,
                    warm64.inputs[:, :-1])
        ref = ddp_mod.solve(*w64_args, riccati_solver="gj")
        # the JAX package's backward pass (Newton-Schulz) against the exact one
        ns64 = ddp_mod.solve(*w64_args) if cell == "product_rk2" else None
        c32 = build_flagship(Nd, Hd, batch=1, device="cpu")
        f32 = lambda t: t.float() if t.is_floating_point() else t  # noqa: E731
        refs32 = sqp.ReferenceBundle(*(f32(a) for a in refs64))
        x32, ws32, us32 = (t.float() for t in (c64.x0, warm64.states, warm64.inputs[:, :-1]))

        def cpu32(x0_, rows_):
            return ddp_mod.solve(c32.model, dset, c32.params,
                                 sqp.ReferenceBundle(*(a[rows_] for a in refs32)), x0_,
                                 ws32[rows_], us32[rows_], riccati_solver="gj")

        card = ddp_mod.solve(dflag.model, dset, dflag.params,
                             sqp.ReferenceBundle(*(a.to(dev) for a in refs32)), x32.to(dev),
                             ws32.to(dev), us32.to(dev))
        all_rows = torch.arange(len(sub))
        sol32 = cpu32(x32, all_rows)
        d32 = per_scenario(sol32, ref)
        dcard = per_scenario(card, ref)
        lim = {q: (MAIN_FACTOR * v).clamp(min=MAIN_FLOOR[q]) for q, v in d32.items()}
        over = torch.zeros(len(sub), dtype=torch.bool)
        for q in lim:
            over |= ~(dcard[q] <= lim[q])
        ill = {}
        if over.any():
            rows_ = over.nonzero().flatten()
            sub_ref = type(ref)(*(t[rows_] for t in ref))
            runs = [{q: v[rows_] for q, v in d32.items()}]
            for seed in DDP_ULP_SEEDS:
                runs.append(per_scenario(cpu32(moved_x0(x32[rows_], seed), rows_), sub_ref))
            own = {q: (MAIN_FACTOR * torch.stack([r[q] for r in runs]).amax(0)).clamp(
                min=MAIN_FLOOR[q]) for q in lim}
            for j, r in enumerate(rows_.tolist()):
                ill[int(sub[r])] = {q: {"card": dcard[q][r].item(), "limit": own[q][j].item()}
                                    for q in lim}
        bad_ill = {b: v for b, v in ill.items()
                   if not all(x["card"] <= x["limit"] for x in v.values())}
        steps_differ = [int(sub[j]) for j in range(len(sub))
                        if int(sub[j]) not in ill
                        and card.step_size[j].item() != sol32.step_size[j].item()]
        compare = {"scenarios": sub.tolist(),
                   "vs_exact_f64": {q: v[~over].max().item() if (~over).any() else None
                                    for q, v in dcard.items()},
                   "cpu_f32_vs_exact_f64": {q: v.max().item() for q, v in d32.items()},
                   "ill_conditioned": ill, "step_size_differs": steps_differ,
                   "ns_vs_exact_f64": None if ns64 is None else {
                       q: v.max().item() for q, v in per_scenario(ns64, ref).items()},
                   "cpu_f64_constraint_violation": ref.constraint_violation.tolist()}
        if bad_ill or steps_differ or (Bd == 1 and len(ill) > MAIN_MAX_ILL):
            raise AssertionError(f"ddp {cell}: card vs CPU float64: {compare}")

        emit({"phase": "ddp_path", "cell": cell, "batch": Bd, "knots": Nd,
              "horizon": Hd, "integrator": integ, "iterations": iters,
              "sqp_warm_solves": DDP_WARM, "launches": d_counts,
              "launches_per_solve": per_solve,
              "solve_ms": statistics.median(solve_times) * 1e3,
              "solve_ms_all": [x * 1e3 for x in solve_times],
              "entry_solve_s": drun.seconds,
              "step_size": sorted(set(sol.step_size.cpu().tolist()))[:8],
              "constraint_violation_max": sol.constraint_violation.max().item(),
              "scenarios_with_nan_gains": [int((~torch.isfinite(it["Ks"]).flatten(1).all(1)).sum())
                                           for it in its],
              "properties": props, "card_vs_cpu": compare})

        # B15 on the first iteration's rollouts (and the product shape's re-roll)
        it0 = its[0]
        alphas = torch.tensor(dset.alphas, device=dev)
        rollout_case(cell, dflag, dset, (drun.refs, dflag.x0, it0["xs"], it0["us"],
                                         it0["Ks"].contiguous(), it0["kffs"].contiguous(),
                                         alphas), True, cell == "product_rk2")
        if cell == "product_rk2":
            rollout_case(cell, dflag, dset, (drun.refs, dflag.x0, drun.warm.states,
                                             drun.warm.inputs[:, :-1].contiguous(), None, None,
                                             alphas[:1]), False, False)
            ddp_lq_case(cell, dset, it0)
        del its, drun, dflag, card, ref, ns64

    # ---- 5. kernels ----
    cf_rows = ("synth_imu", "rbd_to_centroidal", "dummy_step", "state_input_to_v")
    for n in ("project_knot", "riccati_solve", "riccati_solve_parallel", "solve_qp",
              "leg_ik", "wbc_qp", "sim_step", "momentum_observer", "kalman_update",
              "swing_plan", "knot_refs", "ddp_rollout") + b1 + cf_rows:
        rows[n]["launches"] = sum(c[n] for c in path_launches.values())
        rows[n]["launches_by_path"] = {p: c[n] for p, c in path_launches.items()}
    for row, (path, n) in gj_rows.items():
        rows[row]["launches"] = gj_by_n[path].get(n, 0)
        rows[row]["launches_by_path"] = {path: rows[row]["launches"]}
    emit({"kernels": [rows[n] for n in ("gj_inverse", "gj_inverse_kalman", "gj_inverse_observer",
                                        "project_knot", "riccati_solve", "riccati_solve_parallel",
                                        "solve_qp") + b1 + ("swing_plan", "leg_ik",
                                                            "knot_refs", "wbc_qp", "sim_step",
                                                            "momentum_observer",
                                                            "kalman_update") + cf_rows
                                        + ("ddp_rollout",)]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
