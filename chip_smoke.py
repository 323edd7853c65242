#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the hand-written kernels (csrc/*.cu, nvcc for sm_90a);
  3. each kernel against its plain PyTorch version on the card, at the
     MPC step's shapes: B6 gj_inverse, B2 project_knot, B3 riccati_solve
     (errors against the float32 and float64 plain versions; kernel /
     plain / library times by CUDA events, medians of 15);
  4. the main path: the flagship problem (B=128 scenarios, 66 knots over
     1.0 s, trot, 0.25 m/s) through ``Mpc``, one cold and one warm step, with
     every kernel's launch count read around it, held against the port's
     own CPU runs (plain versions: float32, and float64 with the exact Huu
     solve); then the product shape (B=1, 53 knots over 0.8 s);
  5. the kernels line: launches, error, times and bound of each kernel.
The last line is {"ok": true, "device": {...}}.  Any failed check raises.
Exits non-zero without a card, and outside the repository.
"""
import json
import statistics
import subprocess
import sys
import time

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
TOL = {"gj_inverse": 1e-5, "project_knot": 1e-4, "riccati_solve": 2e-3}
TOL_FACTOR = 2.0
# Card main path vs the port's CPU runs, on states, inputs and cost relative
# to max(1, |cost|).  The Riccati kernel solves Huu exactly (Cholesky); the
# plain version is the JAX algorithm, 20 Newton-Schulz iterations, which
# has not converged on the warm step of the scenarios farthest from the
# nominal state: there the two algorithms differ by up to ~0.05 in states,
# ~2.5 in inputs and ~8% in cost in float64 alone.  So:
#  - against the CPU float32 run (plain, NS): within ALGO_TOL;
#  - against the CPU float64 run with the exact solve (riccati_solver='gj'):
#    within MAIN_FACTOR times the CPU float32 'gj' run's own distance to it
#    (float32 alone moves the B=128 step by ~1e-2 in states, ~2% in cost),
#    or the floor MAIN_FLOOR.
# The accepted step sizes must equal the CPU float32 run's.
ALGO_TOL = {"states": 0.1, "inputs": 5.0, "cost_rel": 0.15}
MAIN_FACTOR = 3.0
MAIN_FLOOR = {"states": 1e-3, "inputs": 0.1, "cost_rel": 1e-4}


def emit(obj):
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


def rel_err(got, ref):
    """(max |got - ref|, that over max |ref|)."""
    diff = (got.double() - ref.double()).abs().max().item()
    return diff, diff / max(ref.double().abs().max().item(), 1e-30)


def errors(names, got, plain32, plain64):
    """Per output: the kernel against the float32 plain version, the kernel
    against the float64 plain version, float32 plain against float64 plain."""
    return {n: (rel_err(a, b), rel_err(a, c), rel_err(b, c))
            for n, a, b, c in zip(names, got, plain32, plain64)}


def check(name, errs, tol):
    """Raise unless every output is within max(tol, TOL_FACTOR x the float32
    plain version's error on it) of the float64 plain version."""
    bad = {n: {"vs_f64": e64[1], "limit": max(tol, TOL_FACTOR * p64[1])}
           for n, (_, e64, p64) in errs.items() if e64[1] > max(tol, TOL_FACTOR * p64[1])}
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs a GPU", file=sys.stderr)
        return 2

    from hunter_bipedal_control_tpu_torch.entry import build_flagship
    from hunter_bipedal_control_tpu_torch.kernels import _build
    from hunter_bipedal_control_tpu_torch.ops import linalg
    from hunter_bipedal_control_tpu_torch.solver import mpc as mpc_mod, riccati, sqp

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
    ptxas = [ln.strip() for ln in _build.build_log.splitlines() if "Used" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(secs, 3), "library": _build.LIB_PATH,
          "ptxas": ptxas[:24]})

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

    # ---- 3. kernels vs plain versions at the main path's shapes ----
    B, N, H = 128, 66, 1.0
    gen = torch.Generator(device="cpu").manual_seed(0)

    def spd(batch, n):
        X = torch.randn(batch, n, n, generator=gen)
        return (X @ X.transpose(1, 2) / n + 0.5 * torch.eye(n)).to(dev).contiguous()

    A5 = spd(B * 7 * 2, 5)          # IK damped normal systems: 2 legs x 7 samples
    err = errors(["inverse"], [linalg.gj_inverse(A5, True)], [linalg.gj_inverse_plain(A5, True)],
                 [linalg.gj_inverse_plain(A5.double(), True)])
    record("gj_inverse", "cuda", "hunter_bipedal_control_tpu_torch/csrc/gj_inverse.cu",
           "hunter_bipedal_control_tpu/ops/linalg.py:141", err, TOL["gj_inverse"],
           cuda_ms(lambda: linalg.gj_inverse(A5, True)),
           cuda_ms(lambda: linalg.gj_inverse_plain(A5, True)),
           cuda_ms(lambda: torch.linalg.inv(A5)), gj_cost(B * 7 * 2, 5),
           {"shape": list(A5.shape), "pivot": True})
    A16 = spd(B * N, 16)            # the projection's 16x16 Gram shape
    err16 = errors(["inverse"], [linalg.gj_inverse(A16, False)],
                   [linalg.gj_inverse_plain(A16, False)],
                   [linalg.gj_inverse_plain(A16.double(), False)])
    b16 = bound(*gj_cost(B * N, 16))
    emit({"phase": "kernel_extra", "name": "gj_inverse", "shape": list(A16.shape),
          "pivot": False, "tol": TOL["gj_inverse"], "outputs": per_output(err16, TOL["gj_inverse"]),
          "kernel_ms": cuda_ms(lambda: linalg.gj_inverse(A16, False)),
          "plain_ms": cuda_ms(lambda: linalg.gj_inverse_plain(A16, False)),
          "library_ms": cuda_ms(lambda: torch.linalg.inv(A16)), "bound_ms": b16[0],
          "bound_by": b16[1]})
    check("gj_inverse 16x16", err16, TOL["gj_inverse"])

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

    # ---- 4. the main path ----
    mpc = mpc_mod.Mpc(model, settings, params, flag.planner_cfg)
    args = (flag.schedule, flag.target, 0.0, flag.x0, z6, flag.default_joints)
    counters = {"gj_inverse": linalg.gj_inverse, "project_knot": sqp.project_knot,
                "riccati_solve": riccati.riccati_solve}
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    cold, st1, _ = mpc(flag.state, *args)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t
    warm, _, _ = mpc(st1, *args)
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    for n, c in launches.items():
        rows[n]["launches"] = c
        if c <= 0:
            raise AssertionError(f"kernel {n} was not launched on the main path")
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
    def cpu_steps(dtype, solver):
        f = build_flagship(N, H, batch=B, device="cpu", dtype=dtype)
        m = mpc_mod.Mpc(f.model, settings._replace(riccati_solver=solver), f.params,
                        f.planner_cfg)
        a = (f.schedule, f.target, 0.0, f.x0, torch.zeros(6, dtype=dtype), f.default_joints)
        s1, st, _ = m(f.state, *a)
        s2, _, _ = m(st, *a)
        return s1, s2

    t = time.perf_counter()
    cpu32 = cpu_steps(torch.float32, "ns")
    cpu_s = time.perf_counter() - t
    exact32 = cpu_steps(torch.float32, "gj")
    exact64 = cpu_steps(torch.float64, "gj")

    def dist(a, b):
        return {"states": (a.states.cpu().double() - b.states.double()).abs().max().item(),
                "inputs": (a.inputs.cpu().double() - b.inputs.double()).abs().max().item(),
                "cost_rel": ((a.cost.cpu().double() - b.cost.double()).abs()
                             / b.cost.double().abs().clamp(min=1.0)).max().item()}

    compare = {}
    for k, (name, g_) in enumerate((("cold", cold), ("warm", warm))):
        vs_cpu = dist(g_, cpu32[k])
        vs_exact = dist(g_, exact64[k])
        noise = dist(exact32[k], exact64[k])
        tol = {q: max(MAIN_FLOOR[q], MAIN_FACTOR * v) for q, v in noise.items()}
        same_alpha = bool(torch.equal(g_.step_size.cpu(), cpu32[k].step_size))
        compare[name] = {"vs_cpu_f32": vs_cpu, "vs_cpu_f32_tol": ALGO_TOL,
                         "vs_exact_f64": vs_exact, "vs_exact_f64_tol": tol,
                         "exact_f32_vs_exact_f64": noise, "step_size_equal": same_alpha,
                         "step_size": sorted(set(g_.step_size.cpu().tolist()))}
        ok = (all(vs_cpu[q] <= ALGO_TOL[q] for q in ALGO_TOL)
              and all(vs_exact[q] <= tol[q] for q in tol) and same_alpha)
        if not ok:
            raise AssertionError(f"{name} step: card vs CPU: {compare[name]}")
    emit({"phase": "main_path", "batch": B, "knots": N, "horizon": H,
          "launches": launches, "cold_step_s": cold_s, "step_ms": step_ms,
          "solves_per_s": B / (step_ms / 1e3), "cost_mean": warm.cost.mean().item(),
          "cpu_run_s": cpu_s, "card_vs_cpu": compare})

    # the product shape: one scenario, 53 knots over 0.8 s
    pflag = build_flagship(53, 0.8, batch=1, device=dev)
    pmpc = mpc_mod.Mpc(pflag.model, pflag.settings, pflag.params, pflag.planner_cfg)
    pargs = (pflag.schedule, pflag.target, 0.0, pflag.x0, z6, pflag.default_joints)
    p1, pst, _ = pmpc(pflag.state, *pargs)
    p2, _, _ = pmpc(pst, *pargs)
    torch.cuda.synchronize()
    if not all(torch.isfinite(s.states).all() and torch.isfinite(s.cost).all() for s in (p1, p2)):
        raise AssertionError("product shape: non-finite solution")
    ptimes = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pmpc(pst, *pargs)
        torch.cuda.synchronize()
        ptimes.append(time.perf_counter() - t)
    emit({"phase": "product_shape", "batch": 1, "knots": 53, "horizon": 0.8,
          "step_ms": statistics.median(ptimes) * 1e3, "cost": p2.cost.item(),
          "step_size": p2.step_size.item()})

    # ---- 5. kernels ----
    emit({"kernels": [rows[n] for n in ("gj_inverse", "project_knot", "riccati_solve")]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
