"""The port's scalarized SoA core (the plain version of kernel B1) against the
JAX package, on the CPU in float64, on tests/test_soa.py's setup (B=2
scenarios x 3 knots, seed 11, random states, inputs, flags and foot
references).  JAX runs eagerly, as tests/test_soa.py runs it: jit of the
SoA graph takes minutes to compile on the CPU.

- ``build_consts`` equal field by field;
- ``fk``'s link poses, ``combined_rows_arrays``, ``flow_arrays`` and every
  key of ``linearization_arrays`` within 1e-11 absolute;
- ``knot_linearization_batch`` within 1e-11 and ``stage_merit_batch`` within
  1e-12 of JAX, relative to max |JAX| + 1 (tests/test_soa.py:64-79), and
  the port's SoA against the port's dense forms at the same tolerances;
- the solver's masked, dt-scaled ``knot_linearization_all_plain`` and
  ``eval_merit_plain`` (lin_backend='soa') against the same quantities
  rebuilt from JAX's batch functions as ``sqp.solve`` builds them;
- kernel B1's host side that runs here: the merit's scratch kept per
  device and stream.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunter_bipedal_control_tpu.models import soa as jsoa
from hunter_bipedal_control_tpu.models.robot import load_model as jload
from hunter_bipedal_control_tpu.ocp import problem as jocp
from hunter_bipedal_control_tpu_torch import convert
from hunter_bipedal_control_tpu_torch.models import soa as tsoa
from hunter_bipedal_control_tpu_torch.ocp import problem as tocp
from hunter_bipedal_control_tpu_torch.ocp import soa_kernel
from hunter_bipedal_control_tpu_torch.solver import sqp as tsqp

F64 = torch.float64
DJ = np.array([0.10, 0., 0.40, 0.93, 0.53, -0.10, 0., -0.40, 0.93, -0.53])
DT = 0.015
ABS = 1e-11
LIN_REL, MERIT_REL = 1e-11, 1e-12
LIN_KEYS = ("Jcom", "flow0", "g0", "eq_mask", "soft0", "Vh", "Vv", "dvb", "Jc", "Jcdot", "p_c",
            "p_com")


def t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def close_abs(got, ref, atol=ABS):
    got, ref = got.detach().numpy(), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() < atol, np.abs(got - ref).max()


def close_rel(got, ref, rtol):
    """max |got - ref| / (max |ref| + 1) < rtol (tests/test_soa.py's measure)."""
    got, ref = got.detach().numpy(), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    rel = np.abs(got - ref).max() / (np.abs(ref).max() + 1.0)
    assert rel < rtol, rel


@pytest.fixture(scope="module")
def setup():
    """tests/test_soa.py's data, on both sides."""
    m = jload(dtype=jnp.float64)
    qnom = jnp.asarray(np.concatenate([[0., 0., 0.63], np.zeros(3), DJ]))
    params = jocp.make_input_cost(m, jocp.default_ocp_params(m, jnp.float64), qnom)
    rng = np.random.RandomState(11)
    B, K = 2, 3
    x = np.concatenate(
        [0.3 * rng.randn(B, K, 6), 0.05 * rng.randn(B, K, 3) + [0, 0, 0.63],
         0.3 * rng.randn(B, K, 3), DJ[None, None] + 0.2 * rng.randn(B, K, 10)], axis=2)
    u = rng.randn(B, K, 22) * np.r_[np.full(12, 30.0), np.full(10, 2.0)]
    fl = rng.randint(0, 2, (B, K, 4)).astype(np.float64)
    fpr = 0.1 * rng.randn(B, K, 4, 3)
    fvr = 0.1 * rng.randn(B, K, 4, 3)
    arrays = (x, u, fl, fpr, fvr)
    tm = convert.from_numpy(jax.tree.map(np.asarray, m), "cpu", F64)
    tp = convert.from_numpy(jax.tree.map(np.asarray, params), "cpu", F64)
    return (m, params, [jnp.asarray(a) for a in arrays]), (tm, tp, [t(a) for a in arrays])


@pytest.fixture(scope="module")
def linearization(setup):
    (m, p, (x, u, fl, fpr, fvr)), (tm, tp, (xt, ut, flt, fprt, fvrt)) = setup
    return (jsoa.linearization_arrays(m, p, x, u, fl, fpr, fvr),
            tsoa.linearization_arrays(tm, tp, xt, ut, flt, fprt, fvrt))


def test_build_consts_matches_jax(setup):
    (m, *_), (tm, *_) = setup
    ref, got = jsoa.build_consts(m), tsoa.build_consts(tm)
    assert got._fields == ref._fields
    for name in ref._fields:
        assert getattr(got, name) == getattr(ref, name), name
    # a second model with the same content hits the content-hash cache
    tm2 = convert.from_numpy(jax.tree.map(np.asarray, m), "cpu", F64)
    assert tsoa.build_consts(tm2) is got


def test_fk_matches_jax(setup):
    (m, _, (x, *_)), (tm, _, (xt, *_)) = setup
    ref = jsoa.fk(jsoa.build_consts(m), jsoa._cols(x[..., 6:]))
    got = tsoa.fk(tsoa.build_consts(tm), tsoa._cols(xt[..., 6:]))

    def leaves(v):
        if isinstance(v, (list, tuple)):
            return [x for e in v for x in leaves(e)]
        return [v]

    for field in ("R", "p", "com", "axis_w", "anchor"):
        got_l, ref_l = leaves(getattr(got, field)), leaves(getattr(ref, field))
        assert len(got_l) == len(ref_l), field
        for a, b in zip(got_l, ref_l):
            if isinstance(b, float):
                assert a == b, field
            else:
                close_abs(a, b)


def test_combined_rows_arrays_matches_jax(setup):
    (m, p, arrays), (tm, tp, tarrays) = setup
    ref = jsoa.combined_rows_arrays(m, p, *arrays)
    got = tsoa.combined_rows_arrays(tm, tp, *tarrays)
    for a, b in zip(got, ref):
        close_abs(a, b)


def test_flow_arrays_matches_jax(setup):
    (m, _, (x, u, *_)), (tm, _, (xt, ut, *_)) = setup
    close_abs(tsoa.flow_arrays(tm, xt, ut), jsoa.flow_arrays(m, x, u))


@pytest.mark.parametrize("key", LIN_KEYS)
def test_linearization_arrays_matches_jax(linearization, key):
    ref, got = linearization
    assert sorted(got) == sorted(LIN_KEYS) == sorted(ref)
    close_abs(got[key], ref[key])


def test_stage_merit_batch_matches_jax(setup):
    (m, p, (x, u, fl, fpr, fvr)), (tm, tp, (xt, ut, flt, fprt, fvrt)) = setup
    ref = jocp.stage_merit_batch(m, p, x, u, x + 0.01, fl, fpr, fvr, DT)
    got = tocp.stage_merit_batch(tm, tp, xt, ut, xt + 0.01, flt, fprt, fvrt, DT)
    for a, b in zip(got, ref):
        close_rel(a, b, MERIT_REL)


@pytest.fixture(scope="module")
def knot_linearizations(setup):
    (m, p, (x, u, fl, fpr, fvr)), (tm, tp, (xt, ut, flt, fprt, fvrt)) = setup
    return (jocp.knot_linearization_batch(m, p, x, u, x + 0.01, fl, fpr, fvr, DT),
            tocp.knot_linearization_batch(tm, tp, xt, ut, xt + 0.01, flt, fprt, fvrt, DT))


def test_knot_linearization_batch_matches_jax(knot_linearizations):
    ref, got = knot_linearizations
    assert len(got) == len(ref) == 13
    for a, b in zip(got, ref):
        close_rel(a, b, LIN_REL)


@pytest.mark.parametrize("which", ["linearization", "merit"])
def test_soa_matches_dense(setup, knot_linearizations, which):
    """The port's two backends on the same inputs (the dense forms share no
    code with the SoA core)."""
    _, (tm, tp, (xt, ut, flt, fprt, fvrt)) = setup
    args = (tm, tp, xt, ut, xt + 0.01, flt, fprt, fvrt, DT)
    if which == "linearization":
        got, ref, tol = knot_linearizations[1], tocp.knot_linearization_fused(*args), LIN_REL
    else:
        got, ref, tol = tocp.stage_merit_batch(*args), tocp.stage_merit_fused(*args), MERIT_REL
    for a, b in zip(got, ref):
        close_rel(a, b.detach().numpy(), tol)


def _solver_inputs(setup):
    """The setup as one solver call: 3 knots per scenario are N+1 = 3 states
    (N = 2 intervals of DT), inputs on the first 2, references on all 3."""
    (m, p, (x, u, fl, fpr, fvr)), (tm, tp, (xt, ut, flt, fprt, fvrt)) = setup
    N = x.shape[1] - 1
    settings = tsqp.SqpSettings(n_intervals=N, horizon=N * DT)
    assert settings.lin_backend == "soa"
    refs = tsqp.ReferenceBundle(times=torch.zeros(x.shape[:2], dtype=F64), x_nom=xt + 0.01,
                                contact_flags=flt, foot_pos_ref=fprt, foot_vel_ref=fvrt)
    jax_args = (m, p, x, u, fl, fpr, fvr, N)
    return jax_args, (tm, settings, tp, refs, xt, ut[:, :N])


def test_knot_linearization_all_plain_matches_jax_solve(setup):
    """sqp.solve's knot_linearization_all (JAX sqp.py:237-268, 'soa'): the
    batch form on the first N knots, cost terms scaled by dt, C and D masked."""
    (m, p, x, u, fl, fpr, fvr, N), targs = _solver_inputs(setup)
    out = list(jocp.knot_linearization_batch(m, p, x[:, :N], u[:, :N], x[:, :N] + 0.01,
                                             fl[:, :N], fpr[:, :N], fvr[:, :N], DT))
    for i in (3, 4, 5, 6, 7, 8):
        out[i] = DT * out[i]
    out[10] = out[10] * out[12][..., None]
    out[11] = out[11] * out[12][..., None]
    before = (soa_kernel.soa_linearize.launches, soa_kernel.soa_merit.launches)
    got = tsqp.knot_linearization_all(*targs)
    assert (soa_kernel.soa_linearize.launches, soa_kernel.soa_merit.launches) == before
    for a, b in zip(got, out):
        close_rel(a, b, LIN_REL)
    for a, b in zip(tsqp.knot_linearization_all_plain(*targs), got):
        assert torch.equal(a, b)


def test_eval_merit_plain_matches_jax_solve(setup):
    """sqp.solve's eval_merit (JAX sqp.py:270-292, 'soa') on two candidates
    per scenario: dt-scaled total cost and |defects|_1 / N + |eq|_1 / N."""
    (m, p, x, u, fl, fpr, fvr, N), (tm, settings, tp, refs, xt, ut) = _solver_inputs(setup)
    shift = np.array([0.0, 0.02])[None, :, None, None]
    xs = x[:, None] + shift
    us = u[:, None, :N] + 10 * shift
    rep = [jnp.broadcast_to(a[:, None, :N], (a.shape[0], 2, N, *a.shape[2:]))
           for a in (x + 0.01, fl, fpr, fvr)]
    costs, xnext, eq = jocp.stage_merit_batch(m, p, xs[:, :, :N], us, *rep, DT)
    ref = (DT * costs.sum(-1),
           jnp.abs(xs[:, :, 1:] - xnext).sum((-1, -2)) / N + jnp.abs(eq).sum((-1, -2)) / N)
    before = soa_kernel.soa_merit.launches
    got = tsqp.eval_merit(tm, settings, tp, refs, t(xs), t(us))
    assert soa_kernel.soa_merit.launches == before
    for a, b in zip(got, ref):
        close_rel(a, b, MERIT_REL)


def test_soa_merit_scratch_kept_per_stream():
    """The merit's tickets (zeroed once, when made) and partial sums are
    kept per (device, stream), reused while large enough and grown, still
    zero, when a launch needs more."""
    soa_kernel._MERIT_SCRATCH.clear()
    t1, p1 = soa_kernel.merit_scratch("cpu", 7, 6, 100)
    assert t1.dtype == torch.int32 and p1.dtype == torch.float32
    assert t1.numel() >= 6 and p1.numel() >= 100 and bool((t1 == 0).all())
    t2, p2 = soa_kernel.merit_scratch("cpu", 7, 4, 50)
    assert t2 is t1 and p2 is p1
    t3, p3 = soa_kernel.merit_scratch("cpu", 7, 10, 50)
    assert t3.numel() >= 10 and p3.numel() >= 100 and bool((t3 == 0).all())
    t4, _ = soa_kernel.merit_scratch("cpu", 8, 6, 100)
    assert t4 is not t3
    soa_kernel._MERIT_SCRATCH.clear()

