"""The CUDA kernels of the MPC step and the control tick against their
plain PyTorch versions, on the card, at the main paths' shapes in float32
(marker ``cuda``; each test skips without a card).  This file imports no
JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are chip_smoke.py's: max |kernel - plain| / max(1, max |plain|)
within 1e-5 (gj_inverse), 1e-4 (project_knot) and 2e-3 (riccati_solve,
whose kernel factors Huu by Cholesky where the plain version iterates
Newton-Schulz).  solve_qp: each output within max(1e-4, 2 x the float32
plain version's own error) of the float64 plain version, on its own scale
(the primal residual on the WBC acceptance test's, 1 + max |b|), on the
WBC's QP at B=4096, 3 and 1 and on 64 seeded QPs of the hierarchical WBC's
shapes (me=1, mi=40 or 1; ill-conditioned: their float32 plain error is the
largest over the inputs and four one-ulp moves of them); n, me or mi above
64 refused.
riccati_solve (B3) solves exactly too: each output also within max(1e-4,
2 x the float32 exact plain version's own error) of the float64 exact plain
version (riccati_solver='gj'), on its own scale, on the flagship's cold-step
data at B=1/N=53 and B=128/N=66; an indefinite Huu gives NaN gains at its
knot and every earlier one; inputs off a 16-byte boundary give the aligned
run's outputs bit for bit; a second LQ's gains written into the buffer the
allocator takes back from a first LQ's give a fresh run's outputs bit for
bit; float64, non-contiguous input and nx != 22 refused.
riccati_solve_parallel (B5, exact solves): each output within max(1e-4,
2 x the float32 exact plain version's own error) of the float64 exact plain
version, on its own scale, both plain versions run on the CPU.
soa_linearize and soa_merit (B1): each of the 13 linearization outputs and
the merit's cost and metric within max(1e-4, 2 x the float32 plain SoA
version's own error) of the float64 plain SoA version, on its own scale,
on random and main-path data at B=1/N=53, B=128/N=66 and B=256/N=53, the
merit also with 1 and 3 candidates at N=53, 66 and 7; the merit gives the
same bits on repeated launches, a NaN in one knot of one scenario's
candidate reaches that (scenario, candidate) alone, and each entry point is
one device kernel a call.
leg_ik (B8a): both passes' joints, each within max(1e-4, 2 x the float32
plain version's own error) of the float64 plain version, on its own scale,
on main-path and random data at B=1/S=6, B=128/S=7, the ragged B=3/S=5 and
B=256/S=6 (768 one-warp blocks), both plain versions run on the CPU; the
keep-if-improved tests reported on request leave the joints bit for bit as
the bare call's and flip at most 2 x the float32 plain version's legs + 2;
a NaN in a pose, a toe target or a warm joint gives NaN where the float32
plain version has it.
wbc_qp (B9): each of the six QP arrays within max(1e-4, 2 x the float32
plain version's own error) of the float64 plain version, on its own scale,
on standing (bench.py's batch) and walking states (mixed contact flags, both
stance modes) at B=1, 3 and 4096; a NaN in the measurement, the desired
state or input, or a flag gives NaN in the same rows as the plain version
(in H and g at the same entries); a gain changed in place or replaced
reaches the next QP; the six outputs contiguous and 16-byte aligned.
sim_step (B11): the tick's q, v, last acceleration and contact forces, each
within max(1e-4, 2 x the float32 plain version's own error) of the float64
plain version, on its own scale, outside the scenarios whose in-contact
decisions went the other way from the float64 plain version's in some
substep; the kernel flips at most 2 x the float32 plain version's
scenarios + 2; on the standing robot (B=1) and on sweep-shaped batches
(``entry.sim_step_batch``, B=3, 1024 and 4096: both warp layouts and a
ragged last wave; a 9 ms delay ring, per-scenario mass scale and field, or
neither), the same bits without the decisions; a NaN in q, v, the command,
the mass scale or the field gives NaN where the plain version has it; a
SimParams tensor changed in place reaches the next launch.
momentum_observer (B10) and kalman_update (B12): each output (the observer's
p_scg_z, est_forces and tau_dist; the filter's x_hat and P) within
max(1e-4, 2 x the float32 plain version's own error) of the float64 plain
version, on its own scale, on seeded walking inputs
(``entry.estimator_batch``) at B=1 and B=4096, the filter also at B=1027
(a partial block), from a loop's first tick (P = 100 I) and with every foot
in swing or in stance, one launch each and no B6 launch; a NaN measurement
gives NaN where the plain version has it.
synth_imu (B13a), rbd_state_to_centroidal (B13b), dummy_step (B14a) and
state_input_to_v (B14b): each output (the IMU's quaternion, local angular
velocity, specific force and world angular velocity; the centroidal state;
the stepped state; v and the tick's rbd state) within max(1e-4, 2 x the
float32 plain version's own error) of the float64 plain version, on its own
scale, on seeded walking robots (``entry.centroidal_batch``) at B=1 and
B=4096, one launch each; a NaN state gives NaN where the plain version has
it; float64 input, a wrong width and a model of another topology refused.
swing_plan (B8b1) and knot_refs (B8b2), the reference prep around the IK:
every output within max(1e-4, 2 x the float32 plain version's own error)
of the float64 plain version, each entry's error relative to max(1, |entry|)
(the padded phases carry 1e9 s window starts), B8b1's per-phase outputs
on the phases with empty windows (their swing velocities divide by the
1e-6 s clamp) apart from the live ones, outside the scenarios where
a phase or window test of the float32 plain version went the other way
from the float64 one's; every decision (phases, segments, the windows'
tests) equal to the float32 plain version's; on the flagship's main-path
inputs and on seeded schedules of four gaits around t = 0 and t = 20 s at
B=1 and B=128, and on the schedules at the swing planner's edges
(``entry.swing_plan_edge_batch``: all stance, a single swing, the padded
tail, no real event, init times on and an ulp before event times); the float32 plain version runs on the card (torch divides
by a Python number there as the kernel does, by its reciprocal), the
float64 one on the CPU; inputs shared by expand
(stride 0) give the same bits as contiguous copies; one launch each per
MPC step; float64 and rows that are not contiguous refused.
ddp_rollout (B15) and the DDP's use of B2 and B3, on the product shape's
DDP solve on the card (B=1, 53 knots over 0.8 s, RK2, two iterations):
B15's states, inputs, cost and metric on the first iteration's six
closed-loop rollouts with each integrator, and on the open-loop re-roll,
each within max(1e-4, 2 x the float32 plain version's error) of the
float64 plain version (on the CPU), on its scale max(1, max |plain|);
ODE45's accepted slots equal to the float32 plain version's; the same
rule at B=3 (the flagship's batch) and B=128 (the product shape's data
tiled, x_init moved per scenario by 1e-3; every 8th scenario held) with
one, six and ten step sizes (ten: two blocks a scenario) over the
rollouts whose float64 states stay within 1e3, and on the re-roll at
B=128 (the warm start tiled, its inputs moved per scenario; the float32
plain error over x_init and two one-ulp moves, chip_smoke's re-roll
rule); a NaN in x_init, in one gain or in one knot's x_nom
gives NaN where the plain version has it; float64, rows that are not
contiguous, a policy without its feedforward, references of another
length and an unknown integrator refused, launching nothing; B2 (d = 0,
hess_reg 1e-5, the pivoting Gram inverse; its float32
plain error the largest over the inputs and four one-ulp moves of them)
and B3 (the backward pass, against the exact plain version) under the same
rule;
tests/test_ddp.py's properties on the card's solve and one launch of B1,
B2, B3 and B15 per iteration plus one re-roll per solve.
contact_class (B16), the full-order loop's contact classification: its
three flags equal to the float32 plain version's on the card (decisions in
torch's order and rounding) on ``entry.contact_class_batch``'s seeded
schedules (ticks on and one ulp beside event times, NaN forces) at B=1, 3
and 4096, with a schedule shared by expand (stride 0) too; one launch per
call; float64 times, int32 modes and a wrong width refused, launching
nothing.
"""
import numpy as np
import pytest
import torch

from hunter_bipedal_control_tpu_torch.backends import dummy, fullorder
from hunter_bipedal_control_tpu_torch.entry import (SimBatch, build_flagship, build_sim_loop,
                                                    build_wbc_batch, centroidal_batch,
                                                    contact_class_batch,
                                                    estimator_batch, projected_lq, qp_batch,
                                                    sim_step_batch, swing_plan_edge_batch,
                                                    walking_wbc_batch)
from hunter_bipedal_control_tpu_torch.estim import contact, kalman
from hunter_bipedal_control_tpu_torch.gait import mode_schedule as ms
from hunter_bipedal_control_tpu_torch.models import centroidal
from hunter_bipedal_control_tpu_torch.models.robot import load_model
from hunter_bipedal_control_tpu_torch.models.spatial import rotation_zyx
from hunter_bipedal_control_tpu_torch.ocp import soa_kernel
from hunter_bipedal_control_tpu_torch.ops import linalg, qp
from hunter_bipedal_control_tpu_torch.refs import ik as ik_mod
from hunter_bipedal_control_tpu_torch.runtime.controller import JointCommand
from hunter_bipedal_control_tpu_torch.entry import ddp_solve as entry_ddp_solve
from hunter_bipedal_control_tpu_torch.solver import ddp as ddp_mod
from hunter_bipedal_control_tpu_torch.solver import mpc as mpc_mod, riccati, sqp
from hunter_bipedal_control_tpu_torch.wbc import wbc

NX = NU = 22
M = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rel_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1.0))


def spd(rng, batch, n):
    X = rng.standard_normal((batch, n, n))
    return X @ np.swapaxes(X, -1, -2) / n + 0.5 * np.eye(n)


def knot_data(rng, shape, device, masked=None, asym=False):
    """Projection inputs shaped like the SQP's (masked rows, SPD Quu);
    ``masked`` True / False masks every row / no row, ``asym`` adds an
    asymmetric part to Qxx and Quu."""
    def spd_(n, shift):
        X = rng.standard_normal((*shape, n, n))
        return X @ np.swapaxes(X, -1, -2) / n + shift * np.eye(n)

    mask = (rng.random((*shape, M)) > 0.25).astype(np.float64)
    if masked is not None:
        mask = np.full_like(mask, 0.0 if masked else 1.0)
    A = np.eye(NX) + 0.05 * rng.standard_normal((*shape, NX, NX))
    B = 0.05 * rng.standard_normal((*shape, NX, NU))
    d, qx, qu = (0.01 * rng.standard_normal((*shape, NX)), rng.standard_normal((*shape, NX)),
                 rng.standard_normal((*shape, NU)))
    Qxx, Quu = spd_(NX, 1.0), spd_(NU, 0.5)
    if asym:
        Qxx = Qxx + 0.3 * rng.standard_normal(Qxx.shape)
        Quu = Quu + 0.3 * rng.standard_normal(Quu.shape)
    arrays = (A, B, d, qx, qu, Qxx, Quu, 0.1 * rng.standard_normal((*shape, NU, NX)),
              rng.standard_normal((*shape, M)),
              rng.standard_normal((*shape, M, NX)) * mask[..., None],
              rng.standard_normal((*shape, M, NU)) * mask[..., None], mask)
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,pivot", [(128 * 7 * 2, 5, True), (128 * 66, 16, False),
                                           (1, 28, True), (4096, 28, True), (4096, 28, False),
                                           (4096 * 2, 5, True), (5, 17, True), (2, 23, False),
                                           (3, 32, True)])
def test_gj_inverse_kernel(cuda, batch, n, pivot):
    A = torch.tensor(spd(np.random.default_rng(n), batch, n), dtype=torch.float32, device=cuda)
    before = linalg.gj_inverse.launches
    before_n = linalg.gj_inverse.launches_by_n.get(n, 0)
    got = linalg.gj_inverse(A, pivot=pivot)
    torch.cuda.synchronize()
    assert linalg.gj_inverse.launches == before + 1
    assert linalg.gj_inverse.launches_by_n[n] == before_n + 1
    assert rel_err(got, linalg.gj_inverse_plain(A, pivot)) < 1e-5


@pytest.mark.cuda
def test_gj_inverse_kernel_refuses_bad_input(cuda):
    with pytest.raises(TypeError):
        linalg.gj_inverse(torch.eye(5, device=cuda, dtype=torch.float64)[None])
    with pytest.raises(ValueError):
        linalg.gj_inverse(torch.eye(5, device=cuda).expand(3, 5, 5))


@pytest.mark.cuda
def test_project_knot_kernel(cuda):
    args = knot_data(np.random.default_rng(4), (128, 66), cuda)
    got = sqp.project_knot(sqp.SqpSettings(), *args)
    ref = sqp.project_knot_plain(sqp.SqpSettings(), *args)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert rel_err(a, b) < 1e-4


def _project_against_plain(settings, args):
    """One launch of B2 on ``args``, each output within 1e-4 of the plain
    version's on the card (max |a - b| / max(1, max |b|))."""
    before = sqp.project_knot.launches
    got = sqp.project_knot(settings, *args)
    ref = sqp.project_knot_plain(settings, *args)
    torch.cuda.synchronize()
    assert sqp.project_knot.launches == before + 1
    for name, a, b in zip(("A_t", "B_t", "d_t", "qx_t", "qw", "Qxx_t", "Qww", "Qwx", "E", "e",
                           "P"), got, ref):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        assert rel_err(a, b) < 1e-4, (name, rel_err(a, b))
    return got


# (batch, knots): the product and bench shapes, and knot counts that leave a
# partial tail of the persistent grid (each block runs one or two knots)
@pytest.mark.cuda
@pytest.mark.parametrize("batch,n_knots", [(1, 53), (128, 66), (5, 131), (1, 1)])
@pytest.mark.parametrize("case", ["random", "asym", "all_masked", "none_masked"])
def test_project_knot_kernel_cases(cuda, batch, n_knots, case):
    kw = {"asym": {"asym": True}, "all_masked": {"masked": True},
          "none_masked": {"masked": False}}.get(case, {})
    args = knot_data(np.random.default_rng(batch * 1000 + n_knots), (batch, n_knots), cuda, **kw)
    got = _project_against_plain(sqp.SqpSettings(), args)
    if case == "all_masked":
        eye = torch.eye(NU, device=cuda).expand(batch, n_knots, NU, NU)
        assert rel_err(got[10], eye) == 0.0 and float(got[8].abs().max()) == 0.0


@pytest.mark.cuda
def test_project_knot_kernel_ddp_shapes(cuda):
    """The DDP's use: d = 0, hess_reg 1e-5, the Gram's pivot +1e-30."""
    args = knot_data(np.random.default_rng(21), (128, 66), cuda)
    args[2] = torch.zeros_like(args[2])
    _project_against_plain(sqp.SqpSettings(proj_pivot=True, hess_reg=1e-5), args)


@pytest.mark.cuda
def test_project_knot_kernel_nan_knot(cuda):
    """A NaN in one knot's D is NaN in that knot's outputs, as in the plain
    version, and in no other knot's: with more knots than the grid holds, a
    block runs the NaN knot and then another one from the same buffers."""
    args = knot_data(np.random.default_rng(24), (16, 66), cuda)
    args[10][0, 5, 3, 7] = float("nan")
    got = sqp.project_knot(sqp.SqpSettings(), *args)
    ref = sqp.project_knot_plain(sqp.SqpSettings(), *args)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        fin = torch.isfinite(b)
        assert bool(torch.isnan(a[0, 5]).any()) and int((~fin).flatten(2).any(-1).sum()) == 1
        assert float((a[fin] - b[fin]).abs().max() / b[fin].abs().max().clamp(min=1)) < 1e-4


@pytest.mark.cuda
def test_project_knot_kernel_unaligned_inputs(cuda):
    """Inputs 4 bytes off an 8-byte boundary take the kernel's 4-byte copies;
    the outputs equal the aligned inputs' bit for bit."""
    args = knot_data(np.random.default_rng(22), (3, 53), cuda)
    moved = []
    for t in args:
        buf = torch.empty(t.numel() + 1, device=cuda)
        buf[1:] = t.flatten()
        moved.append(buf[1:].view(t.shape))
    assert all(t.data_ptr() % 8 == 4 for t in moved)
    got = _project_against_plain(sqp.SqpSettings(), moved)
    for a, b in zip(got, sqp.project_knot(sqp.SqpSettings(), *args)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_project_knot_kernel_refuses_bad_input(cuda):
    args = knot_data(np.random.default_rng(23), (1, 4), cuda)
    with pytest.raises(TypeError):
        sqp.project_knot(sqp.SqpSettings(), *[t.double() for t in args])
    with pytest.raises(ValueError):
        sqp.project_knot(sqp.SqpSettings(), *args[:9], args[9][..., :15, :], args[10][..., :15, :],
                         args[11][..., :15])
    with pytest.raises(ValueError):
        sqp.project_knot(sqp.SqpSettings(), args[0].transpose(-1, -2), *args[1:])


@pytest.mark.cuda
def test_riccati_solve_kernel(cuda):
    rng = np.random.default_rng(5)
    proj = sqp.project_knot_plain(sqp.SqpSettings(), *knot_data(rng, (128, 66), cuda))
    A_t, B_t, d_t, qx_t, qw, Qxx_t, Qww, Qwx, E, e, P = [t.contiguous() for t in proj]
    lq = riccati.StageLQ(A=A_t, B=B_t, d=d_t, Qxx=Qxx_t, Qww=Qww, Qwx=Qwx, qx=qx_t, qw=qw)
    dx0 = torch.tensor(0.01 * rng.standard_normal((128, NX)), dtype=torch.float32, device=cuda)
    got = riccati.riccati_solve(lq, E, P, e, dx0, 1e-6)
    ref = riccati.riccati_solve_plain(lq, E, P, e, dx0, 1e-6)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert rel_err(a, b) < 2e-3


@pytest.mark.cuda
def test_gj_inverse_kernel_refuses_n_above_32(cuda):
    with pytest.raises(ValueError):
        linalg.gj_inverse(torch.eye(33, device=cuda)[None].contiguous())


def _wbc_qp(device, dtype, batch=4096):
    """The WBC's QP data of bench.py's standing batch, by the plain version
    (in any dtype on the card)."""
    wb = build_wbc_batch(batch, device, dtype)
    return wbc.wbc_qp_plain(wb.model, wb.params, wb.x_des, wb.u_des, wb.rbd, wb.contact_flags,
                      wb.stance_mode)


def _own_scale_err(got, ref, floor=1e-30):
    return float((got.double() - ref.double()).abs().max()
                 / ref.double().abs().max().clamp(min=floor))


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True])
def test_solve_qp_kernel(cuda, warm):
    """The WBC's QP at B=4096 (bench.py's standing batch), 10 iterations,
    cold and warm from the cold solution."""
    data64 = [t.contiguous() for t in _wbc_qp(cuda, torch.float64)]
    data = [t.float().contiguous() for t in data64]
    kw = dict(n_iters=10, lam0=torch.ones(4096, 40, device=cuda),
              nu0=torch.zeros(4096, 28, device=cuda), warm_margin=1.0)
    kw["x0"] = torch.zeros(4096, 38, device=cuda)
    if warm:
        kw["x0"] = qp.solve_qp_plain(*data64, **{k: (v.double() if torch.is_tensor(v) else v)
                                                 for k, v in kw.items()}).x.float().contiguous()
    kw64 = {k: (v.double() if torch.is_tensor(v) else v) for k, v in kw.items()}
    before = qp.solve_qp.launches
    got = qp.solve_qp(*data, **kw)
    torch.cuda.synchronize()
    assert qp.solve_qp.launches == before + 1
    ref32 = qp.solve_qp_plain(*data, **kw)
    ref64 = qp.solve_qp_plain(*data64, **kw64)
    # the primal residual on the WBC acceptance test's scale, floored at 1
    res_scale = 1.0 + torch.maximum(data64[3].abs().amax(-1), data64[5].abs().amax(-1))
    for name, floor in (("x", 1e-30), ("eq_dual", 1e-30), ("ineq_dual", 1e-30),
                        ("primal_residual", 1.0)):
        a, b, c = getattr(got, name), getattr(ref32, name), getattr(ref64, name)
        assert torch.isfinite(a).all(), name
        if name == "primal_residual":
            a, b, c = a / res_scale, b / res_scale, c / res_scale
        assert (_own_scale_err(a, c, floor) <= max(1e-4, 2.0 * _own_scale_err(b, c, floor))), name


@pytest.mark.cuda
def test_solve_qp_kernel_not_spd_gives_nan(cuda):
    H, g, Aeq, beq, Ain, bin_ = [t.float().contiguous() for t in _wbc_qp(cuda, torch.float32, 8)]
    H[3] = -1e3 * torch.eye(38, device=cuda)
    got = qp.solve_qp(H, g, Aeq, beq, Ain, bin_, n_iters=10)
    ref = qp.solve_qp_plain(H, g, Aeq, beq, Ain, bin_, n_iters=10)
    torch.cuda.synchronize()
    for name in ("x", "eq_dual", "ineq_dual"):
        a, b = getattr(got, name), getattr(ref, name)
        assert torch.equal(torch.isnan(a).any(-1), torch.isnan(b).any(-1)), name
        assert torch.isnan(a).any(-1).nonzero().flatten().tolist() == [3], name
    assert torch.isnan(got.primal_residual[3])


def _ulp_moved(t, seed):
    """t with each nonzero entry moved by one ulp up, down or not (seeded):
    exact zeros (masked rows) stay."""
    g = torch.Generator().manual_seed(seed)
    step = torch.randint(-1, 2, t.shape, generator=g).to(t.device, t.dtype)
    return torch.where((step != 0) & (t != 0), torch.nextafter(t, t + step * 1e3), t)


def _check_qp(got, data64, kw, n_iters, ulp_seeds=()):
    """Each output of the kernel's solution ``got`` within max(1e-4, 2 x the
    float32 plain version's error) of the float64 plain version, on its own
    scale (the primal residual on the WBC acceptance test's, floored at 1).
    With ``ulp_seeds`` the float32 plain error is the largest over the
    inputs and their one-ulp moves by those seeds (where conditioning
    amplifies rounding, one float32 run is one sample of its error)."""
    kw64 = {k: (v.double() if torch.is_tensor(v) else v) for k, v in kw.items()}
    data32 = [t.float() for t in data64]
    ref32s = [qp.solve_qp_plain(*d, n_iters=n_iters, **kw) for d in
              [data32] + [[_ulp_moved(t, 10 * s + k) for k, t in enumerate(data32)]
                          for s in ulp_seeds]]
    ref64 = qp.solve_qp_plain(*data64, n_iters=n_iters, **kw64)
    res_scale = 1.0 + torch.maximum(data64[3].abs().amax(-1), data64[5].abs().amax(-1))
    for name, floor in (("x", 1e-30), ("eq_dual", 1e-30), ("ineq_dual", 1e-30),
                        ("primal_residual", 1.0)):
        a, c = getattr(got, name), getattr(ref64, name)
        bs = [getattr(r, name) for r in ref32s]
        assert torch.isfinite(a).all(), name
        if name == "primal_residual":
            a, c, bs = a / res_scale, c / res_scale, [b / res_scale for b in bs]
        plain = max(_own_scale_err(b, c, floor) for b in bs)
        assert _own_scale_err(a, c, floor) <= max(1e-4, 2.0 * plain), name
    assert torch.equal(got.iterations.cpu(), torch.full((got.x.shape[0],), n_iters,
                                                        dtype=torch.int32)), "iterations"


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("batch", [1, 3])
def test_solve_qp_kernel_small_batch(cuda, batch, warm):
    """The WBC's QP at B=1 (one warp in the grid) and B=3 (two QPs a block:
    the second block ragged), 10 iterations, cold and warm."""
    data64 = [t.contiguous() for t in _wbc_qp(cuda, torch.float64, batch)]
    kw = dict(x0=torch.zeros(batch, 38, device=cuda), lam0=torch.ones(batch, 40, device=cuda),
              nu0=torch.zeros(batch, 28, device=cuda), warm_margin=1.0)
    if warm:
        kw["x0"] = qp.solve_qp_plain(*data64, n_iters=10, **{
            k: (v.double() if torch.is_tensor(v) else v) for k, v in kw.items()}).x.float()
    before = qp.solve_qp.launches
    got = qp.solve_qp(*[t.float() for t in data64], n_iters=10, **kw)
    torch.cuda.synchronize()
    assert qp.solve_qp.launches == before + 1
    _check_qp(got, data64, kw, 10)


@pytest.mark.cuda
def test_solve_qp_kernel_generic_instance(cuda):
    """The WBC's QP (B=16, cold, 10 iterations) through both instances of
    the kernel: as it is (38/28/40, compiled in) and padded to n=39 by a
    variable no row touches (its H entry the mean of H's diagonal, its g
    0), which runs the generic instance.  The padded run is held to its
    float64 plain version by the rule above, its added variable stays
    exactly 0, and each output of the two runs lies within max(1e-4, 4 x the
    float32 plain version's error) of the other (two solves each within 2x
    of the float64 one)."""
    batch = 16
    data64 = [t.contiguous() for t in _wbc_qp(cuda, torch.float64, batch)]
    H, g, Aeq, beq, Ain, bin_ = data64
    pad = lambda t: torch.nn.functional.pad(t, (0, 1))
    Hp = torch.nn.functional.pad(H, (0, 1, 0, 1))
    Hp[:, 38, 38] = torch.diagonal(H, dim1=-2, dim2=-1).mean(-1)
    padded64 = [Hp.contiguous(), pad(g), pad(Aeq), beq, pad(Ain), bin_]
    comp = qp.solve_qp(*[t.float() for t in data64], n_iters=10)
    gen = qp.solve_qp(*[t.float() for t in padded64], n_iters=10)
    torch.cuda.synchronize()
    _check_qp(gen, padded64, {}, 10)
    assert torch.equal(gen.x[:, 38], torch.zeros(batch, device=cuda))
    ref32 = qp.solve_qp_plain(*[t.float() for t in data64], n_iters=10)
    ref64 = qp.solve_qp_plain(*data64, n_iters=10)
    res_scale = 1.0 + torch.maximum(beq.abs().amax(-1), bin_.abs().amax(-1))
    for name, floor in (("x", 1e-30), ("eq_dual", 1e-30), ("ineq_dual", 1e-30),
                        ("primal_residual", 1.0)):
        a, b, p32, c = (getattr(r, name) for r in (gen, comp, ref32, ref64))
        if name == "x":
            a = a[:, :38]
        if name == "primal_residual":
            a, b, p32, c = (t / res_scale for t in (a, b, p32, c))
        limit = max(1e-4, 4.0 * _own_scale_err(p32, c, floor))
        assert _own_scale_err(a, b, floor) <= limit, name


@pytest.mark.cuda
@pytest.mark.parametrize("mi", [40, 1])
def test_solve_qp_kernel_hierarchical(cuda, mi):
    """The hierarchical WBC's shapes (n=38, me=1, mi=40: its level-0 torque
    and friction rows; mi=1: its placeholder row) on 64 seeded QPs
    (``entry.qp_batch``), 15 iterations, cold.  Their H is ill-conditioned
    (~1e6): mu_min is float32's for the float64 run too (both then run one
    algorithm), and the float32 plain error is its largest over the inputs
    and four one-ulp moves of them."""
    data64 = list(qp_batch(64, 1, mi, seed=0, device=cuda, dtype=torch.float64))
    kw = dict(mu_min=float(torch.finfo(torch.float32).eps) * 50.0)
    got = qp.solve_qp(*[t.float() for t in data64], n_iters=15, **kw)
    torch.cuda.synchronize()
    _check_qp(got, data64, kw, 15, ulp_seeds=range(4))


@pytest.mark.cuda
@pytest.mark.parametrize("big", ["n", "me", "mi"])
def test_solve_qp_kernel_refuses_dims_above_64(cuda, big):
    dims = {"n": 38, "me": 28, "mi": 40, big: qp.MAX_DIM + 1}
    n, me, mi = dims["n"], dims["me"], dims["mi"]
    z = lambda *s: torch.zeros((2, *s), device=cuda)
    with pytest.raises(ValueError):
        qp.solve_qp(z(n, n) + torch.eye(n, device=cuda), z(n), z(me, n), z(me), z(mi, n),
                    z(mi) + 1.0, n_iters=2)


B5_TOL = 1e-4


def _random_lq(cuda, batch, n_knots, seed):
    rng = np.random.default_rng(seed)
    proj = sqp.project_knot_plain(sqp.SqpSettings(), *knot_data(rng, (batch, n_knots), cuda))
    A_t, B_t, d_t, qx_t, qw, Qxx_t, Qww, Qwx, E, e, P = [t.contiguous() for t in proj]
    lq = riccati.StageLQ(A=A_t, B=B_t, d=d_t, Qxx=Qxx_t, Qww=Qww, Qwx=Qwx, qx=qx_t, qw=qw)
    dx0 = torch.tensor(0.01 * rng.standard_normal((batch, NX)), dtype=torch.float32, device=cuda)
    return lq, E, P, e, dx0


def _b5_against_exact(lq, E, P, e, dx0):
    before = riccati.riccati_solve_parallel.launches
    got = riccati.riccati_solve_parallel(lq, E, P, e, dx0, 1e-6)
    torch.cuda.synchronize()
    assert riccati.riccati_solve_parallel.launches == before + 1
    lq32 = riccati.StageLQ(*(t.cpu() for t in lq))
    args32 = [t.cpu() for t in (E, P, e, dx0)]
    ref32 = riccati.riccati_solve_parallel_plain(lq32, *args32, 1e-6, exact=True)
    ref64 = riccati.riccati_solve_parallel_plain(riccati.StageLQ(*(t.double() for t in lq32)),
                                                 *(t.double() for t in args32), 1e-6,
                                                 exact=True)
    for name, a, b, c in zip(("K", "kff", "dxs", "dus"), got, ref32, ref64):
        a = a.cpu()
        assert torch.isfinite(a).all(), name
        assert _own_scale_err(a, c) <= max(B5_TOL, 2.0 * _own_scale_err(b, c)), name


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n_knots", [(1, 53), (1, 66), (3, 53)])
def test_riccati_parallel_kernel_random(cuda, batch, n_knots):
    _b5_against_exact(*_random_lq(cuda, batch, n_knots, seed=n_knots + batch))


@pytest.mark.cuda
@pytest.mark.parametrize("n_knots,horizon", [(53, 0.8), (66, 1.0)])
def test_riccati_parallel_kernel_main_path(cuda, n_knots, horizon):
    _b5_against_exact(*projected_lq(build_flagship(n_knots, horizon, batch=1, device=cuda)))


@pytest.mark.cuda
def test_riccati_parallel_kernel_not_spd_gives_nan(cuda):
    """An indefinite Qww at knot 6: the knots whose gains depend on it, and
    the rollout after them, are NaN on the card as in the exact plain version."""
    lq, E, P, e, dx0 = _random_lq(cuda, 1, 20, seed=9)
    Qww = lq.Qww.clone()
    Qww[0, 6] = -1e3 * torch.eye(NU, device=cuda)
    lq = lq._replace(Qww=Qww)
    got = riccati.riccati_solve_parallel(lq, E, P, e, dx0, 1e-6)
    torch.cuda.synchronize()
    ref = riccati.riccati_solve_parallel_plain(riccati.StageLQ(*(t.cpu() for t in lq)),
                                               *(t.cpu() for t in (E, P, e, dx0)), 1e-6,
                                               exact=True)
    bad = torch.isnan(got[0].cpu()).flatten(2).any(-1)[0]
    assert torch.equal(bad, torch.isnan(ref[0]).flatten(2).any(-1)[0])
    assert bad[:6].all() and not bad[7:].any()
    for a, b in zip(got, ref):
        assert torch.equal(torch.isnan(a.cpu()), torch.isnan(b))


@pytest.mark.cuda
def test_riccati_parallel_kernel_refuses_bad_input(cuda):
    lq, E, P, e, dx0 = _random_lq(cuda, 1, 5, seed=1)
    with pytest.raises(TypeError):
        riccati.riccati_solve_parallel(riccati.StageLQ(*(t.double() for t in lq)), E, P, e, dx0,
                                       1e-6)
    with pytest.raises(ValueError):
        riccati.riccati_solve_parallel(lq._replace(A=lq.A.transpose(-1, -2)), E, P, e, dx0, 1e-6)


# B3 solves each knot exactly (a Cholesky of sym(Huu)), so it is held to the
# exact plain version (riccati_solver='gj') by B5's rule
B3_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n_knots,horizon", [(1, 53, 0.8), (128, 66, 1.0)])
def test_riccati_solve_kernel_main_path(cuda, batch, n_knots, horizon):
    """The flagship's cold-step LQ data (the card's own projection): each
    output within max(1e-4, 2 x the float32 exact plain version's error) of
    the float64 exact plain version, on its own scale; one launch."""
    flag = build_flagship(n_knots, horizon, batch=batch, device=cuda)
    lq, E, P, e, dx0 = projected_lq(flag)
    reg = flag.settings.hess_reg
    before = riccati.riccati_solve.launches
    got = riccati.riccati_solve(lq, E, P, e, dx0, reg)
    torch.cuda.synchronize()
    assert riccati.riccati_solve.launches == before + 1
    ref32 = riccati.riccati_solve_plain(lq, E, P, e, dx0, reg, solver="gj")
    ref64 = riccati.riccati_solve_plain(riccati.StageLQ(*(t.double() for t in lq)),
                                        *(t.double() for t in (E, P, e, dx0)), reg, solver="gj")
    for name, a, b, c in zip(("K", "kff", "dxs", "dus"), got, ref32, ref64):
        assert torch.isfinite(a).all(), name
        assert _own_scale_err(a, c) <= max(B3_TOL, 2.0 * _own_scale_err(b, c)), name


@pytest.mark.cuda
def test_riccati_solve_kernel_not_spd_gives_nan(cuda):
    """An indefinite Qww at knot 6 of 20: the sweep runs backward, so the
    gains of knots 0-6 are NaN and those after it finite; one launch."""
    lq, E, P, e, dx0 = _random_lq(cuda, 1, 20, seed=9)
    Qww = lq.Qww.clone()
    Qww[0, 6] = -1e3 * torch.eye(NU, device=cuda)
    before = riccati.riccati_solve.launches
    K, kff, dxs, dus = riccati.riccati_solve(lq._replace(Qww=Qww), E, P, e, dx0, 1e-6)
    torch.cuda.synchronize()
    assert riccati.riccati_solve.launches == before + 1
    assert torch.isnan(K[0, :7]).all() and torch.isnan(kff[0, :7]).all()
    assert torch.isfinite(K[0, 7:]).all() and torch.isfinite(kff[0, 7:]).all()
    assert torch.isnan(dxs[0, 1:]).all() and torch.isnan(dus[0]).all()


@pytest.mark.cuda
def test_riccati_solve_kernel_unaligned_inputs(cuda):
    """Inputs 4 bytes past a 16-byte boundary take the kernel's 4-byte
    copies in place of its 16-byte and bulk ones: the same outputs, bit
    for bit."""
    lq, E, P, e, dx0 = _random_lq(cuda, 2, 9, seed=3)

    def shifted(t):
        out = torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape)
        out.copy_(t)
        return out

    got = riccati.riccati_solve(riccati.StageLQ(*(shifted(t) for t in lq)),
                                *(shifted(t) for t in (E, P, e, dx0)), 1e-6)
    ref = riccati.riccati_solve(lq, E, P, e, dx0, 1e-6)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_riccati_solve_kernel_reused_gain_buffer(cuda):
    """Two different LQs in a row, the second's gains written into the
    buffer the allocator takes back from the first: the rollout's copies
    read this call's gains, so dxs and dus are within 2e-3 of the plain
    version and every output equals a run into fresh buffers, bit for bit."""
    first = _random_lq(cuda, 4, 30, seed=11)
    second = _random_lq(cuda, 4, 30, seed=12)
    fresh = riccati.riccati_solve(*second, 1e-6)
    out = riccati.riccati_solve(*first, 1e-6)
    torch.cuda.synchronize()
    ptr = out[0].data_ptr()
    del out
    got = riccati.riccati_solve(*second, 1e-6)
    torch.cuda.synchronize()
    assert got[0].data_ptr() == ptr
    ref = riccati.riccati_solve_plain(*second, 1e-6)
    for name, a, b in zip(("dxs", "dus"), got[2:], ref[2:]):
        assert rel_err(a, b) < 2e-3, name
    for a, b in zip(got, fresh):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_riccati_solve_kernel_refuses_bad_input(cuda):
    lq, E, P, e, dx0 = _random_lq(cuda, 1, 5, seed=1)
    with pytest.raises(TypeError):
        riccati.riccati_solve(riccati.StageLQ(*(t.double() for t in lq)), E, P, e, dx0, 1e-6)
    with pytest.raises(ValueError):
        riccati.riccati_solve(lq._replace(A=lq.A.transpose(-1, -2)), E, P, e, dx0, 1e-6)
    with pytest.raises(ValueError):
        riccati.riccati_solve(lq._replace(A=lq.A[..., :21, :21].contiguous()), E, P, e, dx0,
                              1e-6)


# ---------------------------------------------------------------------------
# B1: the SoA linearization and merit (csrc/soa_linearize.cu)
# ---------------------------------------------------------------------------

B1_TOL = 1e-4
LIN_NAMES = ("xnext", "A", "B", "cost", "qx", "qu", "Qxx", "Quu", "Qux", "g", "C", "D", "mask")


def _cast(tup, device, dtype):
    """A NamedTuple with its floating tensors on ``device`` in ``dtype``
    (index tensors and other fields as they are)."""
    return type(tup)(*(t.to(device, dtype) if torch.is_tensor(t) and t.is_floating_point()
                       else t for t in tup))


def _soa_problem(cuda, batch, n_knots, horizon, main_path, seed=0):
    """(model, settings, params, refs, xs, us) on the card, float32: the
    flagship's cold-step warm start and references (``main_path``) or random
    states, inputs, flags and references around the nominal pose."""
    flag = build_flagship(n_knots, horizon, batch=batch, device=cuda)
    st = flag.settings
    if main_path:
        sched = mpc_mod.ModeSchedule(*(a.expand(batch, *a.shape) for a in flag.schedule))
        target = mpc_mod.tg.TargetTrajectories(*(a.expand(batch, *a.shape) for a in flag.target))
        bundle, _, _, _ = mpc_mod.prepare_references(
            flag.model, st, flag.planner_cfg, flag.state.planner, sched, target,
            torch.zeros(batch, device=cuda), flag.x0, torch.zeros(batch, 6, device=cuda),
            flag.default_joints.expand(batch, -1))
        xs, us = mpc_mod._warm_start(flag.model, st, bundle, flag.state, flag.x0)
        return flag.model, st, flag.params, bundle, xs.contiguous(), us.contiguous()
    rng = np.random.default_rng(seed)
    K1 = n_knots + 1
    x0 = flag.x0[0].double().cpu().numpy()
    xs = x0 + np.concatenate([0.3 * rng.standard_normal((batch, K1, 6)),
                              0.02 * rng.standard_normal((batch, K1, 6)),
                              0.1 * rng.standard_normal((batch, K1, 10))], axis=-1)
    us = rng.standard_normal((batch, n_knots, 22)) * np.r_[np.full(12, 30.0), np.full(10, 1.0)]
    us[..., 2:12:3] += 30.0
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    bundle = sqp.ReferenceBundle(
        times=t(np.tile(np.arange(K1) * horizon / n_knots, (batch, 1))),
        x_nom=t(x0 + 0.01 * rng.standard_normal((batch, K1, 22))),
        contact_flags=t(rng.integers(0, 2, (batch, K1, 4)).astype(np.float64)),
        foot_pos_ref=t(0.1 * rng.standard_normal((batch, K1, 4, 3))),
        foot_vel_ref=t(0.1 * rng.standard_normal((batch, K1, 4, 3))))
    return flag.model, st, flag.params, bundle, t(xs), t(us)


def _plain_cpu(fn, problem, dtype, *extra):
    model, st, params, bundle, *arrays = problem
    return fn(_cast(model, "cpu", dtype), st, _cast(params, "cpu", dtype),
              _cast(bundle, "cpu", dtype), *(a.to("cpu", dtype) for a in arrays), *extra)


def _held_to_f64(got, ref32, ref64, names):
    for name, a, b, c in zip(names, got, ref32, ref64):
        a = a.cpu()
        assert torch.isfinite(a).all(), name
        assert _own_scale_err(a, c) <= max(B1_TOL, 2.0 * _own_scale_err(b, c)), name


def _candidates(problem, n_cand=2, seed=1):
    """Line-search-like candidates: the trajectory moved along a random
    direction by 1 and 0.25 of its step."""
    model, st, params, bundle, xs, us = problem
    g = torch.Generator(device="cpu").manual_seed(seed)
    dxs = (0.01 * torch.randn(xs.shape, generator=g)).to(xs.device)
    dus = (torch.randn(us.shape, generator=g) * 2.0).to(us.device)
    a = torch.tensor([1.0, 0.25, 0.0625][:n_cand], device=xs.device)[None, :, None, None]
    return (model, st, params, bundle, (xs[:, None] + a * dxs[:, None]).contiguous(),
            (us[:, None] + a * dus[:, None]).contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("main_path", [False, True], ids=["random", "main_path"])
@pytest.mark.parametrize("batch,n_knots,horizon", [(1, 53, 0.8), (128, 66, 1.0)])
def test_soa_linearize_kernel(cuda, batch, n_knots, horizon, main_path):
    problem = _soa_problem(cuda, batch, n_knots, horizon, main_path)
    before = soa_kernel.soa_linearize.launches
    got = sqp.knot_linearization_all(*problem)
    torch.cuda.synchronize()
    assert soa_kernel.soa_linearize.launches == before + 1
    ref32 = _plain_cpu(sqp.knot_linearization_all_plain, problem, torch.float32)
    ref64 = _plain_cpu(sqp.knot_linearization_all_plain, problem, torch.float64)
    _held_to_f64(got, ref32, ref64, LIN_NAMES)


@pytest.mark.cuda
@pytest.mark.parametrize("main_path", [False, True], ids=["random", "main_path"])
@pytest.mark.parametrize("batch,n_knots,horizon", [(1, 53, 0.8), (128, 66, 1.0)])
def test_soa_merit_kernel(cuda, batch, n_knots, horizon, main_path):
    problem = _candidates(_soa_problem(cuda, batch, n_knots, horizon, main_path))
    before = soa_kernel.soa_merit.launches
    got = sqp.eval_merit(*problem)
    torch.cuda.synchronize()
    assert soa_kernel.soa_merit.launches == before + 1
    ref32 = _plain_cpu(sqp.eval_merit_plain, problem, torch.float32)
    ref64 = _plain_cpu(sqp.eval_merit_plain, problem, torch.float64)
    _held_to_f64(got, ref32, ref64, ("cost", "metric"))


def _device_kernels(run):
    """The device kernels ``run()`` launches (names), recorded by the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
@pytest.mark.parametrize("n_cand", [1, 3])
@pytest.mark.parametrize("n_knots,horizon", [(53, 0.8), (66, 1.0), (7, 0.1)])
def test_soa_merit_kernel_candidates(cuda, n_cand, n_knots, horizon):
    """Any number of candidates, any N (7: not a multiple of the knots a
    block takes)."""
    problem = _candidates(_soa_problem(cuda, 3, n_knots, horizon, False), n_cand)
    got = sqp.eval_merit(*problem)
    torch.cuda.synchronize()
    assert got[0].shape == (3, n_cand)
    ref32 = _plain_cpu(sqp.eval_merit_plain, problem, torch.float32)
    ref64 = _plain_cpu(sqp.eval_merit_plain, problem, torch.float64)
    _held_to_f64(got, ref32, ref64, ("cost", "metric"))


@pytest.mark.cuda
@pytest.mark.parametrize("main_path", [False, True], ids=["random", "main_path"])
def test_soa_kernels_batch_256(cuda, main_path):
    problem = _soa_problem(cuda, 256, 53, 0.8, main_path)
    got = sqp.knot_linearization_all(*problem)
    torch.cuda.synchronize()
    ref32 = _plain_cpu(sqp.knot_linearization_all_plain, problem, torch.float32)
    ref64 = _plain_cpu(sqp.knot_linearization_all_plain, problem, torch.float64)
    _held_to_f64(got, ref32, ref64, LIN_NAMES)
    cand = _candidates(problem)
    got = sqp.eval_merit(*cand)
    torch.cuda.synchronize()
    ref32 = _plain_cpu(sqp.eval_merit_plain, cand, torch.float32)
    ref64 = _plain_cpu(sqp.eval_merit_plain, cand, torch.float64)
    _held_to_f64(got, ref32, ref64, ("cost", "metric"))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n_knots,horizon", [(1, 53, 0.8), (128, 66, 1.0)])
def test_soa_merit_kernel_same_bits(cuda, batch, n_knots, horizon):
    """The knots' sums in a fixed order: two launches on the same inputs
    give the same bits, as do other launches in between."""
    problem = _candidates(_soa_problem(cuda, batch, n_knots, horizon, True))
    first = [t.clone() for t in sqp.eval_merit(*problem)]
    other = _candidates(_soa_problem(cuda, batch, 7, 0.1, False), 3)
    sqp.eval_merit(*other)
    second = sqp.eval_merit(*problem)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["state", "input"])
def test_soa_merit_kernel_nan_knot(cuda, where):
    """A NaN in one knot of one scenario's candidate makes that (scenario,
    candidate) NaN and no other; the next launch is unaffected."""
    model, st, params, bundle, xs, us = _candidates(_soa_problem(cuda, 4, 53, 0.8, True), 3)
    clean = [t.clone() for t in sqp.eval_merit(model, st, params, bundle, xs, us)]
    xs, us = xs.clone(), us.clone()
    (xs if where == "state" else us)[2, 1, 17, 5] = float("nan")
    cost, metric = sqp.eval_merit(model, st, params, bundle, xs, us)
    torch.cuda.synchronize()
    bad = torch.zeros_like(cost, dtype=torch.bool)
    bad[2, 1] = True
    assert torch.isnan(cost[bad]).all() and torch.isnan(metric[bad]).all()
    assert torch.equal(cost[~bad], clean[0][~bad]) and torch.equal(metric[~bad], clean[1][~bad])
    again = sqp.eval_merit(model, st, params, bundle, *(a.clone() for a in (xs, us)))
    torch.cuda.synchronize()
    assert torch.isfinite(again[0][~bad]).all()


@pytest.mark.cuda
def test_soa_kernels_one_launch_per_call(cuda):
    problem = _soa_problem(cuda, 128, 66, 1.0, True)
    cand = _candidates(problem)
    sqp.knot_linearization_all(*problem), sqp.eval_merit(*cand)  # the buffers made
    for fn, args, counter, kernel in (
            (sqp.knot_linearization_all, problem, soa_kernel.soa_linearize, "soa_linearize"),
            (sqp.eval_merit, cand, soa_kernel.soa_merit, "soa_merit")):
        before = counter.launches
        names = _device_kernels(lambda: fn(*args))
        assert counter.launches == before + 1
        assert len(names) == 1 and kernel in names[0], names


@pytest.mark.cuda
def test_soa_kernel_refuses_other_topology(cuda):
    model, st, params, bundle, xs, us = _soa_problem(cuda, 1, 5, 0.1, False)
    bad = load_model(device="cpu")
    bad = bad._replace(joint_parent=torch.tensor([0, 1, 2, 3, 4, 0, 6, 7, 8, 8]))
    bad = _cast(bad, cuda, torch.float32)
    with pytest.raises(ValueError, match="topology"):
        sqp.knot_linearization_all(bad, st, params, bundle, xs, us)
    with pytest.raises(ValueError, match="topology"):
        sqp.eval_merit(bad, st, params, bundle, xs[:, None].contiguous(),
                       us[:, None].contiguous())


@pytest.mark.cuda
def test_soa_kernel_refuses_bad_input(cuda):
    model, st, params, bundle, xs, us = _soa_problem(cuda, 2, 5, 0.1, False)
    args = (model, params, xs, us, bundle.x_nom, bundle.contact_flags, bundle.foot_pos_ref,
            bundle.foot_vel_ref, 0.02)
    with pytest.raises(TypeError):
        soa_kernel.soa_linearize(*args[:2], xs.double(), *args[3:])
    with pytest.raises(ValueError):
        soa_kernel.soa_linearize(*args[:3], us.transpose(0, 1).contiguous().transpose(0, 1),
                                 *args[4:])
    with pytest.raises(TypeError):
        soa_kernel.soa_merit(*args[:2], xs[:, None].contiguous(), us[:, None].double(), *args[4:])


LEG_IK_TOL = 1e-4
DJ = [0.10, 0., 0.40, 0.93, 0.53, -0.10, 0., -0.40, 0.93, -0.53]


def _ik_inputs(cuda, batch, n_knots, horizon, main_path, seed=0):
    """(model, poses, warm_joints, des, R_des) on the card, float32: what
    the flagship's cold step gives ``joint_reference_ik`` (``main_path``),
    or seeded random base poses, warm joints within the joint limits, toe
    targets and target rotations around the standing pose."""
    flag = build_flagship(n_knots, horizon, batch=batch, device=cuda)
    if main_path:
        captured = {}
        real = ik_mod.joint_reference_ik

        def capture(*a, **k):
            captured.setdefault("args", a)
            return real(*a, **k)

        sched = mpc_mod.ModeSchedule(*(a.expand(batch, *a.shape) for a in flag.schedule))
        target = mpc_mod.tg.TargetTrajectories(*(a.expand(batch, *a.shape) for a in flag.target))
        ik_mod.joint_reference_ik = capture
        try:
            mpc_mod.prepare_references(
                flag.model, flag.settings, flag.planner_cfg, flag.state.planner, sched, target,
                torch.zeros(batch, device=cuda), flag.x0, torch.zeros(batch, 6, device=cuda),
                flag.default_joints.expand(batch, -1))
        finally:
            ik_mod.joint_reference_ik = real
        return captured["args"]
    rng = np.random.default_rng(seed)
    S = int(horizon / mpc_mod.JOINT_REF_STEP) + 1
    lo, hi = flag.model.joint_lower.cpu().numpy(), flag.model.joint_upper.cpu().numpy()
    poses = np.concatenate([0.02 * rng.standard_normal((batch, S, 3)) + [0.0, 0.0, 0.63],
                            0.1 * rng.standard_normal((batch, S, 3))], axis=-1)
    warm = np.clip(np.array(DJ) + 0.2 * rng.standard_normal((batch, 10)), lo, hi)
    des = (np.array([[0.03, 0.11, 0.0], [0.03, -0.11, 0.02]])
           + 0.05 * rng.standard_normal((batch, S, 2, 3)))
    R_des = rotation_zyx(torch.tensor(0.1 * rng.standard_normal((batch, 3))))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32).to(cuda).contiguous()
    return flag.model, t(poses), t(warm), t(des), t(R_des)


# the product shape (S=6), the bench shape (S=7), a ragged batch (B=3,
# S=5: 15 samples, the last warp's second half idle) and a wider one
# (B=256, S=6: 768 one-warp blocks)
LEG_IK_SHAPES = [(1, 53, 0.8), (128, 66, 1.0), (3, 40, 0.65), (256, 53, 0.8)]


@pytest.mark.cuda
@pytest.mark.parametrize("main_path", [False, True], ids=["random", "main_path"])
@pytest.mark.parametrize("batch,n_knots,horizon", LEG_IK_SHAPES)
def test_leg_ik_kernel(cuda, batch, n_knots, horizon, main_path):
    model, *arrays = _ik_inputs(cuda, batch, n_knots, horizon, main_path)
    assert arrays[0].shape[1] == int(horizon / mpc_mod.JOINT_REF_STEP) + 1
    before = ik_mod.leg_ik.launches
    got = ik_mod.joint_reference_ik(model, *arrays)
    torch.cuda.synchronize()
    assert ik_mod.leg_ik.launches == before + 1

    def plain(dtype):
        return ik_mod.joint_reference_ik_plain(_cast(model, "cpu", dtype),
                                               *(a.to("cpu", dtype) for a in arrays))

    ref32, ref64 = plain(torch.float32), plain(torch.float64)
    for name, a, b, c in zip(("qj1", "joint_refs"), got, ref32, ref64):
        a = a.cpu()
        assert a.shape == c.shape and torch.isfinite(a).all(), name
        assert _own_scale_err(a, c) <= max(LEG_IK_TOL, 2.0 * _own_scale_err(b, c)), name


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n_knots,horizon", LEG_IK_SHAPES)
def test_leg_ik_decisions(cuda, batch, n_knots, horizon):
    """The kernel's keep-if-improved tests, reported on request, leave the
    joints as they are and go the other way from the float64 plain
    version's on at most twice as many legs as the float32 plain version's,
    plus two."""
    model, *arrays = _ik_inputs(cuda, batch, n_knots, horizon, True)
    qj1, refs, kept = ik_mod.leg_ik(model, *arrays, with_decisions=True)
    bare = ik_mod.leg_ik(model, *arrays)
    assert torch.equal(qj1, bare[0]) and torch.equal(refs, bare[1])
    assert kept.shape == (2, 5, batch, arrays[0].shape[1], 2) and kept.dtype == torch.bool
    dec = {}
    for dtype in (torch.float32, torch.float64):
        d = []
        ik_mod.joint_reference_ik_plain(_cast(model, "cpu", dtype),
                                        *(a.to("cpu", dtype) for a in arrays), decisions=d)
        dec[dtype] = torch.stack([torch.stack(x) for x in d])

    def flipped_legs(d):
        return int((d != dec[torch.float64]).any(1).any(0).sum())

    assert flipped_legs(kept.cpu()) <= 2 * flipped_legs(dec[torch.float32]) + 2


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["pose", "target", "warm"])
def test_leg_ik_kernel_nan(cuda, where):
    """A NaN in one sample's pose, one leg's toe target or one warm joint
    (B=3, S=5) gives NaN in both passes where the float32 plain version has
    it (a NaN warm joint stays in its scenario's outputs; a NaN pose keeps
    its sample's warm joints), every other output finite."""
    model, poses, warm, des, R_des = _ik_inputs(cuda, 3, 40, 0.65, False, seed=5)
    if where == "pose":
        poses[1, 2, 4] = float("nan")
    elif where == "target":
        des[2, 4, 1, 0] = float("nan")
    else:
        warm[0, 7] = float("nan")
    got = ik_mod.joint_reference_ik(model, poses, warm, des, R_des)
    ref = ik_mod.joint_reference_ik_plain(_cast(model, "cpu", torch.float32), poses.cpu(),
                                          warm.cpu(), des.cpu(), R_des.cpu())
    for a, b in zip(got, ref):
        a = a.cpu()
        assert torch.equal(a.isnan(), b.isnan()), where
        assert bool(a.isnan().any()) == (where == "warm")
        if where == "pose":
            assert torch.equal(a[1, 2], warm[1].cpu())


@pytest.mark.cuda
def test_leg_ik_refuses_other_topology(cuda):
    _, *arrays = _ik_inputs(cuda, 1, 5, 0.3, False)
    bad = load_model(device="cpu")
    bad = bad._replace(joint_parent=torch.tensor([0, 1, 2, 3, 4, 0, 6, 7, 8, 8]))
    with pytest.raises(ValueError, match="topology"):
        ik_mod.joint_reference_ik(_cast(bad, cuda, torch.float32), *arrays)


@pytest.mark.cuda
def test_leg_ik_refuses_bad_input(cuda):
    model, poses, warm, des, R_des = _ik_inputs(cuda, 2, 5, 0.3, False)
    with pytest.raises(ValueError):
        ik_mod.leg_ik(model, poses.transpose(0, 1).contiguous().transpose(0, 1), warm, des,
                      R_des)
    with pytest.raises(TypeError):
        ik_mod.leg_ik(model, poses, warm.double(), des, R_des)


WBC_QP_TOL = 1e-4
WBC_QP_NAMES = ("H", "g", "Aeq", "beq", "Ain", "bin")


def _wbc_inputs(wb, dtype=torch.float32):
    """(model, params, x_des, u_des, rbd, flags, stance) of a WbcBatch in ``dtype``."""
    dev = wb.rbd.device
    return (_cast(wb.model, dev, dtype), _cast(wb.params, dev, dtype),
            *(t.to(dtype) for t in (wb.x_des, wb.u_des, wb.rbd, wb.contact_flags)),
            wb.stance_mode)


@pytest.mark.cuda
@pytest.mark.parametrize("walking", [False, True], ids=["standing", "walking"])
@pytest.mark.parametrize("batch", [1, 3, 4096])
def test_wbc_qp_kernel(cuda, batch, walking):
    wb = walking_wbc_batch(batch, cuda, seed=batch) if walking else build_wbc_batch(batch, cuda)
    args = _wbc_inputs(wb)
    before = wbc.wbc_qp.launches
    got = wbc.wbc_qp(*args)
    torch.cuda.synchronize()
    assert wbc.wbc_qp.launches == before + 1
    ref32 = wbc.wbc_qp_plain(*args)
    ref64 = wbc.wbc_qp_plain(*_wbc_inputs(wb, torch.float64))
    for name, a, b, c in zip(WBC_QP_NAMES, got, ref32, ref64):
        assert a.shape == c.shape and a.dtype == torch.float32, name
        assert torch.isfinite(a).all(), name
        assert _own_scale_err(a, c) <= max(WBC_QP_TOL, 2.0 * _own_scale_err(b, c)), name
    if walking and batch == 4096:
        assert wb.stance_mode.any() and not wb.stance_mode.all()
        assert len(torch.unique(wb.contact_flags, dim=0)) == 4


# (argument of wbc_qp, column) of the NaN: the measurement's base position,
# a joint, the angular velocity and a joint velocity; the desired momentum and
# a desired joint; a contact force and a joint velocity of u_des; a flag
WBC_NAN_CASES = {"base_pos": (4, 3), "joint": (4, 6), "omega": (4, 16), "joint_vel": (4, 22),
                 "x_des_momentum": (2, 1), "x_des_joint": (2, 15), "u_des_force": (3, 4),
                 "u_des_joint_vel": (3, 17), "flag": (5, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(WBC_NAN_CASES))
@pytest.mark.parametrize("batch", [8, 1024])
def test_wbc_qp_kernel_nan_rows(cuda, batch, case):
    """A NaN in one scenario's measurement, desired state or input, or
    contact flags gives NaN QP data in that scenario, in the rows where the
    plain version has NaN (and, for H and g, at the entries); in both of
    the kernel's launch shapes (four warps a scenario at B=8, one at
    B=1024)."""
    arg, col = WBC_NAN_CASES[case]
    wb = walking_wbc_batch(batch, cuda, seed=5)
    args = list(_wbc_inputs(wb))
    args[arg] = args[arg].clone()
    args[arg][3, col] = float("nan")
    got = wbc.wbc_qp(*args)
    ref = wbc.wbc_qp_plain(*args)
    torch.cuda.synchronize()

    def nan_rows(t):
        return torch.isnan(t).any(-1) if t.dim() == 3 else torch.isnan(t)

    for name, a, b in zip(WBC_QP_NAMES, got, ref):
        assert torch.equal(nan_rows(a), nan_rows(b)), name
        assert not nan_rows(a)[[0, 1, 2, 4, 5, 6, 7]].any(), name
        assert not nan_rows(a)[8:].any(), name
    for name, a, b in zip(WBC_QP_NAMES[:2], got[:2], ref[:2]):
        assert torch.equal(torch.isnan(a), torch.isnan(b)), name
    assert any(nan_rows(a)[3].any() for a in got)
    if arg == 4:
        assert nan_rows(got[3])[3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["in_place", "replaced"])
def test_wbc_qp_kernel_gain_change(cuda, change):
    """The kernel's gains buffer is kept per WbcParams and rebuilt when a
    gain changes in place or the WbcParams is replaced: the next QP is the
    one a fresh WbcParams with that gain gives, bit for bit."""
    wb = walking_wbc_batch(16, cuda, seed=2)
    args = list(_wbc_inputs(wb))
    before = wbc.wbc_qp(*args)[1].clone()
    params = args[1]
    fresh = args[:1] + [params._replace(**{f: getattr(params, f).clone()
                                           for f in wbc.GAIN_FIELDS})] + args[2:]
    fresh[1].swing_kp.mul_(2.0)
    if change == "in_place":
        params.swing_kp.mul_(2.0)
    else:
        args[1] = params._replace(swing_kp=2.0 * params.swing_kp)
    got = wbc.wbc_qp(*args)
    ref = wbc.wbc_qp(*fresh)
    torch.cuda.synchronize()
    assert not torch.equal(got[1], before)
    for name, a, b in zip(WBC_QP_NAMES, got, ref):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3])
def test_wbc_qp_kernel_outputs_aligned(cuda, batch):
    """The six outputs are contiguous, each at a 16-byte-aligned address (the
    kernel stores H, Aeq and Ain by 16 bytes), and B4 takes them as they are:
    its solution on them is its solution on copies."""
    wb = walking_wbc_batch(batch, cuda, seed=3)
    outs = wbc.wbc_qp(*_wbc_inputs(wb))
    for name, t in zip(WBC_QP_NAMES, outs):
        assert t.is_contiguous() and t.data_ptr() % 16 == 0, name
    sol = qp.solve_qp(*outs, n_iters=10)
    ref = qp.solve_qp(*(t.clone() for t in outs), n_iters=10)
    torch.cuda.synchronize()
    for a, b in zip(sol, ref):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
        assert torch.equal(a.isnan(), b.isnan())


@pytest.mark.cuda
def test_wbc_qp_kernel_refuses_bad_input(cuda):
    wb = walking_wbc_batch(4, cuda, seed=1)
    model, params, x_des, u_des, rbd, flags, stance = _wbc_inputs(wb)
    before = wbc.wbc_qp.launches
    with pytest.raises(TypeError):
        wbc.wbc_qp(model, params, x_des.double(), u_des, rbd, flags, stance)
    with pytest.raises(ValueError):
        wbc.wbc_qp(model, params, x_des.t().contiguous().t(), u_des, rbd, flags, stance)
    with pytest.raises(ValueError):
        wbc.wbc_qp(model, params, x_des, u_des[:, :21].contiguous(), rbd, flags, stance)
    with pytest.raises(TypeError):
        wbc.wbc_qp(model, params, x_des, u_des, rbd, flags, stance.float())
    bad = load_model(device="cpu")
    bad = _cast(bad._replace(joint_parent=torch.tensor([0, 1, 2, 3, 4, 0, 6, 7, 8, 8])), cuda,
                torch.float32)
    with pytest.raises(ValueError, match="topology"):
        wbc.wbc_qp(bad, params, x_des, u_des, rbd, flags, stance)
    assert wbc.wbc_qp.launches == before


SIM_TOL = 1e-4
SIM_NAMES = ("q", "v", "acc", "contact_forces")


def _sim_inputs(sb, dtype):
    """(model, params, q, v, active) of a SimBatch in ``dtype``, the active
    command read from its ring."""
    dev = sb.state.q.device
    params = fullorder.SimParams(*(a.to(dtype) if torch.is_tensor(a) else a for a in sb.params))
    state = sb.state._replace(**{f: getattr(sb.state, f).to(dtype) for f in
                                 ("q", "v", "t", "base_acc", "contact_forces", "cmd_buffer")})
    cmd = type(sb.command)(*(c.to(dtype) for c in sb.command))
    _, _, active = fullorder._push_command(params, state, cmd)
    return _cast(sb.model, dev, dtype), params, state.q, state.v, active.contiguous()


def _sim_held(sb):
    """The kernel against the float32 and float64 plain versions: per output
    (kernel error, float32 plain error) outside the flipped scenarios, and
    the flipped scenarios of the kernel and of the float32 plain version."""
    args32 = _sim_inputs(sb, torch.float32)
    got = fullorder.substeps(*args32, with_decisions=True)
    args64 = _sim_inputs(sb, torch.float64)
    dec32, dec64 = [], []
    ref32 = fullorder.substeps_plain(*args32, decisions=dec32)
    ref64 = fullorder.substeps_plain(*args64, decisions=dec64)
    torch.cuda.synchronize()
    d64 = torch.stack(dec64, 1)
    flip_k = (got[4] != d64).flatten(1).any(-1)
    flip_p = (torch.stack(dec32, 1) != d64).flatten(1).any(-1)
    keep = ~(flip_k | flip_p)
    errs = {n: (_own_scale_err(a[keep], c[keep]), _own_scale_err(b[keep], c[keep]))
            for n, a, b, c in zip(SIM_NAMES, got[:4], ref32, ref64)}
    return got, errs, int(flip_k.sum()), int(flip_p.sum())


def _sim_case(cuda, batch, knobs=True):
    """The sim loop's standing robot under a PD hold at its joints (B=1), or
    ``entry.sim_step_batch``'s sweep states (per-scenario mass scale and
    field, or with ``knobs`` False none)."""
    if batch == 1:
        setup = build_sim_loop(cuda)
        st = setup.state.plant
        zeros = torch.zeros((1, 10), device=cuda)
        cmd = JointCommand(st.q[:, 6:], zeros, torch.full_like(zeros, 40.0),
                           torch.full_like(zeros, 2.0), zeros)
        return SimBatch(setup.model, setup.sim_params, st, cmd)
    sb = sim_step_batch(batch, cuda, seed=3)
    if not knobs:
        sb = sb._replace(params=sb.params._replace(mass_scale=None, gravity_delta=None))
    return sb


def _sim_kernel_held(sb, batch):
    before = fullorder.sim_step.launches
    got, errs, flips, flips32 = _sim_held(sb)
    assert fullorder.sim_step.launches == before + 1
    for name, a in zip(SIM_NAMES, got[:4]):
        assert a.dtype == torch.float32 and torch.isfinite(a).all(), name
    for name, (e, e32) in errs.items():
        assert e <= max(SIM_TOL, 2.0 * e32), (name, e, e32)
    assert flips <= 2 * flips32 + 2, (flips, flips32)
    if batch >= 1024:
        share = got[4].float().mean().item()
        assert 0.2 < share < 0.8, share
    # without the decisions: the same launch, the same bits
    again = fullorder.substeps(*_sim_inputs(sb, torch.float32))
    torch.cuda.synchronize()
    for name, a, b in zip(SIM_NAMES, again, got[:4]):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 1024, 4096])
def test_sim_step_kernel(cuda, batch):
    """B=1 and 3 take four warps a scenario, 1024 and 4096 one (4096: a
    ragged last wave)."""
    _sim_kernel_held(_sim_case(cuda, batch), batch)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [3, 1024])
def test_sim_step_kernel_knobs_none(cuda, batch):
    """mass_scale and gravity_delta None: the wrapper hands the kernel 1 and 0."""
    _sim_kernel_held(_sim_case(cuda, batch, knobs=False), batch)


@pytest.mark.cuda
def test_sim_step_kernel_params_changed_in_place(cuda):
    """The wrapper keeps its fixed pointers per (model, SimParams, B): a
    SimParams tensor changed in place (the friction coefficient, the field)
    reaches the next launch, which equals a launch on a fresh SimParams."""
    sb = sim_step_batch(64, cuda, seed=6)
    model, params, q, v, active = _sim_inputs(sb, torch.float32)
    before = fullorder.substeps(model, params, q, v, active)
    params.friction_mu.mul_(0.5)
    params.gravity_delta.add_(0.25)
    after = fullorder.substeps(model, params, q, v, active)
    fresh = params._replace(**{f: getattr(params, f).clone() for f in ("friction_mu",
                                                                        "gravity_delta")})
    ref = fullorder.substeps(model, fresh, q, v, active)
    torch.cuda.synchronize()
    assert not torch.equal(after[1], before[1])
    for name, a, b in zip(SIM_NAMES, after, ref):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_sim_step_wrapper_launches_once(cuda):
    """sim_step on the card: the ring in torch and one kernel launch.  Its
    q, v, base_acc and contact forces are those of the held launch on the
    same inputs bit for bit, which _sim_held holds to the float64 plain
    substeps within max(SIM_TOL, 2x the float32 plain version's error)
    outside the scenarios whose contact decisions flipped."""
    sb = sim_step_batch(64, cuda, seed=4)
    before = fullorder.sim_step.launches
    nxt = fullorder.sim_step(sb.model, sb.params, sb.state, sb.command)
    torch.cuda.synchronize()
    assert fullorder.sim_step.launches == before + 1
    buf, head, _ = fullorder._push_command(sb.params, sb.state, sb.command)
    assert torch.equal(nxt.cmd_buffer, buf) and torch.equal(nxt.buf_head, head)
    assert torch.equal(nxt.t, sb.state.t + sb.params.dt * sb.params.substeps)
    got, errs, flips, flips32 = _sim_held(sb)
    for name, b in (("q", got[0]), ("v", got[1]), ("base_acc", got[2][:, 0:6]),
                    ("contact_forces", got[3])):
        assert torch.equal(getattr(nxt, name), b), name
    for name, (e, e32) in errs.items():
        assert e <= max(SIM_TOL, 2.0 * e32), (name, e, e32)
    assert flips <= 2 * flips32 + 2, (flips, flips32)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["q", "v", "command", "mass_scale", "gravity_delta"])
@pytest.mark.parametrize("batch", [8, 1024])
def test_sim_step_kernel_nan(cuda, where, batch):
    """A NaN in scenario 3's q, v, command, mass scale or field, in turn:
    NaN where the float32 plain version has it, in every output."""
    sb = sim_step_batch(batch, cuda, seed=5)
    args = list(_sim_inputs(sb, torch.float32))
    if where in ("q", "v"):
        t = args[2 if where == "q" else 3].clone()
        t[3, 4 if where == "q" else 12] = float("nan")
        args[2 if where == "q" else 3] = t
    elif where == "command":
        t = args[4].clone()
        t[3, 2, 6] = float("nan")
        args[4] = t
    else:
        knob = getattr(args[1], where).clone()
        knob[3] = float("nan")
        args[1] = args[1]._replace(**{where: knob})
    got = fullorder.substeps(*args)
    ref = fullorder.substeps_plain(*args)
    torch.cuda.synchronize()
    others = [b for b in range(batch) if b != 3]
    for name, a, b in zip(SIM_NAMES, got, ref):
        assert torch.equal(torch.isnan(a), torch.isnan(b)), name
        assert not torch.isnan(a[others]).any(), name
    assert torch.isnan(got[0][3]).all()


@pytest.mark.cuda
def test_sim_step_kernel_refuses_bad_input(cuda):
    sb = sim_step_batch(4, cuda, seed=1)
    model, params, q, v, active = _sim_inputs(sb, torch.float32)
    before = fullorder.sim_step.launches
    with pytest.raises(TypeError):
        fullorder.substeps(model, params, q.double(), v, active)
    with pytest.raises(ValueError):
        fullorder.substeps(model, params, q[:, :15].contiguous(), v, active)
    with pytest.raises(ValueError):
        fullorder.substeps(model, params, q, v.t().contiguous().t(), active)
    with pytest.raises(ValueError):
        fullorder.substeps(model, params, q, v, active[:, :4].contiguous())
    bad = load_model(device="cpu")
    bad = _cast(bad._replace(joint_parent=torch.tensor([0, 1, 2, 3, 4, 0, 6, 7, 8, 8])), cuda,
                torch.float32)
    with pytest.raises(ValueError, match="topology"):
        fullorder.substeps(bad, params, q, v, active)
    assert fullorder.sim_step.launches == before


EST_TOL = 1e-4
EST_DT = 0.002
KF_SENSORS = ("zyx", "joint_pos", "joint_vel", "omega_world", "quat_xyzw", "linear_accel_local",
              "contact_flags")


def _observer_args(eb, dtype):
    return (_cast(eb.model, eb.rbd.device, dtype), _cast(eb.observer_params, eb.rbd.device, dtype),
            _cast(eb.observer, eb.rbd.device, dtype), eb.rbd.to(dtype), eb.cmd_torque.to(dtype),
            EST_DT)


def _observer_outputs(res):
    return (res[0].p_scg_z_last, res[0].est_forces, res[1])


def _kalman_args(eb, dtype):
    dev = eb.rbd.device
    return ((_cast(eb.model, dev, dtype), _cast(eb.kalman_params, dev, dtype),
             _cast(eb.kalman, dev, dtype)),
            {**{k: eb.sensors[k].to(dtype) for k in KF_SENSORS}, "dt": EST_DT})


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 4096, 4097])
def test_momentum_observer_kernel(cuda, batch):
    """B=3 and 4097 leave the last block partly empty (four scenarios a
    block)."""
    eb = estimator_batch(batch, cuda, seed=batch)
    before = (contact.momentum_observer_update.launches, linalg.gj_inverse.launches)
    got = _observer_outputs(contact.momentum_observer_update(*_observer_args(eb, torch.float32)))
    torch.cuda.synchronize()
    assert (contact.momentum_observer_update.launches,
            linalg.gj_inverse.launches) == (before[0] + 1, before[1])
    ref32 = _observer_outputs(contact.momentum_observer_plain(*_observer_args(eb, torch.float32)))
    ref64 = _observer_outputs(contact.momentum_observer_plain(*_observer_args(eb, torch.float64)))
    for name, a, b, c in zip(("p_scg_z", "est_forces", "tau_dist"), got, ref32, ref64):
        assert a.shape == (batch, 16) and a.dtype == torch.float32, name
        assert torch.isfinite(a).all(), name
        assert _own_scale_err(a, c) <= max(EST_TOL, 2.0 * _own_scale_err(b, c)), name


def _kalman_case(eb, case):
    """``entry.estimator_batch``'s inputs as they are ("walking"), from the
    first tick of a loop (``init_kalman_state``: x = 0, P = 100 I), or with
    every foot in swing (flags 0: every gate at high_suspect_number) or in
    stance (flags 1)."""
    if case == "first_tick":
        return eb._replace(kalman=kalman.init_kalman_state(eb.kalman.x_hat.shape[0],
                                                           eb.rbd.device, eb.rbd.dtype))
    if case in ("swing", "stance"):
        flags = eb.sensors["contact_flags"]
        fill = torch.zeros_like if case == "swing" else torch.ones_like
        return eb._replace(sensors={**eb.sensors, "contact_flags": fill(flags)})
    return eb


@pytest.mark.cuda
@pytest.mark.parametrize("batch, case", [(1, "walking"), (4096, "walking"), (1027, "walking"),
                                         (256, "first_tick"), (256, "swing"),
                                         (256, "stance")])
def test_kalman_update_kernel(cuda, batch, case):
    """B=1027 leaves a partial block (four scenarios a block)."""
    eb = _kalman_case(estimator_batch(batch, cuda, seed=batch + 1), case)
    args, kw = _kalman_args(eb, torch.float32)
    before = (kalman.kalman_update.launches, linalg.gj_inverse.launches)
    st, pos, vel = kalman.kalman_update(*args, **kw)
    torch.cuda.synchronize()
    assert (kalman.kalman_update.launches, linalg.gj_inverse.launches) == (before[0] + 1,
                                                                           before[1])
    assert torch.equal(pos, st.x_hat[:, 0:3]) and torch.equal(vel, st.x_hat[:, 3:6])
    assert st.feet_heights is args[2].feet_heights
    ref32 = kalman.kalman_update_plain(*args, **kw)[0]
    args64, kw64 = _kalman_args(eb, torch.float64)
    ref64 = kalman.kalman_update_plain(*args64, **kw64)[0]
    for name in ("x_hat", "P"):
        a, b, c = (getattr(r, name) for r in (st, ref32, ref64))
        assert a.shape == c.shape and a.dtype == torch.float32, name
        assert torch.isfinite(a).all(), name
        assert _own_scale_err(a, c) <= max(EST_TOL, 2.0 * _own_scale_err(b, c)), name
    # the xy conditioning as the float64 plain version decided it
    cond = (st.P[:, 0:2, 2:] == 0).flatten(1).all(-1)
    assert torch.equal(cond, (ref64.P[:, 0:2, 2:] == 0).flatten(1).all(-1))
    if batch > 1 and case == "walking":
        assert cond.any() and (~cond).any()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [8, 7, 4097])
@pytest.mark.parametrize("which", ["observer", "kalman"])
def test_estimator_kernels_nan(cuda, which, batch):
    """A NaN in one scenario's measurement gives NaN in that scenario's
    outputs where the plain version has it, and nowhere else (the filter's
    covariance does not depend on the measurement: it stays finite); B=7
    and 4097 leave the last block partly empty."""
    eb = estimator_batch(batch, cuda, seed=6)
    if which == "observer":
        rbd = eb.rbd.clone()
        rbd[3, 7] = float("nan")
        args = list(_observer_args(eb, torch.float32))
        args[3] = rbd
        got = _observer_outputs(contact.momentum_observer_update(*args))
        ref = _observer_outputs(contact.momentum_observer_plain(*args))
    else:
        args, kw = _kalman_args(eb, torch.float32)
        kw["joint_pos"] = kw["joint_pos"].clone()
        kw["joint_pos"][3, 2] = float("nan")
        got = kalman.kalman_update(*args, **kw)[0][:2]
        ref = kalman.kalman_update_plain(*args, **kw)[0][:2]
    torch.cuda.synchronize()
    others = [n for n in range(batch) if n != 3]
    for a, b in zip(got, ref):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert not torch.isnan(a[others]).any()
    assert torch.isnan(got[0][3]).any()


@pytest.mark.cuda
def test_estimator_kernels_refuse_bad_input(cuda):
    eb = estimator_batch(4, cuda, seed=7)
    model, op, ost, rbd, tau, dt = _observer_args(eb, torch.float32)
    (_, kp, kst), kw = _kalman_args(eb, torch.float32)
    before = (contact.momentum_observer_update.launches, kalman.kalman_update.launches)
    with pytest.raises(TypeError):
        contact.momentum_observer_update(model, op, ost, rbd.double(), tau, dt)
    with pytest.raises(ValueError):
        contact.momentum_observer_update(model, op, ost, rbd, tau[:, :9], dt)
    with pytest.raises(TypeError):
        kalman.kalman_update(model, kp, kst._replace(P=kst.P.double()), **kw)
    with pytest.raises(ValueError):
        kalman.kalman_update(model, kp, kst, **{**kw, "quat_xyzw": kw["quat_xyzw"][:, :3]})
    bad = load_model(device="cpu")
    bad = _cast(bad._replace(joint_parent=torch.tensor([0, 1, 2, 3, 4, 0, 6, 7, 8, 8])), cuda,
                torch.float32)
    with pytest.raises(ValueError, match="topology"):
        contact.momentum_observer_update(bad, op, ost, rbd, tau, dt)
    with pytest.raises(ValueError, match="topology"):
        kalman.kalman_update(bad, kp, kst, **kw)
    assert (contact.momentum_observer_update.launches,
            kalman.kalman_update.launches) == before


CF_TOL = 1e-4
CF_KERNELS = ("synth_imu", "rbd_to_centroidal", "dummy_step", "state_input_to_v")


def _cf_wrapper(name):
    return {"synth_imu": fullorder.synth_imu,
            "rbd_to_centroidal": centroidal.rbd_state_to_centroidal,
            "dummy_step": dummy.dummy_step, "state_input_to_v": centroidal.state_input_to_v}[name]


def _cf_run(name, cb, plain=False):
    """The outputs of kernel ``name`` (or its plain version) on the batch."""
    if name == "synth_imu":
        fn = fullorder.synth_imu_plain if plain else fullorder.synth_imu
        return fn(cb.model, cb.plant, with_omega_world=True)
    if name == "rbd_to_centroidal":
        fn = (centroidal.rbd_state_to_centroidal_plain if plain
              else centroidal.rbd_state_to_centroidal)
        return (fn(cb.model, cb.rbd),)
    if name == "dummy_step":
        fn = dummy.dummy_step_plain if plain else dummy.dummy_step
        return (fn(cb.model, dummy.init_dummy_plant(cb.x, 0.1), cb.u, EST_DT).x,)
    if plain:
        v = centroidal.state_input_to_v_plain(cb.model, cb.x, cb.u)
        return v, centroidal.q_v_to_rbd_state(cb.model, centroidal.state_to_q(cb.x), v)
    return centroidal.state_input_to_v(cb.model, cb.x, cb.u, with_rbd=True)


def _cf_cast(cb, dtype):
    return cb._replace(model=_cast(cb.model, cb.x.device, dtype),
                       plant=_cast(cb.plant, cb.x.device, dtype),
                       **{f: getattr(cb, f).to(dtype) for f in ("rbd", "x", "u")})


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4096])
@pytest.mark.parametrize("name", CF_KERNELS)
def test_centroidal_kernels(cuda, name, batch):
    cb = centroidal_batch(batch, cuda, seed=batch + 2)
    counter = _cf_wrapper(name)
    before = counter.launches
    got = _cf_run(name, cb)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref32 = _cf_run(name, cb, plain=True)
    ref64 = _cf_run(name, _cf_cast(cb, torch.float64), plain=True)
    for k, (a, b, c) in enumerate(zip(got, ref32, ref64)):
        assert a.shape == c.shape and a.dtype == torch.float32, (name, k)
        assert torch.isfinite(a).all(), (name, k)
        assert _own_scale_err(a, c) <= max(CF_TOL, 2.0 * _own_scale_err(b, c)), (name, k)


@pytest.mark.cuda
def test_synth_imu_reads_base_acc_by_row_stride(cuda):
    """The plant's base_acc is a (B, 6) view of a (B, 16) tensor: the kernel
    reads it by row stride and gives what it gives on a contiguous copy."""
    cb = centroidal_batch(64, cuda, seed=11)
    acc = cb.plant.base_acc
    assert acc.stride() == (16, 1)
    got = fullorder.synth_imu(cb.model, cb.plant, with_omega_world=True)
    dense = fullorder.synth_imu(cb.model, cb.plant._replace(base_acc=acc.contiguous()),
                                with_omega_world=True)
    torch.cuda.synchronize()
    for a, b in zip(got, dense):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CF_KERNELS)
def test_centroidal_kernels_nan(cuda, name):
    """A NaN in one scenario's state gives NaN in that scenario's outputs
    where the plain version has it, and nowhere else."""
    cb = centroidal_batch(8, cuda, seed=9)
    if name == "synth_imu":
        v = cb.plant.v.clone()
        v[3, 4] = float("nan")
        cb = cb._replace(plant=cb.plant._replace(v=v))
    elif name == "rbd_to_centroidal":
        rbd = cb.rbd.clone()
        rbd[3, 7] = float("nan")
        cb = cb._replace(rbd=rbd)
    else:
        x = cb.x.clone()
        x[3, 14] = float("nan")
        cb = cb._replace(x=x)
    got, ref = _cf_run(name, cb), _cf_run(name, cb, plain=True)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert not torch.isnan(a[[0, 1, 2, 4, 5, 6, 7]]).any()
    assert torch.isnan(got[-1][3]).any()


@pytest.mark.cuda
def test_centroidal_kernels_refuse_bad_input(cuda):
    cb = centroidal_batch(4, cuda, seed=10)
    before = [_cf_wrapper(n).launches for n in CF_KERNELS]
    with pytest.raises(TypeError):
        fullorder.synth_imu(cb.model, cb.plant._replace(q=cb.plant.q.double()))
    with pytest.raises(ValueError):
        fullorder.synth_imu(cb.model, cb.plant._replace(base_acc=cb.plant.base_acc[:, :3]))
    with pytest.raises(TypeError):
        centroidal.rbd_state_to_centroidal(cb.model, cb.rbd.double())
    with pytest.raises(ValueError):
        centroidal.rbd_state_to_centroidal(cb.model, cb.rbd[:, :31])
    with pytest.raises(TypeError):
        dummy.dummy_step(cb.model, dummy.init_dummy_plant(cb.x.double()), cb.u, EST_DT)
    with pytest.raises(ValueError):
        dummy.dummy_step(cb.model, dummy.init_dummy_plant(cb.x), cb.u[:3], EST_DT)
    with pytest.raises(TypeError):
        centroidal.state_input_to_v(cb.model, cb.x, cb.u.double())
    with pytest.raises(ValueError):
        centroidal.state_input_to_v(cb.model, cb.x[:, :21], cb.u)
    bad = load_model(device="cpu")
    bad = _cast(bad._replace(joint_parent=torch.tensor([0, 1, 2, 3, 4, 0, 6, 7, 8, 8])), cuda,
                torch.float32)
    with pytest.raises(ValueError, match="topology"):
        centroidal.rbd_state_to_centroidal(bad, cb.rbd)
    with pytest.raises(ValueError, match="topology"):
        dummy.dummy_step(bad, dummy.init_dummy_plant(cb.x), cb.u, EST_DT)
    with pytest.raises(ValueError, match="topology"):
        centroidal.state_input_to_v(bad, cb.x, cb.u)
    assert [_cf_wrapper(n).launches for n in CF_KERNELS] == before


PREP_TOL = 1e-4
# the decisions that move values (a phase, the windows' tests); a segment
# taken at a time equal to a node time is continuous either way
PREP_FLIP_DECISIONS = ("cmd_phase", "next_phase", "tail", "fresh", "sample_phase", "knot_phase")
PREP_GAITS = ("STANCE_GAIT", "TROT_GAIT", "FLYING_TROT_GAIT", "STANDING_TROT_GAIT")


def _prep_inputs(cuda, batch, n_knots, horizon, main_path, seed=0):
    """``swing_plan``'s arguments on the card, float32: the flagship's own
    (its shared schedule, target, command, default joints and init time
    broadcast by expand, as ``mpc_step`` hands them) for ``main_path``;
    else per scenario a schedule of one of four gaits tiled around t = 0 or
    t = 20 s, an init time mid-phase, on one of its events or near 20 s, a
    cmd_vel target made there, x_init, command and latest stance positions
    around the standing robot, the yaw lead and velocity feedback on; for
    ``main_path`` None, ``entry.swing_plan_edge_batch``'s schedules at the
    swing planner's edges (its own batch)."""
    if main_path is None:
        return swing_plan_edge_batch(cuda, horizon=horizon)
    flag = build_flagship(n_knots, horizon, batch=batch, device=cuda)
    S = int(horizon / mpc_mod.JOINT_REF_STEP) + 1
    if main_path:
        sched = ms.ModeSchedule(*(a.expand(batch, *a.shape) for a in flag.schedule))
        target = mpc_mod.tg.TargetTrajectories(*(a.expand(batch, *a.shape) for a in flag.target))
        return (flag.model, flag.planner_cfg, flag.state.planner, sched, target,
                torch.zeros((), device=cuda).expand(batch), flag.x0,
                torch.zeros(6, device=cuda).expand(batch, 6),
                flag.default_joints.expand(batch, -1), horizon, S)
    rng = np.random.default_rng(seed)
    events, modes, t0 = [], [], []
    for b in range(batch):
        base = 20.0 if b % 3 == 2 else 0.0
        sch = ms.tile_template(getattr(ms, PREP_GAITS[b % 4])("cpu"), base - horizon,
                               base + 4 * horizon)
        ev = sch.event_times
        t = {0: base + rng.uniform(0.01, 0.3), 1: float(ev[ev > base][rng.integers(0, 3)]),
             2: base + rng.uniform(0.0, 0.4)}[b % 3]
        events.append(ev)
        modes.append(sch.modes)
        t0.append(t)
    t0 = torch.tensor(t0, dtype=torch.float32)
    x = flag.x0.cpu() + torch.tensor(0.02 * rng.standard_normal((batch, 22)), dtype=torch.float32)
    cmd_vel = torch.tensor([0.25, 0.1, 0.0, 0.3]) + torch.tensor(
        0.05 * rng.standard_normal((batch, 4)), dtype=torch.float32)
    target = mpc_mod.tg.cmd_vel_to_target(cmd_vel, x, t0, horizon,
                                          mpc_mod.tg.default_cmd_vel_config(device="cpu"))
    cfg = flag.planner_cfg._replace(foothold_yaw_lead=torch.tensor(0.1, device=cuda),
                                    foothold_vel_fb=torch.tensor(0.3, device=cuda))
    latest = mpc_mod.swp.PlannerState(torch.tensor(0.1 * rng.standard_normal((batch, 4, 3)),
                                                   dtype=torch.float32, device=cuda))
    t = lambda a: a.to(cuda).contiguous()  # noqa: E731
    return (flag.model, cfg, latest, ms.ModeSchedule(t(torch.stack(events)), t(torch.stack(modes))),
            mpc_mod.tg.TargetTrajectories(*map(t, target)), t(t0), t(x),
            t(torch.tensor(0.2 * rng.standard_normal((batch, 6)), dtype=torch.float32)),
            flag.default_joints.expand(batch, -1), horizon, S)


def _to(a, dtype, device="cpu"):
    """A tensor or NamedTuple (nested ones too) on ``device``, floating
    tensors in ``dtype``."""
    if torch.is_tensor(a):
        return a.to(device, dtype) if a.is_floating_point() else a.to(device)
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(_to(t, dtype, device) for t in a))
    return a


def _plan_outputs(plan):
    return (plan.planner.latest_stance_position, *plan.refs[:3], *plan.refs[4:], *plan[2:])


def _split_empty_windows(outs, live):
    """B8b1's outputs with each per-phase one (B, 4, P1, ...) split into its
    live phases and the phases whose window is empty (``live`` false): an
    empty window's swing velocities divide by the 1e-6 s clamp on its length,
    so their error would set the live phases' limit."""
    res = []
    for t in outs:
        if t.dim() >= 3 and tuple(t.shape[:3]) == tuple(live.shape):
            m = live.reshape(*live.shape, *([1] * (t.dim() - 3)))
            res += [torch.where(m, t, 0.0), torch.where(m, 0.0, t)]
        else:
            res.append(t)
    return res


def _prep_check(got, p32, p64, dec_k, d32, d64, windows=False):
    """Decisions equal the float32 plain version's; every output within
    max(PREP_TOL, 2 x float32 plain's error) of float64 plain, entry errors
    over max(1, |entry|), outside the scenarios float32 flips; ``windows``:
    B8b1's outputs, the per-phase ones' live and empty windows apart."""
    got, p32, p64 = ([t.cpu().double() for t in ts] for ts in (got, p32, p64))
    if windows:
        live = p64[5] > p64[4]
        got, p32, p64 = (_split_empty_windows(ts, live) for ts in (got, p32, p64))
    dec_k, d32, d64 = ({n: t.cpu().long() for n, t in d.items()} for d in (dec_k, d32, d64))
    for n in d32:
        assert torch.equal(dec_k[n], d32[n]), n
    Bn = got[0].shape[0]
    flip = torch.zeros(Bn, dtype=torch.bool)
    for n in PREP_FLIP_DECISIONS:
        if n in d32:
            flip |= (d32[n] != d64[n]).reshape(Bn, -1).any(-1)
    keep = ~flip
    assert keep.sum() >= Bn // 2

    def err(a, b):
        a, b = a[keep], b[keep]
        return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())

    for k, (a, b, c) in enumerate(zip(got, p32, p64)):
        assert a.shape == c.shape and not torch.isnan(a[keep]).any(), k
        assert err(a, c) <= max(PREP_TOL, 2.0 * err(b, c)), (k, err(a, c), err(b, c))


@pytest.mark.cuda
@pytest.mark.parametrize("main_path", [False, True, None], ids=["seeded", "main_path", "edges"])
@pytest.mark.parametrize("batch,n_knots,horizon", [(1, 53, 0.8), (128, 66, 1.0)])
def test_prep_kernels(cuda, batch, n_knots, horizon, main_path):
    args = _prep_inputs(cuda, batch, n_knots, horizon, main_path)
    model, S = args[0], args[-1]
    batch = args[6].shape[0]
    plan, dec_k = mpc_mod.swing_plan(*args, with_decisions=True)
    _, jr = ik_mod.leg_ik(model, plan.poses, plan.warm, plan.des, plan.R_des)
    bundle, mod, kdec = mpc_mod.knot_refs(args[3], plan, args[5], horizon, n_knots, jr,
                                          with_decisions=True)
    torch.cuda.synchronize()
    d32, d64 = {}, {}
    p32 = mpc_mod.swing_plan_plain(*args, decisions=d32)
    p64 = mpc_mod.swing_plan_plain(*(_to(a, torch.float64) for a in args), decisions=d64)
    _prep_check(_plan_outputs(plan), _plan_outputs(p32), _plan_outputs(p64), dec_k, d32, d64,
                windows=True)
    # B8b2 alone, on the card's B8b1 and B8a outputs
    e32, e64 = {}, {}
    kargs = (args[3], plan, args[5], horizon, n_knots, jr)
    k32 = mpc_mod.knot_refs_plain(*kargs, decisions=e32)
    k64 = mpc_mod.knot_refs_plain(*(_to(a, torch.float64) for a in kargs), decisions=e64)
    _prep_check((*bundle, mod.states), (*k32[0], k32[1].states), (*k64[0], k64[1].states),
                kdec, e32, e64)
    assert plan.times.shape == (batch, S) and bundle.x_nom.shape == (batch, n_knots + 1, 22)
    assert mod.times is plan.times and mod.inputs is plan.inputs


@pytest.mark.cuda
def test_prep_reads_shared_inputs_by_stride(cuda):
    """Inputs broadcast by expand (batch stride 0) give the same bits as
    contiguous copies, in both kernels."""
    args = _prep_inputs(cuda, 128, 66, 1.0, True)
    assert args[3].event_times.stride(0) == 0 and args[4].states.stride(0) == 0

    def contiguous(a):
        if torch.is_tensor(a):
            return a.contiguous()
        return type(a)(*map(contiguous, a)) if hasattr(a, "_fields") else a

    flat = [contiguous(a) if k >= 2 else a for k, a in enumerate(args)]
    one, other = mpc_mod.swing_plan(*args), mpc_mod.swing_plan(*flat)
    assert all(torch.equal(a, b) for a, b in zip(_plan_outputs(one), _plan_outputs(other)))
    _, jr = ik_mod.leg_ik(args[0], one.poses, one.warm, one.des, one.R_des)
    k1 = mpc_mod.knot_refs(args[3], one, args[5], 1.0, 66, jr)
    k2 = mpc_mod.knot_refs(flat[3], one, flat[5], 1.0, 66, jr)
    assert all(torch.equal(a, b) for a, b in zip((*k1[0], k1[1].states), (*k2[0], k2[1].states)))


@pytest.mark.cuda
def test_prep_launches_once_per_step(cuda):
    """On the card an MPC step launches B8b1, B8a and B8b2 once each, and
    prepare_references returns the kernels' outputs."""
    flag = build_flagship(53, 0.8, batch=1, device=cuda)
    mpc = mpc_mod.Mpc(flag.model, flag.settings, flag.params, flag.planner_cfg)
    args = (flag.schedule, flag.target, 0.0, flag.x0, torch.zeros(6, device=cuda),
            flag.default_joints)
    counters = (mpc_mod.swing_plan, ik_mod.leg_ik, mpc_mod.knot_refs)
    before = [c.launches for c in counters]
    _, state, _ = mpc(flag.state, *args)
    mpc(state, *args)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 2, 2]
    sargs = _prep_inputs(cuda, 1, 53, 0.8, True)
    bundle, refs, mod, planner = mpc_mod.prepare_references(
        flag.model, flag.settings, *sargs[1:9])
    plan = mpc_mod.swing_plan(*sargs)
    assert torch.equal(refs.node_pos, plan.refs.node_pos) and bundle.x_nom.is_contiguous()
    assert torch.isfinite(bundle.x_nom).all() and torch.isfinite(mod.states).all()


@pytest.mark.cuda
def test_prep_refuses_bad_input(cuda):
    args = list(_prep_inputs(cuda, 2, 53, 0.8, False))
    with pytest.raises(TypeError):
        mpc_mod.swing_plan(*args[:6], args[6].double(), *args[7:])
    bad = list(args)
    bad[4] = bad[4]._replace(states=bad[4].states.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        mpc_mod.swing_plan(*bad)
    with pytest.raises(ValueError):
        mpc_mod.swing_plan(*args[:-1], 1)
    plan = mpc_mod.swing_plan(*args)
    _, jr = ik_mod.leg_ik(args[0], plan.poses, plan.warm, plan.des, plan.R_des)
    with pytest.raises(ValueError, match="contiguous"):
        mpc_mod.knot_refs(args[3], plan, args[5], 0.8, 53, jr.transpose(0, 1).contiguous()
                          .transpose(0, 1))
    flag = build_flagship(53, 0.8, batch=2, device=cuda)
    with pytest.raises(TypeError):
        mpc_mod.prepare_references(flag.model, flag.settings,
                                   *(_cast(a, cuda, torch.float64) if hasattr(a, "_fields")
                                     else a.double() for a in args[1:9]))


DDP_TOL = 1e-4
DDP_ROLL = ("xs", "us", "cost", "eq")


@pytest.fixture(scope="module")
def ddp_run():
    """The product shape's DDP solve on the card (B=1, 53 knots over 0.8 s,
    RK2, two iterations, warm-started by three SQP solves), every
    iteration's data captured."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    flag = build_flagship(53, 0.8, batch=1, device=dev)
    settings = ddp_mod.DdpSettings(n_iterations=2)
    its = []
    run = entry_ddp_solve(flag, settings, on_iteration=its.append)
    torch.cuda.synchronize()
    return flag, settings, run, its


def _roll_args(flag, run, it, closed, alphas):
    if closed:
        return (run.refs, flag.x0, it["xs"], it["us"], it["Ks"].contiguous(),
                it["kffs"].contiguous(), alphas)
    return (run.refs, flag.x0, run.warm.states, run.warm.inputs[:, :-1].contiguous(), None,
            None, alphas[:1])


def _roll_own_err(got, ref):
    """max |got - ref| over max(1, max |ref|), on the CPU in float64."""
    got, ref = got.cpu().double(), ref.cpu().double()
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["RK2", "RK4", "ODE45"])
def test_ddp_rollout_kernel(cuda, ddp_run, integrator):
    """B15 on the first iteration's closed-loop rollouts (six step sizes):
    each output within max(1e-4, 2 x the float32 plain version's error) of
    the float64 plain version (on the CPU), ODE45's accepted slots equal to
    the float32 plain version's."""
    flag, settings, run, its = ddp_run
    rs = ddp_mod.rollout_settings(settings._replace(integrator=integrator))
    args = _roll_args(flag, run, its[0], True, torch.tensor(settings.alphas, device=cuda))
    before = ddp_mod.closed_rollout.launches
    got = ddp_mod.closed_rollout(flag.model, flag.params, *args, rs)
    torch.cuda.synchronize()
    assert ddp_mod.closed_rollout.launches == before + 1
    ref32 = ddp_mod.closed_rollout_plain(flag.model, flag.params, *args, rs)
    f64 = build_flagship(53, 0.8, batch=1, device="cpu", dtype=torch.float64)
    args64 = (_cast(args[0], "cpu", torch.float64),) + tuple(t.cpu().double() for t in args[1:])
    ref64 = ddp_mod.closed_rollout_plain(f64.model, f64.params, *args64, rs)
    for name, a, b, c in zip(DDP_ROLL, got, ref32, ref64):
        assert a.shape == c.shape and a.dtype == torch.float32, name
        assert torch.isfinite(a).all(), name
        assert _roll_own_err(a, c) <= max(DDP_TOL, 2.0 * _roll_own_err(b, c)), name
    assert torch.equal(got[4].cpu(), ref32[4].cpu())
    assert (got[4] > 0).all() == (integrator == "ODE45")


@pytest.mark.cuda
def test_ddp_rollout_kernel_open_loop(cuda, ddp_run):
    """The re-roll (no feedback, u = us_bar): inputs copied exactly, states
    within max(1e-4, 2 x the float32 plain version's error)."""
    flag, settings, run, its = ddp_run
    rs = ddp_mod.rollout_settings(settings)
    args = _roll_args(flag, run, its[0], False, torch.tensor(settings.alphas, device=cuda))
    got = ddp_mod.closed_rollout(flag.model, flag.params, *args, rs)
    ref32 = ddp_mod.closed_rollout_plain(flag.model, flag.params, *args, rs)
    f64 = build_flagship(53, 0.8, batch=1, device="cpu", dtype=torch.float64)
    args64 = (_cast(args[0], "cpu", torch.float64), args[1].cpu().double(),
              args[2].cpu().double(), args[3].cpu().double(), None, None,
              args[6].cpu().double())
    ref64 = ddp_mod.closed_rollout_plain(f64.model, f64.params, *args64, rs)
    assert torch.equal(got[1][:, 0], args[3])
    for name, a, b, c in zip(DDP_ROLL, got, ref32, ref64):
        assert _roll_own_err(a, c) <= max(DDP_TOL, 2.0 * _roll_own_err(b, c)), name


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["x_init", "K", "x_nom"])
@pytest.mark.parametrize("integrator", ["RK2", "RK4", "ODE45"])
def test_ddp_rollout_kernel_nan(cuda, ddp_run, integrator, where):
    """A NaN in x_init, in one gain of one knot or in one knot's x_nom gives
    NaN where the plain version has it (x_nom's: the cost alone)."""
    flag, settings, run, its = ddp_run
    rs = ddp_mod.rollout_settings(settings._replace(integrator=integrator))
    args = list(_roll_args(flag, run, its[0], True, torch.tensor(settings.alphas, device=cuda)))
    if where == "x_init":
        args[1] = args[1].clone()
        args[1][0, 3] = float("nan")
    elif where == "K":
        args[4] = args[4].clone()
        args[4][0, 20, 14, 3] = float("nan")
    else:
        x_nom = args[0].x_nom.clone()
        x_nom[0, 30, 8] = float("nan")
        args[0] = args[0]._replace(x_nom=x_nom)
    got = ddp_mod.closed_rollout(flag.model, flag.params, *args, rs)
    ref = ddp_mod.closed_rollout_plain(flag.model, flag.params, *args, rs)
    for name, a, b in zip(DDP_ROLL, got, ref):
        assert torch.equal(torch.isnan(a), torch.isnan(b)), name
    assert torch.isnan(got[2]).all()


@pytest.fixture(scope="module")
def ddp_batch_runs(ddp_run):
    """B15's closed-loop rollout arguments at B=3 and B=128.  B=3: the
    product shape's DDP solve on the card at batch 3 (one iteration after
    three SQP solves), its first iteration.  B=128: the B=1 run's first
    iteration tiled, x_init moved per scenario by a seeded 1e-3 (every block
    reads its own copy; the flagship's own B=128 scenarios start far from
    the nominal state, where the first iteration's rollouts amplify
    rounding past the float32 plain version's own distance to float64)."""
    dev = torch.device("cuda")
    flag3 = build_flagship(53, 0.8, batch=3, device=dev)
    its = []
    run3 = entry_ddp_solve(flag3, ddp_mod.DdpSettings(n_iterations=1), on_iteration=its.append)
    flag, settings, run, its1 = ddp_run
    it = its1[0]
    g = torch.Generator(device="cpu").manual_seed(0)
    x0 = (flag.x0.cpu() + 1e-3 * torch.randn(128, 22, generator=g)).to(dev)
    tile = lambda t: t.expand(128, *t.shape[1:]).contiguous()  # noqa: E731
    refs = type(run.refs)(*(tile(t) for t in run.refs))
    torch.cuda.synchronize()
    return {3: (flag3, (run3.refs, flag3.x0, its[0]["xs"], its[0]["us"],
                        its[0]["Ks"].contiguous(), its[0]["kffs"].contiguous())),
            128: (flag, (refs, x0, tile(it["xs"]), tile(it["us"]), tile(it["Ks"]),
                         tile(it["kffs"])))}


# ten step sizes: two blocks of a scenario's rollouts (eight warps, then two)
ALPHAS_10 = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.7, 0.3, 0.05, 0.002)
# at B=128 the plain versions run on every 8th scenario
BATCH_STRIDE = 8


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["RK2", "RK4", "ODE45"])
@pytest.mark.parametrize("n_alpha", [1, 6, 10])
@pytest.mark.parametrize("batch", [3, 128])
def test_ddp_rollout_kernel_batches(cuda, ddp_run, ddp_batch_runs, batch, n_alpha, integrator):
    """B15 at B=3 and 128 with one, six and ten step sizes: each output
    within max(1e-4, 2 x the float32 plain version's error) of the float64
    plain version (on the CPU), each rollout on its scale max(1, max
    |plain|), over the rollouts whose float64 states stay finite and within
    1e3 (at B=128 every 8th scenario); ODE45's accepted slots equal to the
    float32 plain version's there; one launch."""
    _, settings, _, _ = ddp_run
    flag, roll = ddp_batch_runs[batch]
    rs = ddp_mod.rollout_settings(settings._replace(integrator=integrator))
    args = roll + (torch.tensor(ALPHAS_10[:n_alpha], device=cuda),)
    before = ddp_mod.closed_rollout.launches
    got = ddp_mod.closed_rollout(flag.model, flag.params, *args, rs)
    torch.cuda.synchronize()
    assert ddp_mod.closed_rollout.launches == before + 1
    sub = torch.arange(0, batch, BATCH_STRIDE if batch > 8 else 1, device=cuda)
    args = (type(args[0])(*(t[sub] for t in args[0])),) + tuple(t[sub] for t in args[1:6]) + (
        args[6],)
    got = tuple(t[sub] for t in got)
    ref32 = ddp_mod.closed_rollout_plain(flag.model, flag.params, *args, rs)
    f64 = build_flagship(53, 0.8, batch=1, device="cpu", dtype=torch.float64)
    args64 = (_cast(args[0], "cpu", torch.float64),) + tuple(t.cpu().double() for t in args[1:])
    ref64 = ddp_mod.closed_rollout_plain(f64.model, f64.params, *args64, rs)
    xs64 = ref64[0].flatten(2)
    held = torch.isfinite(xs64).all(-1) & (xs64.abs().amax(-1) <= 1e3)
    assert held.any()

    def per_roll(a, c):
        a, c = a.cpu().double(), c.cpu().double()
        a, c = (a[..., None], c[..., None]) if a.dim() == 2 else (a, c)
        return ((a - c).abs().flatten(2).amax(-1)
                / c.abs().flatten(2).amax(-1).clamp(min=1.0))[held].max().item()

    for name, a, b, c in zip(DDP_ROLL, got, ref32, ref64):
        assert a.shape == c.shape and a.dtype == torch.float32, name
        assert per_roll(a, c) <= max(DDP_TOL, 2.0 * per_roll(b, c)), name
    assert torch.equal(got[4].cpu()[held], ref32[4].cpu()[held])
    assert (got[4][held] > 0).all() == (integrator == "ODE45")


@pytest.mark.cuda
def test_ddp_rollout_kernel_open_loop_batch(cuda, ddp_run, ddp_batch_runs):
    """The re-roll at B=128: the product shape's warm start tiled, its
    inputs moved per scenario by a seeded 1e-3 N or rad/s (every block
    reads its own copy): inputs copied exactly, each output within
    max(1e-4, 2 x the float32 plain version's error) of the float64 plain
    version over the finite rollouts, the float32 plain error the largest
    over x_init and two one-ulp moves of it (chip_smoke's re-roll rule: the
    open loop amplifies rounding, one float32 run's error bounds no
    other's)."""
    flag, _ = ddp_batch_runs[128]
    _, settings, run, _ = ddp_run
    rs = ddp_mod.rollout_settings(settings)
    tile = lambda t: t.expand(128, *t.shape[1:]).contiguous()  # noqa: E731
    g = torch.Generator(device="cpu").manual_seed(1)
    us = tile(run.warm.inputs[:, :-1]) + (1e-3 * torch.randn(128, 53, 22, generator=g)).to(cuda)
    args = (type(run.refs)(*(tile(t) for t in run.refs)), tile(flag.x0),
            tile(run.warm.states), us, None, None,
            torch.tensor(settings.alphas[:1], device=cuda))
    got = ddp_mod.closed_rollout(flag.model, flag.params, *args, rs)
    assert torch.equal(got[1][:, 0], args[3])
    runs = [ddp_mod.closed_rollout_plain(flag.model, flag.params, *args, rs)]
    for seed in range(2):
        gm = torch.Generator(device=cuda).manual_seed(seed)
        x0 = args[1]
        moved = torch.nextafter(x0, x0 + torch.randint(-1, 2, x0.shape, generator=gm,
                                                       device=cuda) * 1e3)
        runs.append(ddp_mod.closed_rollout_plain(flag.model, flag.params, args[0], moved,
                                                 *args[2:], rs))
    f64 = build_flagship(53, 0.8, batch=1, device="cpu", dtype=torch.float64)
    args64 = (_cast(args[0], "cpu", torch.float64), args[1].cpu().double(),
              args[2].cpu().double(), args[3].cpu().double(), None, None,
              args[6].cpu().double())
    ref64 = ddp_mod.closed_rollout_plain(f64.model, f64.params, *args64, rs)
    held = torch.isfinite(ref64[0].flatten(2)).all(-1)
    for k, (name, a, c) in enumerate(zip(DDP_ROLL, got, ref64)):
        a, c = (t.cpu().double()[held] for t in (a, c))
        plain = max(_roll_own_err(r[k].cpu().double()[held], c) for r in runs)
        assert _roll_own_err(a, c) <= max(DDP_TOL, 2.0 * plain), name


@pytest.mark.cuda
def test_ddp_rollout_refuses_bad_input(cuda, ddp_run):
    flag, settings, run, its = ddp_run
    rs = ddp_mod.rollout_settings(settings)
    args = list(_roll_args(flag, run, its[0], True, torch.tensor(settings.alphas, device=cuda)))
    before = ddp_mod.closed_rollout.launches
    short = args[0]._replace(x_nom=args[0].x_nom[:, :-1].contiguous())
    bad = [(1, args[1].double(), TypeError),
           (3, torch.cat([args[3], args[3]], -1)[..., :22], ValueError),
           (5, None, ValueError), (0, short, ValueError),
           (6, args[6].double(), TypeError)]
    for i, value, err in bad:
        a = list(args)
        a[i] = value
        with pytest.raises(err):
            ddp_mod.closed_rollout(flag.model, flag.params, *a, rs)
    with pytest.raises(ValueError):
        ddp_mod.closed_rollout(flag.model, flag.params, *args, rs._replace(integrator="EULER"))
    assert ddp_mod.closed_rollout.launches == before


@pytest.mark.cuda
def test_ddp_lq_kernels(cuda, ddp_run):
    """B2 and B3 on the DDP's own data (d = 0, hess_reg 1e-5, the pivoting
    Gram inverse) against the plain projection and backward pass."""
    flag, settings, run, its = ddp_run
    sset = ddp_mod.sqp_settings(settings)
    (_, A, B, _, qx, qu, Qxx, Quu, Qux, g, C, D, m) = its[0]["lin"]
    pin = [t.contiguous() for t in (A, B, torch.zeros_like(qx), qx, qu, Qxx, Quu, Qux, g, C, D,
                                     m)]
    got = sqp.project_knot(sset, *pin)
    ref64 = sqp.project_knot_plain(sset, *[t.double() for t in pin])
    # the float32 plain error: the largest over the inputs and one-ulp moves
    # of them (but the mask): the Gram's toe and heel rows are nearly
    # dependent, and one float32 run's error does not bound another's
    runs = [sqp.project_knot_plain(sset, *pin)]
    for seed in range(4):
        g = torch.Generator(device=cuda).manual_seed(seed)
        moved = [torch.nextafter(t, t + torch.randint(-1, 2, t.shape, generator=g,
                                                       device=cuda) * 1e3)
                 for t in pin[:-1]]
        runs.append(sqp.project_knot_plain(sset, *moved, pin[-1]))
    for k, (a, c) in enumerate(zip(got, ref64)):
        plain = max(_own_scale_err(r[k], c) for r in runs)
        assert _own_scale_err(a, c) <= max(DDP_TOL, 2.0 * plain), k
    A_t, B_t, d_t, qx_t, qw, Qxx_t, Qww, Qwx, E, e, P = [t.float().contiguous() for t in ref64]
    lq = riccati.StageLQ(A=A_t, B=B_t, d=torch.zeros_like(qx_t), Qxx=Qxx_t, Qww=Qww, Qwx=Qwx,
                         qx=qx_t, qw=qw)
    zx = torch.zeros(1, 22, device=cuda)
    K, kff, _, _ = riccati.riccati_solve(lq, E, P, e, zx, settings.hess_reg)
    lq64 = riccati.StageLQ(*(t.double() for t in lq))
    K64, kff64, _, _ = riccati.backward_scan(lq64, torch.zeros(1, 22, 22, device=cuda,
                                                               dtype=torch.float64),
                                             zx.double(), settings.hess_reg, solver="gj")
    K32, kff32, _, _ = riccati.backward_scan(lq, torch.zeros(1, 22, 22, device=cuda), zx,
                                             settings.hess_reg, solver="gj")
    for a, b, c in ((K, K32, K64), (kff, kff32, kff64)):
        assert _own_scale_err(a, c) <= max(DDP_TOL, 2.0 * _own_scale_err(b, c))


@pytest.mark.cuda
def test_ddp_solve_on_card(cuda, ddp_run):
    """tests/test_ddp.py's properties on the card's solve, one launch of B1,
    B2, B3 and B15 per iteration and one re-roll per solve."""
    flag, settings, run, its = ddp_run
    sol = run.solution
    assert torch.isfinite(sol.states).all()
    assert float(sol.step_size) >= 0.5 and float(sol.constraint_violation) < 1e-3
    dt = settings.horizon / settings.n_intervals
    defects = sol.states[:, 1:] - sqp.rk2_step(flag.model, sol.states[:, :-1],
                                               sol.inputs[:, :-1], dt)
    assert float(defects.abs().max()) < 1e-4
    assert float((sol.states[..., 8] - 0.63).abs().max()) < 0.05
    counters = (soa_kernel.soa_linearize, sqp.project_knot, riccati.riccati_solve,
                ddp_mod.closed_rollout, soa_kernel.soa_merit)
    before = [c.launches for c in counters]
    ddp_mod.solve(flag.model, settings, flag.params, run.refs, flag.x0, run.warm.states,
                  run.warm.inputs[:, :-1])
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 2, 2, 3, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 4096])
def test_contact_class_kernel(cuda, batch):
    """B16's flags equal the float32 plain version's on the card, one launch
    per call."""
    cb = contact_class_batch(batch, cuda, seed=5)
    before = contact.contact_class.launches
    got = contact.contact_class(*cb)
    torch.cuda.synchronize()
    assert contact.contact_class.launches == before + 1
    ref = contact.contact_class_plain(*cb)
    for a, b in zip(got, ref):
        assert a.dtype == torch.bool and a.shape == (batch, 4)
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_contact_class_reads_shared_schedule_by_stride(cuda):
    cb = contact_class_batch(64, cuda, seed=6)
    shared = ms.ModeSchedule(event_times=cb.schedule.event_times[:1].expand(64, -1),
                             modes=cb.schedule.modes[:1].expand(64, -1))
    cb = cb._replace(schedule=shared)
    got = contact.contact_class(*cb)
    ref = contact.contact_class_plain(*cb._replace(schedule=ms.ModeSchedule(
        *(t.contiguous() for t in shared))))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_contact_class_refuses_bad_input(cuda):
    cb = contact_class_batch(8, cuda, seed=7)
    before = contact.contact_class.launches
    bad = [(cb._replace(tt=cb.tt.double()), TypeError),
           (cb._replace(schedule=cb.schedule._replace(modes=cb.schedule.modes.int())), TypeError),
           (cb._replace(est_forces=cb.est_forces[:, :12].contiguous()), ValueError),
           (cb._replace(cmd_contact=cb.cmd_contact.t().contiguous().t()), ValueError)]
    for args, err in bad:
        with pytest.raises(err):
            contact.contact_class(*args)
    assert contact.contact_class.launches == before
