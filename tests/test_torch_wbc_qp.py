"""Port parity: kernel B9's plain version, ``wbc/wbc.py::wbc_qp_plain``,
against the QP data that the JAX ``wbc_update`` hands ``solve_qp``, and the
routing of its wrapper ``wbc_qp``, on the CPU.

The JAX data are recorded by a stand-in for the name ``wbc.py`` calls
(``hunter_bipedal_control_tpu.wbc.wbc.solve_qp``), one scenario at a time
under ``jax.disable_jit()``; the JAX package is not changed.  B=3 perturbed
states as tests/test_torch_wbc.py builds them (three contact modes), walking,
in stance mode, and with both stance modes in one batch.  Each of the six
arrays (H, g, Aeq, beq, Ain, bin) within 1e-9 of its own scale (max |JAX|,
floored at 1) in float64 and 1e-4 in float32 (both sides float32).
``wbc_qp`` on CPU tensors is ``wbc_qp_plain`` bit for bit and launches
nothing; the wrapper refuses what its kernel does not take before any launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hunter_bipedal_control_tpu.wbc.wbc as jwbc
from hunter_bipedal_control_tpu.models.centroidal import q_v_to_rbd_state
from hunter_bipedal_control_tpu.models.robot import load_model as jload
from hunter_bipedal_control_tpu.ocp.problem import weight_compensating_input
from hunter_bipedal_control_tpu_torch import convert
from hunter_bipedal_control_tpu_torch.wbc import wbc as twbc

DJ = np.array([0.10, 0., 0.40, 0.93, 0.53, -0.10, 0., -0.40, 0.93, -0.53])
QNOM = np.concatenate([[0., 0., 0.63], np.zeros(3), DJ])
FLAGS = np.array([[1., 0., 1., 0.], [0., 1., 0., 1.], [1., 1., 1., 1.]])
B = 3
STANCE = {"walking": [False] * B, "stance": [True] * B, "mixed": [False, True, False]}
NAMES = ("H", "g", "Aeq", "beq", "Ain", "bin")
TOL = {torch.float64: 1e-9, torch.float32: 1e-4}


def scaled_err(got, ref):
    got = got.detach().double().numpy()
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


@pytest.fixture(scope="module")
def states():
    """(rbd, x_des, u_des) float64, as tests/test_torch_wbc.py draws them."""
    jm = jload(dtype=jnp.float64)
    rng = np.random.default_rng(20)
    q = QNOM + np.concatenate([0.01 * rng.standard_normal((B, 6)),
                               0.05 * rng.standard_normal((B, 10))], axis=1)
    v = 0.1 * rng.standard_normal((B, 16))
    rbd = np.asarray(jax.vmap(lambda a, b: q_v_to_rbd_state(jm, a, b))(q, v))
    x_des = np.concatenate([0.05 * rng.standard_normal((B, 6)), np.tile(QNOM, (B, 1))
                            + 0.02 * rng.standard_normal((B, 16))], axis=1)
    u_des = np.asarray(jax.vmap(lambda f: weight_compensating_input(jm, f, 22, jnp.float64))(
        FLAGS)) + np.concatenate([rng.standard_normal((B, 12)),
                                  0.2 * rng.standard_normal((B, 10))], axis=1)
    return rbd, x_des, u_des


def jax_qp_data(states, stance, jdtype):
    """The six arrays JAX's ``wbc_update`` passes ``solve_qp``, per scenario,
    stacked (numpy)."""
    rbd, x_des, u_des = states
    jm = jload(dtype=jdtype)
    params = jwbc.default_wbc_params(jdtype)
    state = jwbc.init_wbc_state(jdtype)
    seen, real = [], jwbc.solve_qp

    def record(*args, **kwargs):
        seen.append([np.asarray(a) for a in args[:6]])
        return real(*args, **kwargs)

    jwbc.solve_qp = record
    try:
        with jax.disable_jit():
            for i in range(B):
                a = [jnp.asarray(t[i], jdtype) for t in (x_des, u_des, rbd, FLAGS)]
                jwbc.wbc_update(jm, params, state, *a, jnp.asarray(STANCE[stance][i]))
    finally:
        jwbc.solve_qp = real
    assert len(seen) == B
    return [np.stack(arrs) for arrs in zip(*seen)]


def port_args(states, stance, dtype):
    rbd, x_des, u_des = states
    model = convert.from_numpy(jax.tree.map(np.asarray, jload(dtype=jnp.float64)), "cpu", dtype)
    params = twbc.default_wbc_params("cpu", dtype)
    arrays = [torch.tensor(a, dtype=dtype) for a in (x_des, u_des, rbd, FLAGS)]
    return (model, params, *arrays, torch.tensor(STANCE[stance]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("stance", list(STANCE))
def test_wbc_qp_plain_matches_jax(states, stance, dtype):
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    ref = jax_qp_data(states, stance, jdtype)
    got = twbc.wbc_qp_plain(*port_args(states, stance, dtype))
    for name, a, b in zip(NAMES, got, ref):
        assert a.dtype == dtype, name
        assert scaled_err(a, b) < TOL[dtype], name
    walk = ~torch.tensor(STANCE[stance])
    # the swing rows see the tasks only when walking
    assert (got[1].abs().amax(-1)[walk] > 1.0).all()


def test_wbc_qp_routes_cpu_to_plain(states):
    args = port_args(states, "mixed", torch.float32)
    before = twbc.wbc_qp.launches
    got = twbc.wbc_qp(*args)
    ref = twbc.wbc_qp_plain(*args)
    assert twbc.wbc_qp.launches == before
    for name, a, b in zip(NAMES, got, ref):
        assert a.device.type == "cpu" and torch.equal(a, b), name


def test_wbc_qp_refuses_what_the_kernel_does_not_take(states):
    """Off the CPU the wrapper checks before it builds or launches anything:
    a tensor that is not on the card, a batch that is not one leading dim,
    gains of the wrong shape."""
    model, params, x_des, u_des, rbd, flags, stance = port_args(states, "mixed", torch.float32)
    meta = [t.to("meta") for t in (x_des, u_des, rbd, flags, stance)]
    before = twbc.wbc_qp.launches
    with pytest.raises(ValueError, match="CUDA"):
        twbc.wbc_qp(model, params, *meta)
    with pytest.raises(ValueError, match="rbd_measured"):
        twbc.wbc_qp(model, params, *meta[:2], meta[2][None], *meta[3:])
    with pytest.raises(ValueError, match="torque_limits"):
        twbc.params_buffer(params._replace(torque_limits=params.torque_limits[:4]))
    assert twbc.params_buffer(params).shape == (twbc.N_PARAMS,)
    assert twbc.wbc_qp.launches == before
