"""The port's sensor noise (``backends/sensor_noise.py``) against the JAX
package's, on the CPU.

- ``corrupt`` fed the JAX package's own standard-normal draws (its 8-way key
  split: seven draws and the next key) equals JAX's ``corrupt``, float64,
  1e-12, over a chain of ticks.
- With draws from the state's ``torch.Generator``, 4000 ticks meet the
  statistics of tests/test_sensor_noise.py:31-36 (gyro noise around a
  bounded bias, accelerometer and encoder spreads, a slow bias walk).
- The parameters and a noise state carry across by ``convert.from_numpy``;
  the loop with noisy sensing runs (``entry.build_sim_loop(noise=True)``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from hunter_bipedal_control_tpu.backends import sensor_noise as jsn
from hunter_bipedal_control_tpu_torch import convert
from hunter_bipedal_control_tpu_torch.backends import fullorder
from hunter_bipedal_control_tpu_torch.backends import sensor_noise as tsn
from hunter_bipedal_control_tpu_torch.entry import build_sim_loop, rt_commands, run_sim_loop
from hunter_bipedal_control_tpu_torch.models.spatial import zyx_to_quat
from hunter_bipedal_control_tpu_torch.ops import linalg, qp
from hunter_bipedal_control_tpu_torch.wbc import wbc

F64 = torch.float64


def jax_draws(key, dtype=jnp.float64):
    """The normal draws JAX's ``corrupt`` makes from ``key``, in its order."""
    keys = jax.random.split(key, 8)
    shapes = [(3,)] * 5 + [(10,)] * 2
    return [np.asarray(jax.random.normal(k, sh, dtype)) for k, sh in zip(keys[:7], shapes)]


def test_corrupt_matches_jax_on_its_draws():
    rng = np.random.default_rng(0)
    jp = jsn.default_sensor_noise_params(jnp.float64)
    tp = tsn.default_sensor_noise_params("cpu", F64)
    jst = jsn.init_noise_state(jp, 3, jnp.float64)
    tst = tsn.NoiseState(generator=torch.Generator(), gyro_bias=torch.tensor(
        np.asarray(jst.gyro_bias))[None], accel_bias=torch.tensor(np.asarray(jst.accel_bias))[None])
    for _ in range(5):
        zyx = rng.normal(0.0, 0.3, 3)
        quat = np.asarray(zyx_to_quat(torch.tensor(zyx)))
        om, acc = rng.normal(0.0, 1.0, 3), rng.normal(0.0, 3.0, 3) + [0., 0., 9.81]
        qj, vj = rng.normal(0.0, 0.5, 10), rng.normal(0.0, 2.0, 10)
        draws = [torch.tensor(d)[None] for d in jax_draws(jst.key)]
        jst, *jout = jsn.corrupt(jp, jst, *(jnp.asarray(a) for a in (quat, om, acc, qj, vj)),
                                 0.002)
        tst, *tout = tsn.corrupt(tp, tst, *(torch.tensor(a)[None] for a in (quat, om, acc, qj, vj)),
                                 0.002, draws=draws)
        for a, b in zip(tout + [tst.gyro_bias, tst.accel_bias],
                        jout + [jst.gyro_bias, jst.accel_bias]):
            np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)


def test_corrupt_statistics():
    """tests/test_sensor_noise.py:31-36's statistics on the port's own
    generator-driven draws (float32, 4000 ticks of 2 ms)."""
    p = tsn.default_sensor_noise_params("cpu")
    st = tsn.init_noise_state(p, 0, batch=1, device="cpu")
    quat = torch.tensor([[0., 0., 0., 1.]])
    omega, accel = torch.zeros(1, 3), torch.tensor([[0., 0., 9.81]])
    qj = vj = torch.zeros(1, 10)
    oms, acs, jps = [], [], []
    for _ in range(4000):
        st, _, om, ac, jp, _ = tsn.corrupt(p, st, quat, omega, accel, qj, vj, 0.002)
        oms.append(om)
        acs.append(ac)
        jps.append(jp)
    oms, acs, jps = torch.cat(oms), torch.cat(acs), torch.cat(jps)
    assert 0.01 < float(oms.std()) < 0.04
    assert abs(float(oms.mean())) < 0.02
    assert 0.05 < float(acs[:, 0].std()) < 0.2
    assert 2e-4 < float(jps.std()) < 1e-3
    assert float(st.gyro_bias.abs().max()) < 0.05


def test_noise_params_and_state_from_jax():
    jp = jsn.default_sensor_noise_params(jnp.float64)
    tp = convert.from_numpy(jax.tree.map(np.asarray, jp), "cpu", F64)
    own = tsn.default_sensor_noise_params("cpu", F64)
    for f in tsn.SensorNoiseParams._fields:
        assert torch.equal(getattr(tp, f), getattr(own, f)), f
    jst = jsn.init_noise_state(jp, 5, jnp.float64)
    tst = convert.from_numpy(jax.tree.map(lambda a: np.asarray(a)[None], jst), "cpu", F64)
    assert isinstance(tst.generator, torch.Generator)
    np.testing.assert_array_equal(tst.gyro_bias[0].numpy(), np.asarray(jst.gyro_bias))
    np.testing.assert_array_equal(tst.accel_bias[0].numpy(), np.asarray(jst.accel_bias))


def test_sim_loop_with_noisy_sensing_runs():
    """Two periods of the loop at a small horizon with the default noise:
    finite, the filter's base position within a few cm of the plant's, and
    on CPU tensors no kernel launched."""
    setup = build_sim_loop("cpu", noise=True, n_intervals=8, horizon=0.24, lin_backend="dense",
                           noise_seed=1)
    assert setup.state.noise is not None
    counters = (fullorder.sim_step, wbc.wbc_qp, qp.solve_qp, linalg.gj_inverse)
    before = [c.launches for c in counters]
    fin, telem = run_sim_loop(setup, rt_commands(2))
    assert [c.launches for c in counters] == before
    assert all(torch.isfinite(v.double()).all() for v in telem.values())
    assert float(telem["est_pos_err"].max()) < 0.05
    assert not bool(fin.emergency_stop.any())
    assert not torch.equal(fin.noise.gyro_bias, setup.state.noise.gyro_bias)
