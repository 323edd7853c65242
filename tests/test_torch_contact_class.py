"""Port parity: kernel B16's plain version, the full-order loop's contact
classification (``estim/contact.py::contact_class_plain``), against the JAX
package's ``swing_windows``, ``phase_index_at_time``, ``classify_contact``
and ``early_late_contact_flags`` as its ``runtime/sim_loop.py`` (:172-202)
composes them, on ``entry.contact_class_batch``'s seeded schedules: ticks
on event times and one float32 ulp either side of them, NaN forces.  The
three outputs are decisions, so they must be equal, in float64 and in
float32.  The CPU wrapper is the plain version bit for bit and launches
nothing; the kernel's constants (the 9 ms early-contact margin, the 1e-6 s
clamp on a window's length) are the plain version's, rounded to float32.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunter_bipedal_control_tpu.estim import contact as jcon
from hunter_bipedal_control_tpu.gait import mode_schedule as jms
from hunter_bipedal_control_tpu_torch.entry import contact_class_batch
from hunter_bipedal_control_tpu_torch.estim import contact as tcon

B = 160


def _jax_class(batch, dtype):
    """The JAX package's classification at each scenario's tick, as its
    sim loop composes it (windows over [t - H, t + 2H] of the period)."""
    jp = jcon.default_contact_params(dtype)
    H = batch.horizon

    def one(ev, modes, tp, tt, est, cmd):
        sched = jms.ModeSchedule(event_times=ev, modes=modes)
        starts, stops, _ = jms.swing_windows(sched, tp - H, tp + 2 * H)
        p = jms.phase_index_at_time(sched, tt)
        ss = jnp.stack([starts[:, p], stops[:, p]], axis=1)
        est_contact = jcon.classify_contact(jp, est, cmd, ss, tt)
        frac = jnp.clip((tt - ss[:, 0]) / jnp.maximum(ss[:, 1] - ss[:, 0], 1e-6), 0.0, 1.0)
        early, late = jcon.early_late_contact_flags(None, est_contact, cmd, frac, ss[:, 1] - tt)
        return est_contact, early, late

    np_ = lambda t: t.numpy()  # noqa: E731
    return jax.jit(jax.vmap(one))(
        np_(batch.schedule.event_times), np_(batch.schedule.modes), np_(batch.t_period),
        np_(batch.tt), np_(batch.est_forces), np_(batch.cmd_contact))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_contact_class_plain_matches_jax(dtype):
    batch = contact_class_batch(B, "cpu", dtype, seed=3)
    got = tcon.contact_class_plain(*batch)
    ref = _jax_class(batch, jnp.float64 if dtype == torch.float64 else jnp.float32)
    for name, a, b in zip(("est_contact", "early", "late"), got, ref):
        assert a.dtype == torch.bool and a.shape == (B, 4), name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    # the batch reaches every branch: contacts both ways, early and late flags
    # set, NaN forces
    assert got[0].any() and not got[0].all() and got[1].any() and got[2].any()
    assert torch.isnan(batch.est_forces).any()


def test_contact_class_batch_ticks_on_events():
    """Four scenarios in five tick on an event time or one ulp beside it:
    the phase search takes each side of the event as torch.searchsorted
    (right) does."""
    batch = contact_class_batch(B, "cpu", torch.float32, seed=3)
    ev, tt = batch.schedule.event_times, batch.tt
    on = (ev == tt[:, None]).any(-1)
    below = (ev == torch.nextafter(tt, torch.tensor(np.inf))[:, None]).any(-1)
    above = (ev == torch.nextafter(tt, torch.tensor(-np.inf))[:, None]).any(-1)
    kind = torch.arange(B) % 5
    assert on[kind == 0].all() and below[kind == 1].all() and above[kind == 2].all()


def test_contact_class_cpu_wrapper_is_plain():
    batch = contact_class_batch(B, "cpu", torch.float32, seed=4)
    before = tcon.contact_class.launches
    got = tcon.contact_class(*batch)
    ref = tcon.contact_class_plain(*batch)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert tcon.contact_class.launches == before


def test_kernel_constants_match_the_plain_version():
    src = (Path(tcon.__file__).parents[1] / "csrc" / "reference_prep.cu").read_text()
    got = {n: float(np.float32(float(e)))
           for n, e in re.findall(r"(\w+) = static_cast<float>\(([-+.0-9e]+)\)", src)}
    assert got["EARLY_MARGIN"] == float(np.float32(0.009))
    assert got["DT_MIN"] == float(np.float32(1e-6))
    plain = Path(tcon.__file__).read_text()
    assert "time_to_stop > 0.009" in plain and "min=1e-6" in plain
