"""Fixed-shape gait mode schedules.

Port of ``hunter_bipedal_control_tpu/gait/mode_schedule.py`` (the parts on
the MPC step's path).  A schedule is a pair of fixed-size tensors padded
with ``BIG_TIME`` event times.  Queries take a schedule with leading batch
dims (..., MAX_PHASES) and query times (..., K).  Mode numbers:
FLY = 0, R = 1, L = 2, STANCE = 3, mapped to the contacts
[L_toe, R_toe, L_heel, R_heel].
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device

MAX_PHASES = 56
NUM_FEET = 4

FLY, R_MODE, L_MODE, STANCE = 0, 1, 2, 3

MODE_CONTACTS = np.array(
    [
        [0.0, 0.0, 0.0, 0.0],  # FLY
        [0.0, 1.0, 0.0, 1.0],  # R
        [1.0, 0.0, 1.0, 0.0],  # L
        [1.0, 1.0, 1.0, 1.0],  # STANCE
    ]
)

BIG_TIME = 1e9
T_MAX = 8


class ModeSchedule(NamedTuple):
    """event_times (..., MAX_PHASES) padded with BIG_TIME; modes (..., MAX_PHASES+1) int64.

    Phase p covers [event_times[p-1], event_times[p]) with mode modes[p]."""

    event_times: torch.Tensor
    modes: torch.Tensor


class GaitTemplate(NamedTuple):
    """A periodic mode sequence template: switching_times (T_MAX+1,), modes (T_MAX,)."""

    switching_times: torch.Tensor
    modes: torch.Tensor
    n_modes: torch.Tensor
    duration: torch.Tensor


def make_template(mode_names, switching_times, device=None, dtype=torch.float32) -> GaitTemplate:
    dev = resolve_device(device)
    names = {"FLY": FLY, "R": R_MODE, "L": L_MODE, "STANCE": STANCE}
    modes = [names[m] if isinstance(m, str) else int(m) for m in mode_names]
    n = len(modes)
    st = list(map(float, switching_times))
    assert len(st) == n + 1
    pad_m = modes + [modes[-1]] * (T_MAX - n)
    pad_t = st + [st[-1]] * (T_MAX - n)
    return GaitTemplate(
        switching_times=torch.tensor(pad_t, dtype=dtype, device=dev),
        modes=torch.tensor(pad_m, dtype=torch.int64, device=dev),
        n_modes=torch.tensor(n, dtype=torch.int64, device=dev),
        duration=torch.tensor(st[-1] - st[0], dtype=dtype, device=dev),
    )


def STANCE_GAIT(device=None, dtype=torch.float32):
    return make_template(["STANCE"], [0.0, 0.5], device, dtype)


def TROT_GAIT(device=None, dtype=torch.float32):
    return make_template(["L", "R"], [0.0, 0.3, 0.6], device, dtype)


def tile_template(template: GaitTemplate, start_time, final_time) -> ModeSchedule:
    """Tile a periodic template over [start_time, final_time] (one schedule);
    the phase before start_time continues the template backwards."""
    dev = template.modes.device
    k = torch.arange(MAX_PHASES, device=dev)
    n = template.n_modes
    period = template.duration
    cyc = torch.div(k, n, rounding_mode="floor")
    idx = k - cyc * n
    events = start_time + cyc * period + (template.switching_times[idx] - template.switching_times[0])

    modes_body = template.modes[idx]
    first_mode = template.modes[n - 1]

    valid = events <= final_time + 1e-9
    events = torch.where(valid, events, torch.full_like(events, BIG_TIME))
    modes = torch.cat([first_mode[None], modes_body])
    return ModeSchedule(event_times=events, modes=modes)


def phase_index_at_time(schedule: ModeSchedule, t) -> torch.Tensor:
    """Phase of each query time: t (..., K) -> (..., K) int64."""
    return torch.searchsorted(schedule.event_times.contiguous(), t.contiguous(), right=True)


def mode_at_time(schedule: ModeSchedule, t) -> torch.Tensor:
    """modeAtTime: t (..., K) -> (..., K) mode numbers."""
    return torch.gather(schedule.modes, -1, phase_index_at_time(schedule, t))


def mode_contacts(dtype, device) -> torch.Tensor:
    return torch.as_tensor(MODE_CONTACTS, dtype=dtype, device=device)


def contact_flags_at_time(schedule: ModeSchedule, t, dtype=torch.float32) -> torch.Tensor:
    """(..., K, 4) contact flags at the query times t (..., K)."""
    return mode_contacts(dtype, t.device)[mode_at_time(schedule, t)]


def contact_sequence(schedule: ModeSchedule, dtype=torch.float32) -> torch.Tensor:
    """(..., 4, MAX_PHASES+1) per-leg contact flag per phase."""
    return mode_contacts(dtype, schedule.modes.device)[schedule.modes].transpose(-1, -2)


def swing_windows(schedule: ModeSchedule, horizon_start, horizon_end):
    """Per-leg, per-phase [start, stop] of the contiguous contact/swing window
    containing each phase.  horizon_start/end: (...).

    Returns (start_times, stop_times, contact_seq), each (..., 4, MAX_PHASES+1).
    The JAX package's associative max/min scans over marked flag-change
    boundaries are cumulative max/min here."""
    ev = schedule.event_times
    cs = contact_sequence(schedule, ev.dtype)                       # (..., 4, P1)
    P1 = cs.shape[-1]
    big = torch.full_like(ev[..., :1], BIG_TIME)
    starts_of_phase = torch.cat([horizon_start[..., None].to(ev.dtype), ev], dim=-1)
    ends_of_phase = torch.minimum(torch.cat([ev, big], dim=-1),
                                  horizon_end[..., None].to(ev.dtype))

    ps = torch.arange(P1, device=ev.device).expand(cs.shape)
    true1 = torch.ones_like(cs[..., :1], dtype=torch.bool)
    b_fwd = torch.cat([true1, cs[..., 1:] != cs[..., :-1]], dim=-1)
    idx_f = torch.cummax(torch.where(b_fwd, ps, -1), dim=-1).values
    b_bwd = torch.cat([cs[..., :-1] != cs[..., 1:], true1], dim=-1)
    idx_b = torch.cummin(torch.where(b_bwd, ps, P1).flip(-1), dim=-1).values.flip(-1)

    sop = starts_of_phase[..., None, :].expand(cs.shape)
    eop = ends_of_phase[..., None, :].expand(cs.shape)
    return torch.gather(sop, -1, idx_f), torch.gather(eop, -1, idx_b), cs
