"""Fixed-shape gait mode schedules.

Port of ``hunter_bipedal_control_tpu/gait/mode_schedule.py``.  A schedule
is a pair of fixed-size tensors padded with ``BIG_TIME`` event times.
Queries take a schedule with leading batch dims (..., MAX_PHASES) and query
times (..., K); the template tools (tile, rotate, scale, compact) take
templates and times with leading batch dims too.  Mode numbers:
FLY = 0, R = 1, L = 2, STANCE = 3, mapped to the contacts
[L_toe, R_toe, L_heel, R_heel].  MAX_PHASES = 56 holds ~4.5 s of flying
trot; ``compact_schedule`` keeps the window from saturating with history.
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


def STANDING_TROT_GAIT(device=None, dtype=torch.float32):
    return make_template(["L", "STANCE", "R", "STANCE"], [0.0, 0.25, 0.3, 0.55, 0.6],
                         device, dtype)


def FLYING_TROT_GAIT(device=None, dtype=torch.float32):
    return make_template(["L", "FLY", "R", "FLY"], [0.0, 0.15, 0.2, 0.35, 0.4], device, dtype)


def _lead(*xs):
    """Broadcast leading shape of tensors (or Python numbers) ``xs``."""
    return torch.broadcast_shapes(*(x.shape for x in xs if torch.is_tensor(x)))


def _last(x):
    """A time (a Python number or a tensor (...)) as a trailing-dim operand."""
    return x[..., None] if torch.is_tensor(x) else x


def _expand_template(template: GaitTemplate, lead) -> GaitTemplate:
    """The template's fields broadcast to the leading dims ``lead``."""
    lead = tuple(lead)
    return GaitTemplate(template.switching_times.expand(*lead, T_MAX + 1),
                        template.modes.expand(*lead, T_MAX), template.n_modes.expand(lead),
                        template.duration.expand(lead))


def searchsorted(sorted_seq, v, right: bool = False):
    """``jnp.searchsorted`` over the last dim: both operands promoted to their
    common dtype first, as JAX does."""
    dt = torch.promote_types(sorted_seq.dtype, v.dtype)
    return torch.searchsorted(sorted_seq.to(dt).contiguous(), v.to(dt).contiguous(), right=right)


def tile_template(template: GaitTemplate, start_time, final_time, lead_mode=STANCE,
                  lead_until=None) -> ModeSchedule:
    """Tile a periodic template over [start_time, final_time]
    (GaitSchedule::tileModeSequenceTemplate).  Times are Python numbers or
    tensors (...) and the template may carry the same leading dims.
    modes[0] (before t0) continues the template backwards, unless
    ``lead_until`` is given: then t0 = lead_until and the phase before it is
    ``lead_mode`` (the phase-transition stance of insertModeSequenceTemplate)."""
    t0 = start_time if lead_until is None else lead_until
    lead = _lead(template.switching_times[..., 0], template.modes[..., 0], template.n_modes,
                 t0, final_time)
    tmpl = _expand_template(template, lead)
    k = torch.arange(MAX_PHASES, device=tmpl.modes.device)
    n = tmpl.n_modes[..., None]
    cyc = torch.div(k, n, rounding_mode="floor")
    idx = k - cyc * n
    sw = tmpl.switching_times
    events = _last(t0) + cyc * tmpl.duration[..., None] + (torch.gather(sw, -1, idx) - sw[..., :1])

    modes_body = torch.gather(tmpl.modes, -1, idx)
    if lead_until is None:
        first_mode = torch.gather(tmpl.modes, -1, n - 1)
    else:
        first_mode = torch.full_like(modes_body[..., :1], lead_mode)

    valid = events <= _last(final_time) + 1e-9
    events = torch.where(valid, events, BIG_TIME)
    return ModeSchedule(event_times=events, modes=torch.cat([first_mode, modes_body], dim=-1))


def _cumsum(x):
    """Running sum over the last dim, added in order in x's dtype, as
    ``jnp.cumsum`` does (torch's CPU cumsum accumulates float32 in float64)."""
    out = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., i])
    return torch.stack(out, dim=-1)


def rotate_template(template: GaitTemplate, j) -> GaitTemplate:
    """Rotate a periodic template so that mode index ``j`` (a tensor (...))
    comes first: extending a live gait continues its pattern
    (GaitSchedule.cpp:126-161) instead of restarting at modes[0]."""
    lead = _lead(template.switching_times[..., 0], template.modes[..., 0], template.n_modes, j)
    tmpl = _expand_template(template, lead)
    n = tmpl.n_modes[..., None]
    i = torch.arange(T_MAX, device=tmpl.modes.device)
    src = torch.where(i < n, (i + j[..., None]) % torch.clamp(n, min=1), n - 1)
    sw = tmpl.switching_times
    dur = sw[..., 1:] - sw[..., :-1]
    dur_rot = torch.where(i < n, torch.gather(dur, -1, src), 0.0)
    sw = torch.cat([torch.zeros_like(dur[..., :1]), _cumsum(dur_rot)], dim=-1)
    return tmpl._replace(switching_times=sw, modes=torch.gather(tmpl.modes, -1, src))


def scale_template(template: GaitTemplate, scale) -> GaitTemplate:
    """Scale a template's period by ``scale``, a tensor (...) whose dtype the
    times promote to, as a JAX array's does (domain sweeps over cadence)."""
    sw, dur = template.switching_times, template.duration
    dt = torch.promote_types(sw.dtype, scale.dtype)
    return template._replace(switching_times=sw.to(dt) * scale[..., None].to(dt),
                             duration=dur.to(dt) * scale.to(dt))


def compact_schedule(schedule: ModeSchedule, keep_from) -> ModeSchedule:
    """Shift out the events strictly before ``keep_from`` (...), fixed shape
    (GaitSchedule's deque erase, GaitSchedule.cpp:94-121): without it a
    walking gait fills the MAX_PHASES window with history and the horizon
    tail degenerates to one single-support mode.  Queries at times >=
    keep_from are unchanged: the phase containing keep_from becomes phase 0."""
    ev = schedule.event_times
    k = searchsorted(ev, keep_from[..., None])
    idx = torch.arange(MAX_PHASES, device=ev.device)
    src = torch.clamp(idx + k, 0, MAX_PHASES - 1)
    events = torch.where(idx + k < MAX_PHASES, torch.gather(ev, -1, src), BIG_TIME)
    msrc = torch.clamp(torch.arange(MAX_PHASES + 1, device=ev.device) + k, 0, MAX_PHASES)
    return ModeSchedule(event_times=events, modes=torch.gather(schedule.modes, -1, msrc))


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
