"""Gait timeline management: template insertion + velocity-adaptive
switching (fixed shape, batched over leading dims).

Port of ``hunter_bipedal_control_tpu/gait/adaptive.py``:
  - GaitSchedule::insertModeSequenceTemplate (GaitSchedule.cpp:57-89):
    keep the timeline before the insert time, bridge with a
    phase-transition stance, then tile the new template.
  - SwitchedModelReferenceManager::walkGait / calculateVelAbs
    (SwitchedModelReferenceManager.cpp:185-249): stance <-> trot <->
    flying-trot levels on a 50-sample average velocity magnitude with
    thresholds 0.02 / 0.03 / 0.4 m/s.

The gait templates are made in float32, as the JAX package's template
constants are, and promote to the state's dtype where they meet it, so
that a float64 run sees the same event times as the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from ..models.spatial import rotation_zyx
from .mode_schedule import (BIG_TIME, MAX_PHASES, STANCE, STANCE_GAIT, T_MAX, TROT_GAIT,
                            GaitTemplate, ModeSchedule, compact_schedule, rotate_template,
                            scale_template, searchsorted, tile_template)

VEL_HISTORY = 50
PHASE_TRANSITION_STANCE_TIME = 0.1  # model_settings (task.info:11)


def _where(cond, a: ModeSchedule, b: ModeSchedule) -> ModeSchedule:
    """Per-scenario choice between two schedules; cond (...)."""
    return ModeSchedule(*(torch.where(cond[..., None], x, y) for x, y in zip(a, b)))


def insert_template(schedule: ModeSchedule, template: GaitTemplate, insert_time, final_time,
                    stance_time=PHASE_TRANSITION_STANCE_TIME) -> ModeSchedule:
    """Fixed-shape timeline splice: phases strictly before ``insert_time``
    (...) are kept; a stance bridge of ``stance_time`` follows; the
    template tiles from there to ``final_time``."""
    lead_until = insert_time + stance_time
    tiled = tile_template(template, insert_time, final_time, lead_mode=STANCE,
                          lead_until=lead_until)
    # the bridge phase [insert_time, lead_until) made explicit:
    #   events: [insert_t, lead_until, lead_until + d1, ...]
    #   modes : [STANCE (pre), STANCE (bridge), template...]
    new_events = torch.cat([insert_time.to(tiled.event_times.dtype)[..., None],
                            tiled.event_times[..., :-1]], dim=-1)
    new_modes = torch.cat([torch.full_like(tiled.modes[..., :2], STANCE),
                           tiled.modes[..., 1:-1]], dim=-1)

    ev = schedule.event_times
    n_keep = searchsorted(ev, insert_time[..., None])
    idx = torch.arange(MAX_PHASES, device=ev.device)
    from_old = idx < n_keep
    shifted = torch.clamp(idx - n_keep, 0, MAX_PHASES - 1)
    events = torch.where(from_old, ev, torch.gather(new_events, -1, shifted))
    modes_body = torch.where(from_old, schedule.modes[..., 1:],
                             torch.gather(new_modes[..., 1:], -1, shifted))
    return ModeSchedule(event_times=events,
                        modes=torch.cat([schedule.modes[..., :1], modes_body], dim=-1))


class GaitRunState(NamedTuple):
    """Persistent adaptive-gait state (gaitLevel_ + velocity history), (B, ...)."""

    schedule: ModeSchedule
    gait_level: torch.Tensor    # (B,) int64: 0 stance, 1 trot, 3 flying trot
    vel_history: torch.Tensor   # (B, VEL_HISTORY)
    hist_count: torch.Tensor    # (B,) int64 valid sample count
    gait_scale: torch.Tensor    # (B,) cadence scale for domain sweeps


def init_gait_run_state(batch: int = 1, device=None, dtype=torch.float32, start_time=0.0,
                        horizon=2.4, gait_scale=1.0) -> GaitRunState:
    dev = resolve_device(device)
    sched = tile_template(STANCE_GAIT(dev), start_time - horizon, start_time + horizon * 4)
    return GaitRunState(
        schedule=ModeSchedule(sched.event_times.to(dtype).expand(batch, MAX_PHASES).clone(),
                              sched.modes.expand(batch, MAX_PHASES + 1).clone()),
        gait_level=torch.zeros(batch, dtype=torch.int64, device=dev),
        vel_history=torch.zeros((batch, VEL_HISTORY), dtype=dtype, device=dev),
        hist_count=torch.zeros(batch, dtype=torch.int64, device=dev),
        gait_scale=torch.full((batch,), gait_scale, dtype=dtype, device=dev),
    )


def vel_abs_update(state: GaitRunState, vel_cmd, target_state):
    """calculateVelAbs (:229-249): blend commanded and reference velocity,
    yaw rate scaled by 1/3, 50-sample running average.  vel_cmd (B, 4),
    target_state (B, nx).  Returns (state, vel_avg (B,))."""
    v_cmd_w = (rotation_zyx(target_state[..., 9:12]) @ vel_cmd[..., 0:3, None])[..., 0]
    zero = torch.zeros_like(v_cmd_w[..., 0])
    v4_cmd = torch.stack([v_cmd_w[..., 0], v_cmd_w[..., 1], zero, vel_cmd[..., 3] / 3.0], dim=-1)
    vel_est = target_state[..., 0:6]
    v4_est = torch.stack([vel_est[..., 0], vel_est[..., 1], zero, vel_est[..., 3] / 3.0], dim=-1)
    vel_abs = torch.linalg.vector_norm(0.5 * v4_cmd + 0.5 * v4_est, dim=-1)

    hist = torch.cat([vel_abs[..., None], state.vel_history[..., :-1]], dim=-1)
    count = torch.clamp(state.hist_count + 1, max=VEL_HISTORY)
    vel_avg = hist.sum(-1) / torch.clamp(count, min=1)
    return state._replace(vel_history=hist, hist_count=count), vel_avg


def _insert_time(sched: ModeSchedule, init_time):
    """The next event time >= init_time (findInsertModeSequenceTemplateTimer),
    at most one second ahead."""
    ev = sched.event_times
    idx = searchsorted(ev, init_time[..., None])
    nxt = torch.gather(ev, -1, torch.clamp(idx, 0, MAX_PHASES - 1))
    insert_t = torch.where(idx < MAX_PHASES, nxt, init_time[..., None])[..., 0]
    return torch.minimum(insert_t, init_time + 1.0)


def walk_gait_switch(state: GaitRunState, vel_avg, init_time, final_time) -> GaitRunState:
    """walkGait (:185-217): hysteresis thresholds 0.02 / 0.03 / 0.4 m/s.
    (The reference's flying-trot branch updates gaitLevel_ without inserting
    the template — a latent no-op; this mirrors the effective behaviour of
    switching between stance and trot, and tracks level 3 for parity.)"""
    sched, level = state.schedule, state.gait_level
    dev = level.device
    insert_t = _insert_time(sched, init_time)

    to_stance = (vel_avg <= 0.02) & (level != 0)
    to_trot = (vel_avg > 0.03) & (vel_avg < 0.4) & (level != 1)
    to_fly = (vel_avg >= 0.4) & (level != 3)

    s = state.gait_scale
    sched_stance = insert_template(sched, scale_template(STANCE_GAIT(dev), s), insert_t,
                                   final_time)
    sched_trot = insert_template(sched, scale_template(TROT_GAIT(dev), s), insert_t, final_time)
    new_sched = _where(to_stance, sched_stance, _where(to_trot, sched_trot, sched))
    new_level = torch.where(to_stance, 0, torch.where(to_trot, 1, torch.where(to_fly, 3, level)))
    return state._replace(schedule=new_sched, gait_level=new_level)


def fixed_gait_switch(state: GaitRunState, vel_avg, init_time, final_time,
                      template: GaitTemplate, level_id: int) -> GaitRunState:
    """Stance <-> explicitly selected gait switching (the /gait_type toggle
    analog): walkGait's 0.02 / 0.03 hysteresis and next-event insertion, but
    the walking template is the caller's fixed choice."""
    sched, level = state.schedule, state.gait_level
    insert_t = _insert_time(sched, init_time)

    to_stance = (vel_avg <= 0.02) & (level != 0)
    to_walk = (vel_avg > 0.03) & (level != level_id)

    s = state.gait_scale
    sched_stance = insert_template(sched, scale_template(STANCE_GAIT(level.device), s),
                                   insert_t, final_time)
    sched_walk = insert_template(sched, scale_template(template, s), insert_t, final_time)
    new_sched = _where(to_stance, sched_stance, _where(to_walk, sched_walk, sched))
    new_level = torch.where(to_stance, 0, torch.where(to_walk, level_id, level))
    return state._replace(schedule=new_sched, gait_level=new_level)


def extend_schedule(state: GaitRunState, init_time, final_time,
                    template: GaitTemplate = None) -> GaitRunState:
    """Re-tile when the horizon outruns the stored window (the implicit
    re-tiling GaitSchedule::getModeSchedule performs at every query).

    Past phases older than one second before ``init_time`` are compacted
    away first (GaitSchedule's deque erase), keeping the fixed MAX_PHASES
    window on [init_time - 1, final_time]: without it the window saturates
    with history and walking collapses after ~MAX_PHASES half gait periods."""
    sched = compact_schedule(state.schedule, init_time - 1.0)
    ev = sched.event_times
    real = ev < BIG_TIME / 2
    last_event = torch.where(real, ev, -BIG_TIME).amax(-1)
    need = last_event < final_time
    level, s = state.gait_level, state.gait_scale
    dev = level.device

    def continuation(tmpl: GaitTemplate) -> GaitTemplate:
        """Rotate the template so that the extension continues the live
        pattern: match the (next, next-next) mode pair held in the
        schedule's mode padding against consecutive template modes (the
        pairs are unique for all shipped gaits; no match restarts at
        modes[0], as right after a gait switch)."""
        m = torch.clamp(real.sum(-1) - 1, min=0)
        mu1 = torch.gather(sched.modes, -1, torch.clamp(m + 1, 0, MAX_PHASES)[..., None])
        mu2 = torch.gather(sched.modes, -1, torch.clamp(m + 2, 0, MAX_PHASES)[..., None])
        n = tmpl.n_modes[..., None]
        i = torch.arange(T_MAX, device=dev)
        tm = tmpl.modes.expand(*mu1.shape[:-1], T_MAX)
        nxt = torch.gather(tm, -1, ((i + 1) % torch.clamp(n, min=1)).expand(tm.shape))
        match = (tm == mu1) & (nxt == mu2) & (i < n)
        j = torch.where(match.any(-1), torch.argmax(match.to(torch.int32), dim=-1), 0)
        return rotate_template(tmpl, j)

    # STRICT PARITY with the reference's latent no-op: walkGait's level-3
    # branch sets gaitLevel_ = 3 WITHOUT inserting the flying-trot template
    # (SwitchedModelReferenceManager.cpp:210-218), and getModeSchedule keeps
    # re-tiling the last *inserted* template, trot.  So above 0.4 m/s the
    # reference keeps trotting, and extensions here do too (levels 1 and 3
    # both continue trot).  ``template`` (e.g. FLYING_TROT_GAIT()) is an
    # explicitly selected fixed gait, the /gait_type toggle analog: the
    # extension then continues THAT pattern instead of the adaptive pair.
    walk = TROT_GAIT(dev) if template is None else template
    tmpl_walk = continuation(scale_template(walk, s))
    tmpl_stance = continuation(scale_template(STANCE_GAIT(dev), s))
    ext_stance = insert_template(sched, tmpl_stance, last_event, final_time + 2.4, 0.0)
    ext_walk = insert_template(sched, tmpl_walk, last_event, final_time + 2.4, 0.0)
    ext = _where(level == 0, ext_stance, ext_walk)
    return state._replace(schedule=_where(need, ext, sched))
