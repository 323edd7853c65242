"""Where the time of one batched MPC step goes on the card.

    python -m hunter_bipedal_control_tpu_torch.profile_step [batch] [knots] [horizon]

Builds the flagship problem (default B=128, 66 knots over 1.0 s), runs a
cold and a warm step, then records one more warm step under
``torch.profiler`` and prints one JSON line: the step's wall time, the
device's busy time (sum of kernel and copy durations) and idle share, the
number of device launches, and the device time of the heaviest kernels.
"""
from __future__ import annotations

import json
import sys
import time


def profile_step(batch: int = 128, knots: int = 66, horizon: float = 1.0, top: int = 12):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .entry import build_flagship
    from .solver.mpc import Mpc

    flag = build_flagship(knots, horizon, batch=batch)
    mpc = Mpc(flag.model, flag.settings, flag.params, flag.planner_cfg)
    args = (flag.schedule, flag.target, 0.0, flag.x0,
            torch.zeros(6, device=flag.x0.device), flag.default_joints)
    _, state, _ = mpc(flag.state, *args)
    mpc(state, *args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        mpc(state, *args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    heavy = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:top]
    return {
        "phase": "profile", "device": torch.cuda.get_device_name(0), "batch": batch,
        "knots": knots, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_launches": sum(e.count for e in dev_events),
        "top_kernels": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                         "count": e.count} for e in heavy],
    }


if __name__ == "__main__":
    a = sys.argv[1:]
    print(json.dumps(profile_step(int(a[0]) if a else 128, int(a[1]) if len(a) > 1 else 66,
                                  float(a[2]) if len(a) > 2 else 1.0)))
