"""Device time by kernel and the device's idle share, for the launchers'
`--profile`."""
from __future__ import annotations

import torch


def profiler():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def report(prof, wall_s: float, prof_wall_s: float, top: int = 16) -> None:
    """Device time by kernel (summed over launches) and the device's idle
    share of the unprofiled wall time `wall_s` of the same work (one
    stream: kernels never overlap)."""
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side op; its kernels are listed on their own
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        rows.append((t / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if not busy_ms:
        raise RuntimeError("the profile recorded no device time")
    print(f"profile: device busy {busy_ms:.1f} ms; unprofiled wall "
          f"{wall_s * 1e3:.1f} ms, idle share {1 - busy_ms / (wall_s * 1e3):.3f}"
          f" (profiled wall {prof_wall_s * 1e3:.1f} ms)")
    for ms, n, key in rows[:top]:
        print(f"  {ms:9.2f} ms  {ms / busy_ms:6.1%}  x{n:<6d} {key[:90]}")
