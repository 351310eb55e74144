"""What a traced run reads from `torch.profiler`: the profiled iterations'
windows (the harness's `port_bench.iteration` ranges, each ending in a
synchronise), the device's kernel intervals inside them, the runtime's
launch calls, the device time of the program's `record_function` ranges,
and the breakdown the result line carries. The per-layer metric readers
(`metrics/`) read a `Trace`.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

ITERATION_RANGE = "port_bench.iteration"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch")
KERNEL_NAMES = {"tile_fwd": "tile_fwd_kernel", "tile_bwd": "tile_bwd_kernel",
                "expand": "expand_kernel", "segsum": "segsum_kernel"}
TOP = 10
# the profiler's own host events and the runtime calls under the operators
HOST_NOISE = ("Activity Buffer Request", "cuda", "cu")


@dataclass
class Trace:
    iterations: int
    wall_s: float                  # the profiled iterations' windows
    busy_s: float                  # union of device intervals inside them
    launches: int
    kernel_s: dict                 # KERNEL_NAMES key -> device seconds
    range_ms: dict                 # record_function range -> device ms
    device_ops: list               # [[name, seconds]] top device operations
    idle_gaps: list                # [[next host op, idle seconds]]
    iteration_ms: float = 0.0      # the same run's untraced window
    work: dict = field(default_factory=dict)   # tile kernel -> (bytes, ops)
    step_ops: float = 0.0          # FP32 operations of the iterations


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(intervals, windows):
    out = []
    for s, e in intervals:
        for ws, we in windows:
            a, b = max(s, ws), min(e, we)
            if b > a:
                out.append((a, b))
    return out


def analyse(prof, ranges=("rigidity_knn", "motion_mlp")) -> Trace:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    windows = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.name == ITERATION_RANGE
                     and e.device_type != cuda)
    if not windows:
        raise RuntimeError("the profile holds no profiled iteration")
    annotations = {e.name for e in events
                   if getattr(e, "is_user_annotation", False)}
    annotations.update(ranges)
    annotations.add(ITERATION_RANGE)
    device = [e for e in events if e.device_type == cuda
              and not getattr(e, "is_user_annotation", False)
              and e.name not in annotations]
    spans = _clip([(e.time_range.start, e.time_range.end) for e in device],
                  windows)
    busy = _union(spans)
    busy_us = sum(e - s for s, e in busy)
    wall_us = sum(e - s for s, e in windows)

    inside = lambda e: any(ws <= e.time_range.start < we
                           for ws, we in windows)
    launches = sum(1 for e in events if e.device_type != cuda
                   and e.name in LAUNCH_CALLS and inside(e))
    per_name = {}
    for e in device:
        if inside(e):
            per_name[e.name] = (per_name.get(e.name, 0.0)
                                + e.time_range.elapsed_us() * 1e-6)
    kernel_s = {k: sum(s for n, s in per_name.items() if v in n)
                for k, v in KERNEL_NAMES.items()}
    range_ms = {}
    for e in prof.key_averages():
        if e.key in ranges and e.device_type != cuda:
            range_ms[e.key] = range_ms.get(e.key, 0.0) + getattr(
                e, "device_time_total", 0.0) / 1e3
    device_ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]

    # each idle gap is put to the host operation that started next: what
    # the host was about to launch while the device waited
    host = sorted((e.time_range.start, e.name) for e in events
                  if e.device_type != cuda and e.name not in annotations
                  and not e.name.startswith(HOST_NOISE))
    starts = [s for s, _ in host]
    idle = {}

    def gap(a, b):
        i = bisect.bisect_left(starts, a)
        name = host[i][1] if i < len(host) else "no host operation"
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6

    for ws, we in windows:
        t = ws
        for s, e in busy:
            if ws <= s < we:
                if s > t:
                    gap(t, s)
                t = max(t, e)
        if we > t:
            gap(t, we)
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return Trace(iterations=len(windows), wall_s=wall_us * 1e-6,
                 busy_s=busy_us * 1e-6, launches=launches, kernel_s=kernel_s,
                 range_ms=range_ms,
                 device_ops=[[n, s] for n, s in device_ops],
                 idle_gaps=[[n, s] for n, s in idle_gaps])
