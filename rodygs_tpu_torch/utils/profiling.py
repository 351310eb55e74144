"""Tracing and profiling utilities. Port of `rodygs_tpu/utils/profiling.py`:
  * `StepTimer`: per-step wall times with an EMA and windowed percentiles,
    cheap enough to leave on (host clock; synchronise first for device
    times);
  * `trace`: a `torch.profiler` context writing a Chrome trace;
  * `device_memory_stats`: per-card allocated bytes from `torch.cuda`.

The JAX package's `enable_persistent_compile_cache` has no counterpart:
there is nothing to compile per process beyond the CUDA kernels, and those
are already cached across processes in `rodygs_tpu_torch/_build/`
(kernels.py).
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch


class StepTimer:
    """EMA and windowed percentiles of step wall times.

    Call `tick()` once per step (after a synchronise if exact device timing
    is wanted). `summary()` returns a dict for logging.
    """

    def __init__(self, window: int = 200, ema: float = 0.02):
        self.window = deque(maxlen=window)
        self.ema_coef = ema
        self.ema = None
        self._last = None
        self.count = 0

    def tick(self) -> float | None:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.window.append(dt)
            self.ema = dt if self.ema is None else (
                self.ema_coef * dt + (1 - self.ema_coef) * self.ema)
            self.count += 1
        self._last = now
        return dt

    def summary(self) -> dict:
        if not self.window:
            return {"steps": 0}
        arr = np.asarray(self.window)
        return {
            "steps": self.count,
            "mean_ms": float(arr.mean() * 1e3),
            "ema_ms": float((self.ema or 0.0) * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p90_ms": float(np.percentile(arr, 90) * 1e3),
            "p99_ms": float(np.percentile(arr, 99) * 1e3),
        }


@contextlib.contextmanager
def trace(logdir: str):
    """Host and device trace of the block, written as
    `<logdir>/trace.json` (Chrome trace format):
    `with trace("/tmp/trace"): step()`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


def device_memory_stats() -> list[dict]:
    if not torch.cuda.is_available():
        return []
    return [{"device": f"cuda:{i}",
             "bytes_in_use": torch.cuda.memory_allocated(i),
             "peak_bytes_in_use": torch.cuda.max_memory_allocated(i)}
            for i in range(torch.cuda.device_count())]
