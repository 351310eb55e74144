"""Tracing and profiling utilities. Port of `rodygs_tpu/utils/profiling.py`:
  * `StepTimer`: per-step wall times with an EMA and windowed percentiles,
    cheap enough to leave on (host clock; synchronise first for device
    times);
  * `span`, `count`, `recorded`, `reset`: the program's own spans and
    counters, recorded exactly while a `torch.profiler` session runs;
  * `trace`: a `torch.profiler` context writing a Chrome trace and the
    spans and counters it recorded;
  * `device_memory_stats`: per-card allocated bytes from `torch.cuda`.

The JAX package's `enable_persistent_compile_cache` has no counterpart:
there is nothing to compile per process beyond the CUDA kernels, and those
are already cached across processes in `rodygs_tpu_torch/_build/`
(kernels.py).

Spans. `with span("render"):` (or `@span("render")` on a function) marks
one layer's work. While no profiler runs, `span` reads one flag and
returns a shared no-op: no `record_function`, no CUDA event, no device
read. While one runs, a span enters `torch.profiler.record_function(name)`
(so it lies on the profiler's timeline over the kernels it launched),
stamps host start and end with `time.perf_counter_ns`, and records its
parent (the open span on its thread; a span opened on autograd's backward
thread with none open there takes the open `backward` span) and the
iteration it belongs to (the count of root `iteration` spans opened so
far). With `device=True` it also records a CUDA event pair on the current
stream. `count(name, value)` adds to a counter while recording; a device
tensor is kept as it is and summed only by `recorded()`.

`recorded()` returns what was recorded since the last `reset()`:

    {"iterations": n,
     "spans": {name: {"calls", "host_ms", "self_host_ms", "device_ms",
                      "within": {ancestor name: host ms inside it}}},
     "counters": {name: total}}

A span's self time is its host duration less that of its child spans;
`device_ms` is the events' elapsed time (None for a span without them).
"""

from __future__ import annotations

import contextlib
import functools
import json
import threading
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

ROOT_SPAN = "iteration"
BACKWARD_SPAN = "backward"


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


class _Record:
    """One span as it was recorded."""

    __slots__ = ("name", "parent", "iteration", "start", "end", "events")

    def __init__(self, name, parent, iteration, events):
        self.name = name
        self.parent = parent
        self.iteration = iteration
        self.events = events
        self.end = None
        self.start = time.perf_counter_ns()


class Recorder:
    """The spans and counters recorded while a profiler runs. Records and
    counts are only appended to (one atomic list append each, whatever the
    thread); `recorded()` aggregates them."""

    def __init__(self):
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        self.records: list[_Record] = []
        self.counts: list[tuple] = []
        self.iterations = 0
        self._backward: list[_Record] = []

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str, device: bool) -> _Record:
        stack = self._stack()
        if stack:
            parent = stack[-1]
        else:
            parent = self._backward[-1] if self._backward else None
        if name == ROOT_SPAN and parent is None:
            self.iterations += 1
        events = None
        if device and torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        rec = _Record(name, parent, self.iterations, events)
        stack.append(rec)
        self.records.append(rec)
        if name == BACKWARD_SPAN:
            self._backward.append(rec)
        return rec

    def close(self, rec: _Record) -> None:
        rec.end = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record()
        self._stack().pop()
        if rec.name == BACKWARD_SPAN and self._backward:
            self._backward.pop()

    def count(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            value = value.detach()
        self.counts.append((name, value))

    def recorded(self) -> dict:
        """The spans and counters by name (the module docstring); one
        synchronise when a span holds events or a counter a device tensor."""
        records = [r for r in self.records if r.end is not None]
        if torch.cuda.is_initialized() and (
                any(r.events is not None for r in records)
                or any(isinstance(v, torch.Tensor) and v.is_cuda
                       for _, v in self.counts)):
            torch.cuda.synchronize()
        child_ns = {}
        for r in records:
            if r.parent is not None:
                key = id(r.parent)
                child_ns[key] = child_ns.get(key, 0) + r.end - r.start
        spans = {}
        for r in records:
            s = spans.setdefault(r.name, {"calls": 0, "host_ms": 0.0,
                                          "self_host_ms": 0.0,
                                          "device_ms": None, "within": {}})
            ns = r.end - r.start
            s["calls"] += 1
            s["host_ms"] += ns * 1e-6
            s["self_host_ms"] += (ns - child_ns.get(id(r), 0)) * 1e-6
            if r.events is not None:
                s["device_ms"] = (s["device_ms"] or 0.0) + (
                    r.events[0].elapsed_time(r.events[1]))
            seen, p = set(), r.parent
            while p is not None:
                if p.name not in seen:
                    seen.add(p.name)
                    s["within"][p.name] = s["within"].get(p.name, 0.0) + (
                        ns * 1e-6)
                p = p.parent
        by_name = {}
        for name, v in self.counts:
            by_name.setdefault(name, []).append(v)
        counters = {name: _total(vs) for name, vs in by_name.items()}
        return {"iterations": self.iterations, "spans": spans,
                "counters": counters}


def _total(values: list):
    """The sum of host numbers and tensors; an int when every value is
    integral."""
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    total = sum(v for v in values if not isinstance(v, torch.Tensor))
    if tensors:
        total += sum(t.to(torch.float64).sum().item() for t in tensors)
    integral = all(not t.is_floating_point() for t in tensors) and all(
        isinstance(v, int) for v in values if not isinstance(v, torch.Tensor))
    return int(round(total)) if integral else float(total)


RECORDER = Recorder()
recorded = RECORDER.recorded
reset = RECORDER.reset


class _Off:
    """A span while no profiler runs: one per name, shared, entering
    nothing."""

    __slots__ = ("name", "device")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.device = device

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _spanned(fn, self.name, self.device)


class _Span(_Off):
    """A span while a profiler runs."""

    __slots__ = ("_rf", "_rec")

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._rec = RECORDER.open(self.name, self.device)
        return self

    def __exit__(self, *exc):
        RECORDER.close(self._rec)
        self._rf.__exit__(*exc)
        return False


def _spanned(fn, name: str, device: bool):
    """`fn` in a span `name` at every call (the decorator form)."""

    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with span(name, device):
            return fn(*args, **kwargs)

    return spanned


_OFF = ({}, {})   # by device, then by name


def span(name: str, device: bool = False):
    """A span named `name` (the module docstring): a context manager, or a
    decorator. While no profiler runs, the shared no-op of the name."""
    if not _autograd_profiler._is_profiler_enabled:
        off = _OFF[device].get(name)
        if off is None:
            off = _OFF[device][name] = _Off(name, device)
        return off
    return _Span(name, device)


def count(name: str, value) -> None:
    """Adds `value` (a number, or a tensor summed by `recorded()`) to the
    counter `name` while a profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        RECORDER.count(name, value)


def host_read():
    """A `host_read` span, counted in `host_reads`, around a call at which
    the host waits for the device to finish what it was given: a read of a
    device value (`int(x)`, `bool(x)`), or a copy from pageable host memory
    to the device (`torch.tensor(..., device=cuda)`), which synchronises
    the stream."""
    count("host_reads", 1)
    return span("host_read")


@contextlib.contextmanager
def trace(logdir: str):
    """Host and device trace of the block, written as
    `<logdir>/trace.json` (Chrome trace format), and the spans and counters
    recorded in it as `<logdir>/spans.json` (`recorded()`; `reset()` on
    entry): `with trace("/tmp/trace"): step()`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    reset()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))
    with open(Path(logdir) / "spans.json", "w") as f:
        json.dump(recorded(), f, indent=1)


def device_memory_stats() -> list[dict]:
    if not torch.cuda.is_available():
        return []
    return [{"device": f"cuda:{i}",
             "bytes_in_use": torch.cuda.memory_allocated(i),
             "peak_bytes_in_use": torch.cuda.max_memory_allocated(i)}
            for i in range(torch.cuda.device_count())]
