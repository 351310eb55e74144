"""What the per-layer metrics of the program's own spans and counters read:
the program's recorder (`rodygs_tpu_torch.utils.profiling.recorded`), which
records exactly while a `torch.profiler` session runs, so in a traced run
it holds the profiled iterations and nothing else. Every helper returns
None where there is nothing to read: a program without the recorder, no
`iteration` span recorded, an iteration count other than the trace's, or
a span or counter the program did not record. None of them raises."""

from __future__ import annotations


def recorded(trace):
    """The recorder's spans and counters of the trace's profiled
    iterations, or None."""
    try:
        from rodygs_tpu_torch.utils.profiling import recorded as read
    except ImportError:
        return None
    try:
        rec = read()
        n = rec["iterations"]
        ok = (n > 0 and n == trace.iterations
              and rec["spans"].get("iteration", {}).get("calls", 0) > 0)
    except Exception:  # a reader never raises: a record it cannot read
        return None
    return rec if ok else None


def host_ms(trace, name: str, less=()):
    """Host ms an iteration inside the spans `name`, less the host ms of
    the spans named in `less` inside them."""
    rec = recorded(trace)
    span = rec and rec["spans"].get(name)
    if not span or span["calls"] == 0:
        return None
    ms = span["host_ms"] - sum(
        rec["spans"].get(n, {}).get("within", {}).get(name, 0.0)
        for n in less)
    return ms / rec["iterations"]


def device_ms(trace, names):
    """Device ms an iteration (the spans' event pairs) inside the spans
    `names`, summed."""
    rec = recorded(trace)
    if rec is None:
        return None
    found = [rec["spans"][n]["device_ms"] for n in names
             if rec["spans"].get(n, {}).get("device_ms") is not None]
    if not found:
        return None
    return sum(found) / rec["iterations"]


def counter_share(trace, part: str, whole: str):
    """100 x the counter `part` over the counter `whole`, in %."""
    rec = recorded(trace)
    if rec is None:
        return None
    counters = rec["counters"]
    if not counters.get(whole) or part not in counters:
        return None
    return 100.0 * counters[part] / counters[whole]
