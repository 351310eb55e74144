"""device_idle_share: the share of the profiled iterations' wall time in
which no operation ran on the device (1 - the union of the device's kernel
and copy intervals over the iterations' windows), in %. It reads higher
than an untraced run would: the profiler slows the host."""

LAYER = "Device"
UNIT = "%"
MOVES = "iteration_ms"


def read(trace):
    if trace.wall_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.wall_s)
