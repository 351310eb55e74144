"""roofline.tile_fwd: the least time of the work the profiled iterations' tile_fwd
calls had (`counts/tiles.py`, counted on the benchmark's own projection and
binning of the same states and frames) over the device time of the
`tile_fwd_kernel` launches in those iterations, in % of the roofline. The
bound is against the published peaks of one H100 SXM at 700 W; the run's
card and power limit are on an earlier line."""

LAYER = "Kernels"
UNIT = "%"
MOVES = "iteration_ms"


def read(trace):
    seconds = trace.kernel_s.get("tile_fwd", 0.0)
    if seconds <= 0 or "tile_fwd" not in trace.work:
        return None
    return 100.0 * trace.work["tile_fwd"][2] / seconds
