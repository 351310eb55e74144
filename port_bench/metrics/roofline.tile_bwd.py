"""roofline.tile_bwd: the least time of the work the profiled iterations' tile_bwd
calls had (`counts/tiles.py`, counted on the benchmark's own projection and
binning of the same states and frames) over the device time of the
`tile_bwd_kernel` launches in those iterations, in % of the roofline. The
bound is against the published peaks of one H100 SXM at 700 W; the run's
card and power limit are on an earlier line."""

LAYER = "Kernels"
UNIT = "%"
MOVES = "iteration_ms"


def read(trace):
    seconds = trace.kernel_s.get("tile_bwd", 0.0)
    if seconds <= 0 or "tile_bwd" not in trace.work:
        return None
    return 100.0 * trace.work["tile_bwd"][2] / seconds
