"""mfu: the FP32 operations the profiled iterations' algorithm needs, per
iteration (`counts/`: both renders' tile compositors forward and backward,
two SSIMs, the Pearson terms, the motion basis), over the untraced window's
iteration time at the H100's 67 TFLOP/s FP32 peak, in %. TF32 is off in the
program, so FP32 is the rate its matrix products run at."""

from port_bench.counts.tiles import PEAK_FP32_FLOPS

LAYER = "Whole step"
UNIT = "%"
MOVES = "iteration_ms"


def read(trace):
    if trace.step_ops <= 0 or trace.iteration_ms <= 0:
        return None
    per_it = trace.step_ops / trace.iterations
    return 100.0 * per_it / (trace.iteration_ms * 1e-3 * PEAK_FP32_FLOPS)
