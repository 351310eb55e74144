"""launches_per_iteration: the runtime's kernel-launch calls
(`cudaLaunchKernel` and its variants) the host made inside the profiled
iterations, per iteration."""

LAYER = "Trainers and host dispatch"
UNIT = "launches/it"
MOVES = "iteration_ms"


def read(trace):
    if trace.launches <= 0:
        return None
    return trace.launches / trace.iterations
