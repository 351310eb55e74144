"""motion_mlp_ms: device ms of the kernels launched inside the program's
`motion_mlp` record_function range, the motion basis MLP (`models/motion.py`), per profiled iteration."""

LAYER = "Motion"
UNIT = "ms"
MOVES = "iteration_ms"


def read(trace):
    ms = trace.range_ms.get("motion_mlp", 0.0)
    if ms <= 0:
        return None
    return ms / trace.iterations
