"""rigidity_knn_ms: device ms of the kernels launched inside the program's
`rigidity_knn` record_function range, the rigidity loss's KNN (`train/losses.py`, `ops/knn.py`), per profiled iteration."""

LAYER = "Motion and densify"
UNIT = "ms"
MOVES = "iteration_ms"


def read(trace):
    ms = trace.range_ms.get("rigidity_knn", 0.0)
    if ms <= 0:
        return None
    return ms / trace.iterations
