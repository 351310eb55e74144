"""host_ms.loss: host ms an iteration inside the program's `loss` spans
(`train/losses.py::MultiLoss.__call__`, every active term of both steps),
less the `rigidity_knn` and `motion_mlp` spans inside them (read by
`rigidity_knn_ms` and `motion_mlp_ms`), over the profiled iterations."""

from port_bench import spans

LAYER = "Loss"
UNIT = "ms"
MOVES = "iteration_ms"


def read(trace):
    return spans.host_ms(trace, "loss", less=("rigidity_knn", "motion_mlp"))
