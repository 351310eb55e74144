"""host_ms.optim: host ms an iteration inside the program's `optim` spans
(each step's densification statistics, its Adam and, in the static step,
the poses' Adam), over the profiled iterations."""

from port_bench import spans

LAYER = "Trainers and host dispatch"
UNIT = "ms"
MOVES = "iteration_ms"


def read(trace):
    return spans.host_ms(trace, "optim")
