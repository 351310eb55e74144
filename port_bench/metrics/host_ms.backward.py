"""host_ms.backward: host ms an iteration inside the program's `backward`
spans (the `torch.autograd.grad` call of each step: the calling thread,
blocked while autograd's engine walks the graph and launches the
backward), over the profiled iterations."""

from port_bench import spans

LAYER = "Backward"
UNIT = "ms"
MOVES = "iteration_ms"


def read(trace):
    return spans.host_ms(trace, "backward")
