"""sort_ms: device ms an iteration between the CUDA event pairs of the
program's `fragment_sort` spans (the stable sort of the fragment keys and
the gather of the records, `render/compact.py`) and `fragment_unsort`
spans (the gradient rows back to presort order in the backward), both
renders, over the profiled iterations. An event pair times the stream
between the span's start and end, idle gaps included."""

from port_bench import spans

LAYER = "Render glue, binning, sort"
UNIT = "ms"
MOVES = "iteration_ms"


def read(trace):
    return spans.device_ms(trace, ("fragment_sort", "fragment_unsort"))
