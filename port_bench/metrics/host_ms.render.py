"""host_ms.render: host ms an iteration inside the program's `render`
spans (`render/rasterize.py::render`, both renders of the joint
iteration: preprocess, binning, expand, the fragment sort, the tile
forward and the glue between them), over the profiled iterations. The
profiler slows the host, so it reads higher than an untraced run would."""

from port_bench import spans

LAYER = "Render glue, binning, sort"
UNIT = "ms"
MOVES = "iteration_ms"


def read(trace):
    return spans.host_ms(trace, "render")
