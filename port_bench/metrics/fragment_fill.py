"""fragment_fill: 100 x the fragments the profiled renders had (the
program's `fragments` counter, each render's `num_fragments`) over the
slots they sorted (its `fragment_slots` counter, each render's sorted
capacity), in %: the share of the sort's work that carries a fragment."""

from port_bench import spans

LAYER = "Render glue, binning, sort"
UNIT = "%"
MOVES = "iteration_ms"


def read(trace):
    return spans.counter_share(trace, "fragments", "fragment_slots")
