"""Mean seconds a job of the virtual slab program's ``slab_frontend`` span
(the query's keys, owner routing or refinement over the slabs, and the
one read of the summary); None where no job logged it."""

from benchmark.harness.spans import mean_span_s


def read(run):
    return mean_span_s(run, "slab_frontend")
