"""Mean seconds a job of the virtual slab program's ``slab_merge`` spans
(each round's cross-slab merge and span filter), summed over the rounds;
None where no job logged it."""

from benchmark.harness.spans import mean_span_s


def read(run):
    return mean_span_s(run, "slab_merge")
