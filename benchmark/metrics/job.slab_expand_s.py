"""Mean seconds a job of the virtual slab program's ``slab_expand`` spans
(each round's per-slab expansion, pair sort and run compaction), summed
over the rounds; None where no job logged it."""

from benchmark.harness.spans import mean_span_s


def read(run):
    return mean_span_s(run, "slab_expand")
