"""Mean seconds a job of the virtual slab program's ``slab_tables`` span
(the seed table, its padding to whole slabs and the slabs' ranged bucket
tables); None where no job logged it."""

from benchmark.harness.spans import mean_span_s


def read(run):
    return mean_span_s(run, "slab_tables")
