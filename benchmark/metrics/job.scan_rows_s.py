"""Mean seconds a job of the scan engine's ``scan_rows`` span (the occ
table the scan reads, the nibble table by default, built where the index
has not cached it); None where no job logged it."""

from benchmark.harness.spans import mean_span_s


def read(run):
    return mean_span_s(run, "scan_rows")
