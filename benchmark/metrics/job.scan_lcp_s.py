"""Mean seconds a job of the scan engine's ``scan_lcp`` span (the LCP
array over every suffix of the reference, from the prefix-doubling rank
arrays, and its PSV/NSV pyramid, built where the index has not cached
them); None where no job logged it."""

from benchmark.harness.spans import mean_span_s


def read(run):
    return mean_span_s(run, "scan_lcp")
