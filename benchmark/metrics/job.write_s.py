"""Mean seconds a job of the CLI's ``write`` span (the listing written to
its file)."""

from benchmark.harness.spans import mean_span_s


def read(run):
    return mean_span_s(run, "write")
