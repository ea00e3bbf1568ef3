"""Mean seconds a job of ``run_engine``'s ``join`` span (the query entries
joined into one separator-delimited text: multi-entry or ``-b``)."""

from benchmark.harness.spans import mean_span_s


def read(run):
    return mean_span_s(run, "join")
