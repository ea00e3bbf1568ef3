"""Mean seconds a job of ``run_engine``'s ``emit`` span (the per-entry
split, the mode filter and the emission of every entry's matches)."""

from benchmark.harness.spans import mean_span_s


def read(run):
    return mean_span_s(run, "emit")
