"""Mean seconds a job of the CLI's ``render`` span (``format_matches``:
the listing text)."""

from benchmark.harness.spans import mean_span_s


def read(run):
    return mean_span_s(run, "render")
