"""Mean seconds a job of the ``frontend`` stage in a scan cell (the scan
engine's backward search over every query position, one scan kernel
launch a 4 M-position chunk on a card); None where no job logged it. The
seed engine names its own frontend the same: the metric's entry lists only
cells that run ``-engine scan``."""

from benchmark.harness.spans import mean_span_s


def read(run):
    return mean_span_s(run, "frontend")
