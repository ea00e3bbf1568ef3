"""Mean seconds a job outside the index build and the query: FASTA read
and parse, the render, the write and the rest of the CLI (job wall less
the two PhaseLog phases)."""

from benchmark.harness.arith import mean
from benchmark.harness.readers import phase_s


def read(run):
    jobs = [a for a in run.answers if a.phases]
    if not jobs:
        return None
    return mean([a.wall_s - phase_s(a, "index_build") - phase_s(a, "query")
                 for a in jobs])
