"""Mean seconds a job of the CLI's own ``query`` phase (PhaseLog)."""

from benchmark.harness.readers import mean_phase_s


def read(run):
    return mean_phase_s(run, "query")
