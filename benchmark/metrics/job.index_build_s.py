"""Mean seconds a job of the CLI's own ``index_build`` phase (PhaseLog,
``-v``, ``SLAMEM_LOG_JSON=1``)."""

from benchmark.harness.readers import mean_phase_s


def read(run):
    return mean_phase_s(run, "index_build")
