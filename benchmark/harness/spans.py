"""Helper of the readers of the program's own spans (``utils/log.py``
records, which the CLI prints with ``-v`` and ``SLAMEM_LOG_JSON=1``)."""

from __future__ import annotations

from benchmark.harness.readers import mean_phase_s


def mean_span_s(run, name: str) -> float | None:
    """Mean seconds a job of the span ``name``, its records in a job
    summed; None where no job logged it (a program without the span)."""
    if not any(p["phase"] == name for a in run.answers for p in a.phases):
        return None
    return mean_phase_s(run, name)
