"""Helpers of the metric readers (``benchmark/metrics/*.py``): means per
answer of what the program reported about it."""

from __future__ import annotations

from benchmark.harness.arith import mean


def phase_s(answer, name: str) -> float:
    """Seconds of the CLI's PhaseLog phase ``name`` in one job (-v)."""
    return sum(p["seconds"] for p in answer.phases if p["phase"] == name)


def mean_phase_s(run, name: str) -> float | None:
    """Mean seconds a job of ``name``; None where no job logged phases."""
    jobs = [a for a in run.answers if a.phases]
    return mean([phase_s(a, name) for a in jobs]) if jobs else None


def stage_s(answer, name: str | None) -> float:
    """Seconds of the engine's stage ``name`` (None: every stage) over the
    request's engine calls (``stats['searches'][i]['stage_s']``)."""
    return sum(sec for st in answer.stats["searches"]
               for stage, sec in st["stage_s"].items()
               if name is None or stage == name)


def mean_stage_ms(run, name: str) -> float | None:
    """Mean milliseconds a request in stage ``name``; None where no request
    ran it."""
    reqs = [a for a in run.answers if a.stats is not None]
    if not any(name in st["stage_s"] for a in reqs
               for st in a.stats["searches"]):
        return None
    return 1e3 * mean([stage_s(a, name) for a in reqs])


def idle_pct(run) -> float | None:
    """Idle share of the device over the traced window, %."""
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
