"""Mean milliseconds a request of ``run_engine``'s ``emit`` span (the
per-entry split, the mode filter and the emission of the matches), read
from the request's ``stats['phases']``; None where no request logged
it (a program without the span)."""

from benchmark.harness.arith import mean


def _emit_s(stats: dict) -> list[float]:
    return [p["seconds"] for p in stats.get("phases", [])
            if p["phase"] == "emit"]


def read(run):
    reqs = [_emit_s(a.stats) for a in run.answers if a.stats is not None]
    if not any(reqs):
        return None
    return 1e3 * mean([sum(r) for r in reqs])
