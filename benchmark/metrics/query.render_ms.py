"""Mean milliseconds a request of format_matches (the harness's own span
around the call)."""

from benchmark.harness.arith import mean


def read(run):
    times = [a.render_s for a in run.answers if a.render_s is not None]
    return 1e3 * mean(times) if times else None
