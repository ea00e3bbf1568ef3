"""95th percentile of every request's latency in the window (run_engine
and format_matches), ms."""

from benchmark.harness.arith import percentile


def read(run):
    if run.cell.traffic["kind"] != "library_query":
        return None
    return 1e3 * percentile([a.wall_s for a in run.answers], 95)
