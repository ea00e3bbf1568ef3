"""Query bases of every request completed in the window, in Mbp, over the
window's seconds."""

from benchmark.harness.arith import rate


def read(run):
    if run.cell.traffic["kind"] != "library_query":
        return None
    return rate(sum(a.bases for a in run.answers) / 1e6, run.window_s)
