"""Mean milliseconds a request of run_engine outside the engine's stages:
``stats['query_s']`` less every stage of its engine calls."""

from benchmark.harness.arith import mean
from benchmark.harness.readers import stage_s


def read(run):
    reqs = [a for a in run.answers if a.stats is not None]
    if not reqs:
        return None
    return 1e3 * mean([a.stats["query_s"] - stage_s(a, None) for a in reqs])
