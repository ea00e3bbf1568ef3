"""Mean milliseconds a request in the seed engine's ``expand`` stage
(``stats['searches'][i]['stage_s']``, device-synchronised)."""

from benchmark.harness.readers import mean_stage_ms


def read(run):
    return mean_stage_ms(run, "expand")
