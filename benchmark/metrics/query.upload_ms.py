"""Mean milliseconds a request in the seed engine's ``upload`` stage
(``stats['searches'][i]['stage_s']``, device-synchronised)."""

from benchmark.harness.readers import mean_stage_ms


def read(run):
    return mean_stage_ms(run, "upload")
