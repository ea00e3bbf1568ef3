"""Share of the traced window in which no operation ran on the device, %
(torch.profiler: one less the union of device activity over the
window)."""

from benchmark.harness.readers import idle_pct


def read(run):
    return idle_pct(run)
