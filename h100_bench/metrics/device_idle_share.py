"""Share of the traced slice in which no operation ran on the device, %:
100 * (1 - union of device intervals / slice), from the profiler."""

from h100_bench.metrics._shared import idle_share


def read(run):
    return idle_share(run)
