"""Share of the profiled frames in which no device operation ran, in %."""

from portbench.harness import readers


def read(record):
    return readers.idle_pct(record)
