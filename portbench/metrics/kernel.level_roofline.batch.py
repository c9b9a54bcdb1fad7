"""The level kernel's roofline share over the profiled steps, in %."""

from portbench.harness import readers


def read(record):
    return readers.level_roofline(record)
