"""Level-kernel launches over kernel-eligible levels x frames, in %."""

from portbench.harness import readers


def read(record):
    return readers.level_kernel_share(record)
