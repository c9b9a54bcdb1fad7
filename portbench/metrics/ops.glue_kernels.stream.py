"""Device kernels a frame other than the port's three."""

from portbench.harness import readers


def read(record):
    return readers.glue_kernels(record)
