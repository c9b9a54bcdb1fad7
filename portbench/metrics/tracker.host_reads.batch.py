"""Synchronising host reads a step."""

from portbench.harness import readers


def read(record):
    return readers.host_reads(record)
