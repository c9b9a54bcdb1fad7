"""Synchronising host reads a frame."""

from portbench.harness import readers


def read(record):
    return readers.host_reads(record)
