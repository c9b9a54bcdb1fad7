"""Median host-clock time of the measured window's steps, in ms."""

from portbench.harness import readers


def read(record):
    return readers.step_ms_p50(record)
