"""The fusion's bound (``roofline_map.fuse_bound_ms``) over its device
time, in %, over the profiled frames."""

from portbench.harness import map_trace


def read(record):
    return map_trace.fuse_roofline(record)
