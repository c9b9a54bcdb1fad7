"""Device time (ms) of the kernels launched in ``map.render``, the median
over the profiled frames."""

from portbench.harness import map_trace


def read(record):
    return map_trace.render_ms_p50(record)
