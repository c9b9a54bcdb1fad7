"""Device kernels launched in ``map.render`` a frame, the median over the
profiled frames."""

from portbench.harness import map_trace


def read(record):
    return map_trace.render_kernels(record)
