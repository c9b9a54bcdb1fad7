"""The port's ``utils/profiling.py`` and ``utils/logging.py`` against the
JAX package's, on the CPU.

- with the tracer on, :func:`trace_span` names its spans in the trace that
  :func:`start_trace` / :func:`stop_trace` write (``trace.json``), nested as
  they ran; with it off they leave nothing there; a second start, or a stop
  without a start, raises.
- ``device_memory_stats()`` is None without a GPU.
- ``set_root_logger`` installs the JAX package's handler, stream, format and
  level.
"""

import json
import logging
import sys

import pytest
import torch

from dense_visual_odometry_torch.utils import logging as tlog
from dense_visual_odometry_torch.utils import profiling as tp
from dense_visual_odometry_tpu.utils import logging as jlog


def test_spans_in_the_trace(tmp_path):
    tp.start_trace(tmp_path / "prof")
    with pytest.raises(RuntimeError, match="already running"):
        tp.start_trace(tmp_path / "other")
    with tp.trace_span("dvo_untraced"):
        torch.ones(8).sum()
    tp.enable_tracing()
    try:
        with tp.trace_span("dvo_span"):
            torch.ones(64).cumsum(0)
            with tp.trace_span("dvo_inner"):
                assert float((torch.ones(3) * 2).sum()) == 6.0
    finally:
        tp.disable_tracing()
        tp.drain()
    path = tp.stop_trace()
    assert path == tmp_path / "prof" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"dvo_span", "dvo_inner"} <= names and "dvo_untraced" not in names
    span = next(e for e in events if e.get("name") == "dvo_span")
    inner = next(e for e in events if e.get("name") == "dvo_inner")
    assert span["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= span["ts"] + span["dur"]
    with pytest.raises(RuntimeError, match="no trace"):
        tp.stop_trace()


def test_device_memory_stats_none_without_a_gpu():
    stats = tp.device_memory_stats()
    assert (stats is None) == (not torch.cuda.is_available())


@pytest.mark.parametrize("verbose", [False, True])
def test_set_root_logger_matches_jax(verbose):
    root = logging.getLogger()
    saved = (list(root.handlers), root.level)
    try:
        configured = []
        for module in (tlog, jlog):
            logger = module.set_root_logger(verbose)
            assert logger is root and len(root.handlers) == 1
            handler = root.handlers[0]
            configured.append((type(handler), handler.stream, handler.formatter._fmt,
                               root.level))
        assert configured[0] == configured[1]
        assert configured[0][1] is sys.stdout
        assert configured[0][3] == (logging.DEBUG if verbose else logging.INFO)
    finally:
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])
