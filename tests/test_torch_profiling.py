"""The port's ``utils/profiling.py`` and ``utils/logging.py`` against the
JAX package's, on the CPU.

- :func:`trace_span` and :func:`annotate` name their spans in the trace that
  :func:`start_trace` / :func:`stop_trace` write (``trace.json``); a second
  start, or a stop without a start, raises.
- ``WallClock.summary`` equals the JAX package's on the same samples.
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
from dense_visual_odometry_tpu.utils import profiling as jp


def test_spans_in_the_trace(tmp_path):
    @tp.annotate("dvo_annotated")
    def work(x):
        return (x * 2).sum()

    tp.start_trace(tmp_path / "prof")
    with pytest.raises(RuntimeError, match="already running"):
        tp.start_trace(tmp_path / "other")
    with tp.trace_span("dvo_span"):
        torch.ones(64).cumsum(0)
        assert float(work(torch.ones(3))) == 6.0
    path = tp.stop_trace()
    assert path == tmp_path / "prof" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"dvo_span", "dvo_annotated"} <= names
    span = next(e for e in events if e.get("name") == "dvo_span")
    inner = next(e for e in events if e.get("name") == "dvo_annotated")
    assert span["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= span["ts"] + span["dur"]
    assert work.__name__ == "work"
    with pytest.raises(RuntimeError, match="no trace"):
        tp.stop_trace()


def test_wallclock_summary_matches_jax():
    samples = {"track": [0.5, 0.01, 0.03, 0.02, 0.011], "read": [0.2], "fit": [0.3, 0.1]}
    clocks = tp.WallClock(), jp.WallClock()
    for clock in clocks:
        for name, xs in samples.items():
            for x in xs:
                clock.add(name, x)
        with clock.span("span"):
            pass
    got, want = (c.summary() for c in clocks)
    assert set(got) == set(want)
    for name in samples:
        assert got[name] == want[name]
        assert tp.WallClock.summary(clocks[0], skip_first=False)[name] == \
            jp.WallClock.summary(clocks[1], skip_first=False)[name]
    assert got["span"]["count"] == 1.0


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
