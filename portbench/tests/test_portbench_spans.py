"""The readers of the port's tracer (``harness/spans.py``) on hand-built
records: each value, and None where there is nothing to read or the tracer
dropped spans."""

import pytest

from portbench.harness import spans


def span(sid, name, a_ms, b_ms, parent=None, step=0, **attrs):
    return dict(id=sid, name=name, start_ns=int(a_ms * 1e6), end_ns=int(b_ms * 1e6),
                parent=parent, step=step, **attrs)


def fixture_record() -> spans.SpanRecord:
    """Two 10 ms steps.  Step 0 uploads for 2 ms and waits 1.5 ms in
    ``sync.*``; step 1 uploads for 1 ms and waits 2 ms.  Three kernels:
    two launched inside ``frame.pyramid`` (2 ms and 0.5 ms of device time),
    one elsewhere, and a copy whose launch was not matched."""
    tree = [
        span(0, "session.step", 0, 10, streams=64),
        span(1, "frame.upload", 0.5, 2.5, 0),
        span(2, "frame.pyramid", 2.5, 4, 0),
        span(3, "track.pair", 4, 9, 0),
        span(4, "track.level", 4.5, 8.5, 3, level=3, path="lm.packed_exact"),
        span(5, "sync.trigger", 5, 6, 4),
        span(6, "sync.loop", 7, 7.5, 4),
        span(7, "session.commit", 9, 9.5, 0),
        span(8, "session.step", 10, 20, step=1, streams=64),
        span(9, "frame.upload", 10.5, 11.5, 8, step=1),
        span(10, "frame.pyramid", 11.5, 13, 8, step=1),
        span(11, "track.pair", 13, 19, 8, step=1),
        span(12, "sync.retrack", 14, 16, 11, step=1),
    ]
    return spans.SpanRecord(
        step_ms=[10.0, 10.0], window_steps=2, level_launches=0, eligible_levels=4,
        profiled_steps=2, window_us=20_000.0, steps=[(0.0, 10_000.0), (10_000.0, 20_000.0)],
        device=[("pyr_kernel", 3_100.0, 5_100.0), ("other", 8_100.0, 8_500.0),
                ("pyr_kernel", 12_100.0, 12_600.0), ("Memcpy DtoH", 19_000.0, 19_100.0)],
        launch_us=[3_000.0, 8_000.0, 12_000.0, None],
        spans=tree,
        counters={"retracks": 1, "stream_levels.gather": 128,
                  "stream_levels.gather_kept": 2, "spans.dropped": 0})


def test_span_readers_on_a_built_record():
    rec = fixture_record()
    assert spans.upload_ms_p50(rec) == pytest.approx(1.5)
    assert spans.host_wait_ms_p50(rec) == pytest.approx(1.75)
    assert spans.retrack_pct(rec) == pytest.approx(50.0)
    assert spans.fallback_unneeded_pct(rec) == pytest.approx(100.0 * (1 - 2 / 128))
    assert spans.pyramid_ms(rec) == pytest.approx((2.0 + 0.5) / 2)


def test_idle_by_span():
    rec = fixture_record()
    rows = {label: (ms, pct) for label, ms, pct in spans.idle_by_span(rec)}
    busy = 2_000.0 + 400.0 + 500.0 + 100.0
    idle_ms = (20_000.0 - busy) / 1e3 / 2
    assert sum(ms for ms, _ in rows.values()) == pytest.approx(idle_ms)
    assert sum(pct for _, pct in rows.values()) == pytest.approx(100.0)
    # The uploads lie wholly in idle time: 2 ms and 1 ms over two steps.
    assert rows["frame.upload"][0] == pytest.approx(1.5)
    # The level's own time (4.5-5, 6-7, 7.5-8.5 ms) where the device idled
    # (from 5.1 to 8.1 ms): 6-7 and 7.5-8.1.
    assert rows["track.level[lm.packed_exact]"][0] == pytest.approx((1.0 + 0.6) / 2)
    assert rows["sync.retrack"][0] == pytest.approx(2.0 / 2)
    assert rows["sync.trigger"][0] == pytest.approx(0.9 / 2)
    assert "(no span)" not in rows  # the steps are covered by session.step
    assert "idle by span" in spans.idle_table(spans.idle_by_span(rec))


def test_span_readers_return_none():
    readers = (spans.upload_ms_p50, spans.host_wait_ms_p50, spans.retrack_pct,
               spans.fallback_unneeded_pct, spans.pyramid_ms, spans.idle_by_span)
    empty = spans.SpanRecord(step_ms=[], window_steps=0, level_launches=0, eligible_levels=0)
    assert all(read(empty) is None for read in readers)
    dropped = fixture_record()
    dropped.counters["spans.dropped"] = 1
    assert all(read(dropped) is None for read in readers)
    rec = fixture_record()
    rec.counters["stream_levels.gather"] = 0
    assert spans.fallback_unneeded_pct(rec) is None
    rec = fixture_record()
    rec.launch_us = []  # no launch was matched to the device operations
    assert spans.pyramid_ms(rec) is None
    rec = fixture_record()
    rec.spans = [s for s in rec.spans if s["name"] != "session.step"]
    assert spans.upload_ms_p50(rec) is None and spans.retrack_pct(rec) is None
