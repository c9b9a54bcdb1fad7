"""The port's tracer (``utils/profiling.py``) inside the tracker, on the CPU.

The seeded 120x160 scene of ``test_torch_track.py``, built here with the
port alone (``io.synthetic``, ``preprocess_frame``), on ``tpu_fast``:

- with tracing off nothing is recorded, and ``trace_span`` hands out one
  shared no-op;
- ``track_pair`` and both sessions return the same tensors, bit for bit,
  with tracing on and off;
- the spans form a tree: each child inside its parent's interval, one step
  id a step, one ``track.level`` a level with its ``level`` and ``path``;
- one ``sync.loop`` a read of a loop's done flags, one ``sync.solve`` an
  iteration;
- the trigger's terms (rotation, coverage) and the retrack are counted, and
  every decision is the one taken with tracing off;
- under ``torch.profiler`` each span lies on its ``record_function`` event.
"""

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from dense_visual_odometry_torch.camera import CameraModel
from dense_visual_odometry_torch.config import RobustDVOConfig
from dense_visual_odometry_torch.io import synthetic
from dense_visual_odometry_torch.models import robust
from dense_visual_odometry_torch.models.batched_session import BatchedOdometrySession
from dense_visual_odometry_torch.models.session import OdometrySession
from dense_visual_odometry_torch.parallel import batched_track_pair, stack_frame_data
from dense_visual_odometry_torch.utils import profiling as tp
from dense_visual_odometry_torch.utils.lie import se3

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
H, W, BAND = 120, 160, 16
NOISE_SIGMA = 25.0  # puts the noisy pair's finest IRLS scale over retrack_max_scale
CLOCK_US = 200.0


@pytest.fixture(scope="module")
def scene():
    gray, depth, k = synthetic.textured_scene(H, W, seed=0)
    poses = synthetic.handheld_trajectory(8, seed=0)
    grays, depths = synthetic.render_sequence(gray, depth, k, poses)
    for d in depths:
        d[:BAND], d[-BAND:], d[:, :BAND], d[:, -BAND:] = 0, 0, 0, 0
    noise = np.random.default_rng(5).normal(0, NOISE_SIGMA, (H, W)).astype(np.float32)
    camera = CameraModel.create(k, 1.0)

    def prep(g, d):
        return robust.preprocess_frame(g, d, camera, levels=4, device="cpu")

    return dict(k=k, camera=camera, grays=grays, depths=depths,
                frames=[prep(g, d) for g, d in zip(grays, depths)],
                noisy=prep(grays[1] + noise, depths[1]))


@pytest.fixture
def tracer():
    """The tracer emptied before the test, and off and empty after it."""
    tp.disable_tracing()
    tp.drain()
    yield tp
    tp.disable_tracing()
    tp.drain()


def fast(**overrides) -> RobustDVOConfig:
    data = {**json.loads((CONFIGS / "tpu_fast.json").read_text()), **overrides}
    return RobustDVOConfig.from_dict(data)


def pairs(scene, name):
    """(prev, curr) batches: "hard" (a noisy pair that the retrack takes and
    a three-frame pair that trips the trigger), "retrack" (the noisy pair
    beside an easy one) and "easy"."""
    f, noisy = scene["frames"], scene["noisy"]
    prev, curr = {"hard": ([f[0], f[1]], [noisy, f[4]]),
                  "retrack": ([f[0], f[6]], [noisy, f[7]]),
                  "easy": ([f[0], f[6]], [f[1], f[7]])}[name]
    return stack_frame_data(prev), stack_frame_data(curr)


def track(scene, batch, cfg, **kw):
    prev, curr = pairs(scene, batch)
    return batched_track_pair(prev, curr, torch.tensor(scene["k"]), cfg, **kw)


def traced(fn):
    """``fn()`` with tracing on -> (its result, the drained record)."""
    tp.enable_tracing()
    try:
        out = fn()
    finally:
        tp.disable_tracing()
    return out, tp.drain()


def assert_same(a, b):
    """Equal bit for bit, through tuples and named tuples of tensors."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)


def test_tracing_off_records_nothing(scene, tracer):
    """Off, nothing is recorded, and not even a running profiler sees a
    span of the program."""
    from torch.profiler import ProfilerActivity, profile

    assert not tp.tracing()
    assert tp.trace_span("a") is tp.trace_span("b", level=1)
    tp.count("retracks", 3)
    session = BatchedOdometrySession(scene["camera"], fast(), batch=2, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for n in range(2):
            session.step(torch.tensor(np.stack([scene["grays"][n], scene["grays"][n + 4]])),
                         torch.tensor(np.stack([scene["depths"][n], scene["depths"][n + 4]])))
        track(scene, "hard", fast())
    record = tp.drain()
    assert record["spans"] == []
    assert not any(record["counters"].values())
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not names & {"session.step", "frame.upload", "track.pair", "track.level", "sync.loop"}


@pytest.mark.parametrize("batch", ["hard", "easy"])
def test_track_pair_same_on_and_off(scene, tracer, batch):
    off = track(scene, batch, fast())
    on, record = traced(lambda: track(scene, batch, fast()))
    assert_same(off, on)
    assert record["spans"] and record["counters"]["spans.dropped"] == 0


def _run_session(scene, kind):
    """Three steps of a session; -> each step's pose and diagnostics."""
    cfg = fast()
    out = []
    if kind == "stream":
        session = OdometrySession(scene["camera"], cfg, device="cpu")
        for n in (0, 1, 4):
            out.append((session.step(scene["grays"][n], scene["depths"][n]).matrix,
                        session.last_output.result))
    else:
        session = BatchedOdometrySession(scene["camera"], cfg, batch=2, device="cpu")
        for a, b in ((0, 6), (1, 7), (4, 6)):
            poses = session.step(
                torch.tensor(np.stack([scene["grays"][a], scene["grays"][b]])),
                torch.tensor(np.stack([scene["depths"][a], scene["depths"][b]])))
            out.append((poses, session.last_output.result))
    return out


@pytest.mark.parametrize("kind", ["stream", "batch"])
def test_sessions_same_on_and_off(scene, tracer, kind):
    off = _run_session(scene, kind)
    on, record = traced(lambda: _run_session(scene, kind))
    assert_same(off, on)
    roots = [s for s in record["spans"] if s["parent"] is None]
    assert [s["name"] for s in roots] == ["session.step"] * 3
    assert {s["streams"] for s in roots} == {1 if kind == "stream" else 2}


def test_span_tree_nests(scene, tracer):
    _, record = traced(lambda: _run_session(scene, "batch"))
    spans = {s["id"]: s for s in record["spans"]}
    assert all(s["end_ns"] >= s["start_ns"] for s in spans.values())
    children = {}
    for s in spans.values():
        if s["parent"] is None:
            continue
        parent = spans[s["parent"]]
        assert parent["start_ns"] <= s["start_ns"] and s["end_ns"] <= parent["end_ns"]
        assert s["step"] == parent["step"]
        children.setdefault(parent["name"], Counter())[s["name"]] += 1
    roots = sorted((s for s in spans.values() if s["parent"] is None),
                   key=lambda s: s["start_ns"])
    assert len({s["step"] for s in roots}) == 3
    assert set(children["session.step"]) == {"frame.upload", "frame.pyramid", "track.pair",
                                             "session.commit"}
    assert set(children["track.pair"]) <= {"track.init", "track.cascade", "sync.retrack"}
    assert set(children["level.solve"]) <= {"sync.loop", "sync.solve"}
    for cascade in (s for s in spans.values() if s["name"] == "track.cascade"):
        levels = sorted((s for s in spans.values()
                         if s["name"] == "track.level" and s["parent"] == cascade["id"]),
                        key=lambda s: s["start_ns"])
        assert [s["level"] for s in levels] == [3, 2, 1, 0]
        assert all(s["path"] == "kernel" or s["path"].startswith("lm.") for s in levels)
        assert cascade["retrack"] in (0, 1)
    inner = Counter()
    for s in spans.values():
        if s["name"] in ("level.inputs", "sync.trigger", "level.solve", "level.hessian"):
            assert spans[s["parent"]]["name"] == "track.level"
            inner[s["name"]] += 1
    n_levels = sum(1 for s in spans.values() if s["name"] == "track.level")
    assert inner["level.inputs"] == inner["sync.trigger"] == inner["level.solve"] == n_levels


@pytest.mark.parametrize("loop", ["lm", "gn"])
def test_one_sync_loop_per_read(scene, tracer, monkeypatch, loop):
    """``sync.loop`` spans: every iteration's read, and one more for each
    loop that ended on its done flags before its cap."""
    cfg = fast() if loop == "lm" else fast(lm_lambda0=None, use_level_kernel=False)
    runs = []
    real = {"lm": robust._lm_loop, "gn": robust._gn_loop}[loop]

    def spy(*a):
        out = real(*a)
        runs.append((int(out[3].iterations), a[5]))
        return out

    monkeypatch.setattr(robust, f"_{loop}_loop", spy)
    _, record = traced(lambda: track(scene, "hard", cfg))
    names = Counter(s["name"] for s in record["spans"])
    iterations = sum(it for it, _ in runs)
    assert runs and iterations > 0
    assert any(it < cap for it, cap in runs)
    assert names["sync.loop"] == sum(it + (it < cap) for it, cap in runs)
    assert names["sync.solve"] == iterations
    assert record["counters"]["loop.iterations"] == iterations
    paths = Counter(s["path"] for s in record["spans"] if s["name"] == "track.level")
    assert sum(paths[p] for p in paths if p.startswith(f"{loop}.")) == len(runs)


def _decisions(monkeypatch):
    """Record the batch-global trigger's and the retrack's decisions."""
    seen = []
    plain, counted = robust._any_over_ranks, robust._any_over_ranks_counted

    def spy_plain(mask, group):
        seen.append(plain(mask, group))
        return seen[-1]

    def spy_counted(mask, group, counts):
        out = counted(mask, group, counts)
        seen.append(out[0])
        return out

    monkeypatch.setattr(robust, "_any_over_ranks", spy_plain)
    monkeypatch.setattr(robust, "_any_over_ranks_counted", spy_counted)
    return seen


@pytest.mark.parametrize("term", ["rotation", "coverage"])
def test_trigger_terms_counted(scene, tracer, monkeypatch, term):
    """A guess rotated past ``fallback_max_rotation`` trips the rotation
    term; one moved a metre sideways leaves the shift ball and trips the
    coverage term.  The gather decisions are those of an untraced run."""
    cfg = fast(robust_init_selection=False)
    rot = 2.0 * cfg.fallback_max_rotation
    xi = [0.0, 0.0, 0.0, 0.0, rot, 0.0] if term == "rotation" else [1.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    guess = se3.exp(torch.tensor([xi, [0.0] * 6], dtype=torch.float32))
    seen = _decisions(monkeypatch)
    off = track(scene, "easy", cfg, init_guess=guess)
    off_decisions = list(seen)
    seen.clear()
    on, record = traced(lambda: track(scene, "easy", cfg, init_guess=guess))
    assert_same(off, on)
    assert seen == off_decisions and any(seen)
    counters = record["counters"]
    assert counters[f"stream_levels.hard.{term}"] >= 1
    spans = {s["id"]: s for s in record["spans"]}
    gather = [s for s in spans.values()
              if s["name"] == "track.level" and s["path"] == "lm.packed_exact"]
    first = [s for s in gather if spans[s["parent"]]["retrack"] == 0]
    assert counters["levels.gather"] == len(first) == sum(seen[:cfg.levels]) >= 1
    assert counters["stream_levels.gather"] == 2 * len(gather)


def test_retrack_counted(scene, tracer):
    """One stream over ``retrack_max_scale``: one retrack, one retracked
    stream, and of the second cascade's stream-levels only that stream's
    are kept."""
    cfg = fast()
    _, record = traced(lambda: track(scene, "retrack", cfg))
    c = record["counters"]
    assert c["retracks"] == 1 and c["streams.retracked"] == 1
    assert c.get("levels.gather", 0) == 0 and c["levels.kernel"] == cfg.levels
    assert c["levels.lm.packed_exact"] == cfg.levels
    assert c["stream_levels.gather"] == 2 * cfg.levels
    assert c["stream_levels.gather_kept"] == cfg.levels
    cascades = [s for s in record["spans"] if s["name"] == "track.cascade"]
    assert [s["retrack"] for s in cascades] == [0, 1]
    assert sum(s["name"] == "sync.retrack" for s in record["spans"]) == 1


def _clock_gap_us(scene) -> float:
    """One traced run under ``torch.profiler``: the largest gap (us)
    between a span's start or end and its ``record_function`` event's."""
    from torch.profiler import ProfilerActivity, profile

    tp.enable_tracing()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tp.trace_span("warm-up"):  # the profiler's first range sets it up
            pass
        track(scene, "easy", fast())
    tp.disable_tracing()
    spans = [s for s in tp.drain()["spans"] if s["name"] != "warm-up"]
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e)
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
    assert spans and set(by_name) <= set(events)
    worst = 0.0
    for name, ours in by_name.items():
        theirs = sorted(events[name], key=lambda e: e.start_ns())
        ours.sort(key=lambda s: s["start_ns"])
        assert len(theirs) == len(ours), name
        for s, e in zip(ours, theirs):
            worst = max(worst, abs(s["start_ns"] - e.start_ns()) / 1e3,
                        abs(s["end_ns"] - (e.start_ns() + e.duration_ns())) / 1e3)
    return worst


def test_spans_on_the_profiler_clock(scene, tracer):
    """Each span is a ``record_function`` range while a profiler runs, and
    its start and end lie within 200 us of that event's.  A host that
    deschedules the thread between the two stamps (a scheduler tick, 4 ms,
    under the parallel suite's load) parts them by the time it was away, so
    a run is made again, up to three times; a span on another clock fails
    every run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for _ in range(3):
            worst = _clock_gap_us(scene)
            if worst <= CLOCK_US:
                break
    finally:
        torch.set_num_threads(threads)
    assert worst <= CLOCK_US


def test_drain_clears_and_caps(tracer, monkeypatch):
    monkeypatch.setattr(tp, "MAX_SPANS", 3)
    tp.enable_tracing()
    with tp.trace_span("outer", streams=4) as outer:
        outer.set(path="kernel")
        for n in range(4):
            with tp.trace_span("inner", level=n):
                tp.count("loop.iterations", 2)
    tp.disable_tracing()
    record = tp.drain()
    assert [s["name"] for s in record["spans"]] == ["outer", "inner", "inner"]
    assert record["spans"][0]["path"] == "kernel" and record["spans"][0]["streams"] == 4
    assert record["counters"]["spans.dropped"] == 2
    assert record["counters"]["loop.iterations"] == 8
    assert {s["step"] for s in record["spans"]} == {record["spans"][0]["step"]}
    assert tp.drain() == {"spans": [], "counters": {
        "spans.dropped": 0, "lm_level.launches": 0, "fused_evaluation.launches": 0,
        "stack_accumulate.launches": 0, "median_pyr_down.launches": 0,
        "integrate_volume.launches": 0}}
