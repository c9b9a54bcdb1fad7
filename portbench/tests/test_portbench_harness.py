"""The harness's pieces: metric readers, the result line, discovery by
name, the import check and the roofline's arithmetic."""

import json
import shutil
import sys

import pytest

from portbench import roofline
from portbench.harness import readers, trace
from portbench.harness.cell import BENCH_DIR, ROOT, load_cell
from portbench.harness.runner import Outcome


def fixture_record() -> trace.Record:
    """Two profiled steps of 10 ms: kernels, a copy, idle gaps; the first
    step kept its levels on the level kernel, the second did not."""
    rec = trace.Record(step_ms=[30.0, 10.0, 20.0], window_steps=3,
                       level_launches=9, eligible_levels=4)
    rec.host_read_steps, rec.host_reads = 2, 14
    rec.profiled_steps = 2
    rec.window_us = 20_000.0
    rec.device = [
        ("void level_kernel(LevelParams)", 0.0, 1_000.0),
        ("void at::native::elementwise_kernel<...>", 500.0, 2_500.0),  # overlaps the first
        ("Memcpy DtoH (Device -> Pinned)", 3_000.0, 3_100.0),
        ("fused_kernel", 4_000.0, 4_500.0),
        ("void at::native::reduce_kernel<...>", 5_000.0, 5_400.0),
        ("void level_kernel(LevelParams)", 10_000.0, 12_000.0),
    ]
    rec.steps = [(0.0, 10_000.0), (10_000.0, 20_000.0)]
    rec.level_bound_ms = [0.25, None]
    return rec


def test_readers_on_a_recorded_fixture():
    rec = fixture_record()
    assert readers.step_ms_p50(rec) == 20.0
    assert readers.level_kernel_share(rec) == pytest.approx(75.0)  # 9 / (4 x 3)
    assert readers.host_reads(rec) == 7.0
    # elementwise, reduce: 2 kernels in 2 steps; not the copy, not the port's.
    assert readers.glue_kernels(rec) == 1.0
    busy = 2_500.0 + 100.0 + 500.0 + 400.0 + 2_000.0  # the union, not the sum
    assert readers.idle_pct(rec) == pytest.approx(100.0 * (1 - busy / 20_000.0))
    # The first step's bound over its 1 ms of the level kernel; the second
    # step's 2 ms are left out with its bound.
    assert readers.level_roofline(rec) == pytest.approx(25.0)


def test_readers_return_none_without_anything_to_read():
    rec = trace.Record(step_ms=[], window_steps=0, level_launches=0,
                       eligible_levels=0)
    for read in (readers.step_ms_p50, readers.level_kernel_share, readers.host_reads,
                 readers.glue_kernels, readers.level_roofline, readers.idle_pct):
        assert read(rec) is None
    rec = fixture_record()
    rec.level_bound_ms = [None, None]  # no step kept its levels on the kernel
    assert readers.level_roofline(rec) is None


def test_every_metric_file_reads_the_fixture():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = load_cell(bench["workloads"][0]["name"])
    for spec in bench["per_layer"]:
        value = cell.reader(spec["name"])(fixture_record())
        assert value is None or value >= 0.0, spec["name"]


def test_gaps_are_named_by_the_host_frame():
    stack = ["torch/_tensor.py(40): item",
             "dense_visual_odometry_torch/models/robust.py(301): _lm_loop",
             "dense_visual_odometry_torch/models/session.py(60): session_step"]
    cpu = [("aten::add", 0.0, 30.0, []), ("aten::item", 40.0, 60.0, stack)]
    assert trace.host_frame(cpu, 50.0) == "robust._lm_loop > aten::item"
    assert trace.host_frame(cpu, 35.0) == "aten::add"  # the op that ended last
    assert trace.host_frame(cpu, -1.0) == "host"
    assert trace.idle_gaps([(0.0, 1.0), (3.0, 4.0)], 0.0, 5.0) == [(1.0, 3.0), (4.0, 5.0)]


def test_the_last_line_has_its_keys():
    from portbench import run

    cell = load_cell("fast.b256.xyz")
    outcome = Outcome(attempted=10, failed=0,
                      metrics={"tracked_fps": 1.0, "setup_s": 2.0, "frame_ms_p50": 3.0,
                               "frame_ms_p95": 4.0},
                      numbers={"motion_gap_mm": 0.1}, record=fixture_record())
    device = {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 1}
    checks = {"motion_gap_mm": {"value": 0.1, "limit": 1.0}}
    line = run.result_line(cell, outcome, False, True, checks, device)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"tracked_fps", "setup_s"}
    traced = run.result_line(cell, outcome, True, True, checks, device)
    assert list(traced)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(traced["breakdown"]["device_ops"]) <= 10
    assert "tracker.level_kernel_share.batch" in traced["metrics"]
    assert "tracker.level_kernel_share.stream" not in traced["metrics"]


def test_files_are_found_by_name(tmp_path):
    """A configuration, a mix, a generator, a metric and a cell added as
    files of their own, with no file that is there edited."""
    shutil.copytree(BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "portbench"
    cfg = json.loads((b / "configs" / "fr1-fast.json").read_text())
    (b / "configs" / "fr2-new.json").write_text(json.dumps(dict(cfg, name="fr2-new")))
    mix = json.loads((b / "traffic" / "xyz.b256.json").read_text())
    (b / "traffic" / "walk.b32.json").write_text(json.dumps(dict(mix, streams=32, generator="still")))
    (b / "motion" / "still.py").write_text(
        "import numpy as np\n\ndef poses(n, seed, **params):\n    return np.tile(np.eye(4), (n, 1, 1))\n")
    (b / "metrics" / "new.count.batch.py").write_text("def read(record):\n    return 42.0\n")
    (b / "limits" / "new.b32.walk.json").write_text(json.dumps({"motion_gap_mm": 1.0}))
    bench["configs"].append({"name": "fr2-new", "source": "x", "file": "portbench/configs/fr2-new.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new.b32.walk", "config": "fr2-new", "traffic": "walk.b32",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new.count.batch", "unit": "n", "better": "lower",
                               "source": "program_counter", "layer": "x", "moves": "tracked_fps",
                               "workloads": ["new.b32.walk"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("new.b32.walk", tmp_path)
    assert cell.config["name"] == "fr2-new" and cell.traffic["streams"] == 32
    assert cell.motion()(3, 0).shape == (3, 4, 4)
    assert cell.reader("new.count.batch")(None) == 42.0
    assert [m["name"] for m in cell.metric_specs(True)][-1] == "new.count.batch"
    assert cell.limits == {"motion_gap_mm": 1.0}


def test_import_check_compares_whole_top_level_names(monkeypatch):
    from portbench import run

    assert "dense_visual_odometry_torch" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    monkeypatch.setitem(sys.modules, "dense_visual_odometry_tpu_extra", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "dense_visual_odometry_tpu", object())
    assert run.forbidden_modules() == ["dense_visual_odometry_tpu", "jax"]


def test_level_bound_reads_perf_md():
    """PERF.md's level-0 B=64 bound, 0.0761 ms by bytes (chip_smoke.py's
    phase 3), is met at a valid share of 0.7414 of the 240 x 320 grid."""
    npx = 240 * 320
    out = roofline.level_solve_work((64, 240, 320), 2, [0.7414 * npx] * 64, [5.0] * 64)
    b = roofline.bound(*out)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(0.0761, abs=5e-5)
    full = roofline.bound(*roofline.level_solve_work((64, 240, 320), 2, [npx] * 64, [5.0] * 64))
    assert full["bound_ms"] > b["bound_ms"]


def test_level_step_bound_reads_the_diagnostics():
    """A step's bound from the finest size, the tier's strides and the
    diagnostics: level 0 alone reads PERF.md's bound; levels 0 and 1 add
    level 1's grid (240 x 320 at stride 2, 120 x 160 a stride-2 grid)."""
    npx = 240 * 320
    counts = [[0.7414 * npx] * 64, [0.7 * 120 * 160] * 64]
    alone = roofline.level_step_bound_ms((480, 640), (2, 2, 1, 1), [0], counts, [5, 7])
    assert alone == pytest.approx(0.0761, abs=5e-5)
    both = roofline.level_step_bound_ms((480, 640), (2, 2, 1, 1), [0, 1], counts, [5, 7])
    level1 = roofline.bound(*roofline.level_solve_work((64, 120, 160), 2, counts[1], [7] * 64))
    assert both == pytest.approx(alone + level1["bound_ms"])
