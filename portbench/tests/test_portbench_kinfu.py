"""``correct`` in the KinectFusion cell (``kinfu512.b1.desk``): a sound run
passes; a frame left unfused, a fusion at a pose 2 mm off, a render shifted
by half a voxel, a render whose gray is sampled before the refinement, or
the reference put in the program's place and computed in TF32 (the
control), fails.

On the CPU the runs are the cell's own entry and judge at 240x320 with a
256^3 cube of the stated 3 m (the truncation kept at 5.1 voxels), twelve
pool frames and eight steps, four of them sampled; the test marked ``cuda``
reads the control at the cell's own size on the card."""

import dataclasses
import time

import pytest
import torch

from portbench import control_kinfu
from portbench.harness import check, map_check
from portbench.harness.cell import load_cell

CELL = "kinfu512.b1.desk"
SMALL = map_check.Options(device="cpu", size=(240, 320), pool_frames=12, max_steps=8,
                            resolution=256, samples=4)
SEED = 4_000_000_017


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def run_small():
    cell = load_cell(CELL)
    outcome = cell.entry().run(cell, SEED, 1e9, False, time.perf_counter(), SMALL)
    return cell, outcome, check.verdict(outcome.numbers, cell.limits)[0]


@pytest.fixture(scope="module")
def sound():
    return run_small()


def test_sound_run_is_correct(sound):
    cell, outcome, ok = sound
    assert ok, outcome.numbers
    assert outcome.numbers["pairs"] == SMALL.samples
    assert set(cell.limits) <= set(outcome.numbers)


def test_control_is_not_correct_at_a_small_size(sound):
    cell, outcome, _ = sound
    readings = control_kinfu.tf32_reference(outcome.notes["evidence"])
    assert not check.verdict(readings, cell.limits)[0], readings
    # TF32's rounding moves most voxels' projections and every render.
    for name in ("fuse_diff_pct", "render_gap_mm_p50", "render_gray_gap_p50"):
        assert readings[name] > cell.limits[name], (name, readings[name])


def unfused(tracker_cls):
    integrate = tracker_cls._integrate

    def broken(self, fd, world):
        if self._frame_idx % 2 == 0:  # every second frame left out
            integrate(self, fd, world)
    return broken


def moved(tracker_cls):
    integrate = tracker_cls._integrate

    def broken(self, fd, world):
        world = world.clone()
        world[0, 3] += 0.002  # fused 2 mm off the returned pose
        integrate(self, fd, world)
    return broken


def shifted(march):
    def broken(volume, intrinsics, pose, cfg, *args, **kwargs):
        ox, oy, oz = cfg.origin
        cfg = dataclasses.replace(cfg, origin=(ox + cfg.voxel_size / 2, oy, oz))
        return march(volume, intrinsics, pose, cfg, *args, **kwargs)
    return broken


def gray_unrefined(surface):
    """The render's depth as it is, its gray sampled at the crossing before
    the refinement: only the photometric template moves."""
    from dense_visual_odometry_torch.models import tsdf

    def broken(cfg, rays, phi_field, gray_field, found, t_hit):
        depth, _ = surface(cfg, rays, phi_field, gray_field, found, t_hit)
        gray = tsdf.trilinear_sample(cfg, rays, gray_field, t_hit)
        return depth, torch.where(depth > 0, gray, torch.zeros_like(gray))
    return broken


@pytest.mark.parametrize("fault", ["unfused", "moved", "shifted", "gray_unrefined"])
def test_broken_mapping_is_not_correct(fault, monkeypatch):
    from dense_visual_odometry_torch.models import frame_to_model as f2m
    from dense_visual_odometry_torch.models import tsdf

    tracker = f2m.FrameToModelTracker
    if fault == "shifted":
        monkeypatch.setattr(f2m, "raycast_view_march_volume",
                            shifted(f2m.raycast_view_march_volume))
    elif fault == "gray_unrefined":
        monkeypatch.setattr(tsdf, "_surface", gray_unrefined(tsdf._surface))
    else:
        monkeypatch.setattr(tracker, "_integrate", {"unfused": unfused,
                                                    "moved": moved}[fault](tracker))
    cell, outcome, ok = run_small()
    assert not ok, outcome.numbers
    if fault == "gray_unrefined":  # the motion hardly moves: the gray's own limit fails
        assert outcome.numbers["render_gray_gap_p50"] > cell.limits["render_gray_gap_p50"]


def test_parent_without_the_volume_march_fails_at_once(monkeypatch):
    """A port without the volume march (no ``tsdf.VOLUME_MARCH_STEP``)
    refuses the cell before any frame is made."""
    from dense_visual_odometry_torch.models import tsdf

    monkeypatch.delattr(tsdf, "VOLUME_MARCH_STEP")
    cell = load_cell(CELL)
    t0 = time.perf_counter()
    with pytest.raises(ImportError):
        cell.entry().run(cell, SEED, 1e9, False, t0, SMALL)
    assert time.perf_counter() - t0 < 5.0


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card(cuda):
    cell = load_cell(CELL)
    outcome = cell.entry().run(cell, SEED, 3.0, False, time.perf_counter())
    assert check.verdict(outcome.numbers, cell.limits)[0], outcome.numbers
    readings = control_kinfu.tf32_reference(outcome.notes["evidence"])
    assert not check.verdict(readings, cell.limits)[0], readings
