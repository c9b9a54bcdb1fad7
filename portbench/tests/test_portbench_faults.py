"""``correct`` against the cells' limits: a sound run passes; the timed path
broken underneath, or the reference put in its place and computed in TF32
(the control), fails.

On the CPU the runs are the cells' own at 640x480 with two streams, eight
pool frames and three steps; the test marked ``cuda`` reads the control at
a cell's own size on the card."""

import time

import pytest
import torch

from portbench import control
from portbench.harness import check, runner
from portbench.harness.cell import load_cell

SMALL = runner.Options(device="cpu", streams=2, pool_frames=8, max_steps=3)
SEED = 4_000_000_017


def run_small(workload, opts=SMALL):
    cell = load_cell(workload)
    if cell.traffic["streams"] == 1:
        opts = runner.Options(**{**opts.__dict__, "streams": 1})
    outcome = cell.entry().run(cell, SEED, 1e9, False, time.perf_counter(), opts)
    return cell, outcome, check.verdict(outcome.numbers, cell.limits)[0]


def unchanged(step):
    def broken(state, *args, **kwargs):
        _, out = step(state, *args, **kwargs)
        return state, out._replace(pose=state.pose)
    return broken


def half_left_out(step):
    def broken(state, *args, **kwargs):
        new, out = step(state, *args, **kwargs)
        h = state.pose.shape[0] // 2

        def mix(n, o):
            if isinstance(n, tuple):
                return type(n)(*(mix(a, b) for a, b in zip(n, o))) if hasattr(n, "_fields") \
                    else tuple(mix(a, b) for a, b in zip(n, o))
            return torch.cat([n[:h], o[h:]])

        new = mix(new, state)
        return new, out._replace(pose=new.pose)
    return broken


def altered(step):
    def broken(state, *args, **kwargs):
        new, out = step(state, *args, **kwargs)
        pose = new.pose.clone()
        pose[..., 0, 3] += 0.002  # 2 mm where the answer is produced
        return new._replace(pose=pose), out._replace(pose=pose)
    return broken


def keep_old(new, old, mask):
    """``new`` with ``old`` where ``mask`` (per stream, or one flag) is set."""
    if isinstance(new, tuple):
        parts = [keep_old(a, b, mask) for a, b in zip(new, old)]
        return type(new)(*parts) if hasattr(new, "_fields") else tuple(parts)
    m = mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim())) if mask.dim() else mask
    return torch.where(m, old, new)


def refused(step):
    """Half the batch refused: success flags false, pose and state kept
    (one stream: every second frame)."""
    calls = [0]

    def broken(state, *args, **kwargs):
        new, out = step(state, *args, **kwargs)
        calls[0] += 1
        if out.success.dim():
            mask = torch.arange(out.success.shape[0], device=out.success.device) < max(
                1, out.success.shape[0] // 2)
        else:
            mask = torch.tensor(calls[0] % 2 == 0, device=out.success.device)
        new = keep_old(new, state, mask)
        return new, out._replace(pose=new.pose, success=out.success & ~mask)
    return broken


FAULTS = {"unchanged": unchanged, "half": half_left_out, "altered": altered,
          "refused": refused}
STEPS = {"fast.b256.xyz": ("batched_session", "batched_session_step"),
         "fast.b64.desk": ("batched_session", "batched_session_step"),
         "parity.b1.desk": ("session", "session_step")}


@pytest.mark.parametrize("workload", sorted(STEPS))
def test_sound_run_is_correct(workload):
    _, outcome, ok = run_small(workload)
    assert ok, outcome.numbers


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", sorted(STEPS))
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    if fault == "half" and workload.startswith("parity.b1"):
        pytest.skip("one stream has no half to leave out")
    import importlib

    module, name = STEPS[workload]
    mod = importlib.import_module(f"dense_visual_odometry_torch.models.{module}")
    monkeypatch.setattr(mod, name, FAULTS[fault](getattr(mod, name)))
    _, outcome, ok = run_small(workload)
    assert not ok, outcome.numbers


def test_refused_frames_fail_only_by_their_share():
    """Refused frames keep their poses, so the pose numbers pass; the
    share of refused frames alone fails."""
    import importlib

    mod = importlib.import_module("dense_visual_odometry_torch.models.batched_session")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "batched_session_step", refused(mod.batched_session_step))
        cell, outcome, ok = run_small("fast.b64.desk")
    assert not ok
    failing = [n for n, limit in cell.limits.items() if not outcome.numbers[n] <= limit]
    assert failing == ["lost_pct"], outcome.numbers
    assert outcome.numbers["lost_pct"] == pytest.approx(50.0)


@pytest.mark.parametrize("workload", ["fast.b256.xyz", "parity.b1.desk"])
def test_control_is_not_correct_at_a_small_size(workload):
    cell, outcome, ok = run_small(workload)
    assert ok
    readings = control.tf32_reference(outcome.notes["evidence"], SEED, 8, 2)
    assert not check.verdict(readings | {"pairs": 8.0}, cell.limits)[0], readings
    for name in ("gray_gap", "depth_gap"):  # the pyramids' TF32 error needs no long run
        assert readings[name] > cell.limits[name], (name, readings[name])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["fast.b256.xyz", "parity.b1.desk", "fast.b64.desk"])
def test_control_is_not_correct_on_the_card(workload, cuda):
    cell = load_cell(workload)
    outcome = cell.entry().run(cell, SEED, 2.0, False, time.perf_counter())
    assert check.verdict(outcome.numbers, cell.limits)[0]
    readings = control.tf32_reference(outcome.notes["evidence"], SEED,
                                      cell.traffic["check_pairs"], cell.traffic["state_streams"])
    assert not check.verdict(readings | {"pairs": 1.0}, cell.limits)[0], readings
