"""The port's ``apps/train_matcher.py`` against the JAX package's, on the CPU,
on a bundled-format directory of four 192x256 frames of the seeded synthetic
scene (``chip_smoke.bundled_dataset``).

- ``build_dataset`` (with and without augmentation, at scale 0.5 and 1) and
  ``real_pair_dataset`` equal the JAX package's bit for bit: the same
  ``default_rng`` stream, cv2 calls, renders and labels.
- ``evaluate`` and ``evaluate_fine`` with the committed weights: the same
  precision and recall, the subpixel errors within :data:`FINE_PX_ATOL`
  (1e-5 px).
- ``main([... --steps 3 --platform cpu])`` writes weights that both
  packages' ``load_params`` read, and prints the JAX tool's summary keys.
- The default ``-o`` lies in this package, outside the JAX package.
"""

import inspect
import json

import numpy as np
import pytest
import torch

from chip_smoke import bundled_dataset
from dense_visual_odometry_torch.apps import train_matcher as tt
from dense_visual_odometry_torch.models import matcher as tm
from dense_visual_odometry_tpu.apps import train_matcher as jt
from dense_visual_odometry_tpu.models import matcher as jm

FINE_PX_ATOL = 1e-5
SUMMARY_KEYS = {"final_loss", "holdout_precision", "holdout_recall", "holdout_fine_px",
                "holdout_coarse_px", "steps", "pairs", "scale"}


@pytest.fixture(scope="module")
def bundled(tmp_path_factory):
    return bundled_dataset(tmp_path_factory.mktemp("bundled"), 192, 256, 4)


def assert_same_data(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("flags", [[], ["--no-augment"], ["--scale", "1.0", "--seed", "3"]])
def test_build_dataset_bit_for_bit(bundled, flags):
    argv = ["--data-dir", str(bundled), "--pairs", "5", "--holdout", "2", *flags]
    got = tt.build_dataset(tt.parse_args(argv))
    assert_same_data(got, jt.build_dataset(jt.parse_args(argv)))
    assert got["gray1"].shape[0] == 7 and (got["gt"] >= 0).mean() > 0.5


def test_real_pair_dataset_bit_for_bit(bundled):
    pairs = [(0, 3), (1, 2), (2, 2)]
    assert_same_data(tt.real_pair_dataset(pairs, str(bundled)),
                     jt.real_pair_dataset(pairs, str(bundled)))


def test_evaluate_matches_jax(bundled):
    data = tt.build_dataset(tt.parse_args(["--data-dir", str(bundled), "--pairs", "2",
                                           "--holdout", "2"]))
    hold = np.arange(2, 4)
    params, model = jm.load_params(), tm.load_matcher(device="cpu")
    assert tt.evaluate(model, data, hold) == jt.evaluate(params, data, hold)
    got, want = tt.evaluate_fine(model, data, hold), jt.evaluate_fine(params, data, hold)
    np.testing.assert_allclose(got, want, rtol=0, atol=FINE_PX_ATOL)
    assert got[0] < got[1]  # the trained head beats the cell centres


def test_main_writes_weights_and_prints_the_jax_keys(bundled, tmp_path, capsys):
    out = tmp_path / "w" / "m.npz"
    summary = tt.main(["--data-dir", str(bundled), "--steps", "3", "--pairs", "2",
                       "--holdout", "1", "--dim", "32", "--layers", "1", "--platform", "cpu",
                       "-o", str(out)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == SUMMARY_KEYS
    # The JAX tool prints the same keys (read from its source, not run: its
    # main points JAX's compile cache at the repository).
    source = inspect.getsource(jt.main)
    assert all(f'"{k}"' in source for k in SUMMARY_KEYS)
    assert printed == {k: summary[k] for k in SUMMARY_KEYS}
    assert len(summary["losses"]) == len(summary["step_s"]) == 3
    assert np.isfinite(summary["losses"]).all() and printed["steps"] == 3
    want = tm.init_params(torch.Generator().manual_seed(0), dim=32, layers=1)
    for read in (tm.load_params(out), {k: np.asarray(v) for k, v in jm.load_params(out).items()}):
        assert {k: v.shape for k, v in read.items()} == {k: v.shape for k, v in want.items()}
    assert not np.array_equal(tm.load_params(out)["conv0_w"], want["conv0_w"])  # trained


def test_default_output_outside_the_jax_package():
    out = tt.parse_args([]).output
    assert out == str(tt.DEFAULT_OUTPUT)
    jax_pkg = jm.DEFAULT_WEIGHTS.resolve().parents[1]
    assert jax_pkg.name == "dense_visual_odometry_tpu"
    assert jax_pkg not in tt.DEFAULT_OUTPUT.resolve().parents
    assert tt.DEFAULT_OUTPUT.resolve().parents[1].name == "dense_visual_odometry_torch"
    assert tm.DEFAULT_WEIGHTS.resolve() == jm.DEFAULT_WEIGHTS.resolve()  # serving reads JAX's
