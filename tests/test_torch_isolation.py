"""The port stands alone: no JAX, no JAX package, and no silent CPU fallback.

- No file of ``dense_visual_odometry_torch`` nor ``chip_smoke.py`` imports
  ``jax`` or ``dense_visual_odometry_tpu`` (checked on the syntax tree).
- With both made unimportable, every module of the port and
  ``chip_smoke.py`` still load (in a subprocess).
- Without a GPU, the entry points' default device raises instead of running
  on the CPU, and ``chip_smoke.py`` exits non-zero without printing a result,
  also from a directory that holds nothing else of the repository.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "dense_visual_odometry_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "dense_visual_odometry_tpu")


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def _clean_env() -> dict:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_loads_without_jax():
    modules = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted(PORT.rglob("*.py"))
    ]
    code = (
        "import sys\n"
        + "".join(f"sys.modules[{name!r}] = None\n" for name in FORBIDDEN)
        + "import importlib\n"
        + f"for m in {modules!r}:\n    importlib.import_module(m)\n"
        + "import chip_smoke\n"
        + "assert not any(k.split('.')[0] in "
        + f"{FORBIDDEN!r} and v is not None for k, v in sys.modules.items())\n"
        + "print('loaded', len(" + repr(modules) + "))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().startswith("loaded")


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")


def test_entry_points_default_to_the_gpu():
    _no_gpu()
    from dense_visual_odometry_torch.apps import benchmark
    from dense_visual_odometry_torch.camera import CameraModel
    from dense_visual_odometry_torch.config import RobustDVOConfig
    from dense_visual_odometry_torch.models.batched_session import (
        BatchedOdometrySession,
        init_batched_state,
    )
    from dense_visual_odometry_torch.models.robust import preprocess_frame
    from dense_visual_odometry_torch.models.session import OdometrySession, init_state
    from dense_visual_odometry_torch.models.sparse import SparseVO

    cam = CameraModel.create(np.eye(3), 1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        OdometrySession(cam, RobustDVOConfig.from_json(ROOT / "configs" / "tpu_fast.json"))
    with pytest.raises(RuntimeError, match="CUDA"):
        preprocess_frame(np.zeros((8, 8), np.float32), np.zeros((8, 8), np.float32),
                         cam, levels=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(8, 8, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedOdometrySession(cam)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_batched_state(2, 8, 8, 2)
    for matcher in ("zncc", "learned"):
        with pytest.raises(RuntimeError, match="CUDA"):
            SparseVO(cam, matcher=matcher)
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark.main(["tum", "-d", "missing", "-m", "sparse"])
    # Asked for explicitly, the CPU runs the plain versions.
    OdometrySession(cam, device="cpu")
    SparseVO(cam, matcher="learned", device="cpu")


def _run_chip_smoke(cwd: Path):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=_clean_env(),
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    _no_gpu()
    out = _run_chip_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "cuda" in out.stderr.lower()


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_chip_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
