"""A cell as ``BENCHMARK.json`` names it, and the files it is made of.

Every piece is found by its name, so that a later change adds a
configuration, a traffic mix, a motion generator, an entry or a per-layer
metric as a file of its own:

- ``configs/<config>.json``: the deployment (camera, resolution, depth
  factor, the tracker's tier file under the checkout's ``configs/``);
- ``traffic/<traffic>.json``: the mix (entry, streams, chips, motion
  generator and its parameters, pool, where the frames live, the loop);
- ``motion/<generator>.py``: ``poses(n, seed, **params)``;
- ``entries/<entry>.py``: ``run(cell, args) -> Outcome``;
- ``metrics/<metric>.py``: ``read(record)`` -> a number or None;
- ``limits/<workload>.json``: the limits of the numbers that ``correct``
  compares in that cell.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: str):
    """A module loaded from ``path``: names may hold dots, so files are
    loaded by path, not by import name."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    with path.open() as fp:
        return json.load(fp)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict
    root: Path = ROOT
    bench_dir: Path = BENCH_DIR

    def metric_specs(self, trace: bool) -> List[dict]:
        """The metrics this cell reports: its end-to-end ones with
        ``trace`` off, its per-layer ones with it on."""
        specs = self.per_layer if trace else self.end_to_end
        return [m for m in specs if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric: str) -> Callable:
        return load_module(self.bench_dir / "metrics" / f"{metric}.py",
                           f"portbench_metric_{metric}").read

    def motion(self) -> Callable:
        gen = self.traffic["generator"]
        return load_module(self.bench_dir / "motion" / f"{gen}.py",
                           f"portbench_motion_{gen}").poses

    def entry(self):
        name = self.traffic["entry"]
        return load_module(self.bench_dir / "entries" / f"{name}.py", f"portbench_entry_{name}")


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files."""
    bench_dir = root / BENCH_DIR.name
    bench = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(root / configs[w["config"]]["file"])
    traffic = read_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = read_json(bench_dir / "limits" / f"{workload}.json")
    return Cell(name=workload, config=config, traffic=traffic, chips=int(w["chips"]),
                end_to_end=bench["end_to_end"], per_layer=bench["per_layer"],
                limits=limits, root=root, bench_dir=bench_dir)
