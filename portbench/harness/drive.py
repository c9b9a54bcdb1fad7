"""What every entry shares: the frames, the schedule of the streams, the
measured window, and the result.

Streams play the cell's pool of rendered frames forwards and backwards,
each from its own offset drawn from the seed, so that a step's batch holds
pairs from every phase of the trajectory; every seed plays the same frames
in another order.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench.harness.cell import Cell
from portbench.scene import render, synthetic

# The scene and the trajectory are fixed by the traffic file; the run's
# seed draws the sensor noise and the streams' offsets.
CHROMA_AMPLITUDE = 20.0
CHROMA_CELL = 30


@dataclass
class Frames:
    rgb: torch.Tensor  # (N, H, W, 3) uint8 on the device
    depth: torch.Tensor  # (N, H, W) uint16 values in int16 storage, on the device
    poses: np.ndarray  # (N, 4, 4) camera-to-world, the truth
    intrinsics: np.ndarray  # (3, 3)
    depth_factor: float


def make_frames(cell: Cell, seed: int, device, size: Optional[tuple] = None) -> Frames:
    """The cell's pool, rendered and degraded on ``device``."""
    cfg, traffic = cell.config, cell.traffic
    h, w = size or (cfg["height"], cfg["width"])
    gray, depth, k = synthetic.textured_scene(h, w, seed=traffic["scene_seed"])
    cam = cfg["camera"]
    k = np.array([[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]], [0.0, 0.0, 1.0]],
                 np.float32)
    k[0] *= w / cfg["width"]
    k[1] *= h / cfg["height"]
    poses = cell.motion()(traffic["pool_frames"], traffic["trajectory_seed"], **traffic["motion"])
    chroma = CHROMA_AMPLITUDE * synthetic._smooth_noise(
        np.random.default_rng(traffic["scene_seed"] + 1), h, w, CHROMA_CELL)
    pool = render.make_pool(gray, depth, k, poses, seed, cfg["depth_factor"], chroma, device)
    return Frames(rgb=pool["rgb"], depth=pool["depth"], poses=poses, intrinsics=k,
                  depth_factor=float(cfg["depth_factor"]))


def motion_stats(poses: np.ndarray) -> Dict[str, float]:
    """Mean translation (mm) and rotation (deg) between consecutive poses."""
    rel = np.einsum("nij,njk->nik", np.linalg.inv(poses[1:]), poses[:-1])
    t = np.linalg.norm(rel[:, :3, 3], axis=1) * 1e3
    cos = np.clip((np.trace(rel[:, :3, :3], axis1=1, axis2=2) - 1) / 2, -1, 1)
    r = np.degrees(np.arccos(cos))
    return {"mean_mm": float(t.mean()), "mean_deg": float(r.mean()),
            "max_mm": float(t.max()), "max_deg": float(r.max())}


class Schedule:
    """Frame index of stream s at step k: a ping-pong over the pool from
    the stream's offset.  The offsets are spread evenly over the ping-pong's
    period and dealt to the streams in an order drawn from the seed, so that
    every seed's steps hold the same phases (one stream starts at the
    pool's first frame)."""

    def __init__(self, streams: int, pool: int, seed: int):
        self.pool = pool
        self.period = 2 * pool - 2
        spread = (np.arange(streams) * self.period) // streams
        self.offsets = np.random.default_rng(seed).permutation(spread)

    def frames(self, k: int) -> np.ndarray:
        p = (self.offsets + k) % self.period
        return np.where(p < self.pool, p, self.period - p)


@dataclass
class Window:
    outputs: List[np.ndarray] = field(default_factory=list)  # per step: (B, ROW) rows
    step_ms: List[float] = field(default_factory=list)
    seconds: float = 0.0


def run_window(step: Callable[[int], np.ndarray], first_step: int, seconds: float,
               max_steps: Optional[int] = None) -> Window:
    """Steps ``first_step``, ``first_step + 1``, ... until ``seconds`` have
    passed (or ``max_steps`` are done); each step's result is on the host."""
    win = Window()
    t0 = time.perf_counter()
    k = first_step
    while True:
        ts = time.perf_counter()
        win.outputs.append(step(k))
        te = time.perf_counter()
        win.step_ms.append((te - ts) * 1e3)
        k += 1
        if te - t0 >= seconds or (max_steps is not None and k - first_step >= max_steps):
            break
    win.seconds = te - t0
    return win


def device_info(chips: int) -> dict:
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i) for i in range(chips))),
    }


# A step's row per stream: the pose (camera-to-world, 16), the motion the
# step returned (previous camera -> current camera, 16), the success flag.
POSE, MOTION, SUCCESS = slice(0, 16), slice(16, 32), 32
ROW = 33


def pose_rows(poses: torch.Tensor, transforms: torch.Tensor, success: torch.Tensor) -> np.ndarray:
    """One host read of (B, 4, 4) poses and transforms and (B,) success
    -> (B, ROW)."""
    b = poses.shape[0]
    return torch.cat([poses.reshape(b, 16).float(), transforms.reshape(b, 16).float(),
                      success.reshape(b, 1).float()], 1).cpu().numpy()
