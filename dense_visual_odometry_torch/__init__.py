"""Dense visual odometry in PyTorch with hand-written CUDA kernels for Hopper.

The port of ``dense_visual_odometry_tpu`` (the JAX package, kept beside it as
the reference).  It carries frame-to-frame robust photometric odometry under
every shipped configuration (``configs/*.json``): ``models.robust.track_pair``,
``parallel.batched.batched_track_pair``, ``models.session.OdometrySession``
and the multi-stream ``models.batched_session.BatchedOdometrySession``, and
the SLAM back end on one device: keyframe SLAM (``models.slam.SlamSession``,
``models.batched_slam.BatchedSlamSession``), the windowed pose graph
(``models.posegraph``) and dense bundle adjustment (``models.dense_ba``),
mapping (``models.tsdf``, ``models.brick_tsdf``, ``models.frame_to_model``),
and sparse odometry (``models.sparse.SparseVO`` with Harris + ZNCC or the
LoFTR-lite matcher of ``models.matcher``, which ``apps.train_matcher``
trains).  The three kernels of the
tracker live in ``ops/cuda``; each has a plain PyTorch version that the CPU
runs.

Geometry stays in full float32: TF32 is switched off for matrix products
and convolutions, as the JAX package forces highest matmul precision.
"""

__version__ = "0.1.0"

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from dense_visual_odometry_torch.camera import CameraModel  # noqa: E402,F401
from dense_visual_odometry_torch.config import RobustDVOConfig  # noqa: E402,F401
from dense_visual_odometry_torch.utils.lie import Pose  # noqa: E402,F401
