"""Tracking models: the robust frame-to-frame solver, the odometry sessions
and the SLAM back end (keyframe SLAM, the pose graph, dense BA)."""

from dense_visual_odometry_torch.models.batched_slam import BatchedSlamSession  # noqa: F401
from dense_visual_odometry_torch.models.dense_ba import (  # noqa: F401
    DenseBAConfig,
    DenseBAData,
    DenseBAResult,
    build_dense_ba_data,
    optimize_dense_ba,
)
from dense_visual_odometry_torch.models.posegraph import (  # noqa: F401
    PoseGraphEdges,
    PoseGraphResult,
    build_normal_system,
    concat_edges,
    edge_residual,
    odometry_chain_edges,
    optimize_pose_graph,
    solve_normal_system,
)
from dense_visual_odometry_torch.models.slam import KeyframePolicy, SlamSession  # noqa: F401
