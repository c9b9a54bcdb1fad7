"""Tracking models: the robust frame-to-frame solver, the odometry sessions,
the SLAM back end (keyframe SLAM, the pose graph, dense BA), mapping (dense
and brick TSDF volumes, raycasts, mesh export, frame-to-model tracking) and
sparse odometry (``models.sparse``, ``models.matcher``: imported from their
modules, as in the JAX package)."""

from dense_visual_odometry_torch.models.batched_slam import BatchedSlamSession  # noqa: F401
from dense_visual_odometry_torch.models.brick_tsdf import (  # noqa: F401
    BrickTSDFConfig,
    BrickTSDFVolume,
    dense_crop,
    extract_mesh_bricks,
    integrate_brick,
    make_brick_volume,
    raycast_view_march_brick,
)
from dense_visual_odometry_torch.models.dense_ba import (  # noqa: F401
    DenseBAConfig,
    DenseBAData,
    DenseBAResult,
    build_dense_ba_data,
    optimize_dense_ba,
)
from dense_visual_odometry_torch.models.frame_to_model import (  # noqa: F401
    FrameToModelTracker,
    ModelTrackerPolicy,
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
from dense_visual_odometry_torch.models.tsdf import (  # noqa: F401
    TSDFConfig,
    TSDFVolume,
    extract_mesh,
    integrate,
    integrate_frames,
    make_volume,
    raycast_view,
    raycast_view_march,
    save_mesh_obj,
    save_mesh_ply,
)
