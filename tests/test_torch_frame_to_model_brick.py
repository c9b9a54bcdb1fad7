"""``FrameToModelTracker`` of the port against the JAX package's on a brick
volume in KinectFusion mode, on the CPU: the checks of
``test_torch_frame_to_model.py`` (which holds the scene, the tolerances and
why), in a file of their own so that each file's JAX compile stays alone."""

from tests.test_torch_frame_to_model import (  # noqa: F401  (fixtures)
    end_to_end,
    failed_solve_leaves_the_volume,
    one_torch_thread,
    scene,
)

MODE = "kinfu_brick"


def test_tracks_like_jax(scene):
    end_to_end(scene, MODE)


def test_failed_solve_leaves_the_volume(scene):
    failed_solve_leaves_the_volume(scene, MODE)
