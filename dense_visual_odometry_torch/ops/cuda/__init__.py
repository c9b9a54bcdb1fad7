"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain versions.

- ``level_solver``: a whole pyramid level's LM solve per launch.
- ``fused_iter``: one photometric evaluation of a pose reduced to its 6x6
  system, on the level kernel's inputs.
- ``stackwarp``: the frozen window sampled at per-pixel displacements.
- ``pyramid``: one image-pyramid step, the 3x3 median at the kept pixels.
- ``tsdf``: one frame fused into a whole dense TSDF volume, in place; a
  view of the volume rendered by the volume march.

A wrapper launches its kernel for CUDA tensors and runs the plain PyTorch
version for CPU tensors (``tsdf``'s callers in ``models/tsdf.py``,
``integrate`` and ``raycast_view_march_volume``, do that for it); each
counts its launches in ``<wrapper>.launches``.
"""
