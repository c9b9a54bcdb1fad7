"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain versions.

- ``level_solver``: a whole pyramid level's LM solve per launch.
- ``fused_iter``: one photometric evaluation reduced to 56 scalars.
- ``stackwarp``: the frozen window sampled at per-pixel displacements.

A wrapper launches its kernel for CUDA tensors and runs the plain PyTorch
version for CPU tensors; each counts its launches in ``<wrapper>.launches``.
"""
