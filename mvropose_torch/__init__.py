"""MvRoPose on PyTorch and CUDA: a port of `mvropose_tpu` to one NVIDIA H100.

The JAX package `mvropose_tpu` is the reference; every module here names its
counterpart there and is held against it by the `tests/test_torch_*` parity
tests. The port imports torch and numpy and never jax or flax. The one piece
it shares with the reference is the numpy-only rig layer
(`mvropose_tpu.rig`: camera sources and the streaming loop).

Layering (bottom-up), mirroring the reference:
  csrc/      CUDA C++ kernels for Hopper (sm_90a), built with nvcc at first use
  ops/       kernel wrappers (ctypes-bound) beside their plain-torch versions
  geometry/  rotations, camera, FK, triangulation, PnP, heatmaps, in plain torch
  decode/    heatmap -> keypoint decoding (kernel on CUDA tensors)
  pose/      keypoints + FK -> per-camera pose (RANSAC PnP, joint refinement)
  models/    ViT backbone, CNN stem, UNet/angle heads, multi-view fusion
  utils/     weight bridge from `save_params_npz` files, seeded random init
  cli/       the `serve` subcommand
"""

__version__ = "0.1.0"
