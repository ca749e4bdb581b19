"""PyTorch/CUDA port of the real-time video deepfake detection framework.

The JAX package `real_time_video_deepfake_detection_tpu` is the reference;
this package mirrors its module layout (core, state, ops, kernels, models,
pipeline, serving, utils, train) so each module has a counterpart there.
It imports torch and numpy only. Entry points take an explicit `device` and
run on "cuda" unless the caller passes device="cpu"; the hand-written CUDA
kernels under csrc/ are built with nvcc at first use on a CUDA device and
replaced by their plain torch versions for CPU tensors.
"""

__version__ = "0.1.0"
