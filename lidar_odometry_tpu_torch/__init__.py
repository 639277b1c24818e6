"""lidar_odometry_tpu_torch — the PyTorch + CUDA (Hopper) port of the
JAX package beside it.

It mirrors the JAX package's layout (utils/ ops/ models/ io/), so every
module has one counterpart there, and it is held against that package on
the same numpy inputs by tests/test_torch_*.py. It imports torch and numpy
only: never jax, and nothing of the JAX package (importing any module
there imports jax), so the host-only modules it needs are copies.

Every kernel of the odometry main path is hand-written CUDA C++ under
csrc/, built with nvcc for sm_90a at first use and loaded with ctypes
(kernels.py). Each kernel's wrapper launches it for CUDA tensors and runs
its plain PyTorch twin, kept beside it, for CPU tensors only. Entry points
run on "cuda" unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry is float32 end to end. TF32 would keep ~10 mantissa bits, and
# the JAX reference forces full-f32 matmuls because reduced-precision
# operands lost ~0.4 m at 100 m range; state both switches explicitly.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
