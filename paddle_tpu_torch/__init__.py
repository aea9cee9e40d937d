"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The fluid API (Program IR, layers, Executor, io) and the inference
predictor, run eagerly by PyTorch on an NVIDIA GPU.  Each Pallas kernel
of the JAX package is replaced by a CUDA kernel written by hand for
Hopper (``ops/kernels/csrc``); every kernel keeps a plain PyTorch
version beside it, which runs only for tensors on the CPU.

This package imports torch, numpy and the standard library only.
"""

from . import fluid  # noqa: F401
from . import ops  # noqa: F401
from . import reader  # noqa: F401
from .reader import batch  # noqa: F401  (paddle.batch)

__version__ = '0.1.0'
