"""Op lowerings (PyTorch) registered by type; importing this package
registers them all.  Kernels written by hand for the GPU live in
``ops/kernels``."""

from . import registry  # noqa: F401
from . import tensor_ops  # noqa: F401
from . import math_ops  # noqa: F401
from . import nn_ops  # noqa: F401
from . import activation_ops  # noqa: F401
from . import misc_ops  # noqa: F401
from . import fused_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import collective_ops  # noqa: F401
