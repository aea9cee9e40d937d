"""CUDA kernels written by hand for Hopper, each beside its plain
PyTorch version; importing the package registers them (common.KERNELS).
Nothing is compiled at import: a kernel builds at its first launch."""

from . import common  # noqa: F401
from . import dropout  # noqa: F401
from . import embedding  # noqa: F401
from . import finite_check  # noqa: F401
from . import flash_attention  # noqa: F401
from . import fused_optimizer  # noqa: F401
from . import graph_cond  # noqa: F401
from . import quant_collective  # noqa: F401
