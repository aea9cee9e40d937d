"""Op lowerings (PyTorch) registered by type; importing this package
registers them all.  Kernels written by hand for the GPU live in
``ops/kernels``."""

from . import registry  # noqa: F401
from . import tensor_ops  # noqa: F401
from . import math_ops  # noqa: F401
from . import nn_ops  # noqa: F401
from . import activation_ops  # noqa: F401
from . import misc_ops  # noqa: F401
from . import loss_ops  # noqa: F401
from . import fused_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import collective_ops  # noqa: F401
from . import host_ops  # noqa: F401
from . import amp_ops  # noqa: F401
from . import sequence_ops  # noqa: F401
from . import rnn_ops  # noqa: F401
from . import lang_ops  # noqa: F401
from . import vision_ops  # noqa: F401
from . import detection_ops  # noqa: F401
from . import detection_host_ops  # noqa: F401
