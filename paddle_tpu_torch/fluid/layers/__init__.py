"""fluid.layers: the subset the BERT, CTR and image models, the
learning-rate schedules and gradient clipping use (reference:
python/paddle/fluid/layers/)."""

from . import nn  # noqa: F401
from . import math_op_patch  # noqa: F401
from . import ops  # noqa: F401
from . import tensor  # noqa: F401
from . import io  # noqa: F401
from . import learning_rate_scheduler  # noqa: F401

from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .learning_rate_scheduler import (  # noqa: F401
    noam_decay, exponential_decay, natural_exp_decay, inverse_time_decay,
    polynomial_decay, piecewise_decay, cosine_decay, linear_lr_warmup)
