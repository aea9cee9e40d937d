"""fluid API of the PyTorch port (reference: python/paddle/fluid/__init__.py).

The static-graph path: Program IR, layers (with the learning-rate
schedules), append_backward, gradient clipping, regularizers, the
Adam, LAMB and Adagrad optimizers, the eager Executor (inference and
training steps) and inference-model io.
"""

from . import core  # noqa: F401  (before framework: ops import it)
from . import framework  # noqa: F401
from . import unique_name  # noqa: F401
from . import initializer  # noqa: F401
from . import layers  # noqa: F401
from . import io  # noqa: F401
from . import backward  # noqa: F401
from . import optimizer  # noqa: F401
from . import clip  # noqa: F401
from . import regularizer  # noqa: F401
from .core import (CPUPlace, CUDAPlace, LoDTensor, Scope,  # noqa: F401
                   global_scope, scope_guard)
from .executor import Executor  # noqa: F401
from .flags import get_flags, set_flags  # noqa: F401
from .backward import append_backward  # noqa: F401
from .framework import (Program, Variable, Parameter,  # noqa: F401
                        default_main_program, default_startup_program,
                        program_guard)
from .param_attr import ParamAttr  # noqa: F401
