"""Mixed-precision training: ``decorate`` an optimizer for bf16 compute
with dynamic loss scaling.  Reference:
python/paddle/fluid/contrib/mixed_precision/."""

from .decorator import decorate, OptimizerWithMixedPrecision  # noqa: F401
from .fp16_lists import AutoMixedPrecisionLists  # noqa: F401
