"""fluid.contrib of the PyTorch port: mixed precision.  Reference:
python/paddle/fluid/contrib/."""

from . import mixed_precision  # noqa: F401
