"""fluid.incubate: the collective fleet (reference:
python/paddle/fluid/incubate/)."""

from . import fleet  # noqa: F401
