"""Fleet: the role makers and the collective (data-parallel) fleet.
The parameter-server fleet and the fleet utilities are not ported
(ROADMAP Queue 1 item 14)."""

from . import base  # noqa: F401
from . import collective  # noqa: F401
