"""Multi-process data parallelism: the launcher (``python -m
paddle_tpu_torch.distributed.launch``), the rank's process group
(``init_distributed``, the backend rule) and the wire calls of the
collective ops (``wire``).

Reference: python/paddle/distributed/launch.py.  The launcher module is
imported on first use of its names, so ``python -m`` runs it without a
second copy in ``sys.modules``.
"""

_LAUNCH_NAMES = ('init_distributed', 'choose_backend', 'local_card',
                 'world_size', 'DEFAULT_TIMEOUT_S')


def __getattr__(name):
    if name in _LAUNCH_NAMES:
        from . import launch
        return getattr(launch, name)
    raise AttributeError(name)
