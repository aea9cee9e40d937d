"""Distributed transpilers (program rewriting).

Reference: python/paddle/fluid/transpiler/ — DistributeTranspiler
(distribute_transpiler.py:536) rewrites programs for the parameter
server or NCCL2 modes; collective.py (GradAllReduce:178, LocalSGD:270)
inserts collective ops.  The NCCL2 / collective modes mark the program
for the collective runtime (the rewrite itself comes from GradAllReduce
or the fleet CollectiveOptimizer); the parameter-server modes are not
ported (ROADMAP Queue 1 item 14).
"""

from .collective import (Collective, GradAllReduce, LocalSGD,  # noqa: F401
                         SingleProcessMultiThread)
from .memory_optimize import memory_optimize, release_memory  # noqa: F401


def _no_ps(what):
    return NotImplementedError(
        '%s: the parameter-server runtime is not ported (ROADMAP Queue 1 '
        'item 14)' % what)


class DistributeTranspilerConfig(object):
    """Reference: distribute_transpiler.py:141."""

    def __init__(self):
        self.slice_var_up = True
        self.split_method = None
        self.min_block_size = 8192
        self.sync_mode = True
        self.mode = 'nccl2'
        self.collective_mode = 'grad_allreduce'
        self.nccl_comm_num = 1
        self.hierarchical_allreduce_inter_nranks = 0
        self.use_hierarchical_allreduce = False
        self.geo_sgd_mode = False
        self.geo_sgd_need_push_nums = 100


class DistributeTranspiler(object):
    """Reference: distribute_transpiler.py:536."""

    def __init__(self, config=None):
        self.config = config or DistributeTranspilerConfig()
        self._trainer_id = 0
        self._trainers = 1

    def transpile(self, trainer_id, program=None, pservers='127.0.0.1:0',
                  trainers=1, sync_mode=True, startup_program=None,
                  current_endpoint='127.0.0.1:0'):
        from .. import framework
        program = program or framework.default_main_program()
        self._trainer_id = trainer_id
        self._trainers = trainers
        mode = self.config.mode
        if mode in ('nccl2', 'collective'):
            # the gradients' collectives come from the fleet optimizer
            # or GradAllReduce; this marks the program for the
            # collective runtime
            program._collective_dp = True
            program._bump_version()
            self.trainer_program = program
            return
        if mode in ('pserver', 'ps', 'geo'):
            raise _no_ps("DistributeTranspiler mode='%s'" % mode)
        raise NotImplementedError(
            "DistributeTranspiler mode='%s' is not a mode "
            "(nccl2 | collective | pserver | geo)" % mode)

    def get_trainer_program(self, wait_port=True):
        return self.trainer_program

    def get_pserver_program(self, endpoint):
        raise _no_ps('get_pserver_program')

    def get_pserver_programs(self, endpoint):
        raise _no_ps('get_pserver_programs')

    def get_startup_program(self, endpoint, pserver_program=None):
        raise _no_ps('get_startup_program')
