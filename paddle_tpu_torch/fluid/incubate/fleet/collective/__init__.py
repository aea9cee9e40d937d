"""Collective fleet: data-parallel training through explicit collective
ops.

Reference: python/paddle/fluid/incubate/fleet/collective/__init__.py
(CollectiveOptimizer, DistributedStrategy).  After the backward, a
``c_allreduce_sum`` (not planned: one all-reduce, no K8) and a
``scale(1/nranks)`` on every gradient, nranks the process group's size;
the program runs on each rank's card with the group
(fluid/executor.py).  ``fleet.init`` joins the launcher's group.  AMP
and recompute run; LocalSGD is not ported and raises (ROADMAP Queue 1
item 12).
"""

from ..base.fleet_base import Fleet, DistributedOptimizer, Mode
from ....framework import default_main_program, default_startup_program


class DistributedStrategy(object):
    """Reference: collective/__init__.py DistributedStrategy."""

    def __init__(self):
        self.mode = 'grad_allreduce'  # or 'local_sgd'
        self.nrings = 1
        self.use_local_sgd = False
        self.local_sgd_period = 4
        self.use_amp = False
        self.amp_loss_scaling = 2 ** 15
        self.use_recompute = False
        self.recompute_checkpoints = []
        self.forward_recompute = False
        self.exec_strategy = None


class CollectiveOptimizer(DistributedOptimizer):
    """Reference: collective/__init__.py CollectiveOptimizer."""

    def __init__(self, optimizer, strategy=None):
        super(CollectiveOptimizer, self).__init__(
            optimizer, strategy or DistributedStrategy())

    def _insert_allreduce(self, block, params_grads, nranks):
        for p, g in params_grads:
            if g is None:
                continue
            block.append_op('c_allreduce_sum', inputs={'X': g},
                            outputs={'Out': g},
                            attrs={'ring_id': 0}, infer_shape=False)
            block.append_op('scale', inputs={'X': g},
                            outputs={'Out': g},
                            attrs={'scale': 1.0 / nranks},
                            infer_shape=False)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .....distributed import launch
        s = self._strategy
        if s.use_local_sgd or s.mode == 'local_sgd':
            raise NotImplementedError(
                'DistributedStrategy local_sgd: LocalSGD is not ported '
                '(ROADMAP Queue 1 item 12, "LocalSGD and collective_utils")')
        opt = self._optimizer
        if s.use_amp:
            from ....contrib.mixed_precision import decorate
            opt = decorate(opt, init_loss_scaling=s.amp_loss_scaling,
                           use_dynamic_loss_scaling=True)
        if s.use_recompute:
            from ....optimizer import RecomputeOptimizer
            opt = RecomputeOptimizer(opt)
            opt._set_checkpoints(s.recompute_checkpoints)
        params_grads = opt.backward(loss, startup_program, parameter_list,
                                    no_grad_set)
        program = loss.block.program
        self._insert_allreduce(program.global_block(), params_grads,
                               max(launch.world_size(), 1))
        optimize_ops = opt.apply_gradients(params_grads)
        program._collective_dp = True
        program._bump_version()
        return optimize_ops, params_grads


class CollectiveFleet(Fleet):
    def __init__(self):
        super(CollectiveFleet, self).__init__(Mode.COLLECTIVE)

    def init(self, role_maker=None):
        """Join the launcher's process group (a no-op for one rank),
        then take the role."""
        from .....distributed import launch
        launch.init_distributed()
        super(CollectiveFleet, self).init(role_maker)

    def distributed_optimizer(self, optimizer, strategy=None):
        self._optimizer = CollectiveOptimizer(optimizer, strategy)
        return self._optimizer

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None,
                             export_for_deployment=True):
        from .... import io
        return io.save_inference_model(dirname, feeded_var_names,
                                       target_vars, executor, main_program)

    def save_persistables(self, executor, dirname, main_program=None,
                          filename=None):
        from .... import io
        return io.save_persistables(executor, dirname, main_program,
                                    filename)


fleet = CollectiveFleet()
