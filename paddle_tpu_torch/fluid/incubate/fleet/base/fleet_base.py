"""Fleet base. Reference:
python/paddle/fluid/incubate/fleet/base/fleet_base.py:38 (Fleet) —
the init / worker_num / distributed_optimizer contract.
"""

import abc


class Mode(object):
    TRANSPILER = 1
    PSLIB = 2
    COLLECTIVE = 3


class Fleet(object):
    __metaclass__ = abc.ABCMeta

    def __init__(self, mode):
        self._is_initialized = False
        self._mode = mode
        self._optimizer = None
        self._role_maker = None
        self._executor = None

    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def is_worker(self):
        return self._role_maker.is_worker()

    def is_server(self):
        return self._role_maker.is_server()

    def server_num(self):
        return self._role_maker.server_num()

    def server_index(self):
        return self._role_maker.server_index()

    def worker_endpoints(self, to_string=False):
        eps = self._role_maker.get_trainer_endpoints()
        return ','.join(eps) if to_string else eps

    def server_endpoints(self, to_string=False):
        eps = self._role_maker.get_pserver_endpoints()
        return ','.join(eps) if to_string else eps

    def init(self, role_maker=None):
        from .role_maker import PaddleCloudRoleMaker
        self._role_maker = role_maker or PaddleCloudRoleMaker()
        self._role_maker.generate_role()
        self._is_initialized = True

    def distributed_optimizer(self, optimizer, strategy=None):
        raise NotImplementedError

    def init_worker(self):
        pass

    def init_server(self, model_dir=None):
        pass

    def run_server(self):
        pass

    def stop_worker(self):
        pass

    def barrier_worker(self):
        pass


class DistributedOptimizer(object):
    """Reference fleet_base.py DistributedOptimizer."""

    __metaclass__ = abc.ABCMeta

    def __init__(self, optimizer, strategy=None):
        self._optimizer = optimizer
        self._strategy = strategy

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return self._optimizer.backward(loss, startup_program,
                                        parameter_list, no_grad_set,
                                        callbacks)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    @abc.abstractmethod
    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        pass
