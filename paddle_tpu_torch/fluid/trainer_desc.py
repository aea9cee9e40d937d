"""TrainerDesc configs (JAX: fluid/trainer_desc.py).

Reference: python/paddle/fluid/trainer_desc.py:21 — a protobuf
(trainer_desc.proto) carried from python to the C++ TrainerFactory
(framework/trainer.h:64).  Here the descriptor is a plain dict (the
framework has no protobuf plane); Executor.train_from_dataset consumes
the same knobs (thread -> prefetch depth, fetch config -> print loop,
debug).
"""

import multiprocessing

from .device_worker import DeviceWorkerFactory

__all__ = ['TrainerDesc', 'MultiTrainer', 'DistMultiTrainer',
           'PipelineTrainer']


class TrainerDesc(object):
    def __init__(self):
        self.proto_desc = {
            'class_name': None,
            'device_worker_name': None,
            'thread_num': multiprocessing.cpu_count(),
            'debug': False,
            'fetch_config': {'fetch_var_names': [],
                             'fetch_var_str_format': [],
                             'print_period': 100},
        }
        self._fleet_desc = None
        self._device_worker = None
        self._program = None
        self._infer = False

    def _set_fetch_var_and_info(self, fetch_vars, fetch_info,
                                print_period):
        fc = self.proto_desc['fetch_config']
        for i, v in enumerate(fetch_vars):
            fc['fetch_var_names'].append(v.name)
            fc['fetch_var_str_format'].append(fetch_info[i])
        fc['print_period'] = print_period

    def _set_debug(self, debug):
        self.proto_desc['debug'] = bool(debug)

    def _set_thread(self, thread_num):
        self.proto_desc['thread_num'] = int(thread_num)

    def _set_device_worker(self, device_worker):
        self._device_worker = device_worker

    def _set_infer(self, infer):
        self._infer = bool(infer)

    def _set_fleet_desc(self, fleet_desc):
        self._fleet_desc = fleet_desc

    def _set_program(self, program):
        self._program = program

    def _gen_trainer_desc(self):
        if self._device_worker is not None:
            self._device_worker._gen_worker_desc(self.proto_desc)

    def _desc(self):
        return dict(self.proto_desc)

    def __str__(self):
        return str(self.proto_desc)


class MultiTrainer(TrainerDesc):
    """Multi-thread single-node trainer (framework/multi_trainer.cc)."""

    def __init__(self):
        super(MultiTrainer, self).__init__()
        self.proto_desc['class_name'] = 'MultiTrainer'

    def _set_program(self, program):
        super(MultiTrainer, self)._set_program(program)

    def _gen_trainer_desc(self):
        super(MultiTrainer, self)._gen_trainer_desc()


class DistMultiTrainer(TrainerDesc):
    """Distributed (parameter-server) trainer
    (framework/dist_multi_trainer.cc)."""

    def __init__(self):
        super(DistMultiTrainer, self).__init__()
        self.proto_desc['class_name'] = 'DistMultiTrainer'

    def _gen_trainer_desc(self):
        super(DistMultiTrainer, self)._gen_trainer_desc()


class PipelineTrainer(TrainerDesc):
    """Pipeline trainer (framework/pipeline_trainer.cc); its schedule,
    PipelineOptimizer over the program pipeline, waits with ROADMAP
    Queue 1 item 13."""

    def __init__(self):
        super(PipelineTrainer, self).__init__()
        self.proto_desc['class_name'] = 'PipelineTrainer'

    def _gen_trainer_desc(self):
        super(PipelineTrainer, self)._gen_trainer_desc()


class TrainerFactory(object):
    """Reference: python/paddle/fluid/trainer_factory.py:23 — builds a
    TrainerDesc + DeviceWorker pair from a fleet opt_info dict."""

    def _create_trainer(self, opt_info=None):
        if not opt_info:
            trainer = MultiTrainer()
            trainer._set_device_worker(
                DeviceWorkerFactory()._create_device_worker('Hogwild'))
            return trainer
        trainer_name = opt_info.get('trainer', 'MultiTrainer')
        worker_name = opt_info.get('device_worker', 'Hogwild')
        classes = {c.__name__: c for c in
                   (MultiTrainer, DistMultiTrainer, PipelineTrainer)}
        if trainer_name not in classes:
            raise ValueError('unknown trainer %r (have %s)'
                             % (trainer_name, sorted(classes)))
        trainer = classes[trainer_name]()
        trainer._set_device_worker(
            DeviceWorkerFactory()._create_device_worker(worker_name))
        if opt_info.get('fleet_desc') is not None:
            trainer._set_fleet_desc(opt_info['fleet_desc'])
            trainer._device_worker._set_fleet_desc(
                opt_info['fleet_desc'])
        if 'thread_num' in opt_info:
            trainer._set_thread(opt_info['thread_num'])
        return trainer
