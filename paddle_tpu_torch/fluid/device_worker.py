"""DeviceWorker configs (JAX: fluid/device_worker.py).

Reference: python/paddle/fluid/device_worker.py:19 — DeviceWorker /
Hogwild / DownpourSGD / Section describe the per-thread worker the C++
trainer runs (hogwild_worker.cc, downpour_worker.cc,
section_worker.cc).

In the port the executor's step is the device worker, so these classes
carry configuration only; what remains of each worker's semantics:

- Hogwild -> Executor.train_from_dataset, whose thread=N stages N
  batches ahead onto the card (fluid/reader.py _AsyncBatchIterator);
- DownpourSGD -> the parameter server (ROADMAP Queue 1 item 14);
- Section -> the pipeline trainer, PipelineOptimizer over the program
  pipeline (ROADMAP Queue 1 item 13).

They validate and carry the same knobs, so reference training scripts
and fleet descriptors keep working.
"""

__all__ = ['DeviceWorker', 'Hogwild', 'DownpourSGD', 'Section']


class DeviceWorker(object):
    def __init__(self):
        self._program = None
        self._infer = None

    def _set_infer(self, infer=False):
        self._infer = infer

    def _set_fleet_desc(self, fleet_desc):
        self._fleet_desc = fleet_desc

    def _set_program(self, program):
        self._program = program

    def _gen_worker_desc(self, trainer_desc):
        """Fill the worker section of a TrainerDesc dict."""
        raise NotImplementedError(
            "DeviceWorker should not be used directly — pick Hogwild, "
            "DownpourSGD or Section")


class Hogwild(DeviceWorker):
    """Multi-thread feeding worker (hogwild_worker.cc).  On one card the
    parallelism that remains is feeder overlap; see
    Executor.train_from_dataset(thread=N)."""

    def _gen_worker_desc(self, trainer_desc):
        trainer_desc['device_worker_name'] = 'HogwildWorker'


class DownpourSGD(DeviceWorker):
    """Async-PS worker (downpour_worker.cc): pull sparse/dense before
    forward, push grads after backward (the parameter server of ROADMAP
    Queue 1 item 14)."""

    def _gen_worker_desc(self, trainer_desc):
        trainer_desc['device_worker_name'] = 'DownpourWorker'
        fleet = getattr(self, '_fleet_desc', None)
        if fleet is not None:
            trainer_desc['fleet_desc'] = fleet


class Section(DeviceWorker):
    """Pipeline section worker (section_worker.cc): the pipeline trainer,
    PipelineOptimizer over the program pipeline (ROADMAP Queue 1 item
    13)."""

    def __init__(self, section_config=None):
        super(Section, self).__init__()
        self._section_config = section_config or {}

    def _gen_worker_desc(self, trainer_desc):
        trainer_desc['device_worker_name'] = 'SectionWorker'
        trainer_desc['section_config'] = dict(self._section_config)


class DeviceWorkerFactory(object):
    def _create_device_worker(self, worker_type):
        classes = {c.__name__.lower(): c
                   for c in (Hogwild, DownpourSGD, Section)}
        key = str(worker_type).lower()
        if key not in classes:
            raise ValueError('unknown device worker %r (have %s)'
                             % (worker_type, sorted(classes)))
        return classes[key]()
