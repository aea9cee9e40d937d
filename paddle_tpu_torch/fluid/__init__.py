"""fluid API of the PyTorch port (reference: python/paddle/fluid/__init__.py).

The static-graph path: Program IR, layers (with the learning-rate
schedules) and nets, append_backward and gradients, gradient clipping,
regularizers, the optimizers of the JAX package's fluid/optimizer.py
(PipelineOptimizer aside) with ModelAverage,
ExponentialMovingAverage and Lookahead, the eager
Executor (inference and training steps, host ops, train_from_dataset),
host-side metrics, io (the native and the reference binary formats),
the data plane (DataLoader / PyReader, DataFeeder, Dataset over the
native MultiSlot feeder, the trainer and device-worker configs),
collective data parallelism (the transpilers, the collective fleet, the
comms planner), data-parallel training through
CompiledProgram.with_data_parallel and ParallelExecutor, and mixed
precision (contrib.mixed_precision.decorate), and the observability
plane (monitor, trace, faultinject, health, profiler, memviz, opprof,
timeseries, with slo and progcheck beside them).
"""

from . import monitor  # noqa: F401  (no dependencies: first)
from . import trace  # noqa: F401  (monitor + flags)
from . import faultinject  # noqa: F401  (monitor + flags)
from . import health  # noqa: F401  (monitor + trace)
from . import core  # noqa: F401  (before framework: ops import it)
from . import framework  # noqa: F401
from . import unique_name  # noqa: F401
from . import initializer  # noqa: F401
from . import layers  # noqa: F401
from . import nets  # noqa: F401
from . import metrics  # noqa: F401
from . import io  # noqa: F401
from . import backward  # noqa: F401
from . import optimizer  # noqa: F401
from . import clip  # noqa: F401
from . import regularizer  # noqa: F401
from . import comms  # noqa: F401
from . import comms_plan  # noqa: F401
from . import transpiler  # noqa: F401
from . import incubate  # noqa: F401
from . import contrib  # noqa: F401
from .core import (CPUPlace, CUDAPlace, CUDAPinnedPlace,  # noqa: F401
                   LoDTensor, Scope, global_scope, scope_guard,
                   is_compiled_with_cuda)
from .executor import Executor  # noqa: F401
from . import compiler  # noqa: F401
from .compiler import (BuildStrategy, CompiledProgram,  # noqa: F401
                       ExecutionStrategy)
from .parallel_executor import ParallelExecutor  # noqa: F401
from . import profiler  # noqa: F401
from . import memviz  # noqa: F401
from . import opprof  # noqa: F401
from . import timeseries  # noqa: F401
from .flags import get_flags, set_flags  # noqa: F401
from .backward import append_backward, gradients  # noqa: F401
from .framework import (Program, Variable, Parameter,  # noqa: F401
                        default_main_program, default_startup_program,
                        program_guard, cpu_places, cuda_places,
                        cuda_pinned_places, name_scope, load_op_library,
                        require_version)
from .initializer import init_on_cpu  # noqa: F401
from .param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
from .io import (save_params, save_persistables,  # noqa: F401
                 load_params, load_persistables, save_inference_model,
                 load_inference_model)
from . import trainer_desc  # noqa: F401
from . import device_worker  # noqa: F401
from .trainer_desc import TrainerFactory  # noqa: F401
from . import data_feeder  # noqa: F401
from .data_feeder import DataFeeder  # noqa: F401
from . import reader  # noqa: F401
from .reader import DataLoader, PyReader  # noqa: F401
from . import dataset  # noqa: F401
from .dataset import (DatasetFactory, InMemoryDataset,  # noqa: F401
                      QueueDataset)
