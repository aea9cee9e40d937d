"""CompiledProgram: data-parallel training of one Program.

Reference: python/paddle/fluid/compiler.py:160
(CompiledProgram.with_data_parallel -> core.ParallelExecutor); the JAX
package's fluid/compiler.py, which runs the same Program as one global
computation over a device mesh (feeds sharded on the batch axis,
parameters replicated, GSPMD's gradient all-reduce).

Here each replica is a process: the ranks of the launcher's process
group (``python -m paddle_tpu_torch.distributed.launch --nproc_per_node
N train.py``), one a card, each fed its own rows of the global batch.
The Program is not rewritten: ``with_data_parallel`` adds no op, and the
data-parallel work lives in the executor (fluid/parallel_executor.py).
The numbers are the JAX package's: the gradient of the global loss,
batch-norm statistics over the global batch, global fetches.
"""

from ..distributed import launch


class BuildStrategy(object):
    """Reference: framework/details/build_strategy.h:37.

    Knob -> disposition in the port:

    - reduce_strategy AllReduce: every rank updates every parameter from
      the averaged gradient.
    - reduce_strategy Reduce: the sharded optimizer state (ZeRO-1) of
      ``with_sharded_optimizer_states()``: each rank holds its rows of
      every accumulator whose dim 0 is > 1 and divisible by the rank
      count, updates those rows of the parameter, and the rows are
      all-gathered.  Bitwise the AllReduce strategy's parameters.
    - gradient_scale CoeffNumDevice: built in (the averaged gradient is
      the gradient of the global loss); One and Customized are rejected.
    - fuse_all_reduce_ops (the gradients travel in flat buckets),
      fuse_all_optimizer_ops, fuse_elewise_add_act_ops,
      memory_optimize, enable_inplace: accepted and ignored.
    - num_trainers / trainer_id: the launcher's process group.
    """

    class ReduceStrategy(object):
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy(object):
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = False
        self.fuse_all_optimizer_ops = False
        self.memory_optimize = True
        self.enable_inplace = True
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy(object):
    """Reference: framework/details/execution_strategy.h:22.  Accepted
    and ignored: a rank runs its ops in program order on its card."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.num_iteration_per_run = 1


_MESH_TODO = ('%s is not ported: the port runs data parallel only, one '
              'process a card (ROADMAP Queue 1 item 13, model '
              'parallelism and the auto-shard planner)')


class CompiledProgram(object):
    def __init__(self, program_or_graph, build_strategy=None):
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._is_data_parallel = False
        self._shard_opt_states_axis = None

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        """Train the program data parallel over the ranks of the
        launcher's process group (joined here, as the collective
        transpiler joins it), each rank on its card.  A process the
        launcher did not start runs one replica, Executor.run's ops.
        `places` holding more than one device needs the launcher: one
        process drives one card.  loss_name, exec_strategy and
        share_vars_from are accepted as the reference's: the loss is
        the backward's, a rank runs its ops in order, and programs
        share variables through the scope they run in."""
        from . import monitor
        monitor.add('compiler/data_parallel_programs_built')
        bs = build_strategy or self._build_strategy
        if bs.gradient_scale_strategy != \
                BuildStrategy.GradientScaleStrategy.CoeffNumDevice:
            raise ValueError(
                'gradient_scale_strategy: only CoeffNumDevice is '
                'meaningful here: the averaged gradient is the gradient '
                'of the global loss (see BuildStrategy)')
        group = launch.init_distributed(places[0] if places else None)
        if places is not None and len(places) > 1 and group is None:
            raise NotImplementedError(
                'with_data_parallel over %d places in one process: the '
                'port runs one process a card; start one rank a card with '
                '"python -m paddle_tpu_torch.distributed.launch '
                '--nproc_per_node %d train.py"' % (len(places),
                                                   len(places)))
        self._is_data_parallel = True
        self._build_strategy = bs
        if bs.reduce_strategy == BuildStrategy.ReduceStrategy.Reduce:
            self.with_sharded_optimizer_states()
        return self

    def with_mesh(self, mesh):
        raise NotImplementedError(_MESH_TODO % 'with_mesh')

    def with_param_shardings(self, rule):
        raise NotImplementedError(_MESH_TODO % 'with_param_shardings')

    def with_sharded_optimizer_states(self, axis='dp'):
        """ZeRO-1 weight-update sharding: each rank keeps its rows of the
        optimizer accumulators (see BuildStrategy); the parameters stay
        whole on every rank."""
        self._shard_opt_states_axis = axis
        return self

    @property
    def program(self):
        return self._program
