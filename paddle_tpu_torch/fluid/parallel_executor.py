"""Data-parallel execution of a CompiledProgram (ParallelExecutor analog).

Reference: framework/parallel_executor.cc + details/ (per-device graph
clones, NCCL all-reduce op handles); the JAX package's
fluid/parallel_executor.py, which runs the Program as ONE computation
over a device mesh: feeds sharded on the batch axis, parameters
replicated, and every batch reduction in it global.

Here a replica is a process, a rank of the launcher's process group
(distributed/launch.py), on its card; each rank is fed its own rows of
the global batch (the JAX package's multi-process ``per_process``
feeds), and the local batches must be equal.  A step (``run_parallel``)
is ``Executor._run_program`` with this rank's ``Replica``, which gives
the JAX package's numbers:

- the gradient of the global loss: every gradient the ops after the
  backward or the fetches read is summed over the ranks and divided by
  their number (``average``: flat buckets, one all-reduce each), the
  CoeffNumDevice scale, exact where the loss is a sum of batch means
  over equal local batches (every model of the repo); a batch feed's
  gradient holds this rank's rows and is only divided;
- ``batch_norm`` over the global batch (ops/nn_ops.py), the
  attention-dropout masks at the rank's rows of the global batch
  (ops/fused_ops.py); the collective ops of a transpiled program are
  the identity, as outside ``shard_map``, so nothing is reduced twice;
- the fetches (``_global_fetch``): a value whose leading dim is the
  local batch is gathered in rank order (the global array); another
  floating value that is not persistable (a loss, an accuracy) is
  averaged over the ranks, an integer one (a count) summed: the global
  batch's value for equal local batches; a persistable value is the
  rank's own, the same on every rank;
- with the sharded optimizer state (``ReduceStrategy.Reduce``), each
  rank keeps its rows of every optimizer accumulator whose dim 0 is > 1
  and divisible by the rank count, updates those rows of the parameter
  and all-gathers them (``gather_rows``): bitwise the AllReduce
  strategy's update, which is elementwise.  ``fluid.io`` and
  ``weights.numpy_state`` read such an accumulator whole
  (``whole_value``), a collective every rank calls.

Ranks that share a card cannot use NCCL (it refuses two ranks on one
device): their collectives go through gloo and host memory
(distributed/wire.py).  A process with no group runs ``Executor.run``.

Observability (JAX: fluid/parallel_executor.py:62-84, 293-299,
427-459, 530-636): a data-parallel step is one ``trace.step_span`` with
the executor's per-step records (``Executor._step_done``), sets the
``parallel/device_count`` and ``parallel/process_count`` gauges, and
each gradient all-reduce bucket is the ``collective.dispatch``
fault-injection site, run in an ``allreduce`` span.
"""

import time

import torch
import torch.distributed as dist

from . import core
from . import faultinject as _finject
from . import framework
from . import monitor
from . import trace as _trace
from ..distributed import launch, wire
from ..ops.registry import Replica

# the largest flat bucket of the gradient all-reduce and the
# parameter-row all-gather
BUCKET_BYTES = 64 << 20


def replica_of(executor):
    """This process's Replica, joining the launcher's group (on the
    executor's place) if it has not yet; None without a group."""
    group = launch.init_distributed(executor.place)
    if group is None:
        return None
    if isinstance(executor.place, core.CUDAPlace) and \
            executor.place.device_id != launch.local_card():
        raise ValueError(
            'with_data_parallel: this rank runs on card %d '
            '(FLAGS_selected_gpus), the executor on %r; make the executor '
            'with fluid.CUDAPlace(%d)' % (launch.local_card(),
                                          executor.place,
                                          launch.local_card()))
    return Replica(group, dist.get_rank(group), dist.get_world_size(group))


def _batch_feed_names(program, feed):
    """Feeds whose declared shape has a -1 leading dim (or that the
    program does not declare): each rank feeds its own rows of them.
    The others are replicated."""
    names = set()
    blk = program.global_block()
    for n in feed:
        v = blk._find_var_recursive(n)
        shp = tuple(getattr(v, 'shape', ()) or ()) if v is not None else ()
        if not shp or shp[0] == -1:
            names.add(n)
    return names


def _local_batch(program, feed, rep, device):
    """The local batch of the batch feeds (the first one's, by name),
    after checking that every rank feeds the same number of rows of
    each; None without batch feeds."""
    names = sorted(_batch_feed_names(program, feed))
    if not names:
        return None
    sizes = []
    for n in names:
        shape = getattr(core.as_array(feed[n]), 'shape', ())
        sizes.append(int(shape[0]) if len(shape) else -1)
    dev = device if dist.get_backend(rep.group) == 'nccl' else 'cpu'
    every = wire.all_gather(torch.tensor([sizes], dtype=torch.int64,
                                         device=dev), rep.group).tolist()
    for j, n in enumerate(names):
        col = [row[j] for row in every]
        if len(set(col)) > 1:
            raise ValueError(
                'feed %r: the ranks feed %s rows; with_data_parallel needs '
                'equal local batches (the averaged gradient is then the '
                'gradient of the global loss)' % (n, col))
    return sizes[0]


def _check_program(compiled, program):
    """Refuse, once per CompiledProgram, the ops whose data-parallel
    result would not be the global computation's."""
    if getattr(compiled, '_dp_checked', None) is program:
        return
    block = program.global_block()
    for op in block.ops:
        if op.type == 'fused_emb_update':
            raise NotImplementedError(
                'with_data_parallel: the sparse Adagrad row update '
                '(fused_emb_update) reads each rank\'s own ids and '
                'gradient rows; not ported (ROADMAP Queue 1 item 4)')
        if op.type == 'reduce_sum':
            x = block._find_var_recursive(op.input('X')[0])
            shape = tuple(getattr(x, 'shape', ()) or ())
            dims = op.attrs.get('dim', [0])
            dims = [dims] if isinstance(dims, int) else list(dims)
            if shape and shape[0] == -1 and (
                    op.attrs.get('reduce_all', False) or
                    any(d % len(shape) == 0 for d in dims)):
                raise NotImplementedError(
                    'with_data_parallel: reduce_sum of %r sums over the '
                    'batch, which each rank would sum over its own rows '
                    '(a loss normalized by a batch sum, as the '
                    'Transformer\'s token count); not ported'
                    % op.input('X')[0])
    compiled._dp_checked = program


def _buckets(tensors):
    """Index lists of consecutive tensors of one dtype and device, each
    list at most BUCKET_BYTES (or one larger tensor)."""
    out, cur, size = [], [], 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if cur and (t.dtype != tensors[cur[0]].dtype or
                    t.device != tensors[cur[0]].device or
                    size + nbytes > BUCKET_BYTES):
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += nbytes
    if cur:
        out.append(cur)
    return out


def average(tensors, rep):
    """Each tensor summed over the ranks and divided by their number,
    in flat buckets: one all-reduce a bucket.  Every rank passes the
    same shapes in the same order."""
    out = [None] * len(tensors)
    for idx in _buckets(tensors):
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        if _finject.armed():
            # chaos hook: 'collective.dispatch:stall:<s>' is a straggler
            _finject.check('collective.dispatch')
        t0 = time.perf_counter()
        wire.all_reduce_(flat, rep.group)
        _trace.record('allreduce', t0, time.perf_counter())
        flat.div_(rep.world)
        parts = flat.split([tensors[i].numel() for i in idx])
        for i, part in zip(idx, parts):
            out[i] = part.view(tensors[i].shape)
    return out


def gather_rows(updates, scope, rep):
    """[(parameter name, (start, stop), updated rows)]: every rank's
    rows of each parameter gathered in rank order and written over the
    parameter in `scope`, in flat buckets (one all-gather a bucket)."""
    rows = [u[2] for u in updates]
    for idx in _buckets(rows):
        flat = torch.cat([rows[i].reshape(-1) for i in idx])
        every = wire.all_gather(flat, rep.group).view(rep.world, -1)
        off = 0
        for i in idx:
            name, r = updates[i][0], rows[i]
            whole = every[:, off:off + r.numel()].reshape(
                (rep.world * r.shape[0],) + tuple(r.shape[1:]))
            off += r.numel()
            p = scope.find_var(name)
            if isinstance(p, torch.Tensor) and p.shape == whole.shape and \
                    p.device == whole.device:
                p.copy_(whole)
            else:
                scope.set_var(name, whole)


def whole_value(value):
    """A scope value as a whole tensor: an accumulator the sharded
    optimizer state keeps by rows (its ``_pt_row_shard`` replica) is
    all-gathered, a collective every rank of its group calls; any other
    value is itself."""
    rep = getattr(core.as_array(value), '_pt_row_shard', None)
    if rep is None:
        return value
    return wire.all_gather(core.as_array(value), rep.group)


def _global_fetch(name, val, block, rep, local_batch, averaged):
    if not isinstance(val, torch.Tensor) or name in averaged:
        return val
    var = block._find_var_recursive(name)
    if var is not None and var.persistable:
        return whole_value(val)
    if val.dim() >= 1 and local_batch is not None and \
            val.shape[0] == local_batch:
        return wire.all_gather(val, rep.group)
    if val.is_floating_point():
        return wire.all_reduce(val, rep.group) / rep.world
    if val.dtype == torch.bool:
        return val
    return wire.all_reduce(val, rep.group)


def run_parallel(executor, compiled, feed, fetch_list, scope, return_numpy,
                 use_program_cache=True):
    """Executor.run of a CompiledProgram: one data-parallel step of this
    rank (see the module docstring), or Executor.run of its program
    where it is not data parallel or the process has no group."""
    from .executor import _fetch_names
    program = compiled.program
    rep = replica_of(executor) if compiled._is_data_parallel else None
    if rep is None:
        return executor.run(program, feed, fetch_list, scope, return_numpy,
                            use_program_cache)
    feed = feed or {}
    scope = scope or core.global_scope()
    names = _fetch_names(fetch_list)
    _check_program(compiled, program)
    monitor.set_gauge('parallel/device_count', rep.world)
    monitor.set_gauge('parallel/process_count', rep.world)
    if _finject.armed():
        _finject.check('executor.step', step=executor._step + 1)
    t0 = time.perf_counter()
    with _trace.step_span(executor._step + 1):
        local_batch = _local_batch(program, feed, rep, executor.device)
        results = executor._run_program(
            program, feed, names, scope, rep,
            compiled._shard_opt_states_axis is not None,
            _batch_feed_names(program, feed), use_program_cache)
        block = program.global_block()
        results = [_global_fetch(n, v, block, rep, local_batch,
                                 executor._averaged)
                   for n, v in zip(names, results)]
        out = executor._return(results, return_numpy)
    executor._step_done(t0, feed, out)
    return out


class ParallelExecutor(object):
    """Reference: python/paddle/fluid/parallel_executor.py.  The program
    made ``with_data_parallel``, run by an Executor on this rank's card
    (``launch.local_card()``), or on ``CPUPlace()`` with
    ``use_cuda=False``.  ``share_vars_from`` (another ParallelExecutor)
    shares its scope."""

    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        from .compiler import CompiledProgram
        from .executor import Executor
        place = core.CUDAPlace(launch.local_card()) if use_cuda else \
            core.CPUPlace()
        program = main_program or framework.default_main_program()
        self._compiled = CompiledProgram(program).with_data_parallel(
            loss_name=loss_name, build_strategy=build_strategy,
            exec_strategy=exec_strategy, places=[place])
        self._exe = Executor(place)
        if scope is None and share_vars_from is not None:
            scope = share_vars_from._scope
        self._scope = scope

    def run(self, fetch_list, feed=None, feed_dict=None,
            return_numpy=True):
        feed = feed if feed is not None else feed_dict
        return self._exe.run(self._compiled, feed=feed,
                             fetch_list=fetch_list, scope=self._scope,
                             return_numpy=return_numpy)
