"""Executor: an eager interpreter over a Program's global block.
Reference: python/paddle/fluid/executor.py:680.

One run feeds the feed dict, calls each op's lowering in program order
through the registry, writes persistable outputs to the scope and
fetches.  Every tensor it creates has the place's device: ``Executor()``
means ``CUDAPlace(0)`` (in a rank the launcher started, the rank's
card) and raises without CUDA; only an explicit ``CPUPlace()`` runs on
the CPU.  Intermediates are released after their
last reader.  What a run records depends on the program:

- a program that writes no persistable variable (inference, a
  ``clone(for_test=True)``) runs under ``torch.inference_mode()``;
- a training step (a program holding backward-role ops, as
  ``append_backward`` builds) takes its gradients as the JAX package
  does by default (its FLAGS_whole_program_grad): the forward ops run
  with autograd recording, one ``torch.autograd.grad`` pass over that
  region yields every @GRAD the optimizer ops read (``_wpg_partition``),
  and the grad ops themselves do not run.  Where that partition does
  not apply (several losses, an intermediate's gradient read) every op
  runs in order and each grad op replays its forward op through
  autograd.  On the whole-program grad a RecomputeOptimizer program's
  re-emitted ops do not run: each span of the forward they repeat runs
  under ``torch.utils.checkpoint`` (``_run_span``);
- any other program (a startup program) runs under ``torch.no_grad()``,
  so the parameters it creates can enter autograd later.

A program the collective transpiler marked (``_collective_dp``:
GradAllReduce, the fleet CollectiveOptimizer, DistributeTranspiler in
nccl2 mode) runs the same way on the rank's card, with the rank's
process group in every op's lowering context: its c_allreduce ops sit
between the gradients and the optimizer (the whole-program grad's
``post`` region) and reduce over the group.  Each rank feeds its own
shard of the batch and keeps its own step counter, so the dropout
masks are keyed alike on every rank.

A while or conditional_block op runs its sub-block here
(``_control_flow``; JAX: fluid/executor.py:553-768): a forward-only
while reads its condition on the host before each trip, one that
carries gradients (``__needs_grad__``) runs ``max_trip_count`` masked
trips with no host read, which the whole-program grad differentiates as
they ran, and a conditional_block reads its condition on the host.
While a CUDA graph is captured none of them reads the host: a
forward-only while is a WHILE node, a conditional_block an IF node, and
an auto-bucketed while's trips are counted on the device before the
step (fluid/cuda_graph.py).  A host op inside a loop body and a
conditional_block that carries gradients keep their unit eager
(``_host_control``).

A ``CompiledProgram`` made ``with_data_parallel`` goes to
fluid/parallel_executor.py, which runs the program here as one
``Replica`` of the process group (``_run_program``): the lowering
context carries the replica (the ops that reduce over the batch take
the global batch's values), every gradient the ops after the backward
read is averaged over the ranks in flat buckets before them, and with
the sharded optimizer state (``ReduceStrategy.Reduce``) each optimizer
op updates this rank's rows of the parameter and its accumulators,
whose rows are then all-gathered.

A contiguous run of same-hyperparameter adam/adamw/lamb ops runs as one
multi-tensor update (``_fused_opt_run``), which on CUDA updates the
parameters and moments in place.  The step counter advances once per
run, before the ops, as in the JAX executor, so dropout masks keyed on
(op seed, step) line up with the JAX package's.

The compile plane (JAX: fluid/executor.py:1830-1868 and
fluid/compile_cache.py): what a step derives from the program, its
op list, the whole-program-grad partition, the drop lists, the fused
optimizer runs and each op's lowering and names, is a ``_Plan`` kept
in the program's ``_exec_cache`` (``_get_plan``), which every rewrite
empties (``Program._bump_version``); scope names resolve through
``_Binder`` once for each scope version.  ``use_program_cache=False``
builds the plan for the call alone.  On a CUDA place a program whose
plan may be captured (``_graph_refusal``: serving, ``for_test`` clones
and the training steps) is replayed from a CUDA graph per scope and
feed signature, which its plan keeps (fluid/cuda_graph.py); a plan
that host ops split (``_Plan.units``) replays each device unit from a
graph of its own, the host ops running between them.  The JAX
package jits each segment with its state donated
(fluid/executor.py:1089); the port's counterpart is that a step writes
every persistable variable into the tensor the scope holds
(``_write_state``), so a graph reads and writes the same state at
every replay, and that the step reaches the device as a tensor
(``_step_mix``, a graph's static input), from which the dropout
masks are drawn.  A fetched persistable is returned as a copy, which
the next step does not change.  ``warmup`` builds plans and captures
ahead of the first run; ``compile`` gives a ``CompiledStep``, which
replays a program's graph on a scope of its own, or, with
allow_host=True, a ``CompiledPipeline`` of a program that host ops
split into segments.

Host ops (ops/host_ops.py: print, save, load, save_combine,
load_combine, py_func) run on the host between the device ops, as the
JAX package runs them between its segments; the read-only ones (print,
save, save_combine) are deferred past the device ops after them that
do not rewrite what they read (``_defer_readonly_host_ops``, JAX:
fluid/executor.py:1893), so the whole-program grad still sees the
forward region whole.  The device ops between host ops form the
plan's units (``_Unit``), each captured in a CUDA graph of its own; a
device unit after the first reads the fed names from the feed again
(the JAX package's segment binding).  ``train_from_dataset`` /
``infer_from_dataset`` drive
``run`` over a fluid.dataset's batches (JAX: fluid/executor.py:2642).

A program ``contrib.mixed_precision.decorate`` rewrote (AMP) runs the
same way: its loss-scale multiply is a forward op, the autograd pass
starts from the scaled loss, and check_finite_and_unscale and
update_loss_scaling are the first ops after the backward region, so in
data parallel they read the averaged gradients and every rank reaches
the same verdict; the multi-tensor optimizer kernel then takes the
unscaled f32 gradients.  An overflowing step hands the optimizer zero
gradients, with the JAX package's consequences: SGD and Momentum leave
the parameters as they are, Adam decays its moments, advances its beta
powers and moves its parameters.

``FLAGS_check_nan_inf`` checks every floating value a step writes (op
outputs, and the gradients of the whole-program grad) on the device,
in one finite_check launch at the end of the step (inside the step's
CUDA graph where it replays), and raises FloatingPointError naming each
non-finite one (JAX: fluid/executor.py:2578).  On an AMP program it checks what the JAX
package checks there, its segments' outputs: the values written to the
scope and the fetches, so an overflow that the loss scaling absorbs
passes and a non-finite fetched loss raises.
``return_numpy='async'`` returns a ``FetchHandle`` per fetch (JAX:
:267).

The observability plane (JAX: fluid/executor.py:206-338, :1308-1321,
:1740-1756, :1836-1886, :2123-2238, :2553-2628) records at step, plan
and op-range level, never per op unless a profile asked for it.  Each
``run`` (and each data-parallel step) is one ``trace.step_span`` and
counts ``executor/run_calls``, ``run_seconds``, the feed and fetch
vars and bytes, and ``last_step_unix_ts``; the ``executor.step``
fault-injection site and the windowed-history sample sit at its
boundary.  Inside, an eager run records the phases ``bind``,
``feed_h2d``, ``dispatch``, ``fetch_d2h`` and ``state_release`` (the
step's values released) and each host op as ``host_op``; a replayed
step records ``feed_h2d``, ``dispatch`` (``graph.replay()``) and
``fetch_d2h`` around the replay (fluid/cuda_graph.py), and nothing is
recorded while a graph is captured.  ``FLAGS_check_nan_inf``'s error
carries the first op that went non-finite (``health.nan_provenance``,
from copies of the state the step read, under ``FLAGS_nan_replay``)
and the flight recorder's dump; a failed dispatch dumps it too, with
memviz's OOM note where the allocator failed.  Under
``profiler.is_enabled()`` ('Serial') a step runs op by op from a plan
built for the call, each op timed to completion; while a profile or a
capture runs (``profiler.op_ranges``) each op runs in a
``record_function`` range named by its type (``type#index`` under
FLAGS_opprof) inside the program's range.  Under ``FLAGS_memviz`` a
plan's first run files its memory row (fluid/memviz.py
``record_run``), a plan build may run
the static verifier (fluid/progcheck.py) and the
``progcheck.mutate`` site.
"""

import collections
import time
import weakref

import numpy as np
import torch
import torch.distributed as dist

from . import backward
from . import compile_cache
from . import core
from . import faultinject as _finject
from . import framework
from . import memviz as _memviz
from . import monitor
from . import opprof as _opprof
from . import profiler as _profiler
from . import timeseries as _tseries
from . import trace as _trace
from .flags import get_flag
from ..ops import registry


# the ops whose lowering runs a sub-block (Executor._control_flow)
_CONTROL_FLOW = ('while', 'conditional_block', 'while_grad',
                 'conditional_block_grad')


def _op_reads(op):
    """The names an op reads: its inputs, and for a while or a
    conditional_block also its loop state (Out), whose values before
    the op it starts from even where the sub-block only writes them."""
    if op.type in ('while', 'conditional_block'):
        return list(op.input_arg_names) + list(op.output('Out'))
    return op.input_arg_names


def _with_sub_blocks(ops):
    """`ops` and, after each control-flow op, the ops of its sub-block
    (recursively)."""
    for op in ops:
        yield op
        sub = op.attrs.get('sub_block')
        if op.type in _CONTROL_FLOW and isinstance(sub, int):
            for inner in _with_sub_blocks(op.block.program.blocks[sub].ops):
                yield inner


def _drop_plan(ops, keep):
    """For each op index, the env names nobody reads after it: values
    are released after their last reader, or right after their writer
    when no op reads them.  Names in `keep` (fetches) stay."""
    last = {}
    for i, op in enumerate(ops):
        for n in _op_reads(op):
            last[n] = i
    drops = [[] for _ in ops]
    for i, op in enumerate(ops):
        for n in op.output_arg_names:
            if n not in last and n not in keep:
                drops[i].append(n)
    for n, i in last.items():
        if n not in keep:
            drops[i].append(n)
    return drops


def _program_group(program):
    """The world group for a program the collective transpiler marked,
    when this process has joined one; None otherwise."""
    if not getattr(program, '_collective_dp', False):
        return None
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def _role(op):
    return op.attrs.get('__op_role__', 'forward')


def _stat_nbytes(v):
    """Byte count of a feed or fetch value for the monitor counters, O(1)
    (JAX: fluid/executor.py:39): tensors and arrays count their bytes,
    anything else (lists, scalars) 0."""
    v = core.as_array(v)
    if isinstance(v, torch.Tensor):
        return float(v.numel() * v.element_size())
    n = getattr(v, 'nbytes', None)
    return float(n) if n is not None else 0.0


def _fetch_names(fetch_list):
    return [v.name if isinstance(v, framework.Variable) else v
            for v in (fetch_list or [])]


def _post_grads(ops, fetch_names):
    """(k, names) for the per-op grad path in data parallel: ops[k] is
    the first op after the backward region starts that is not a
    backward op, and `names` the gradients the backward ops before it
    write that ops[k:] or the fetches read; (len(ops), []) when the
    program has no backward."""
    roles = [_role(op) for op in ops]
    if 'backward' not in roles:
        return len(ops), []
    k = roles.index('backward')
    while k < len(ops) and roles[k] == 'backward':
        k += 1
    written = set(n for op in ops[:k] if _role(op) == 'backward'
                  for n in op.output_arg_names)
    read = set(fetch_names).union(
        *(op.input_arg_names for op in ops[k:]))
    return k, sorted(written & read)


# the optimizer ops whose update is elementwise, and the accumulator
# slots that the sharded optimizer state keeps by rows
_ROW_ACCUMULATORS = {'adam': ('Moment1', 'Moment2'),
                     'adamw': ('Moment1', 'Moment2'),
                     'momentum': ('Velocity',), 'adagrad': ('Moment',)}


# optimizer types the multi-tensor kernels batch -> their fused op
_FUSABLE_OPT = {'adam': 'fused_adam', 'adamw': 'fused_adamw',
                'lamb': 'fused_lamb'}


def _opt_group_key(op):
    """Hyperparameters a fused run must share; per-tensor lr and beta
    powers stay per-op inputs.  (JAX: fluid/executor.py:391.)"""
    a = op.attrs
    key = (op.type, a.get('beta1', 0.9), a.get('beta2', 0.999),
           a.get('epsilon', 1e-6 if op.type == 'lamb' else 1e-8))
    if op.type == 'adamw':
        key += (a.get('coeff', 0.01),)
    elif op.type == 'lamb':
        key += (a.get('weight_decay', 0.01),)
    return key


def _fused_opt_run(ops, i):
    """Maximal contiguous run of same-type, same-hyper optimizer ops
    starting at ops[i] with no read-after-write hazard inside it (op j
    reads nothing an earlier member wrote).  The run list, or None when
    grouping is off, ops[i] is no fusable optimizer or the run is
    shorter than FLAGS_torch_opt_min_tensors (at least 2).  (JAX:
    fluid/executor.py:404.)"""
    if ops[i].type not in _FUSABLE_OPT or \
            not get_flag('FLAGS_torch_opt_fuse', True):
        return None
    key = _opt_group_key(ops[i])
    run = [ops[i]]
    written = set(ops[i].output_arg_names)
    j = i + 1
    while j < len(ops) and ops[j].type == ops[i].type and \
            _opt_group_key(ops[j]) == key:
        if set(ops[j].input_arg_names) & written:
            break
        run.append(ops[j])
        written.update(ops[j].output_arg_names)
        j += 1
    min_n = max(2, int(get_flag('FLAGS_torch_opt_min_tensors', 2)))
    return run if len(run) >= min_n else None


# the ops that read the one ragged level of the padded + mask form
_LEVEL1_CONSUMERS = ('gru', 'lstm', 'lstmp', 'im2sequence',
                     'linear_chain_crf', 'crf_decoding')


def _reject_multilevel_lod(program, name, levels):
    """Raise where a LoDTensor feed of two or more levels reaches a
    sequence op (JAX: fluid/executor.py:2058): the padded + mask form
    holds one ragged level (the '@MASK' feeds), so nested sequences
    (reference framework/lod_tensor.h:219, paragraphs of sentences)
    would compute as dense without a word.  What the feed flows into is
    followed through the ops' outputs, sub-blocks included, to a fixed
    point."""
    tainted = {name}
    ops = [op for block in program.blocks for op in block.ops]
    changed = True
    while changed:
        changed = False
        for op in ops:
            if tainted.isdisjoint(op.input_arg_names):
                continue
            if op.type.startswith('sequence_') or \
                    op.type in _LEVEL1_CONSUMERS:
                raise RuntimeError(
                    "feed '%s' carries a %d-level LoD and flows into op "
                    '[%s] (via %r), which lowers on the padded + mask form '
                    'holding ONE ragged level: nested sequences would '
                    'compute as dense.  Flatten the outer level into the '
                    'batch (one row per inner sequence) and feed the '
                    "level-1 LoD, or use the bucketed DataLoader, which "
                    "emits the '@MASK' feeds the sequence ops read."
                    % (name, levels, op.type,
                       sorted(tainted & set(op.input_arg_names))[0]))
            for out in op.output_arg_names:
                if out not in tainted:
                    tainted.add(out)
                    changed = True


def _recompute_spans(pre, twins):
    """The forward ops a RecomputeOptimizer program emits again in its
    backward (`twins`, each re-emitted op, whose outputs are its forward
    op's with the ``@RC`` suffix), as spans of `pre`: [(start, end)] of
    the runs of consecutive forward ops re-emitted as one group (a
    group's ops follow each other in the backward, in forward order).
    None where a twin has no forward op or a span writes a persistable
    variable (running it again would write it twice)."""
    at = {}
    for i, op in enumerate(pre):
        at.setdefault((op.type, tuple(op.output_arg_names)), i)
    suffix = len(backward.RECOMPUTE_SUFFIX)
    spans, prev = [], None
    for op in twins:
        i = at.get((op.type, tuple(n[:-suffix]
                                   for n in op.output_arg_names)))
        if i is None:
            return None
        if prev is not None and i == prev + 1:
            spans[-1][1] = i + 1
        else:
            spans.append([i, i + 1])
        prev = i
    block = pre[0].block if pre else None
    for a, b in spans:
        if any(_is_persistable(block, n) for op in pre[a:b]
               for n in op.output_arg_names):
            return None
    return sorted((a, b) for a, b in spans if b - a > 1)


def _wpg_partition(ops, program, fetch_names):
    """Whole-program grad (JAX: fluid/executor.py:846): split a training
    step into the forward region, the backward region and the rest, and
    map each gradient a later op or a fetch reads to the variable it
    differentiates.  Returns None where one autograd pass over the
    forward cannot stand in for the backward region: no backward-role
    op, a backward-role op other than the synthesized grad ops, seed
    fills, zero placeholders, aggregation sums and recompute spans, no
    loss, two seeds of one loss, a loss the forward region does not
    write, or a needed gradient of a value the forward region writes
    (an intermediate) or never reads.

    Each loss has its seed fill (one ``append_backward`` each, JAX
    fluid/executor.py:889-906): ``seeds`` lists (loss, its @GRAD, the
    seed value) in program order, and ``regions`` maps each needed
    gradient to the seed whose backward walk last writes it, so the
    gradient is that loss's alone, as on the per-op path.  A program
    with recompute spans takes exactly one loss.

    A RecomputeOptimizer program's re-emitted forward ops and their
    ``recompute_barrier`` ops do not run: each span they re-emit
    (``spans``, ``_recompute_spans``) runs its forward under
    ``torch.utils.checkpoint`` (non-reentrant), which keeps only the
    span's inputs and outputs and runs the span again in the autograd
    pass, as the program's backward would.  (The JAX package declines
    such a program here and runs its grad ops one by one.)"""
    roles = [_role(op) for op in ops]
    if 'backward' not in roles:
        return None
    first = roles.index('backward')
    pre = ops[:first]
    bwd = [op for op in ops[first:] if _role(op) == 'backward']
    post = [op for op in ops[first:] if _role(op) != 'backward']
    rev = {g: p for p, g in getattr(program, '_grad_name_map', {}).items()}
    seeds, twins = [], []
    for op in bwd:
        ws = op.output_arg_names
        if op.type.endswith('_grad') or op.type in ('fill_zeros_like',
                                                    'recompute_barrier'):
            continue
        if ws and all(n.endswith(backward.RECOMPUTE_SUFFIX) for n in ws):
            twins.append(op)
            continue
        if op.type == 'sum' and ws and all(n in rev for n in ws):
            continue
        if op.type in ('fill_constant', 'fill_any_like') and \
                len(ws) == 1 and ws[0] in rev:
            seeds.append((rev[ws[0]], ws[0],
                          float(op.attrs.get('value', 1.0))))
            continue
        return None
    if not seeds or len(set(p for p, _, _ in seeds)) != len(seeds) or \
            (twins and len(seeds) != 1):
        return None
    pre_writes, pre_reads = set(), set()
    for op in pre:
        pre_writes.update(op.output_arg_names)
        pre_reads.update(op.input_arg_names)
    if any(p not in pre_writes for p, _, _ in seeds):
        return None
    seed_grads = set(g for _, g, _ in seeds)
    region_of, region = {}, -1
    for op in bwd:
        ws = op.output_arg_names
        if op.type in ('fill_constant', 'fill_any_like') and ws and \
                ws[0] in seed_grads:
            region += 1
        for n in ws:
            region_of[n] = max(region, 0)
    later_reads = set(n for op in post for n in op.input_arg_names)
    grads, regions = {}, {}
    for g in sorted(set(region_of) & (later_reads | set(fetch_names))):
        if g in seed_grads:
            continue
        p = rev.get(g)
        if p is None or p in pre_writes or p not in pre_reads:
            return None
        grads[g], regions[g] = p, region_of[g]
    # variables append_backward treated as constants: cut from the
    # autograd graph where the forward writes them
    block = ops[0].block
    no_grad = set(getattr(program, '_backward_no_grad_names', ()))
    stop = set()
    for op in pre:
        for n in op.output_arg_names:
            v = block._find_var_recursive(n)
            if n in no_grad or (v is not None and v.stop_gradient and
                                all(n != p for p, _, _ in seeds)):
                stop.add(n)
    spans = _recompute_spans(pre, twins)
    if spans is None:
        return None
    return {'pre': pre, 'post': post, 'seeds': seeds, 'grads': grads,
            'regions': regions, 'stop': stop, 'spans': spans}


def replay_ops(env, ops, step, device=None, program=None, timed=False):
    """Run `ops` one by one on `env` (name -> value, updated with each
    op's outputs) as executor step `step` on `device`, without autograd
    outside the grad ops' own replays: the walk of the NaN provenance
    (fluid/health.py) and the op-cost replay (fluid/opprof.py).  Host
    ops are left out (their side effects ran with the step).  Yields,
    after each op, {'index', 'op', 'reads' (its inputs), 'writes' (its
    outputs), 'seconds'}; with `timed` on a CUDA device the card is
    synchronized around each op."""
    device = torch.device(device or 'cpu')
    exe = Executor(core.CUDAPlace(device.index or 0)
                   if device.type == 'cuda' else core.CPUPlace())
    exe._step = int(step)
    scope = core.Scope()
    if program is None and ops:
        program = ops[0].block.program
    exe._sub_steps = {
        op.attrs['sub_block']: [_OpStep(o) for o in
                                program.blocks[op.attrs['sub_block']].ops]
        for op in _with_sub_blocks(ops) if op.type in _CONTROL_FLOW}
    sync = timed and device.type == 'cuda'
    with torch.no_grad():
        for i, op in enumerate(ops):
            od = registry._REGISTRY.get(op.type)
            if od is not None and od.host:
                continue
            reads = {n: env[n] for n in dict.fromkeys(_op_reads(op))
                     if n in env}
            if sync:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            if op.type in _CONTROL_FLOW:
                writes = exe._control_flow(op, env, scope, program)
            else:
                st = _OpStep(op)
                outs, _ = exe._run_op(st, env, scope, program)
                writes = {}
                for slot, names, _ in st.outs:
                    writes.update(zip(names, outs.get(slot, [])))
            if sync:
                torch.cuda.synchronize(device)
            seconds = time.perf_counter() - t0
            env.update(writes)
            yield {'index': i, 'op': op, 'reads': reads, 'writes': writes,
                   'seconds': seconds}


class FetchHandle(object):
    """A fetch resolving asynchronously (``return_numpy='async'``): the
    device-to-host copy is queued on the current stream, into pinned
    host memory, when the handle is made, and nothing waits for it;
    ``as_numpy()`` waits for that copy alone.  The copy holds the value
    as the step left it, so a later step that updates the variable in
    place does not reach it.  ``np.asarray(handle)`` resolves it too."""

    __slots__ = ('_val', '_host', '_event', '_np')

    def __init__(self, value):
        self._val = value.detach()
        self._np = None
        self._event = None
        if self._val.is_cuda:
            self._host = torch.empty(self._val.shape, dtype=self._val.dtype,
                                     pin_memory=True)
            self._host.copy_(self._val, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = self._val.clone()

    @property
    def value(self):
        """The fetched tensor on its device, unresolved."""
        return self._val

    def as_numpy(self):
        if self._np is None:
            if self._event is not None:
                self._event.synchronize()
            self._np = core.to_numpy(self._host)
        return self._np

    def __array__(self, dtype=None, copy=None):
        arr = self.as_numpy()
        return arr.astype(dtype) if dtype is not None else arr


# host ops that write no program state (print and save write stdout
# and files): deferring one past later device ops is observably the same
# when nothing later rewrites what it reads
_DEFERRABLE_HOST_OPS = ('print', 'save', 'save_combine')


def _defer_readonly_host_ops(ops):
    """Reorder a block's ops so deferrable host ops run after the device
    ops that follow them, unless a later op rewrites their reads (JAX:
    fluid/executor.py:1895).  A deferred op is placed just before the
    first later op that writes what it reads, with every op deferred
    before it, so host side effects keep their relative order."""
    deferred = []  # (op, read names) pending placement
    out = []
    for op in ops:
        writes = set(op.output_arg_names)
        if writes and deferred:
            last = max((i for i, (_, reads) in enumerate(deferred)
                        if reads & writes), default=-1)
            if last >= 0:
                out.extend(d for d, _ in deferred[:last + 1])
                deferred = deferred[last + 1:]
        if op.type in _DEFERRABLE_HOST_OPS:
            deferred.append((op, set(op.input_arg_names)))
        else:
            out.append(op)
    out.extend(d for d, _ in deferred)
    return out


def _is_host(op):
    return getattr(registry._REGISTRY.get(op.type), 'host', False)


def _host_ops(ops):
    """The types of the host ops the executor runs among `ops` and their
    sub-blocks."""
    return sorted(set(op.type for op in _with_sub_blocks(ops)
                      if _is_host(op)))


def _plan_items(ops):
    """A plan's ops split as the JAX package splits them into segments
    (JAX: fluid/executor.py:1926 ``_build_plan``): ('segment', [op
    indices]) of device ops, ('host', i) for each host op, and
    ('bucket', i) before an auto-bucketed while, whose trips are
    counted there; the while begins the next segment."""
    items, cur = [], []
    for i, op in enumerate(ops):
        bucket = op.type == 'while' and op.attrs.get('__auto_bucket__')
        if bucket or _is_host(op):
            if cur:
                items.append(('segment', cur))
                cur = []
            if bucket:
                items.append(('bucket', i))
                cur.append(i)
                continue
            items.append(('host', i))
        else:
            cur.append(i)
    if cur:
        items.append(('segment', cur))
    return items


def _is_persistable(block, name):
    var = block._find_var_recursive(name)
    return var is not None and var.persistable


class _OpStep(object):
    """One op resolved for a plan: its lowering (None when the registry
    has none: the run raises when it reaches the op, as before), its
    input and output names, whether each output is persistable, its
    seed, the outputs the whole-program grad cuts from autograd, and
    the output slots nothing reads after it (every name of the slot
    released right after the op, `unread`: its ``_drop_plan`` entry, and
    not persistable), which its lowering context names."""

    __slots__ = ('op', 'opdef', 'ins', 'outs', 'seed', 'stops', 'unread')

    def __init__(self, op, stop=(), unread=frozenset()):
        self.op = op
        try:
            self.opdef = registry.get(op.type)
        except NotImplementedError:
            self.opdef = None
        block = op.block
        self.ins = tuple((slot, tuple(names))
                         for slot, names in op.inputs.items())
        self.outs = tuple(
            (slot, tuple(names),
             tuple(_is_persistable(block, n) for n in names))
            for slot, names in op.outputs.items())
        self.seed = op.attrs.get('__op_seed__', 0)
        self.stops = tuple(n for n in op.output_arg_names if n in stop)
        self.unread = frozenset(
            slot for slot, names, persistable in self.outs
            if names and not any(persistable) and
            all(n in unread for n in names))


class _Step(object):
    """An op, or a fused optimizer run (``_fused_opt_run``), at op
    index `index`, and the env names released after it."""

    __slots__ = ('index', 'members', 'fused', 'drops')

    def __init__(self, index, members, fused, drops):
        self.index = index
        self.members = members
        self.fused = fused
        self.drops = drops


def _steps(ops, keep, fuse=True):
    drops = _drop_plan(ops, keep)
    out = []
    i = 0
    while i < len(ops):
        run = _fused_opt_run(ops, i) if fuse else None
        members = run or [ops[i]]
        out.append(_Step(i, [_OpStep(op, unread=drops[i + k])
                             for k, op in enumerate(members)],
                         run is not None,
                         [n for j in range(i, i + len(members))
                          for n in drops[j]]))
        i += len(members)
    return out


class _Span(object):
    """A recompute span of the whole-program grad's forward: its op
    steps and drop lists, the names its ops read before writing them
    (`reads`) and the names it writes that live past it (`outs`)."""

    __slots__ = ('steps', 'drops', 'reads', 'outs', 'dropped')

    def __init__(self, steps, drops):
        self.steps, self.drops = steps, drops
        self.dropped = frozenset(n for d in drops for n in d)
        reads, written, outs = [], set(), []
        for st in steps:
            for _, names in st.ins:
                reads.extend(n for n in names
                             if n not in written and n not in reads)
            for _, names, _ in st.outs:
                written.update(names)
                outs.extend(n for n in names
                            if n not in self.dropped and n not in outs)
        self.reads, self.outs = reads, outs


class _Binder(object):
    """Where each scope name lives (JAX: fluid/executor.py:171
    ``_SegmentBinder``): for each scope of a plan, the owner dict of each
    name read from it, resolved once for each ``_chain_token()``; a run
    then reads a scope value with one dict read.  The tables are keyed
    weakly: a plan never keeps a dead scope's values alive."""

    __slots__ = ('_tables',)

    def __init__(self):
        self._tables = weakref.WeakKeyDictionary()

    def owners(self, scope):
        token = scope._chain_token()
        tab = self._tables.get(scope)
        if tab is None or tab[0] != token:
            tab = self._tables[scope] = (token, {})
        return tab[1]


class _Plan(object):
    """A program's run plan for one key of ``_get_plan``: everything a
    step derives from the program and its fetch names, built once.

    kind 'forward' (no backward ops: ``steps``, ``writes_state``),
    'per_op' (every op in order: ``steps``; ``post_grads`` and
    ``var_of`` for data parallel) or 'wpg' (the whole-program grad:
    ``wpg``, ``pre`` with ``pre_drops`` and the recompute ``spans``
    over it, ``post``).  ``no_graph`` says
    why the program is never captured in a CUDA graph (None: it may
    be); ``graphs`` holds its CUDA graphs, weakly keyed by scope, and
    ``scope_reads`` (built with the first capture) the names its ops
    read before writing them (fluid/cuda_graph.py).  ``sub_steps`` maps
    each sub-block a control-flow op runs to its ops' ``_OpStep``s.

    ``serial``: a 'Serial' profile's plan (every op in order, no fused
    runs, each op timed); ``mem_row``: the memviz row its first run
    under FLAGS_memviz filed (None before that run, False where none
    was filed);
    ``verify_items``: its segments for fluid/progcheck.py.

    ``items`` splits the ops as the JAX package splits them into
    segments (``_plan_items``); ``units`` is the run's pipeline
    (``_Unit``): the device ops between host ops, each replayed from a
    CUDA graph of its own, and the host ops between them.  An
    auto-bucketed while splits ``items`` but not ``units``: its trips
    are counted on the device before the step (fluid/cuda_graph.py
    ``count_buckets``), which then replays the graph of their bucket.
    ``buckets`` lists the ops of the plan's auto-bucketed whiles."""

    __slots__ = ('ops', 'keep', 'checked_only', 'kind', 'writes_state',
                 'steps', 'post_grads', 'var_of', 'wpg', 'pre', 'pre_drops',
                 'post', 'no_graph', 'graphs', 'binder', 'scope_reads',
                 'sub_steps', 'spans', 'serial', 'mem_row', 'verify_items',
                 'items', 'units', 'buckets')


class _Unit(object):
    """One item of a plan's pipeline: a host op (``host``, its one
    ``_Step`` in ``steps``), or the device ops between host ops: their
    ``steps``, or, on the whole-program grad, the forward, backward and
    optimizer regions (``wpg``).  ``ops`` are its ops, ``reads`` the
    names they read before writing them, ``no_graph`` why the unit is
    never captured in a CUDA graph (None: it may be)."""

    __slots__ = ('host', 'steps', 'wpg', 'ops', 'reads', 'no_graph')

    def __init__(self, host, steps, ops, wpg=False):
        self.host = host
        self.steps = steps
        self.wpg = wpg
        self.ops = ops
        written, reads = set(), {}
        for op in ops:
            reads.update((n, None) for n in _op_reads(op)
                         if n not in written)
            written.update(op.output_arg_names)
        self.reads = tuple(reads)
        self.no_graph = None if host else _unit_refusal(ops)


def _health_grads(program):
    """The parameters' gradients a step keeps for the tensor-health
    summaries (FLAGS_health_summaries, read at plan build, as the JAX
    package surfaces them at its segment boundary)."""
    if not get_flag('FLAGS_health_summaries', False):
        return frozenset()
    gmap = getattr(program, '_grad_name_map', {})
    return frozenset(gmap[p.name] for p in program.all_parameters()
                     if p.name in gmap)


def _build_plan(program, fetch_names, serial=False):
    block = program.global_block()
    ops = _defer_readonly_host_ops(
        [op for op in block.ops
         if not registry.skipped_by_executor(op.type)])
    plan = _Plan()
    plan.ops = ops
    plan.serial = serial
    plan.mem_row = None
    plan.verify_items = None
    fetched = frozenset(fetch_names)
    plan.keep = keep = fetched | _health_grads(program)
    plan.checked_only = fetched if any(
        op.type == 'check_finite_and_unscale' for op in ops) else None
    plan.writes_state = True
    plan.graphs = weakref.WeakKeyDictionary()
    plan.scope_reads = None
    plan.binder = _Binder()
    plan.sub_steps = {
        op.attrs['sub_block']: [_OpStep(o) for o in
                                program.blocks[op.attrs['sub_block']].ops]
        for op in _with_sub_blocks(ops) if op.type in _CONTROL_FLOW}
    plan.wpg = None
    plan.spans = {}
    plan.items = _plan_items(ops)
    plan.buckets = [op for op in ops if op.type == 'while' and
                    op.attrs.get('__auto_bucket__')]
    # the whole-program grad runs on the device ops between the leading
    # and the trailing host ops, which run before and after it; a host
    # op among those ops keeps the step on the whole-program grad as one
    # unit that no graph captures
    device = [i for i, op in enumerate(ops) if not _is_host(op)]
    lo, hi = (device[0], device[-1] + 1) if device else (0, 0)
    inner = ops[lo:hi]
    mixed = _host_ops(inner) if any(_is_host(op) for op in inner) else None
    edge_reads = set(n for op in ops[:lo] + ops[hi:]
                     for n in op.input_arg_names)
    if any(_role(op) == 'backward' for op in ops) and not serial:
        plan.wpg = _wpg_partition(ops if mixed else inner, program,
                                  list(fetch_names) + sorted(edge_reads))
    if plan.wpg is not None:
        plan.kind = 'wpg'
        wpg = plan.wpg
        later = set(n for op in wpg['post'] for n in op.input_arg_names)
        plan.pre_drops = _drop_plan(wpg['pre'], keep | later | edge_reads |
                                    {p for p, _, _ in wpg['seeds']})
        plan.pre = [_OpStep(op, wpg['stop'], drop)
                    for op, drop in zip(wpg['pre'], plan.pre_drops)]
        plan.spans = {a: _Span(plan.pre[a:b], plan.pre_drops[a:b])
                      for a, b in wpg['spans']}
        plan.post = _steps(wpg['post'], keep | edge_reads)
        if mixed:
            unit = _Unit(False, None, ops, wpg=True)
            unit.no_graph = (
                'host op %s runs between the whole-program grad\'s forward '
                'and optimizer ops, which one autograd pass spans'
                % ', '.join(mixed))
            plan.units = [unit]
        else:
            host = lambda i: _Unit(True, [_Step(i, [_OpStep(ops[i])],  # noqa
                                                 False, [])], [ops[i]])
            plan.units = [host(i) for i in range(lo)] + \
                [_Unit(False, None, inner, wpg=True)] + \
                [host(i) for i in range(hi, len(ops))]
    else:
        plan.kind = 'per_op' if any(_role(op) == 'backward'
                                    for op in ops) else 'forward'
        plan.steps = _steps(ops, keep, fuse=not serial)
        if plan.kind == 'per_op':
            plan.post_grads = _post_grads(ops, fetch_names)
            plan.var_of = {g: p for p, g in
                           getattr(program, '_grad_name_map', {}).items()}
        else:
            plan.writes_state = any(
                _is_persistable(block, n)
                for op in ops for n in op.output_arg_names)
        plan.units = _step_units(plan.steps)
    plan.no_graph = _graph_refusal(plan)
    return plan


def _step_units(steps):
    """The pipeline of a plan that runs its steps in order: each host
    op a unit, the steps between them a device unit each."""
    units, cur = [], []
    for st in steps:
        if not st.fused and _is_host(st.members[0].op):
            if cur:
                units.append(_Unit(False, cur, [m.op for s in cur
                                                for m in s.members]))
                cur = []
            units.append(_Unit(True, [st], [st.members[0].op]))
        else:
            cur.append(st)
    if cur:
        units.append(_Unit(False, cur, [m.op for s in cur
                                        for m in s.members]))
    return units


def _segment_names(plan):
    """(inputs, state, outputs) of a plan's ops as the JAX package's
    segments classify them (fluid/executor.py:2000): the names read
    before any op writes them, those of them the ops also write, and
    the written names that are fetched or persistable."""
    block = plan.ops[0].block if plan.ops else None
    written, reads = set(), set()
    for op in plan.ops:
        reads.update(n for n in _op_reads(op) if n not in written)
        written.update(op.output_arg_names)
    outputs = sorted(n for n in written
                     if n in plan.keep or _is_persistable(block, n))
    return sorted(reads - written), sorted(reads & written), outputs


def _graph_refusal(plan):
    """Why no part of a plan's program is captured in a CUDA graph, or
    None: the reason of its one device unit, or of every device unit
    where each is refused (a plan of host ops alone has nothing to
    capture).  The run-time reasons (the place, collective programs)
    are ``Executor._no_graph``'s."""
    device = [u for u in plan.units if not u.host]
    if not device:
        return 'the program runs host ops only (%s)' % ', '.join(
            _host_ops(plan.ops))
    why = [u.no_graph for u in device if u.no_graph is not None]
    return why[0] if len(why) == len(device) else None


def _unit_refusal(ops):
    """Why a pipeline unit of `ops` (device ops) is never captured.  The
    random ops of a startup program draw from the host generator
    (``LowerCtx.host_draws``): startup programs stay eager; elsewhere
    they draw on the device and are captured."""
    for op in _with_sub_blocks(ops):
        od = registry._REGISTRY.get(op.type)
        if od is not None and od.host_random and \
                op.block.program._is_start_up_program_:
            return ('op %s draws from a host generator (a startup '
                    'program\'s initializer), which a graph would freeze'
                    % op.type)
    for op in ops:
        why = _host_control(op)
        if why is not None:
            return why
    return None


def _host_control(op):
    """Why a control-flow op must read on the host, or None (the
    conditions of while and conditional_block are read on the device,
    by the WHILE and IF nodes of fluid/cuda_graph.py): a host op in its
    sub-block (a graph replays one fixed sequence of launches), or a
    conditional_block that carries gradients.  Autograd records such a
    branch as it ran, and in a graph it would run whether taken or not,
    its values masked: the eager step and the JAX package's lax.cond
    never run an untaken branch, whose non-finite values (a log or a
    division guarded by the condition) would make NaN gradients."""
    if op.type not in _CONTROL_FLOW or \
            not isinstance(op.attrs.get('sub_block'), int):
        return None
    inner = op.block.program.blocks[op.attrs['sub_block']].ops
    host = _host_ops(inner)
    if host:
        return ('op %s (sub-block %d) runs host op %s inside its body, '
                'which a graph cannot replay' % (
                    op.type, op.attrs['sub_block'], ', '.join(host)))
    if op.type == 'conditional_block_grad' or (
            op.type == 'conditional_block' and
            op.attrs.get('__needs_grad__')):
        return ('op %s (sub-block %d) carries gradients: a graph would '
                'run its branch whether or not the condition holds, which '
                'the eager step never does' % (op.type,
                                               op.attrs['sub_block']))
    return None


class CompiledStep(object):
    """A program compiled to one function, ``fn(step, state, data) ->
    {name: tensor}`` (JAX: fluid/executor.py:1213): ``state`` holds the
    names the program updates (parameters, optimizer slots), ``data``
    the pure inputs (feeds, and an inference program's parameters); the
    outputs are the fetches and the persistable variables written.  The
    caller's tensors are left as they were (no donation, as in the JAX
    package).  On a CUDA place a program that may be captured
    (fluid/cuda_graph.py), a training step among them, runs on a scope
    the step keeps, into which each call copies ``state`` and ``data``
    in place (the graph's own state buffers; a new shape or dtype takes
    a new tensor), and so replays its CUDA graph as ``Executor.run``
    does: the first call eager, the second captures; the persistable
    outputs come back as new tensors.  On the CPU the cached plan runs
    eagerly as executor step `step` on a new scope, from copies of
    ``state``."""

    __slots__ = ('fn', 'input_names', 'state_names', 'output_names')

    def __init__(self, fn, input_names, state_names, output_names):
        self.fn = fn
        self.input_names = list(input_names)
        self.state_names = list(state_names)
        self.output_names = list(output_names)

    def __call__(self, step, state, data):
        return self.fn(step, state, data)


class CompiledPipeline(object):
    """A program that host ops (save, load, print, py_func) or an
    auto-bucketed while split into segments, compiled to its run plan
    (JAX: fluid/executor.py:1277): each device unit replays from a CUDA
    graph of its own on a card (fluid/cuda_graph.py ``Pipeline``), the
    host ops run between them through the scope.  Not a pure function:
    host ops may touch files and stdout.

    ``__call__(feed=None, scope=None, return_numpy=True)`` runs one step
    against `scope` (default: the global scope, where the startup
    program put the parameters), as ``Executor.run`` does, and returns
    the fetches in order."""

    __slots__ = ('_exe', '_program', 'input_names', 'fetch_names',
                 'host_op_types')

    def __init__(self, executor, program, plan, feed_names, fetch_names):
        self._exe = executor
        self._program = program
        self.input_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.host_op_types = [plan.ops[i].type for kind, i in plan.items
                              if kind == 'host']

    def __call__(self, feed=None, scope=None, return_numpy=True):
        return self._exe.run(self._program, feed=feed,
                             fetch_list=self.fetch_names, scope=scope,
                             return_numpy=return_numpy)


class WarmupResult(object):
    """What ``Executor.warmup`` did (JAX: fluid/executor.py:1250
    ``_WarmupResult``): ``captured``, the feed signatures (``arg_specs``
    rows) now replayed from CUDA graphs, and ``skipped``, (signature,
    reason) for each one that was not captured."""

    __slots__ = ('captured', 'skipped')

    def __init__(self, captured, skipped):
        self.captured = list(captured)
        self.skipped = list(skipped)


class Executor(object):
    """Reference: python/paddle/fluid/executor.py:680."""

    def __init__(self, place=None):
        if place is None:
            from ..distributed import launch
            place = core.CUDAPlace(launch.local_card())
        self.place = place
        self.device = self.place.torch_device()
        self._step = 0
        self._group = None
        # the data-parallel Replica of the running step (None: one
        # process), whether it shards the optimizer state, the names
        # the step averaged over the ranks, and the (parameter, rows)
        # updates still to be all-gathered
        self._replica = None
        self._batch_feeds = frozenset()
        self._shard_opt = False
        self._averaged = set()
        self._row_updates = []
        # (name, 0-d bool tensor) of the step's values while
        # FLAGS_check_nan_inf is on, else None
        self._verdicts = None
        # on an AMP program the step's fetch names: only they and the
        # persistables are checked (None: every value)
        self._checked_only = None
        # while a CUDA graph is captured under FLAGS_check_nan_inf: (the
        # checked names, their verdict buffer, the snapshot of the step's
        # inputs) of the captured step
        self._captured_nan = None
        # a multi-unit step's staged feeds, which each device unit reads
        # again (feed precedence), and the Pipeline replaying its units
        self._fed = None
        self._unit_graphs = None
        # while a CUDA graph is captured on a card: its conditional nodes
        # (fluid/cuda_graph.py Nodes), and the streams their bodies are
        # captured on, one a nesting depth
        self._nodes = None
        self._body_streams = []
        self._body_pool = None
        # the first run of a graph's signature builds the conditional_block
        # branches it does not take (fluid/cuda_graph.py warm_branch), so
        # nothing in them is first built inside a capture
        self._warm_branches = False
        # the auto-bucket's count runs the ops before the loop without
        # writing the scope (fluid/cuda_graph.py count_buckets)
        self._counting = False
        # the running plan's sub_steps
        self._sub_steps = {}
        # the running plan's owner dicts of the scope's names, and,
        # while a CUDA graph is captured, {name: (dict, value)} of the
        # scope values it reads
        self._owners = {}
        self._reads = None
        # the CUDA-graph state (fluid/cuda_graph.py): the capture
        # stream and the graphs' memory pool
        self._capture_stream = None
        self._graph_pool = None
        # the running step on the device and its mixes (_step_mix), made
        # at most once a run
        self._step_t = None
        self._step_mixes = None
        # {storage pointer: name} of the scope's tensors, made at a run's
        # first new persistable entry (_write_state)
        self._held = None
        # the running step's profiler state: op by op and timed
        # ('Serial'), each op in a record_function range
        self._serial = False
        self._ranges = False
        # FLAGS_status_port: the status plane starts with the first
        # executor (a no-op when the flag is 0 or a server is up)
        from . import health
        health.ensure_serving()

    def _to_device(self, value):
        value = core.as_array(value)
        if isinstance(value, torch.Tensor):
            return value.to(self.device)
        return torch.as_tensor(np.asarray(value), device=self.device)

    def _read(self, name, env, scope):
        value = env.get(name, _UNSET)
        if value is not _UNSET:
            return value
        owners = self._owners
        vars_ = owners.get(name)
        if vars_ is None:
            vars_ = scope._owner_vars(name)
            if vars_ is not None:
                owners[name] = vars_
        value = None if vars_ is None else vars_[name]
        if value is None:
            raise RuntimeError(
                'variable %r is read before it is set: feed it or run the '
                'startup program first' % name)
        if not (isinstance(value, torch.Tensor) and
                value.device == self.device):
            # a host value (loaded params, numpy) moves to the device
            # once: the device copy replaces it where it lives
            value = vars_[name] = self._to_device(value)
        if self._reads is not None:
            self._reads[name] = (vars_, value)
        return value

    def _set_scope(self, scope, name, value):
        """scope.set_var, keeping the running plan's owner dicts true."""
        scope.set_var(name, value)
        self._owners[name] = scope._vars

    def _write_state(self, scope, name, value):
        """Write a persistable variable's new value into the tensor the
        scope holds (the JAX package's donated state): in place where
        shape, dtype and device match, nothing where the value is that
        tensor (the optimizer kernels update it in place), a new entry
        otherwise (the first write, or an inference tensor)."""
        if isinstance(value, torch.Tensor):
            value = value.detach()
            cur = scope._vars.get(name)
            if isinstance(cur, torch.Tensor) and cur.shape == value.shape \
                    and cur.dtype == value.dtype and \
                    cur.device == value.device and not cur.is_inference():
                if cur.data_ptr() != value.data_ptr() or \
                        cur.stride() != value.stride():
                    cur.copy_(value)
                self._owners[name] = scope._vars
                return
            if self._aliases_state(scope, name, value):
                value = value.clone()
        self._set_scope(scope, name, value)

    def _aliases_state(self, scope, name, value):
        """Whether a new persistable entry `value` shares its storage with
        a tensor the scope holds under another name: an identity op
        (assign) of one persistable into another, as Lookahead's startup
        copies each parameter into its slow weights.  The JAX package's
        arrays cannot alias; here the next in-place write of one would
        change the other, so the entry takes a copy."""
        held = self._held
        if held is None:
            held = self._held = {}
            s = scope
            while s is not None:
                for n, v in s._vars.items():
                    if isinstance(v, torch.Tensor):
                        held.setdefault(v.untyped_storage().data_ptr(), n)
                s = s.parent
        ptr = value.untyped_storage().data_ptr()
        other = held.setdefault(ptr, name)
        return other != name

    def _step_mix(self, c):
        """(step * c) mod 2**32 of the running step on the device, made
        once a run for each constant c (the ops of a run share it).  The
        step is a CUDA graph's static input while one is captured, else
        made at the run's first call (one copy from pinned memory)."""
        if self._step_mixes is None:
            self._step_mixes = {}
        m = self._step_mixes.get(c)
        if m is None:
            t = self._step_t
            if t is None:
                t = torch.tensor(self._step, dtype=torch.int64)
                if self.device.type == 'cuda':
                    t = t.pin_memory().to(self.device, non_blocking=True)
                self._step_t = t
            m = self._step_mixes[c] = registry.mul32(t & 0xFFFFFFFF, c)
        return m

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_program_cache=True):
        """Run the program's global block once.  return_numpy=False
        returns the fetched device tensors, 'async' a FetchHandle for
        each.  A CompiledProgram runs data parallel
        (fluid/parallel_executor.py).

        The program's run plan is cached (``_get_plan``); on a CUDA
        place a program that may be captured replays a CUDA graph of
        each feed signature from its second run on
        (fluid/cuda_graph.py).  use_program_cache=False rebuilds the
        plan for this call and runs it eagerly, as the reference's
        uncached run."""
        from .compiler import CompiledProgram
        if isinstance(program, CompiledProgram):
            from .parallel_executor import run_parallel
            return run_parallel(self, program, feed, fetch_list, scope,
                                return_numpy, use_program_cache)
        program = program or framework.default_main_program()
        feed = feed or {}
        fetch_names = _fetch_names(fetch_list)
        scope = scope or core.global_scope()
        if _finject.armed():
            # chaos hook: 'executor.step:die@N' is worker death mid-run
            _finject.check('executor.step', step=self._step + 1)
        t0 = time.perf_counter()
        with _trace.step_span(self._step + 1):
            plan = self._get_plan(program, feed, fetch_names,
                                  use_cache=use_program_cache)
            out = self._run_graphed(plan, program, feed, fetch_names,
                                    scope, return_numpy, use_program_cache)
        self._step_done(t0, feed, out)
        return out

    def _step_done(self, t0, feed, results):
        """The per-step records of a finished step (JAX:
        fluid/executor.py:1740-1756, :2123-2140, :2223-2238): run calls
        and seconds, feed and fetch vars and bytes, the last step's
        time, and the windowed-history sample."""
        monitor.add('executor/run_calls')
        monitor.observe('executor/run_seconds', time.perf_counter() - t0)
        if feed:
            monitor.add('executor/feed_vars', float(len(feed)))
            monitor.add('executor/feed_bytes',
                        sum(_stat_nbytes(v) for v in feed.values()))
        if results:
            monitor.add('executor/fetch_vars', float(len(results)))
            monitor.add('executor/fetch_bytes',
                        sum(_stat_nbytes(v) for v in results))
        monitor.set_gauge('executor/last_step_unix_ts', time.time())
        _tseries.maybe_sample(self._step)

    def _run_graphed(self, plan, program, feed, fetch_names, scope,
                     return_numpy, graphs=True):
        """One step of `plan`: through its CUDA graph where it has one
        (`graphs`, a CUDA place, a plan that may be captured and no
        'Serial' profile), else eagerly."""
        if graphs and plan.no_graph is None and \
                self.device.type == 'cuda' and not plan.serial:
            from . import cuda_graph
            out = cuda_graph.run(self, plan, program, feed, fetch_names,
                                 scope, return_numpy)
            if out is not None:
                return out
        self._step += 1
        results = self._run_plan(plan, program, feed, fetch_names, scope)
        return self._return(results, return_numpy)

    @staticmethod
    def _return(results, return_numpy):
        if return_numpy == 'async':
            return [FetchHandle(r) for r in results]
        if return_numpy:
            t0 = time.perf_counter()
            out = [core.to_numpy(r) for r in results]
            if results:
                t1 = time.perf_counter()
                monitor.observe('executor/fetch_blocked_seconds', t1 - t0)
                _trace.record('fetch_d2h', t0, t1)
            return out
        return [r.detach() if isinstance(r, torch.Tensor) else r
                for r in results]

    # ----------------------------------------------------------- plans
    def _plan_key(self, program, feed, fetch_names, replica, shard_opt):
        """What a cached plan is valid for (JAX: fluid/executor.py:1855):
        the program's version, the feed and fetch names, this executor,
        the flags that change the plan, and the data-parallel replica.
        The feeds' shapes and dtypes key the CUDA graphs instead."""
        return ('plan', program._version, tuple(sorted(feed)),
                tuple(fetch_names), id(self),
                bool(get_flag('FLAGS_check_nan_inf', False)),
                bool(get_flag('FLAGS_torch_opt_fuse', True)),
                int(get_flag('FLAGS_torch_opt_min_tensors', 2)),
                None if replica is None else (replica.world, replica.rank),
                bool(shard_opt))

    def _get_plan(self, program, feed, fetch_names, replica=None,
                  shard_opt=False, use_cache=True):
        """The program's run plan from its ``_exec_cache`` (which every
        rewrite clears: ``Program._bump_version``), built on a miss;
        use_cache=False builds one for this call and leaves the cache
        as it is (JAX: fluid/executor.py:1830).  Under a 'Serial'
        profile every call builds a per-op plan of its own
        (``executor/plan_cache_bypass``)."""
        serial = _profiler.is_enabled()
        if not use_cache or serial:
            compile_cache.count('executor/plan_cache_bypass')
            plan = _build_plan(program, fetch_names, serial=serial)
            self._verify_plan_build(program, plan, feed, fetch_names)
            return plan
        key = self._plan_key(program, feed, fetch_names, replica, shard_opt)
        plan = program._exec_cache.get(key)
        if plan is not None:
            compile_cache.count('executor/plan_cache_hit')
            return plan
        compile_cache.count('executor/plan_cache_miss')
        plan = _build_plan(program, fetch_names)
        self._verify_plan_build(program, plan, feed, fetch_names)
        program._exec_cache[key] = plan
        return plan

    def _verify_plan_build(self, program, plan, feed, fetch_names):
        """The static-verification hook of a plan BUILD (JAX:
        fluid/executor.py:1870): the 'progcheck.mutate' chaos site, then
        the fluid.progcheck pass when FLAGS_program_verify is on;
        error-class findings raise ProgramVerifyError before the run."""
        if _finject.armed():
            c = _finject.check('progcheck.mutate')
            if c is not None and c['action'] == 'mutate':
                from . import progcheck
                progcheck.mutate(program, c['arg'] or 1, plan=plan)
        if get_flag('FLAGS_program_verify', False):
            from . import progcheck
            progcheck.verify_program(program, feed_names=list(feed),
                                     fetch_names=fetch_names, plan=plan,
                                     origin='run')

    def _run_program(self, program, feed, fetch_names, scope, replica=None,
                     shard_opt=False, batch_feeds=(), use_cache=True):
        """One step of `program` through its plan: the fetched values on
        the device.  With a `replica` the step is that data-parallel
        replica's (see the module docstring), fed its rows of
        `batch_feeds`, its optimizer state sharded by rows with
        `shard_opt`."""
        plan = self._get_plan(program, feed, fetch_names, replica,
                              shard_opt, use_cache)
        self._step += 1
        return self._run_plan(plan, program, feed, fetch_names, scope,
                              replica, shard_opt, batch_feeds)

    def _run_plan(self, plan, program, feed, fetch_names, scope,
                  replica=None, shard_opt=False, batch_feeds=(), env=None,
                  step_t=None):
        """Run `plan` as step ``self._step``: the fetched values, a
        persistable one as a copy.  `env` (name -> device tensor) stands
        in for the feed when given, `step_t` for the device step.  While
        a CUDA graph is captured (``self._reads`` set) nothing is
        recorded: the replays record the step."""
        t0 = time.perf_counter()
        self._step_t, self._step_mixes = step_t, None
        data_parallel = replica is not None and replica.world > 1
        self._replica = replica
        self._batch_feeds = frozenset(batch_feeds)
        self._shard_opt = bool(shard_opt and data_parallel)
        self._group = None if replica is not None else \
            _program_group(program)
        self._averaged = set()
        self._row_updates = []
        self._owners = plan.binder.owners(scope)
        if env is None:
            for name, value in feed.items():
                if isinstance(value, core.LoDTensor) and len(value.lod) > 1:
                    _reject_multilevel_lod(program, name, len(value.lod))
            t1 = time.perf_counter()
            env = self._stage_feeds(feed)
        else:
            t1 = time.perf_counter()
        self._fed = dict(env) if len(plan.units) > 1 else None
        self._verdicts = [] if get_flag('FLAGS_check_nan_inf', False) \
            else None
        self._checked_only = plan.checked_only
        self._sub_steps = plan.sub_steps
        self._serial = plan.serial
        body = (plan, env, scope, program, fetch_names, replica,
                data_parallel)
        capturing = self._reads is not None
        if capturing:
            self._ranges, snap = False, None
            if self._verdicts is not None and \
                    get_flag('FLAGS_nan_replay', True):
                # the graph keeps device copies of what the step reads
                snap = self._snapshot_inputs(plan, env, scope)
            results = self._step_body(*body)
        else:
            results, snap = self._recorded_step(body, t0, t1)
        self._owners = {}
        self._step_t = self._step_mixes = self._held = None
        self._fed = None
        if self._verdicts is not None:
            if capturing:
                # checked inside the graph; the replays read the verdicts
                self._captured_nan = self._verdict_launch(self._verdicts) \
                    + (snap,)
                self._verdicts = None
            elif self._verdicts:
                self._raise_non_finite(plan, snap, program)
        if not capturing:
            t0 = time.perf_counter()
            env.clear()
            t1 = time.perf_counter()
            monitor.observe('executor/state_release_seconds', t1 - t0)
            _trace.record('state_release', t0, t1)
            _memviz.maybe_sample(self._step, scope)
        return results

    def _recorded_step(self, body, t0, t1):
        """``_step_body(*body)`` with the records of a step that is not
        captured: the bind and dispatch phases, the executor.dispatch
        fault site, the profiler's program range, the inputs the NaN
        provenance and op-cost replays read, the health summaries and,
        under FLAGS_memviz, the plan's memory row.  Each costs a flag
        read when off.  Returns (results, the snapshot of the inputs or
        None)."""
        plan, env, scope, program = body[:4]
        monitor.observe('executor/bind_seconds', t1 - t0)
        _trace.record('bind', t0, t1)
        self._ranges = _profiler.op_ranges()
        snap = None
        opprof_step = _opprof.want_snapshot(self._step)
        if opprof_step or (self._verdicts is not None and
                           get_flag('FLAGS_nan_replay', True)):
            snap = self._snapshot_inputs(plan, env, scope)
        health = plan.kind != 'forward' and \
            get_flag('FLAGS_health_summaries', False)
        prev = self._param_copies(program, scope) if health else None
        mem = None
        if plan.mem_row is None and get_flag('FLAGS_memviz', False):
            mem = (_memviz.run_begin(self.device),
                   self._read_values(plan, env, scope))
        if _finject.armed():
            # chaos hook: 'executor.dispatch:stall:<s>' is a hung step
            _finject.check('executor.dispatch', step=self._step)
        td = time.perf_counter()
        try:
            if self._ranges:
                with torch.profiler.record_function(
                        _memviz.program_label(program)):
                    results = self._step_body(*body)
            else:
                results = self._step_body(*body)
        except Exception as e:
            if not isinstance(e, FloatingPointError):
                self._dispatch_failed(e, scope)
            raise
        _trace.record('dispatch', td, time.perf_counter())
        if opprof_step:
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
            _opprof.note_segment(
                _memviz.program_label(program), 'step', plan.ops,
                snap[0], snap[1], self._step,
                measured_s=time.perf_counter() - td, device=self.device,
                program_obj=program)
        if mem is not None:
            (state, data), fetch_names = mem[1], body[4]
            plan.mem_row = _memviz.record_run(
                program, self.device, mem[0], state, data,
                dict(zip(fetch_names, results)), plan.ops) or False
        if health:
            self._summarize(program, env, scope, prev)
        return results, snap

    def _step_body(self, plan, env, scope, program, fetch_names, replica,
                   data_parallel):
        """The plan's ops on `env` (the step's dispatch), then its
        fetches."""
        self._dispatch(plan, env, scope, program, data_parallel)
        if self._row_updates:
            from .parallel_executor import gather_rows
            gather_rows(self._row_updates, scope, replica)
            self._row_updates = []
        results = [self._read(n, env, scope) for n in fetch_names]
        return [r.clone() if n not in env and isinstance(r, torch.Tensor)
                else r for n, r in zip(fetch_names, results)]

    def _stage_feeds(self, feed):
        """The feeds on the device: host values move in one span
        ('feed_h2d'); device tensors pass as they are."""
        env, host = {}, None
        for name, value in feed.items():
            value = core.as_array(value)
            if isinstance(value, torch.Tensor) and \
                    value.device == self.device:
                env[name] = value
            else:
                if host is None:
                    host = []
                host.append((name, value))
        if host:
            with _trace.span('feed_h2d', vars=len(host)):
                for name, value in host:
                    env[name] = self._to_device(value)
        return env

    def _dispatch(self, plan, env, scope, program, data_parallel):
        """The plan's ops on `env` (the step's dispatch): its pipeline's
        units in order (``_run_unit``)."""
        for k in range(len(plan.units)):
            self._run_unit(plan, k, env, scope, program, data_parallel)

    def _run_unit(self, plan, k, env, scope, program, data_parallel):
        """Pipeline unit k of the plan: a host op, or device ops, which
        a pipeline step replays from the unit's CUDA graph where it can
        (``self._unit_graphs``, fluid/cuda_graph.py ``Pipeline``).  A
        device unit after the first reads each fed name from the feed,
        as the JAX package's segments bind them (a fed name an earlier
        segment rewrote is fed again)."""
        unit = plan.units[k]
        if unit.host:
            self._run_steps(unit.steps, env, scope, program)
            return
        if k and self._fed:
            env.update((n, self._fed[n]) for n in unit.reads
                       if n in self._fed)
        graphs = self._unit_graphs
        if graphs is not None and unit.no_graph is None and \
                graphs.run(self, plan, k, env, scope, program):
            return
        self._run_device_unit(plan, unit, env, scope, program,
                              data_parallel)

    def _run_device_unit(self, plan, unit, env, scope, program,
                         data_parallel):
        if unit.wpg:
            self._run_whole_program_grad(plan, env, scope, program)
        elif plan.kind == 'per_op':
            hook = None
            k, names = plan.post_grads if data_parallel else (None, ())
            last = [u for u in plan.units if not u.host][-1] is unit
            if data_parallel and (
                    unit.steps[0].index <= k <= unit.steps[-1].index or
                    (last and k > unit.steps[-1].index)):
                hook = (k, lambda env: env.update(self._global_grads(
                    {n: env[n] for n in names
                     if isinstance(env.get(n), torch.Tensor)}, plan.var_of)))
            with torch.no_grad():
                self._run_steps(unit.steps, env, scope, program, hook)
        else:
            mode = torch.no_grad() if plan.writes_state else \
                torch.inference_mode()
            with mode:
                self._run_steps(unit.steps, env, scope, program)

    def _dispatch_failed(self, e, scope):
        """A failed dispatch (JAX: fluid/executor.py:2536-2558): memviz's
        OOM note (with its own flight dump) where the allocator failed,
        else the flight recorder's dump, named in the error's notes."""
        oom_note = None
        if _memviz.is_oom_error(e):
            oom_note = _memviz.oom_incident(e, step=self._step, scope=scope)
            if oom_note:
                e.add_note(oom_note)
        if not (oom_note and 'flight dump' in oom_note):
            dump = _trace.dump_on_error('segfail_step%d' % self._step)
            if dump:
                e.add_note('trace flight recorder (last %d steps) dumped '
                           'to %s' % (len(_trace.steps()), dump))

    def _read_values(self, plan, env, scope):
        """({name: value} of the scope values the plan reads first,
        {name: value} of the feeds): what a run reads."""
        from .cuda_graph import _scope_reads
        state = {}
        for n in _scope_reads(plan):
            if n in env:
                continue
            vars_ = scope._owner_vars(n)
            v = None if vars_ is None else vars_[n]
            if v is not None:
                state[n] = v
        return state, dict(env)

    def _snapshot_inputs(self, plan, env, scope):
        """Copies of what the step reads (the scope values before the
        step writes them in place, and the feeds): the inputs of a
        post-mortem or op-cost replay."""
        state, data = self._read_values(plan, env, scope)
        copy = lambda v: v.detach().clone() if isinstance(  # noqa: E731
            v, torch.Tensor) else self._to_device(v)
        return ({n: copy(v) for n, v in state.items()},
                {n: copy(v) for n, v in data.items()})

    def _param_copies(self, program, scope):
        out = {}
        for p in program.all_parameters():
            v = scope.find_var(p.name)
            if isinstance(v, torch.Tensor):
                out[p.name] = v.detach().clone()
        return out

    def _summarize(self, program, env, scope, prev):
        """FLAGS_health_summaries: the step's tensor-health summaries
        (fluid/health.py summarize_step) over its parameters and their
        gradients."""
        from . import health
        gmap = getattr(program, '_grad_name_map', {})
        names = [p.name for p in program.all_parameters()]
        out = {}
        for n in names:
            out[n] = scope.find_var(n)
            g = gmap.get(n)
            if g is not None and g in env:
                out[g] = env[g]
        health.summarize_step(self._step, out, prev, names, gmap)

    def _global_grads(self, grads, var_of):
        """{gradient name: tensor} -> the gradients of the global loss:
        each summed over the ranks and divided by their number (one
        all-reduce a flat bucket, in name order on every rank), but a
        batch feed's (var_of maps a gradient to its variable), which
        holds this rank's rows and is only divided: its fetch gathers
        the rows."""
        from .parallel_executor import average
        shared = sorted(g for g in grads
                        if var_of.get(g) not in self._batch_feeds)
        out = {g: v / self._replica.world for g, v in grads.items()}
        out.update(zip(shared, average([grads[g] for g in shared],
                                       self._replica)))
        self._averaged.update(shared)
        return out

    # ------------------------------------------------- warmup, compile
    def warmup(self, program=None, feed_shapes=None, fetch_list=None,
               scope=None):
        """Build the program's run plan ahead of the first run and, on a
        CUDA place, capture the CUDA graph of each feed signature (JAX:
        fluid/executor.py:1457).  `feed_shapes` maps each feed name to
        a (shape, dtype) pair or an example array or tensor; a list of
        such dicts gives several signatures (a predictor's batch
        buckets).  Pass the feed names and `fetch_list` the later runs
        use: they key the plan.  Each signature runs once from zero
        feeds, on the capture stream, then is captured; parameters come
        from `scope` (run the startup program first).  Returns a
        WarmupResult naming what was captured and, for each signature
        that was not, why."""
        program = program or framework.default_main_program()
        scope = scope or core.global_scope()
        fetch_names = _fetch_names(fetch_list)
        sigs = feed_shapes if isinstance(feed_shapes, (list, tuple)) \
            else [feed_shapes or {}]
        captured, skipped = [], []
        for k, shapes in enumerate(sigs):
            specs = {n: _spec(v) for n, v in shapes.items()}
            plan = self._get_plan(program, specs, fetch_names)
            if k == 0:
                # forced static verification (JAX: fluid/executor.py:1533):
                # the fast families always, the shape walk under
                # FLAGS_program_verify
                from . import progcheck
                progcheck.verify_program(
                    program, feed_names=list(specs), fetch_names=fetch_names,
                    feed_specs=specs, plan=plan, origin='warmup',
                    level='full' if progcheck.enabled() else 'fast')
            row = tuple(sorted((n, s, core.dtype_name(d))
                               for n, (s, d) in specs.items()))
            why = plan.no_graph or self._no_graph(program)
            if why is None and (len(plan.units) > 1 or plan.buckets):
                why = ('a pipeline of %d units or an auto-bucketed while: '
                       'captured at its second run, unit by unit or bucket '
                       'by bucket' % len(plan.units))
            if why is not None:
                skipped.append((row, why))
                continue
            from . import cuda_graph
            feed = {n: torch.zeros(s, dtype=core.convert_dtype(d),
                                   device=self.device)
                    for n, (s, d) in specs.items()}
            step = self._step
            try:
                why = cuda_graph.warm(self, plan, program, feed,
                                      fetch_names, scope)
            finally:
                self._step = step
            if why is not None:
                skipped.append((row, why))
            else:
                captured.append(row)
        # /healthz readiness: a warmed process is ready before its first
        # step
        compile_cache.plane()._warmed = True
        return WarmupResult(captured, skipped)

    def _no_graph(self, program):
        """Why this run of a capturable plan stays eager, or None."""
        if self.device.type != 'cuda':
            return '%r: CUDA graphs need a CUDA place' % (self.place,)
        if getattr(program, '_collective_dp', False):
            return 'a collective program (its ops reduce over the group)'
        return None

    def compile(self, program, feed_names=(), fetch_names=(),
                allow_host=False):
        """The program as one function, a CompiledStep (JAX:
        fluid/executor.py:1341), where it is one segment; with
        allow_host=True a program that host ops or an auto-bucketed
        while split into segments gives a CompiledPipeline, whose device
        units replay from CUDA graphs with the host ops between them."""
        feed_names = _fetch_names(feed_names)
        fetch_names = _fetch_names(fetch_names)
        monitor.add('executor/programs_compiled')
        plan = self._get_plan(program, dict.fromkeys(feed_names),
                              fetch_names)
        if len(plan.items) != 1 or plan.items[0][0] != 'segment':
            if allow_host:
                return self._pipeline(program, plan, feed_names,
                                      fetch_names)
            why = []
            host = [plan.ops[i].type for kind, i in plan.items
                    if kind == 'host']
            if host:
                why.append('host ops %r' % (host,))
            if any(kind == 'bucket' for kind, _ in plan.items):
                why.append('auto-bucketed unbounded while loops (pass '
                           'max_trip_count to bound them)')
            raise ValueError(
                'Executor.compile needs a single-segment program for one '
                'step function; this one splits into %d segments around '
                '%s: pass allow_host=True for a CompiledPipeline, or run '
                'it with Executor.run' % (
                    sum(kind == 'segment' for kind, _ in plan.items),
                    ' and '.join(why) or 'program cuts'))
        written = set(n for op in plan.ops for n in op.output_arg_names)
        missing = [n for n in fetch_names if n not in written]
        if missing:
            raise ValueError(
                'fetch vars %r are not produced by the compiled step (a '
                'fetch must be written by the program; pure inputs are '
                'available to the caller already)' % (missing,))
        inputs, state, outputs = _segment_names(plan)
        known = set(inputs) | set(state)
        bogus = [n for n in feed_names if n not in known]
        if bogus:
            raise ValueError('feed names %r are not read by the program '
                             '(inputs: %r)' % (bogus, sorted(known)))

        # on a card the step replays a CUDA graph on a scope of its own,
        # the caller's state copied into that scope's tensors
        graphed = plan.no_graph is None and self.device.type == 'cuda'
        kept = core.Scope() if graphed else None

        def fn(step, state, data):
            pure = [(n, v) for n, v in data.items() if n not in feed_names]
            if graphed:
                scope = kept
                for n, v in list(state.items()) + pure:
                    self._assign(scope, n, v)
            else:
                scope = core.Scope()
                for n, v in state.items():
                    scope.set_var(n, v.clone() if isinstance(
                        v, torch.Tensor) else np.array(v))
                for n, v in pure:
                    scope.set_var(n, v)
            saved = self._step
            self._step = int(step) - 1
            try:
                results = self._run_graphed(
                    plan, program, {n: data[n] for n in feed_names},
                    fetch_names, scope, False, graphed)
            finally:
                self._step = saved
            out = dict(zip(fetch_names, results))
            for n in outputs:
                if n not in out:
                    v = scope.find_var(n)
                    out[n] = v.clone() if graphed and isinstance(
                        v, torch.Tensor) else v
            return out

        return CompiledStep(fn, inputs, state, outputs)

    def _pipeline(self, program, plan, feed_names, fetch_names):
        """compile(allow_host=True)'s CompiledPipeline, after the JAX
        package's checks: every fetch is written by the program, every
        feed read by a segment before it writes it or by a host op."""
        known_out, known_in = set(), set()
        for kind, idx in plan.items:
            ops = [plan.ops[i] for i in idx] if kind == 'segment' else \
                [plan.ops[idx]]
            written = set()
            for op in ops:
                known_in.update(n for n in _op_reads(op)
                                if n not in written)
                written.update(op.output_arg_names)
            known_out |= written
        missing = [n for n in fetch_names if n not in known_out]
        if missing:
            raise ValueError('fetch vars %r are not produced by the '
                             'program' % (missing,))
        bogus = [n for n in feed_names if n not in known_in]
        if bogus:
            raise ValueError('feed names %r are not read by the program'
                             % (bogus,))
        return CompiledPipeline(self, program, plan, feed_names,
                                fetch_names)

    def _assign(self, scope, name, value):
        """Write `value` into `scope`'s tensor `name` in place where its
        shape and dtype allow (a CUDA graph reads that tensor), else
        set a device copy of its own."""
        value = core.as_array(value)
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        cur = scope._vars.get(name)
        if isinstance(cur, torch.Tensor) and cur.shape == value.shape \
                and cur.dtype == value.dtype:
            cur.copy_(value)
        else:
            scope.set_var(name, value.to(self.device, copy=True))

    # -------------------------------------------------------- datasets
    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """One pass of `program` over a fluid.dataset's batches, one
        ``run`` a batch (reference executor.py:1115; JAX:
        fluid/executor.py:2707).  The fetches are read and printed every
        `print_period` steps.  thread=N > 1 (or the fleet's thread_num)
        stages N batches ahead onto the executor's card from a producer
        thread (the Hogwild worker's overlap; fluid/reader.py
        _AsyncBatchIterator); at one thread run takes the feeder's
        batches as they are.  Every step goes through run, so a
        full-size batch replays the plan's CUDA graph and a last,
        smaller batch runs its own signature.  Returns the number of
        steps."""
        return self._from_dataset(program, dataset, scope, thread, debug,
                                  fetch_list, fetch_info, print_period)

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """train_from_dataset that updates nothing (JAX:
        fluid/executor.py:2719): a training program runs as its
        clone(for_test=True), cached on the program and made again after
        a rewrite (keyed on the program's version)."""
        program = program or framework.default_main_program()
        if any(_role(op) in ('optimize', 'backward')
               for op in program.global_block().ops):
            cached = getattr(program, '_infer_clone', None)
            if cached is None or cached[0] != program._version:
                cached = (program._version, program.clone(for_test=True))
                program._infer_clone = cached
            program = cached[1]
        return self._from_dataset(program, dataset, scope, thread, debug,
                                  fetch_list, fetch_info, print_period)

    def _from_dataset(self, program, dataset, scope, thread, debug,
                      fetch_list, fetch_info, print_period):
        from .trainer_desc import TrainerFactory
        program = program or framework.default_main_program()
        scope = scope or core.global_scope()
        fetch_names = _fetch_names(fetch_list)
        # the trainer/worker config plane (reference TrainerFactory,
        # executor.py:962): fleet opt_info picks the trainer and may set
        # thread_num when the call leaves thread=0
        opt_info = getattr(program, '_fleet_opt', None)
        trainer = TrainerFactory()._create_trainer(opt_info)
        trainer._set_program(program)
        trainer._set_debug(debug)
        if thread:
            trainer._set_thread(thread)
        elif not opt_info or 'thread_num' not in opt_info:
            trainer._set_thread(0)
        trainer._gen_trainer_desc()
        thread = int(trainer.proto_desc['thread_num'])
        if thread > 1:
            from .reader import _AsyncBatchIterator
            batches = _AsyncBatchIterator(dataset.batches, thread,
                                          self.device)
        else:
            batches = dataset.batches()
        step = 0
        batches = iter(batches)
        try:
            while True:
                # the synchronous feeder's batch is made here: its time
                # is the loop's wait for input (the staged pipeline
                # records its own reader_wait)
                t0 = time.perf_counter()
                try:
                    feed = next(batches)
                except StopIteration:
                    break
                if thread <= 1:
                    t1 = time.perf_counter()
                    monitor.observe('reader/consume_blocked_seconds',
                                    t1 - t0)
                    _trace.record('reader_wait', t0, t1)
                fetches = fetch_names if (fetch_names and print_period and
                                          step % print_period == 0) else []
                out = self.run(program, feed=feed, fetch_list=fetches,
                               scope=scope)
                if fetches:
                    info = fetch_info or fetch_names
                    print('[dataset step %d] %s' % (step, ' '.join(
                        '%s=%s' % (k, np.asarray(v).ravel()[:4])
                        for k, v in zip(info, out))))
                step += 1
        finally:
            if thread > 1:
                batches.close()
        return step

    # ------------------------------------------------------------ ops
    def _ctx(self, seed, program, unread=frozenset()):
        return registry.LowerCtx(
            self._step, seed, device=self.device,
            random_seed=program.random_seed, group=self._group,
            replica=self._replica, step_mix=self._step_mix, unread=unread,
            host_draws=program._is_start_up_program_)

    def _check_finite(self, name, val, persistable=False):
        """Queue a floating value the step writes for the step's finite
        check (FLAGS_check_nan_inf); on an AMP program only a persistable
        or fetched one."""
        if self._verdicts is None or not isinstance(val, torch.Tensor) \
                or not val.is_floating_point():
            return
        if self._checked_only is not None and not persistable and \
                name not in self._checked_only:
            return
        self._verdicts.append((name, val.detach()))

    def _verdict_launch(self, entries):
        """(names, uint8 verdicts) of the queued (name, value) `entries`
        and of the (names, verdicts) of replayed graphs among them, in
        their order: the values checked in one finite_check launch."""
        from ..ops.kernels import finite_check
        vals = [v for n, v in entries if not isinstance(n, tuple)]
        checked = finite_check.finite_check(vals, self.device)
        names, parts, k = [], [], 0
        for n, v in entries:
            if isinstance(n, tuple):
                names.extend(n)
                parts.append(v)
            else:
                names.append(n)
                parts.append(checked[k:k + 1])
                k += 1
        return tuple(names), torch.cat(parts) if len(parts) > 1 else \
            (parts[0] if parts else checked)

    def _raise_non_finite(self, plan=None, snap=None, program=None):
        """Reference CheckVarHasNanOrInf (framework/details/
        nan_inf_utils.h:28), per value written: every value of the step
        is checked in one finite_check launch, its verdicts cross to the
        host in one copy, and the error names every non-finite variable,
        not just the first."""
        names, verdicts = self._verdict_launch(self._verdicts)
        self._verdicts = None
        self._raise_bad(names, verdicts.cpu().tolist(), plan, snap, program)

    def _raise_bad(self, names, ok, plan=None, snap=None, program=None):
        """Raise FloatingPointError naming each of `names` whose verdict
        in `ok` is 0.  Its notes carry the first op that went non-finite
        (``health.nan_provenance``, a replay from `snap`, the copies of
        what the step read) and the flight recorder's dump (JAX:
        fluid/executor.py:2578-2628)."""
        bad = []
        for name, good in zip(names, ok):
            if not good and name not in bad:
                bad.append(name)
        if not bad:
            return
        monitor.add('health/nan_trips')
        err = FloatingPointError(
            'nan/inf detected in %d var(s) [%s] (step %d)'
            % (len(bad), ', '.join(bad), self._step))
        report = None
        if snap is not None and plan is not None:
            from . import health
            with _trace.span('nan_replay', ops=len(plan.ops)):
                report = health.nan_provenance(
                    plan.ops, snap[0], snap[1], self._step, self.device,
                    program)
            err.add_note(health.format_provenance(report))
        dump = _trace.dump_on_error('nan_step%d' % self._step,
                                    extra={'nan_provenance': report}
                                    if report else None)
        if dump:
            err.add_note('trace flight recorder (last %d steps) dumped to '
                         '%s' % (len(_trace.steps()), dump))
        raise err

    def _write(self, names, persistable, vals, env, scope):
        for n, p, val in zip(names, persistable, vals):
            self._check_finite(n, val, p)
            if p and not self._counting:
                self._write_state(scope, n, val)
            else:
                env[n] = val

    def _lower_op(self, st, env, scope, program):
        if self._ranges:
            # a profile runs: the op in a range named as opprof names it
            name = _opprof.op_scope(st.op) if _opprof.instancing() \
                else st.op.type
            with torch.profiler.record_function(name):
                return self._lower_op_inner(st, env, scope, program)
        return self._lower_op_inner(st, env, scope, program)

    def _lower_op_inner(self, st, env, scope, program):
        op = st.op
        if op.type in _CONTROL_FLOW:
            block = op.block
            for n, val in self._control_flow(op, env, scope,
                                             program).items():
                self._write([n], [_is_persistable(block, n)], [val], env,
                            scope)
            return
        outs, rows = self._run_op(st, env, scope, program)
        if st.opdef is not None and st.opdef.host:
            self._write_host(st, outs, env, scope)
            return
        self._write_op(st, outs, {}, rows, env, scope)

    def _write_host(self, st, outs, env, scope):
        """A host op's outputs: into the scope where the name is
        persistable or the scope holds it (and no feed or earlier op of
        the step gave it), as the JAX package's host ops write the scope
        (a load into a parameter of another program), else into the
        env."""
        for slot, names, persistable in st.outs:
            for n, p, val in zip(names, persistable, outs.get(slot, [])):
                self._check_finite(n, val, p)
                if p or (n not in env and scope.find_var(n) is not None):
                    self._write_state(scope, n, val)
                else:
                    env[n] = val

    def _run_op(self, st, env, scope, program):
        """Read an op's inputs and run its lowering (a host op's without
        autograd): (its outputs by slot, the sharded rows of
        ``_shard_rows`` or None)."""
        op = st.op
        opdef = st.opdef or registry.get(op.type)
        read = self._read
        ins = {slot: [read(n, env, scope) for n in names]
               for slot, names in st.ins}
        if opdef.host:
            monitor.add('executor/host_ops_run')
            with _trace.span('host_op', op=op.type), torch.no_grad():
                return opdef.fn(self._ctx(st.seed, program), op, ins), None
        rows = self._shard_rows(op, ins, 0, scope) if self._shard_opt \
            else None
        try:
            outs = opdef.run(self._ctx(st.seed, program, st.unread), ins,
                             op.attrs)
        except Exception as e:
            e.add_note('in op %s (created at %s)' % (
                op.type, '; '.join(op.attrs.get('__op_callstack__', [])[:2])))
            raise
        return outs, rows

    def _write_op(self, st, outs, cursor, rows, env, scope):
        """Write the op's outputs, taken from each output slot of `outs`
        at the slot's `cursor` position (advanced past them).  With
        `rows` (the sharded optimizer state) the accumulators are this
        rank's rows and the parameter's updated rows wait for the
        all-gather."""
        for slot, names, persistable in st.outs:
            k = cursor.get(slot, 0)
            cursor[slot] = k + len(names)
            vals = outs.get(slot, [])[k:k + len(names)]
            if rows is not None and slot == 'ParamOut':
                self._row_updates.append((names[0], rows, vals[0]))
                continue
            self._write(names, persistable, vals, env, scope)
            if rows is not None and slot[:-3] in \
                    _ROW_ACCUMULATORS[st.op.type]:
                scope.find_var(names[0])._pt_row_shard = self._replica

    def _shard_rows(self, op, ins, k, scope):
        """Under the sharded optimizer state: make member k of op's row
        slots in `ins` this rank's rows (the parameter and the averaged
        gradient as views, the accumulators as the scope's shards) and
        return (start, stop), or None where op's accumulators stay
        whole: dim 0 of 1 or not divisible by the ranks (the JAX
        package's rule), or no accumulator.  A whole accumulator the
        startup program made (or a load put back) is replaced in the
        scope by a copy of its rows, so its memory is freed."""
        accs = _ROW_ACCUMULATORS.get(op.type)
        if accs is None:
            if op.type == 'lamb':
                raise NotImplementedError(
                    'lamb under the sharded optimizer state '
                    '(ReduceStrategy.Reduce): its trust ratio is a '
                    'whole-tensor norm (ROADMAP Queue 1 item 4)')
            return None
        p = ins['Param'][k]
        world, rank = self._replica.world, self._replica.rank
        n = p.shape[0] if p.dim() else 1
        if n <= 1 or n % world:
            return None
        a, b = rank * (n // world), (rank + 1) * (n // world)
        ins['Param'][k] = p[a:b]
        ins['Grad'][k] = ins['Grad'][k][a:b]
        for slot in accs:
            acc = ins[slot][k]
            if acc.shape[0] == n:
                acc = acc[a:b].clone()
                self._set_scope(scope, op.input(slot)[0], acc)
            ins[slot][k] = acc
        return a, b

    # --------------------------------------------------- control flow
    # (JAX: fluid/executor.py:477-480, :553-768).  A sub-block runs op by
    # op on an env of its own chained over the parent's (a ChainMap:
    # its writes stay local, its reads fall through to the parent env
    # and the scope); the op's loop state comes back as its outputs.

    def _control_flow(self, op, env, scope, program):
        """{name: value} that the control-flow op `op` writes."""
        sub = self._sub_steps[op.attrs['sub_block']]
        if op.type == 'while':
            return self._lower_while(op, sub, env, scope, program)
        if op.type == 'conditional_block':
            return self._lower_conditional_block(op, sub, env, scope,
                                                 program)
        return self._lower_control_flow_grad(op, sub, env, scope, program)

    def _readable(self, name, env, scope):
        if name in env:
            return True
        vars_ = scope._owner_vars(name)
        return vars_ is not None and vars_[name] is not None

    def _run_sub_block(self, steps, env, scope, program):
        """Run a sub-block's ops (the plan's ``sub_steps``) on `env` (a
        ChainMap over its parent's) through ``_run_op``, or a nested
        control-flow op's lowering; every write stays in `env`.  As in
        the JAX package, FLAGS_check_nan_inf sees a body's values where
        they leave the loop (the control-flow op's outputs): a masked
        trip computes values that it then throws away."""
        for st in steps:
            if st.op.type in _CONTROL_FLOW:
                env.update(self._control_flow(st.op, env, scope, program))
                continue
            outs, _ = self._run_op(st, env, scope, program)
            for slot, names, _ in st.outs:
                env.update(zip(names, outs.get(slot, [])))

    def _body(self, sub, carry, env, scope, program):
        """One trip of a sub-block from `carry`: the carry's new values,
        each in its dtype before the trip (an AMP lowering in the body
        may return bf16 for an f32 carry; JAX: fluid/executor.py:589)."""
        local = collections.ChainMap(dict(carry), env)
        self._run_sub_block(sub, local, scope, program)
        return {n: local[n].to(v.dtype) for n, v in carry.items()}

    def _carry(self, op, env, scope, cond_name=None):
        """The loop state of a control-flow op without gradients: what
        its sub-block writes that has a value before it."""
        names = [n for n in op.output('Out')
                 if self._readable(n, env, scope)]
        if cond_name is not None and cond_name not in names:
            names.append(cond_name)
        return {n: self._read(n, env, scope) for n in names}

    def _entries(self, op, env, scope):
        """The loop state of an op that carries gradients
        (__carry_names__) and its values before the op, which the op
        also writes to its Entry slot."""
        carry, out = {}, {}
        for n, en in zip(op.attrs['__carry_names__'],
                         op.attrs['__entry_names__']):
            if not self._readable(n, env, scope):
                raise RuntimeError(
                    '%s loop state %s is not initialized before the op'
                    % (op.type, n))
            carry[n] = out[en] = self._read(n, env, scope)
        return carry, out

    def _lower_while(self, op, sub, env, scope, program):
        """A while op.  Without gradients, the loop of the JAX package's
        lax.while_loop: the condition read on the host before each trip.
        With them (__needs_grad__, set by backward._control_flow_backward)
        the bounded, masked loop of ``_while_scan``, which reads nothing
        on the host; an unbounded one counts its trips first
        (``_bucket_trips``)."""
        cond_name = op.input('Condition')[0]
        if op.attrs.get('__needs_grad__'):
            carry, out = self._entries(op, env, scope)
            if op.attrs.get('__auto_bucket__') and self._nodes is None:
                # (a capture's bucket was counted before the step:
                # fluid/cuda_graph.py count_buckets)
                self._bucket_trips(op, sub, dict(carry), cond_name, env,
                                   scope, program)
            out.update(self._while_scan(
                sub, carry, cond_name, env, int(op.attrs['max_trip_count']),
                scope, program))
            return out
        carry = self._carry(op, env, scope, cond_name)
        if self._nodes is not None:
            from . import cuda_graph
            return cuda_graph.while_node(
                self, carry, cond_name,
                lambda c: self._body(sub, c, env, scope, program))
        while bool(carry[cond_name].reshape(())):
            carry = self._body(sub, carry, env, scope, program)
        return carry

    def _while_scan(self, sub, carry, cond_name, env, max_t, scope,
                    program):
        """The bounded, masked rendering of a while loop (JAX:
        fluid/executor.py:607 ``_while_scan``): `max_t` trips of the
        body, each kept only while the condition held before it, so
        autograd differentiates the loop as it ran and no trip reads the
        condition on the host.

        Truncation guard: if the condition still holds after `max_t`
        trips (max_trip_count underestimated the trips), the float
        carries become NaN rather than the truncated recurrence; within
        the bound the guard adds an exact 0."""
        for _ in range(max_t):
            pred = carry[cond_name].reshape(()).bool()
            new = self._body(sub, carry, env, scope, program)
            carry = {n: torch.where(pred, new[n], v)
                     for n, v in carry.items()}
        truncated = carry[cond_name].reshape(()).bool()
        poison = torch.where(
            truncated, torch.full((), float('nan'), device=truncated.device),
            torch.zeros((), device=truncated.device))
        return {n: v + poison.to(v.dtype) if v.is_floating_point() else v
                for n, v in carry.items()}

    def _bucket_trips(self, op, sub, carry, cond_name, env, scope,
                      program):
        """The auto-bucket of an unbounded while that carries gradients
        (JAX: fluid/executor.py:2256): the loop once without autograd,
        its trips counted, rounded up to a power of two and set as
        max_trip_count on every op of its bucket group (the forward
        while and its grad)."""
        trips = 0
        with torch.no_grad():
            while bool(carry[cond_name].reshape(())):
                carry = self._body(sub, carry, env, scope, program)
                trips += 1
        bucket = 1
        while bucket < max(trips, 1):
            bucket *= 2
        gid = op.attrs['__bucket_group__']
        for o in op.block.ops:
            if o.attrs.get('__bucket_group__') == gid:
                o.attrs['max_trip_count'] = bucket

    def _count_trips(self, plan, program, feed, scope, step, env=None,
                     step_t=None):
        """The trips of the plan's auto-bucketed whiles at executor step
        `step` (fluid/cuda_graph.py ``count_buckets``): the device ops
        before the last of them run forward-only, their persistable
        writes kept in the run's env, and each of them to its end from
        its entries.  The trips as counted on the host, or, in a
        capture, the counter index of each one's WHILE node."""
        last = max(i for i, op in enumerate(plan.ops)
                   if any(op is b for b in plan.buckets))
        saved = (self._step, self._verdicts)
        self._step, self._verdicts = step, None
        self._step_t, self._step_mixes = step_t, None
        self._owners = plan.binder.owners(scope)
        self._sub_steps = plan.sub_steps
        self._counting = True
        trips = []
        try:
            if env is None:
                env = self._stage_feeds(feed)
            with torch.no_grad():
                for op in plan.ops[:last + 1]:
                    if any(op is b for b in plan.buckets):
                        trips.append(self._while_trips(op, env, scope,
                                                       program))
                    elif not _is_host(op):
                        self._lower_op(_OpStep(op), env, scope, program)
        finally:
            self._counting = False
            self._step, self._verdicts = saved
            self._owners = {}
            self._step_t = self._step_mixes = None
        return trips

    def _while_trips(self, op, env, scope, program):
        sub = self._sub_steps[op.attrs['sub_block']]
        cond = op.input('Condition')[0]
        carry, _ = self._entries(op, env, scope)
        if cond not in carry:
            carry[cond] = self._read(cond, env, scope)
        run = lambda c: self._body(sub, c, env, scope, program)  # noqa
        if self._nodes is not None:
            from . import cuda_graph
            k = len(self._nodes.manifests)
            cuda_graph.while_node(self, carry, cond, run)
            return k
        trips = 0
        while bool(carry[cond].reshape(())):
            carry = run(carry)
            trips += 1
        return trips

    def _lower_conditional_block(self, op, sub, env, scope, program):
        """A conditional_block: its sub-block runs when Cond holds (read
        on the host, the JAX package's lax.cond), else its outputs keep
        their values.  With __needs_grad__ it also writes the entries.
        In a capture the condition stays on the device: an IF node
        (fluid/cuda_graph.py; a branch that carries gradients is never
        captured, ``_host_control``).  The first run of a signature
        builds an untaken branch's kernels without running them
        (``cuda_graph.warm_branch``)."""
        out = {}
        needs_grad = op.attrs.get('__needs_grad__')
        if needs_grad:
            carry, out = self._entries(op, env, scope)
        else:
            carry = self._carry(op, env, scope)
        pred = self._read(op.input('Cond')[0], env, scope)
        run = lambda c: self._body(sub, c, env, scope, program)  # noqa
        if self._nodes is not None and not needs_grad:
            from . import cuda_graph
            carry = cuda_graph.if_node(self, carry, pred, run)
        elif bool(pred.reshape(())):
            carry = run(carry)
        elif self._warm_branches:
            from . import cuda_graph
            cuda_graph.warm_branch(self, op, carry, run)
        out.update(carry)
        return out

    def _lower_control_flow_grad(self, op, sub, env, scope, program):
        """while_grad / conditional_block_grad on the per-op grad path
        (JAX: fluid/executor.py:648 ``_control_flow_grad``): the loop or
        branch again from the saved entries under autograd, then one
        torch.autograd.grad from the float carries' cotangents to the
        entries (GRAD::Entry) and the closure reads (GRAD::X).  The
        whole-program grad never runs it: it differentiates the forward
        op as it ran."""
        carry_names = list(op.attrs['__carry_names__'])
        floats = list(op.attrs['__float_carries__'])
        closure = list(op.attrs['__closure_names__'])
        with torch.enable_grad():
            entry = {n: self._read(en, env, scope)
                     for n, en in zip(carry_names, op.input('Entry'))}
            entry = {n: v.detach().requires_grad_() if n in floats else v
                     for n, v in entry.items()}
            shadow = {n: self._read(n, env, scope).detach().requires_grad_()
                      for n in closure}
            local = collections.ChainMap(shadow, env)
            if op.type == 'while_grad':
                final = self._while_scan(
                    sub, entry, op.input('Condition')[0], local,
                    int(op.attrs['max_trip_count']), scope, program)
            else:
                pred = self._read(op.input('Cond')[0], env, scope)
                run = lambda c: self._body(sub, c, local, scope,  # noqa
                                           program)
                if bool(pred.reshape(())):
                    final = run(entry)
                else:
                    final = entry
            xs = [entry[n] for n in floats] + [shadow[n] for n in closure]
            ys, cts = [], []
            for n, g in zip(floats, op.input('GRAD::Out')):
                if final[n].requires_grad:
                    ys.append(final[n])
                    cts.append(self._read(g, env, scope).to(
                        final[n].dtype).reshape(final[n].shape))
            grads = torch.autograd.grad(ys, xs, cts, allow_unused=True) \
                if ys else [None] * len(xs)
        names = list(op.output('GRAD::Entry')) + list(op.output('GRAD::X'))
        return {g: torch.zeros_like(x).detach() if d is None else d
                for g, x, d in zip(names, xs, grads)}

    def _lower_fused_run(self, run, env, scope, program):
        """One fused_<type> op for a grouped optimizer run: each input
        slot carries the run's tensors in run order, and the outputs
        go back to each member op's outputs.  A run holding a tensor
        the kernel does not take (not f32) runs op by op instead."""
        ins = {}
        for st in run:
            for slot, names in st.ins:
                ins.setdefault(slot, []).extend(
                    self._read(n, env, scope) for n in names)
        if not all(x.dtype == torch.float32 for slot in
                   ('Param', 'Moment1', 'Moment2') for x in ins[slot]) or \
                not all(x.is_floating_point() for x in ins['Grad']):
            for st in run:
                self._lower_op(st, env, scope, program)
            return
        rows = [self._shard_rows(st.op, ins, k, scope) if self._shard_opt
                else None for k, st in enumerate(run)]
        first = run[0].op
        fused = _FUSABLE_OPT[first.type]
        try:
            outs = registry.get(fused).run(
                self._ctx(run[0].seed, program), ins, dict(first.attrs))
        except Exception as e:
            e.add_note('in a fused run of %d %s ops (%s)' % (
                len(run), first.type,
                ', '.join(st.op.outputs.get('ParamOut', ['?'])[0]
                          for st in run)))
            raise
        cursor = {}
        for st, r in zip(run, rows):
            self._write_op(st, outs, cursor, r, env, scope)

    def _run_steps(self, steps, env, scope, program, hook=None):
        """Run a plan's steps in order; `hook` = (k, fn) calls fn(env)
        before the step at op index k.  A 'Serial' profile times each
        op to completion (profiler.record_op)."""
        for st in steps:
            if hook is not None and st.index == hook[0]:
                hook, fn = None, hook[1]
                fn(env)
            if self._serial:
                self._timed_op(st.members[0], env, scope, program)
            elif st.fused:
                if self._ranges:
                    first = st.members[0].op
                    fused = _FUSABLE_OPT[first.type]
                    name = _opprof.op_scope(first, fused) \
                        if _opprof.instancing() else fused
                    with torch.profiler.record_function(name):
                        self._lower_fused_run(st.members, env, scope,
                                              program)
                else:
                    self._lower_fused_run(st.members, env, scope, program)
            else:
                self._lower_op(st.members[0], env, scope, program)
            for n in st.drops:
                env.pop(n, None)
        if hook is not None:
            hook[1](env)

    def _timed_op(self, st, env, scope, program):
        """One op of a 'Serial' profile, host-timed to completion: the
        card is synchronized before and after it (the reference's
        RecordEvent)."""
        cuda = self.device.type == 'cuda'
        if cuda:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        self._lower_op(st, env, scope, program)
        if cuda:
            torch.cuda.synchronize(self.device)
        _profiler.record_op(st.op.type, time.perf_counter() - t0)

    def _run_whole_program_grad(self, plan, env, scope, program):
        """The forward region with autograd recording, one autograd pass
        from each loss whose gradients are read (usually one) to the
        variables whose gradients that loss's backward walk gives, then
        the remaining (optimizer) ops without it."""
        wpg = plan.wpg
        wrt = sorted(set(wpg['grads'].values()))
        fed = {n: env[n] for n in wrt if n in env}
        with torch.enable_grad():
            leaves = []
            for n in wrt:
                leaf = self._read(n, env, scope).detach().requires_grad_()
                leaves.append(leaf)
                env[n] = leaf
            i = 0
            while i < len(plan.pre):
                span = plan.spans.get(i)
                if span is not None:
                    self._run_span(span, env, scope, program)
                    i += len(span.steps)
                    continue
                self._run_pre_step(plan.pre[i], plan.pre_drops[i], env,
                                   scope, program)
                i += 1
            losses = [env[p] for p, _, _ in wpg['seeds']]
            seeds = [torch.full_like(v, value)
                     for v, (_, _, value) in zip(losses, wpg['seeds'])]
            used = sorted(set(wpg['regions'].values()))
            by_region = {}
            for k, r in enumerate(used):
                if losses[r].requires_grad and leaves:
                    row = torch.autograd.grad(
                        [losses[r]], leaves, [seeds[r]], allow_unused=True,
                        retain_graph=k + 1 < len(used))
                else:
                    row = [None] * len(leaves)
                by_region[r] = {
                    n: (torch.zeros_like(x).detach() if g is None else g)
                    for n, x, g in zip(wrt, leaves, row)}
        del leaves
        grads = {g: by_region[wpg['regions'][g]][p]
                 for g, p in wpg['grads'].items()}
        del by_region
        if self._replica is not None and self._replica.world > 1:
            # CoeffNumDevice: the gradients of the global loss
            grads = self._global_grads(grads, wpg['grads'])
        # the optimizer reads the scope's parameters, not the leaves
        for n in wrt:
            env.pop(n, None)
        env.update(fed)
        for (p, g, _), v, seed in zip(wpg['seeds'], losses, seeds):
            env[p] = v.detach()
            if g in plan.keep:
                env[g] = seed
        for g, v in grads.items():
            env[g] = v
            self._check_finite(g, v)
        with torch.no_grad():
            self._run_steps(plan.post, env, scope, program)

    def _run_pre_step(self, st, drop, env, scope, program):
        self._lower_op(st, env, scope, program)
        for n in st.stops:
            if n in env:
                env[n] = env[n].detach()
        for n in drop:
            env.pop(n, None)

    def _run_span(self, span, env, scope, program):
        """A recompute span under non-reentrant torch.utils.checkpoint:
        autograd keeps the span's inputs (its env reads, passed in) and
        outputs only, and runs the span again from them in the backward
        pass, with the same op seeds and device step, so the dropout
        masks and the attention-dropout bits are drawn again bit for
        bit.  No host read: a step with spans is captured like any
        other."""
        from torch.utils.checkpoint import (checkpoint,
                                            set_checkpoint_early_stop)
        reads = [n for n in span.reads if n in env]

        def run(*vals):
            local = dict(zip(reads, vals))
            for st, drop in zip(span.steps, span.drops):
                self._run_pre_step(st, drop, local, scope, program)
            return tuple(local[n] for n in span.outs)

        # the whole span again, as the program's re-emitted ops run it,
        # not only up to the last tensor autograd saved
        with set_checkpoint_early_stop(False):
            outs = checkpoint(run, *[env[n] for n in reads],
                              use_reentrant=False, preserve_rng_state=False)
        for n in span.dropped:
            env.pop(n, None)
        env.update(zip(span.outs, outs))


_UNSET = object()


def _spec(v):
    """(shape, dtype) of a warmup feed spec: a (shape, dtype) pair, or
    an example array, tensor or LoDTensor."""
    v = core.as_array(v)
    if hasattr(v, 'shape') and hasattr(v, 'dtype'):
        return tuple(int(s) for s in v.shape), v.dtype
    shape, dtype = v
    return tuple(int(s) for s in shape), dtype
