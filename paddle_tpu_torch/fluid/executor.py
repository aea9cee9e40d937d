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
  autograd;
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
(op seed, step) line up with the JAX package's.  Segmenting and
compilation of the JAX executor come with later slices.

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
outputs, and the gradients of the whole-program grad) on the device
and raises FloatingPointError naming each non-finite one (JAX:
fluid/executor.py:2578).  On an AMP program it checks what the JAX
package checks there, its segments' outputs: the values written to the
scope and the fetches, so an overflow that the loss scaling absorbs
passes and a non-finite fetched loss raises.
``return_numpy='async'`` returns a ``FetchHandle`` per fetch (JAX:
:267).
"""

import numpy as np
import torch
import torch.distributed as dist

from . import core
from . import framework
from .flags import get_flag
from ..ops import registry


def _drop_plan(ops, keep):
    """For each op index, the env names nobody reads after it: values
    are released after their last reader, or right after their writer
    when no op reads them.  Names in `keep` (fetches) stay."""
    last = {}
    for i, op in enumerate(ops):
        for n in op.input_arg_names:
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


def _wpg_partition(ops, program, fetch_names):
    """Whole-program grad (JAX: fluid/executor.py:846): split a training
    step into the forward region, the backward region and the rest, and
    map each gradient a later op or a fetch reads to the variable it
    differentiates.  Returns None where one autograd pass over the
    forward cannot stand in for the backward region: no backward-role
    op, a backward-role op other than the synthesized grad ops, seed
    fills, zero placeholders and aggregation sums, not exactly one
    loss, or a needed gradient of a value the forward region writes
    (an intermediate) or never reads."""
    roles = [_role(op) for op in ops]
    if 'backward' not in roles:
        return None
    first = roles.index('backward')
    pre = ops[:first]
    bwd = [op for op in ops[first:] if _role(op) == 'backward']
    post = [op for op in ops[first:] if _role(op) != 'backward']
    rev = {g: p for p, g in getattr(program, '_grad_name_map', {}).items()}
    seeds = []
    for op in bwd:
        ws = op.output_arg_names
        if op.type.endswith('_grad') or op.type == 'fill_zeros_like':
            continue
        if op.type == 'sum' and ws and all(n in rev for n in ws):
            continue
        if op.type in ('fill_constant', 'fill_any_like') and \
                len(ws) == 1 and ws[0] in rev:
            seeds.append((rev[ws[0]], ws[0],
                          float(op.attrs.get('value', 1.0))))
            continue
        return None
    if len(seeds) != 1:
        return None
    loss, seed_grad, seed_value = seeds[0]
    pre_writes, pre_reads = set(), set()
    for op in pre:
        pre_writes.update(op.output_arg_names)
        pre_reads.update(op.input_arg_names)
    if loss not in pre_writes:
        return None
    bwd_writes = set(n for op in bwd for n in op.output_arg_names)
    later_reads = set(n for op in post for n in op.input_arg_names)
    grads = {}
    for g in sorted(bwd_writes & (later_reads | set(fetch_names))):
        if g == seed_grad:
            continue
        p = rev.get(g)
        if p is None or p in pre_writes or p not in pre_reads:
            return None
        grads[g] = p
    # variables append_backward treated as constants: cut from the
    # autograd graph where the forward writes them
    block = ops[0].block
    no_grad = set(getattr(program, '_backward_no_grad_names', ()))
    stop = set()
    for op in pre:
        for n in op.output_arg_names:
            v = block._find_var_recursive(n)
            if n in no_grad or (n != loss and v is not None and
                                v.stop_gradient):
                stop.add(n)
    return {'pre': pre, 'post': post, 'loss': loss, 'seed_grad': seed_grad,
            'seed_value': seed_value, 'grads': grads, 'stop': stop}


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

    def _to_device(self, value):
        value = core.as_array(value)
        if isinstance(value, torch.Tensor):
            return value.to(self.device)
        return torch.as_tensor(np.asarray(value), device=self.device)

    def _read(self, name, env, scope):
        if name in env:
            return env[name]
        owner = scope.find_scope(name)
        value = None if owner is None else owner.find_var(name)
        if value is None:
            raise RuntimeError(
                'variable %r is read before it is set: feed it or run the '
                'startup program first' % name)
        if isinstance(value, torch.Tensor) and value.device == self.device:
            return value
        # a host value (loaded params, numpy) moves to the device once:
        # the device copy replaces it in the scope that owns it
        value = self._to_device(value)
        owner.set_var(name, value)
        return value

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """Run the program's global block once.  return_numpy=False
        returns the fetched device tensors, 'async' a FetchHandle for
        each.  A CompiledProgram runs data parallel
        (fluid/parallel_executor.py)."""
        from .compiler import CompiledProgram
        if isinstance(program, CompiledProgram):
            from .parallel_executor import run_parallel
            return run_parallel(self, program, feed, fetch_list, scope,
                                return_numpy)
        program = program or framework.default_main_program()
        results = self._run_program(program, feed or {},
                                    _fetch_names(fetch_list),
                                    scope or core.global_scope())
        return self._return(results, return_numpy)

    @staticmethod
    def _return(results, return_numpy):
        if return_numpy == 'async':
            return [FetchHandle(r) for r in results]
        if return_numpy:
            return [core.to_numpy(r) for r in results]
        return [r.detach() if isinstance(r, torch.Tensor) else r
                for r in results]

    def _run_program(self, program, feed, fetch_names, scope, replica=None,
                     shard_opt=False, batch_feeds=()):
        """One step of `program`: the fetched values on the device.  With
        a `replica` the step is that data-parallel replica's (see the
        module docstring), fed its rows of `batch_feeds`, its optimizer
        state sharded by rows with `shard_opt`."""
        block = program.global_block()
        self._step += 1
        data_parallel = replica is not None and replica.world > 1
        self._replica = replica
        self._batch_feeds = frozenset(batch_feeds)
        self._shard_opt = bool(shard_opt and data_parallel)
        self._group = None if replica is not None else \
            _program_group(program)
        self._averaged = set()
        self._row_updates = []
        ops = [op for op in block.ops if op.type not in registry.HOST_OPS]
        env = {name: self._to_device(value) for name, value in feed.items()}
        keep = set(fetch_names)
        self._verdicts = [] if get_flag('FLAGS_check_nan_inf', False) \
            else None
        self._checked_only = keep if any(
            op.type == 'check_finite_and_unscale' for op in ops) else None
        if any(_role(op) == 'backward' for op in ops):
            plan = _wpg_partition(ops, program, fetch_names)
            if plan is None:
                hook = None
                if data_parallel:
                    k, names = _post_grads(ops, fetch_names)
                    var_of = {g: p for p, g in
                              getattr(program, '_grad_name_map', {}).items()}
                    hook = (k, lambda env: env.update(self._global_grads(
                        {n: env[n] for n in names
                         if isinstance(env.get(n), torch.Tensor)}, var_of)))
                with torch.no_grad():
                    self._run_ops(ops, env, scope, program, keep, hook)
            else:
                self._run_whole_program_grad(plan, env, scope, program,
                                             keep)
        else:
            writes_state = any(
                v is not None and v.persistable
                for op in ops for v in map(block._find_var_recursive,
                                           op.output_arg_names))
            mode = torch.no_grad() if writes_state else \
                torch.inference_mode()
            with mode:
                self._run_ops(ops, env, scope, program, keep)
        if self._row_updates:
            from .parallel_executor import gather_rows
            gather_rows(self._row_updates, scope, replica)
            self._row_updates = []
        results = [self._read(n, env, scope) for n in fetch_names]
        if self._verdicts:
            self._raise_non_finite()
        return results

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

    # ------------------------------------------------------------ ops
    def _ctx(self, op, program):
        return registry.LowerCtx(
            self._step, op.attrs.get('__op_seed__', 0), device=self.device,
            random_seed=program.random_seed, group=self._group,
            replica=self._replica)

    def _check_finite(self, name, val, persistable=False):
        """Queue the on-device verdict isfinite(val).all() of a floating
        value the step writes (FLAGS_check_nan_inf); on an AMP program
        only of a persistable or fetched one."""
        if self._verdicts is None or not isinstance(val, torch.Tensor) \
                or not val.is_floating_point():
            return
        if self._checked_only is not None and not persistable and \
                name not in self._checked_only:
            return
        self._verdicts.append((name, torch.isfinite(val.detach()).all()))

    def _raise_non_finite(self):
        """Reference CheckVarHasNanOrInf (framework/details/
        nan_inf_utils.h:28), per value written: every verdict of the
        step crosses to the host in one copy, and the error names every
        non-finite variable, not just the first."""
        ok = torch.stack([v for _, v in self._verdicts]).cpu().tolist()
        bad = []
        for (name, _), good in zip(self._verdicts, ok):
            if not good and name not in bad:
                bad.append(name)
        self._verdicts = None
        if bad:
            raise FloatingPointError(
                'nan/inf detected in %d var(s) [%s] (step %d)'
                % (len(bad), ', '.join(bad), self._step))

    def _write(self, block, names, vals, env, scope):
        for n, val in zip(names, vals):
            var = block._find_var_recursive(n)
            persistable = var is not None and var.persistable
            self._check_finite(n, val, persistable)
            if persistable:
                scope.set_var(n, val.detach()
                              if isinstance(val, torch.Tensor) else val)
            else:
                env[n] = val

    def _lower_op(self, op, env, scope, program):
        opdef = registry.get(op.type)
        ins = {slot: [self._read(n, env, scope) for n in names]
               for slot, names in op.inputs.items()}
        rows = self._shard_rows(op, ins, 0, scope) if self._shard_opt \
            else None
        try:
            outs = opdef.run(self._ctx(op, program), ins, op.attrs)
        except Exception as e:
            e.add_note('in op %s (created at %s)' % (
                op.type, '; '.join(op.attrs.get('__op_callstack__', [])[:2])))
            raise
        self._write_op(op, outs, {}, rows, env, scope)

    def _write_op(self, op, outs, cursor, rows, env, scope):
        """Write op's outputs, taken from each output slot of `outs` at
        the slot's `cursor` position (advanced past them).  With `rows`
        (the sharded optimizer state) the accumulators are this rank's
        rows and the parameter's updated rows wait for the all-gather."""
        for slot, names in op.outputs.items():
            k = cursor.get(slot, 0)
            cursor[slot] = k + len(names)
            vals = outs.get(slot, [])[k:k + len(names)]
            if rows is not None and slot == 'ParamOut':
                self._row_updates.append((names[0], rows, vals[0]))
                continue
            self._write(op.block, names, vals, env, scope)
            if rows is not None and slot[:-3] in \
                    _ROW_ACCUMULATORS[op.type]:
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
                scope.set_var(op.input(slot)[0], acc)
            ins[slot][k] = acc
        return a, b

    def _lower_fused_run(self, run, env, scope, program):
        """One fused_<type> op for a grouped optimizer run: each input
        slot carries the run's tensors in run order, and the outputs
        go back to each member op's outputs.  A run holding a tensor
        the kernel does not take (not f32) runs op by op instead."""
        ins = {}
        for op in run:
            for slot, names in op.inputs.items():
                ins.setdefault(slot, []).extend(
                    self._read(n, env, scope) for n in names)
        if not all(x.dtype == torch.float32 for slot in
                   ('Param', 'Moment1', 'Moment2') for x in ins[slot]) or \
                not all(x.is_floating_point() for x in ins['Grad']):
            for op in run:
                self._lower_op(op, env, scope, program)
            return
        rows = [self._shard_rows(op, ins, k, scope) if self._shard_opt
                else None for k, op in enumerate(run)]
        fused = _FUSABLE_OPT[run[0].type]
        try:
            outs = registry.get(fused).run(self._ctx(run[0], program), ins,
                                           dict(run[0].attrs))
        except Exception as e:
            e.add_note('in a fused run of %d %s ops (%s)' % (
                len(run), run[0].type,
                ', '.join(op.outputs.get('ParamOut', ['?'])[0]
                          for op in run)))
            raise
        cursor = {}
        for op, r in zip(run, rows):
            self._write_op(op, outs, cursor, r, env, scope)

    def _run_ops(self, ops, env, scope, program, keep, hook=None):
        """Run `ops` in order; `hook` = (k, fn) calls fn(env) before
        ops[k]."""
        drops = _drop_plan(ops, keep)
        i = 0
        while i < len(ops):
            if hook is not None and i == hook[0]:
                hook, fn = None, hook[1]
                fn(env)
            run = _fused_opt_run(ops, i)
            if run is not None:
                self._lower_fused_run(run, env, scope, program)
            else:
                run = [ops[i]]
                self._lower_op(ops[i], env, scope, program)
            for j in range(i, i + len(run)):
                for n in drops[j]:
                    env.pop(n, None)
            i += len(run)
        if hook is not None:
            hook[1](env)

    def _run_whole_program_grad(self, plan, env, scope, program, keep):
        """The forward region with autograd recording, one autograd pass
        from the loss to every variable whose gradient is read, then the
        remaining (optimizer) ops without it."""
        pre, post = plan['pre'], plan['post']
        wrt = sorted(set(plan['grads'].values()))
        fed = {n: env[n] for n in wrt if n in env}
        later = set(n for op in post for n in op.input_arg_names)
        drops = _drop_plan(pre, keep | later | {plan['loss']})
        with torch.enable_grad():
            leaves = []
            for n in wrt:
                leaf = self._read(n, env, scope).detach().requires_grad_()
                leaves.append(leaf)
                env[n] = leaf
            for op, drop in zip(pre, drops):
                self._lower_op(op, env, scope, program)
                for n in op.output_arg_names:
                    if n in plan['stop'] and n in env:
                        env[n] = env[n].detach()
                for n in drop:
                    env.pop(n, None)
            loss = env[plan['loss']]
            seed = torch.full_like(loss, plan['seed_value'])
            if loss.requires_grad and leaves:
                grads = torch.autograd.grad([loss], leaves, [seed],
                                            allow_unused=True)
            else:
                grads = [None] * len(leaves)
        by_name = {n: (torch.zeros_like(x).detach() if g is None else g)
                   for n, x, g in zip(wrt, leaves, grads)}
        del leaves, grads
        grads = {g: by_name[p] for g, p in plan['grads'].items()}
        if self._replica is not None and self._replica.world > 1:
            # CoeffNumDevice: the gradients of the global loss
            grads = self._global_grads(grads, plan['grads'])
        # the optimizer reads the scope's parameters, not the leaves
        for n in wrt:
            env.pop(n, None)
        env.update(fed)
        env[plan['loss']] = loss.detach()
        for g, v in grads.items():
            env[g] = v
            self._check_finite(g, v)
        if plan['seed_grad'] in keep:
            env[plan['seed_grad']] = seed
        with torch.no_grad():
            self._run_ops(post, env, scope, program, keep)
