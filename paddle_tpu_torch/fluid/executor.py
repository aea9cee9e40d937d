"""Executor: an eager interpreter over a Program's global block.
Reference: python/paddle/fluid/executor.py:680.

One run feeds the feed dict, calls each op's lowering in program order
through the registry, writes persistable outputs to the scope and
fetches.  Every tensor it creates has the place's device: ``Executor()``
means ``CUDAPlace(0)`` and raises without CUDA; only an explicit
``CPUPlace()`` runs on the CPU.  Intermediates are released after their
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

A contiguous run of same-hyperparameter adam/adamw/lamb ops runs as one
multi-tensor update (``_fused_opt_run``), which on CUDA updates the
parameters and moments in place.  The step counter advances once per
run, before the ops, as in the JAX executor, so dropout masks keyed on
(op seed, step) line up with the JAX package's.  Segmenting and
compilation of the JAX executor come with later slices.

``FLAGS_check_nan_inf`` checks every floating value a step writes (op
outputs, and the gradients of the whole-program grad) on the device
and raises FloatingPointError naming each non-finite one (JAX:
fluid/executor.py:2578).  ``return_numpy='async'`` returns a
``FetchHandle`` per fetch (JAX: :267).
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
        self.place = place if place is not None else core.CUDAPlace(0)
        self.device = self.place.torch_device()
        self._step = 0
        self._group = None
        # (name, 0-d bool tensor) of the step's values while
        # FLAGS_check_nan_inf is on, else None
        self._verdicts = None

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
        each."""
        program = program or framework.default_main_program()
        scope = scope or core.global_scope()
        feed = feed or {}
        fetch_names = [v.name if isinstance(v, framework.Variable) else v
                       for v in (fetch_list or [])]
        block = program.global_block()
        self._step += 1
        self._group = _program_group(program)
        ops = [op for op in block.ops if op.type not in registry.HOST_OPS]
        env = {name: self._to_device(value) for name, value in feed.items()}
        keep = set(fetch_names)
        self._verdicts = [] if get_flag('FLAGS_check_nan_inf', False) \
            else None
        if any(_role(op) == 'backward' for op in ops):
            plan = _wpg_partition(ops, program, fetch_names)
            if plan is None:
                with torch.no_grad():
                    self._run_ops(ops, env, scope, program, keep)
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
        results = [self._read(n, env, scope) for n in fetch_names]
        if self._verdicts:
            self._raise_non_finite()
        if return_numpy == 'async':
            return [FetchHandle(r) for r in results]
        if return_numpy:
            return [core.to_numpy(r) for r in results]
        return [r.detach() if isinstance(r, torch.Tensor) else r
                for r in results]

    # ------------------------------------------------------------ ops
    def _ctx(self, op, program):
        return registry.LowerCtx(
            self._step, op.attrs.get('__op_seed__', 0), device=self.device,
            random_seed=program.random_seed, group=self._group)

    def _check_finite(self, name, val):
        """Queue the on-device verdict isfinite(val).all() of a floating
        value the step writes (FLAGS_check_nan_inf)."""
        if self._verdicts is not None and isinstance(val, torch.Tensor) \
                and val.is_floating_point():
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
            self._check_finite(n, val)
            var = block._find_var_recursive(n)
            if var is not None and var.persistable:
                scope.set_var(n, val.detach()
                              if isinstance(val, torch.Tensor) else val)
            else:
                env[n] = val

    def _lower_op(self, op, env, scope, program):
        opdef = registry.get(op.type)
        ins = {slot: [self._read(n, env, scope) for n in names]
               for slot, names in op.inputs.items()}
        try:
            outs = opdef.run(self._ctx(op, program), ins, op.attrs)
        except Exception as e:
            e.add_note('in op %s (created at %s)' % (
                op.type, '; '.join(op.attrs.get('__op_callstack__', [])[:2])))
            raise
        for slot, names in op.outputs.items():
            self._write(op.block, names, outs.get(slot, []), env, scope)

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
        for op in run:
            for slot, names in op.outputs.items():
                k = cursor.get(slot, 0)
                self._write(op.block, names,
                            outs.get(slot, [])[k:k + len(names)], env, scope)
                cursor[slot] = k + len(names)

    def _run_ops(self, ops, env, scope, program, keep):
        drops = _drop_plan(ops, keep)
        i = 0
        while i < len(ops):
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
        # the optimizer reads the scope's parameters, not the leaves
        for n in wrt:
            env.pop(n, None)
        env.update(fed)
        env[plan['loss']] = loss.detach()
        for g, p in plan['grads'].items():
            env[g] = by_name[p]
            self._check_finite(g, env[g])
        if plan['seed_grad'] in keep:
            env[plan['seed_grad']] = seed
        with torch.no_grad():
            self._run_ops(post, env, scope, program, keep)
