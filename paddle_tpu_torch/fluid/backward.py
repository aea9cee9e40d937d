"""append_backward: symbolic reverse-mode autodiff over the Program IR.

Reference: python/paddle/fluid/backward.py:1023 (append_backward), which
asks C++ per-op GradOpDescMakers for hand-written grad ops and inserts
sum ops for gradient aggregation.

As in the JAX package, grad ops are synthesized: for forward op `foo`,
op `foo_grad` takes the same primal inputs plus 'GRAD::<out_slot>'
cotangent slots, and its lowering differentiates foo's lowering
(ops/registry.py grad_op_def, by torch.autograd here).  A var consumed
by N ops gets an explicit `sum` op.  The program this builds serializes
like the JAX package's: the same grad op types, @GRAD names and roles.
By default the executor does not run the grad ops one by one: it takes
one autograd pass over the forward region (executor._wpg_partition).

A while or conditional_block op gets one grad op (while_grad,
conditional_block_grad; ``_control_flow_backward``, the JAX package's
fluid/backward.py:341): the forward op saves the entry values of its
loop state (the Entry slot), and gradients reach those entries and the
values the sub-block only reads (its closure: weights used in the
body).  The executor's whole-program grad differentiates through the
loop as it ran (a bounded, masked loop while it carries gradients);
on the per-op grad path the grad op runs that loop again from the
saved entries under autograd.

With ``checkpoints`` (RecomputeOptimizer) the program is rewritten as
the JAX package rewrites it (``_RecomputePlan``, its
fluid/backward.py:137): where the backward walk enters a span of
forward ops between checkpoints, the span's ops are emitted again
(backward role) behind ``recompute_barrier`` ops and write ``@RC``
twins, which the span's grad ops read.  The per-op grad path runs that
program as written, releasing each forward activation after its last
reader; the whole-program grad runs each span's forward under
``torch.utils.checkpoint`` instead (executor._wpg_partition).
"""

from collections import defaultdict

import numpy as np

from . import framework, unique_name
from .framework import grad_var_name


def _is_float_dtype(dtype):
    return str(dtype) in ('float16', 'bfloat16', 'float32', 'float64')


def _creates_grad(var):
    return _is_float_dtype(var.dtype) and not var.stop_gradient


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Append the backward of `loss` to its program; returns
    [(param, grad_var), ...] for the trainable parameters."""
    program = loss.block.program
    block = program.global_block()
    no_grad_set = set(no_grad_set or [])
    # the whole-program-grad executor must treat these names as
    # constants exactly like this pruning pass does
    program._backward_no_grad_names = set(getattr(
        program, '_backward_no_grad_names', ())) | no_grad_set
    with program._role_guard('backward'):
        return _append_backward_impl(loss, program, block, parameter_list,
                                     no_grad_set, checkpoints)


def _append_backward_impl(loss, program, block, parameter_list,
                          no_grad_set, checkpoints):
    loss_idx = None
    for i in range(len(block.ops) - 1, -1, -1):
        if loss.name in block.ops[i].output_arg_names:
            loss_idx = i
            break
    if loss_idx is None:
        raise ValueError('loss %s is not produced in this program'
                         % loss.name)

    # contributions: var name -> list of grad var names
    contribs = defaultdict(list)

    # seed d(loss) = 1
    loss_grad = block.create_var(
        name=grad_var_name(loss.name), shape=loss.shape, dtype=loss.dtype,
        persistable=False)
    block.append_op(
        'fill_constant', outputs={'Out': loss_grad},
        attrs={'shape': list(loss.shape), 'dtype': loss.dtype,
               'value': 1.0})
    contribs[loss.name].append(loss_grad.name)

    def resolve_grad(name):
        """Collapse accumulated contributions into <name>@GRAD."""
        lst = contribs.get(name)
        if not lst:
            return None
        target = grad_var_name(name)
        if len(lst) == 1:
            return lst[0]
        if not block.has_var(target):
            src = block._find_var_recursive(name)
            tv = block.create_var(name=target,
                                  shape=src.shape if src else (),
                                  dtype=src.dtype if src else 'float32')
            tv.stop_gradient = True
        block.append_op('sum', inputs={'X': list(lst)},
                        outputs={'Out': target}, infer_shape=False)
        contribs[name] = [target]
        return target

    checkpoint_names = set(v.name if isinstance(v, framework.Variable)
                           else v for v in (checkpoints or []))
    recompute = None
    if checkpoint_names:
        recompute = _RecomputePlan(block, block.ops[:loss_idx + 1],
                                   checkpoint_names, loss.name)

    for op in reversed(block.ops[:loss_idx + 1]):
        rename = recompute.activations_for(op) if recompute else {}
        _op_backward(block, op, contribs, resolve_grad, no_grad_set, rename)

    # resolve every accumulated grad and publish the name map so callers
    # can find grads of arbitrary vars
    grad_map = {}
    for name in list(contribs.keys()):
        g = resolve_grad(name)
        if g is not None:
            grad_map[name] = g
    if not hasattr(program, '_grad_name_map'):
        program._grad_name_map = {}
    program._grad_name_map.update(grad_map)

    params_grads = []
    wanted = None
    if parameter_list is not None:
        wanted = set(p.name if isinstance(p, framework.Variable) else p
                     for p in parameter_list)
    for p in block.all_parameters():
        if not p.trainable or p.name in no_grad_set:
            continue
        if wanted is not None and p.name not in wanted:
            continue
        g = resolve_grad(p.name)
        if g is None:
            continue
        params_grads.append((p, block._find_var_recursive(g)))
    return params_grads


RECOMPUTE_SUFFIX = '@RC'
RECOMPUTE_INPUT_SUFFIX = '@RCIN'


class _RecomputePlan(object):
    """Activation checkpointing by program rewrite (the reference's
    _append_backward_ops_with_checkpoints_, backward.py:618; the JAX
    package's fluid/backward.py:137, name for name).

    The forward ops are cut into spans after each op that writes a
    checkpoint (or the loss).  When the backward walk enters a span of
    more than one op, the span's ops are emitted again, reading the
    span's activation inputs through ``recompute_barrier`` ops
    (``<name>@RCIN``) and writing ``<name>@RC`` twins; the span's grad
    ops then read the twins.  Names nobody writes in the forward (feeds,
    parameters) and persistable ones are read as they are."""

    def __init__(self, block, fwd_ops, checkpoint_names, loss_name):
        from ..ops import registry
        self.block = block
        produced = set()
        for op in fwd_ops:
            produced.update(op.output_arg_names)
        self.stable = set()
        for op in fwd_ops:
            for n in op.input_arg_names:
                if n not in produced:
                    self.stable.add(n)
                else:
                    v = block._find_var_recursive(n)
                    if v is not None and getattr(v, 'persistable', False):
                        self.stable.add(n)
        keep = set(checkpoint_names) | {loss_name}
        self.span_of = {}
        self.spans = []
        cur = []
        for op in fwd_ops:
            if op.type in registry.HOST_OPS:
                continue
            cur.append(op)
            self.span_of[id(op)] = len(self.spans)
            if any(n in keep for n in op.output_arg_names):
                self.spans.append(cur)
                cur = []
        if cur:
            self.spans.append(cur)
        self.keep = keep
        self._emitted = {}

    def activations_for(self, op):
        """The rename map of the span holding `op`, its recompute ops
        emitted on first use (the backward walk meets a span's last op
        first, so they land just before the span's grad ops)."""
        s = self.span_of.get(id(op))
        if s is None or len(self.spans[s]) <= 1:
            return {}
        if s in self._emitted:
            return self._emitted[s]
        span_ops = self.spans[s]
        rename = {}
        span_produced = set()
        for f in span_ops:
            span_produced.update(f.output_arg_names)
        for f in span_ops:
            for n in f.input_arg_names:
                if n in rename or n in span_produced or n in self.stable:
                    continue
                self._mk_var(n, n + RECOMPUTE_INPUT_SUFFIX)
                self.block.append_op(
                    'recompute_barrier', inputs={'X': [n]},
                    outputs={'Out': [n + RECOMPUTE_INPUT_SUFFIX]},
                    infer_shape=False)
                rename[n] = n + RECOMPUTE_INPUT_SUFFIX
        # the span again, outputs renamed (a checkpoint's twin is written
        # but read by nobody: the checkpoint itself stays)
        for f in span_ops:
            ins = {slot: [rename.get(n, n) for n in names]
                   for slot, names in f.inputs.items()}
            outs = {}
            for slot, names in f.outputs.items():
                row = []
                for n in names:
                    rc = n + RECOMPUTE_SUFFIX
                    self._mk_var(n, rc)
                    if n not in self.keep:
                        rename[n] = rc
                    row.append(rc)
                outs[slot] = row
            attrs = dict(f.attrs)
            attrs['__op_role__'] = 'backward'
            self.block.append_op(f.type, inputs=ins, outputs=outs,
                                 attrs=attrs, infer_shape=False)
        self._emitted[s] = rename
        return rename

    def _mk_var(self, src_name, new_name):
        if self.block.has_var(new_name):
            return
        v = self.block._find_var_recursive(src_name)
        nv = self.block.create_var(
            name=new_name, shape=v.shape if v is not None else (),
            dtype=v.dtype if v is not None else 'float32')
        nv.stop_gradient = True


def _op_backward(block, op, contribs, resolve_grad, no_grad_set,
                 rename=None):
    rename = rename or {}
    if op.type in ('while', 'conditional_block'):
        # does the loop or branch need a gradient?  Its declared outputs
        # may be empty, so the sub-blocks' writes count too
        out_names = set(op.output_arg_names)

        def _collect(sub_idx, seen):
            if sub_idx is None or sub_idx in seen:
                return
            seen.add(sub_idx)
            for sop in block.program.blocks[sub_idx].ops:
                out_names.update(sop.output_arg_names)
                _collect(sop.attrs.get('sub_block'), seen)

        _collect(op.attrs.get('sub_block'), set())
        if any(contribs.get(n) for n in out_names):
            return _control_flow_backward(block, op, contribs,
                                          resolve_grad, no_grad_set)
        return False
    from ..ops import registry
    if op.type in registry.HOST_OPS:
        return False
    # gather available output grads
    grad_in = {}
    for slot, names in op.outputs.items():
        if not any(contribs.get(n) for n in names):
            continue
        row = []
        for n in names:
            g = resolve_grad(n)
            if g is None:
                # sibling output without grad: a zeros placeholder keeps
                # positional alignment within the slot
                v = block._find_var_recursive(n)
                z = block.create_var(
                    name=unique_name.generate(n + '@ZERO'),
                    shape=v.shape, dtype=v.dtype)
                block.append_op('fill_zeros_like',
                                inputs={'X': rename.get(n, n)},
                                outputs={'Out': z})
                g = z.name
            row.append(g)
        grad_in['GRAD::' + slot] = row
    if not grad_in:
        return False

    # does any input need a gradient?
    if not any(v is not None and _creates_grad(v) and n not in no_grad_set
               for n, v in ((n, block._find_var_recursive(n))
                            for n in op.input_arg_names)):
        return False

    grad_inputs = {slot: [rename.get(n, n) for n in names]
                   for slot, names in op.inputs.items()}
    grad_inputs.update(grad_in)
    grad_outputs = {}
    for slot, names in op.inputs.items():
        row = []
        for n in names:
            v = block._find_var_recursive(n)
            gname = unique_name.generate(grad_var_name(n))
            gv = block.create_var(name=gname,
                                  shape=v.shape if v else (),
                                  dtype=v.dtype if v else 'float32')
            gv.stop_gradient = True
            row.append(gname)
            if v is not None and _creates_grad(v) and n not in no_grad_set:
                contribs[n].append(gname)
        grad_outputs['GRAD::' + slot] = row
    attrs = dict(op.attrs)
    # the grad op inherits the forward op's attrs (incl. __op_seed__, so
    # dropout regenerates the same mask) but NOT its role
    attrs['__op_role__'] = 'backward'
    block.append_op(op.type + '_grad', inputs=grad_inputs,
                    outputs=grad_outputs, attrs=attrs, infer_shape=False)
    return True


def _new_grad_var(block, n, v):
    """A stop_gradient variable unique_name'd after n, shaped like the
    variable v."""
    gv = block.create_var(name=unique_name.generate(n),
                          shape=v.shape if v else (),
                          dtype=v.dtype if v else 'float32')
    gv.stop_gradient = True
    return gv.name


def _control_flow_backward(block, op, contribs, resolve_grad, no_grad_set):
    """Differentiate a while / conditional_block op (the reference's
    WhileGradOp and ConditionalBlockGradOp, operators/controlflow/
    while_op.cc and conditional_block_op.cc, replay saved step scopes).

    The forward op re-declares its loop state (carry) as the Entry slot
    and, marked __needs_grad__, saves the carry's values before it
    there; a while then runs bounded and masked (max_trip_count trips,
    or a power of two its executor counts when unbounded: the
    auto-bucket).  The grad op maps the cotangents of the float
    carries after the op to the gradients of their entries (GRAD::Entry)
    and of the closure reads (GRAD::X): the differentiable inputs the
    sub-block only reads."""
    is_while = op.type == 'while'
    if is_while and int(op.attrs.get('max_trip_count') or 0) <= 0:
        # no bound: the executor counts the trips on the host before the
        # loop and runs it at the next power of two (every op of the
        # group, the forward while and its grad)
        op.attrs['__auto_bucket__'] = True
        op.attrs['__bucket_group__'] = unique_name.generate('while_bucket')
    carry_names = list(op.output('Out'))
    cond_slot = 'Condition' if is_while else 'Cond'
    cond_name = op.input(cond_slot)[0]
    if is_while and cond_name not in carry_names:
        carry_names.append(cond_name)

    float_carries = []
    for n in carry_names:
        v = block._find_var_recursive(n)
        if v is not None and _is_float_dtype(v.dtype):
            float_carries.append(n)

    # the cotangents of the float carries after the op; the producers
    # before the op get the entry gradients appended below instead
    cot_row = []
    for n in float_carries:
        g = resolve_grad(n)
        if g is None:
            v = block._find_var_recursive(n)
            z = block.create_var(name=unique_name.generate(n + '@ZERO'),
                                 shape=v.shape, dtype=v.dtype)
            z.stop_gradient = True
            block.append_op('fill_zeros_like', inputs={'X': n},
                            outputs={'Out': z}, infer_shape=False)
            g = z.name
        cot_row.append(g)
        contribs[n] = []

    # the entry variables, which the forward op's lowering fills with the
    # carry's values before it (__needs_grad__)
    entry_row = [_new_grad_var(block, n + '@CF_ENTRY',
                               block._find_var_recursive(n))
                 for n in carry_names]
    op.attrs['__needs_grad__'] = True
    op.attrs['__carry_names__'] = list(carry_names)
    op.attrs['__entry_names__'] = list(entry_row)
    op.outputs['Entry'] = list(entry_row)

    # closure reads: declared X values the sub-block only reads, the same
    # after the op, so read by name
    closure = []
    for n in op.input('X'):
        if n in carry_names or n in closure:
            continue
        v = block._find_var_recursive(n)
        if v is not None and _creates_grad(v) and n not in no_grad_set:
            closure.append(n)

    entry_grad_row = []
    for n in float_carries:
        v = block._find_var_recursive(n)
        gname = _new_grad_var(block, grad_var_name(n), v)
        entry_grad_row.append(gname)
        if _creates_grad(v) and n not in no_grad_set:
            contribs[n].append(gname)
    closure_grad_row = []
    for n in closure:
        gname = _new_grad_var(block, grad_var_name(n),
                              block._find_var_recursive(n))
        closure_grad_row.append(gname)
        contribs[n].append(gname)

    grad_inputs = {'X': list(op.input('X')), cond_slot: [cond_name],
                   'Entry': list(entry_row), 'GRAD::Out': cot_row}
    attrs = {'sub_block': op.attrs['sub_block'],
             '__carry_names__': list(carry_names),
             '__float_carries__': list(float_carries),
             '__closure_names__': list(closure),
             '__op_role__': 'backward'}
    if is_while:
        if op.attrs.get('__auto_bucket__'):
            attrs['__bucket_group__'] = op.attrs['__bucket_group__']
        else:
            attrs['max_trip_count'] = int(op.attrs['max_trip_count'])
    block.append_op(op.type + '_grad', inputs=grad_inputs,
                    outputs={'GRAD::Entry': entry_grad_row,
                             'GRAD::X': closure_grad_row},
                    attrs=attrs, infer_shape=False)
    return True


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """The gradients of `targets` with respect to `inputs` (reference
    backward.py:1407; the JAX package's fluid/backward.py:463): a
    single one-element target is differentiated as it is; otherwise the
    weighted sum sum_i <target_gradients_i, targets_i> (ones where no
    target gradient is given) through reduce_sum ops.  Returns the
    gradient variable of each input, None where it has none."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if target_gradients is not None and not isinstance(
            target_gradients, (list, tuple)):
        target_gradients = [target_gradients]
    block = targets[0].block
    program = block.program
    if len(targets) == 1 and target_gradients is None and \
            int(np.prod(targets[0].shape or (1,))) == 1:
        loss = targets[0]
    else:
        parts = []
        for i, t in enumerate(targets):
            tg = target_gradients[i] if target_gradients else None
            weighted = t
            if tg is not None:
                weighted = block.create_var(
                    name=unique_name.generate(t.name + '@WEIGHTED'),
                    shape=t.shape, dtype=t.dtype)
                block.append_op('elementwise_mul',
                                inputs={'X': t, 'Y': tg},
                                outputs={'Out': weighted},
                                attrs={'axis': -1})
            s = block.create_var(
                name=unique_name.generate(t.name + '@TSUM'),
                shape=(), dtype=t.dtype)
            block.append_op('reduce_sum', inputs={'X': weighted},
                            outputs={'Out': s},
                            attrs={'dim': None, 'reduce_all': True,
                                   'keep_dim': False},
                            infer_shape=False)
            parts.append(s.name)
        if len(parts) == 1:
            loss = block.vars[parts[0]]
        else:
            total = block.create_var(
                name=unique_name.generate('calc_grad_total'),
                shape=(), dtype=targets[0].dtype)
            block.append_op('sum', inputs={'X': parts},
                            outputs={'Out': total}, infer_shape=False)
            loss = total
    append_backward(loss, no_grad_set=no_grad_set)
    outs = []
    for v in inputs:
        gname = program._grad_name_map.get(v.name)
        outs.append(block._find_var_recursive(gname) if gname else None)
    return outs


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    return calc_gradient(targets, inputs, target_gradients, no_grad_set)
