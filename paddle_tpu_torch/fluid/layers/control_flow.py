"""Control-flow layers: While, while_loop, cond, case, switch_case,
Switch, IfElse, StaticRNN, DynamicRNN, increment and the tensor arrays.

Reference: python/paddle/fluid/layers/control_flow.py over
operators/controlflow/{while,conditional_block}_op.cc (a sub-block run
by a nested Executor).  As in the JAX package's layers/control_flow.py,
a while op's loop state is the set of parent variables its sub-block
writes, and a conditional_block declares its reads (X) and writes
(Out); the executor runs the sub-block (fluid/executor.py
``_lower_while``, ``_lower_conditional_block``).  The programs these
layers build serialize like the JAX package's, op for op.
"""

from ..framework import Variable
from ..layer_helper import LayerHelper
from .io import Print  # noqa: F401  (the host op's layer)


class BlockGuard(object):
    def __init__(self, main_program):
        self.main_program = main_program

    def __enter__(self):
        self.main_program._create_block()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.main_program._rollback()
        return exc_type is None


class WhileGuard(BlockGuard):
    def __init__(self, while_op):
        super(WhileGuard, self).__init__(while_op.helper.main_program)
        self.while_op = while_op

    def __enter__(self):
        self.while_op.status = While.IN_WHILE_BLOCK
        return super(WhileGuard, self).__enter__()

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        self.while_op.status = While.AFTER_WHILE_BLOCK
        self.while_op._complete()
        return super(WhileGuard, self).__exit__(exc_type, exc_val,
                                                exc_tb)


class While(object):
    """Reference: layers/control_flow.py While."""

    BEFORE_WHILE_BLOCK = 0
    IN_WHILE_BLOCK = 1
    AFTER_WHILE_BLOCK = 2

    def __init__(self, cond, is_test=False, name=None,
                 max_trip_count=None):
        """max_trip_count bounds the loop for gradients: a loop that
        carries gradients runs exactly that many masked trips, with no
        host read of the condition (the reference's WhileGradOp replays
        saved step scopes instead, operators/controlflow/while_op.cc),
        so a training step holding it can be replayed from a CUDA
        graph.  WITHOUT a bound the executor auto-buckets: a counting
        pass on the host measures the trip count each step and runs the
        masked loop at the next power of two.  Pass max_trip_count when
        you know the bound to skip the counting pass."""
        self.helper = LayerHelper('while', name=name)
        self.status = While.BEFORE_WHILE_BLOCK
        if not isinstance(cond, Variable):
            raise TypeError('While cond must be a Variable')
        self.cond_var = cond
        self.max_trip_count = max_trip_count

    def block(self):
        return WhileGuard(self)

    def _complete(self):
        main_program = self.helper.main_program
        while_block = main_program.current_block()
        parent_block = main_program.block(while_block.parent_idx)
        # loop state: parent vars written inside the sub-block
        inner_writes = []
        seen = set()
        for op in while_block.ops:
            for n in op.output_arg_names:
                if n in seen:
                    continue
                seen.add(n)
                v = parent_block._find_var_recursive(n)
                if v is not None and not while_block.has_var(n):
                    inner_writes.append(n)
        x_names = sorted(set(
            n for op in while_block.ops for n in op.input_arg_names
            if parent_block._find_var_recursive(n) is not None
            and not while_block.has_var(n)))
        attrs = {'sub_block': while_block.idx, 'is_test': False}
        if self.max_trip_count:
            attrs['max_trip_count'] = int(self.max_trip_count)
        parent_block.append_op(
            'while',
            inputs={'X': x_names, 'Condition': self.cond_var},
            outputs={'Out': inner_writes},
            attrs=attrs,
            infer_shape=False)
        _mark_loop_outputs_differentiable(parent_block, inner_writes)


def _mark_loop_outputs_differentiable(parent_block, out_names):
    """A float var overwritten by a while/conditional_block is loop
    state: its post-op value is computed by the sub-block, so gradients
    must be able to reach the op even when the var's initializer (e.g.
    fill_constant) is marked stop_gradient."""
    for n in out_names:
        v = parent_block._find_var_recursive(n)
        if v is not None and str(v.dtype) in ('float16', 'bfloat16',
                                              'float32', 'float64'):
            v.stop_gradient = False


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper('increment')
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op('increment', inputs={'X': x}, outputs={'Out': out},
                     attrs={'step': float(value)})
    return out


#: default capacity for LoDTensorArray's fixed-length dense rendering
ARRAY_CAPACITY = 64


def create_array(dtype, initialized_list=None):
    """LoDTensorArray analog.  Reference: layers/control_flow.py
    create_array over the growable C++ LoDTensorArray; here, as in the
    JAX package, an array is a FIXED-CAPACITY stacked tensor
    ([capacity, ...element]) materialized at the first array_write
    (which knows the element shape)."""
    helper = LayerHelper('create_array')
    arr = helper.create_variable_for_type_inference(dtype)
    arr._tensor_array = {'materialized': False, 'dtype': dtype}
    if initialized_list:
        for i, v in enumerate(initialized_list):
            from . import tensor as _t
            array_write(v, _t.fill_constant([1], 'int64', i), arr)
    return arr


def _array_len_var(array, helper):
    name = array.name + '@ARRLEN'
    block = helper.main_program.current_block()
    v = block._find_var_recursive(name)
    if v is None:
        v = block.create_var(name=name, shape=(1,), dtype='int64')
        helper.append_op('fill_constant', outputs={'Out': v},
                         attrs={'shape': [1], 'dtype': 'int64',
                                'value': 0.0})
    return v


def array_write(x, i, array=None):
    """Write x at index i (dense rendering: row i of a [capacity, ...]
    stacked tensor; reference operators/controlflow/tensor_array
    ops)."""
    helper = LayerHelper('array_write')
    if array is None:
        array = create_array(x.dtype)
    meta = getattr(array, '_tensor_array', None)
    if meta is not None and not meta['materialized']:
        from . import tensor as _t
        shape = [ARRAY_CAPACITY] + list(x.shape)
        helper.append_op('fill_constant', outputs={'Out': array},
                         attrs={'shape': shape, 'dtype': x.dtype,
                                'value': 0.0})
        array.shape = tuple(shape)
        array.dtype = x.dtype
        meta['materialized'] = True
    helper.append_op('write_to_array',
                     inputs={'X': x, 'I': i, 'Array': array},
                     outputs={'Out': array}, infer_shape=False)
    if meta is not None:
        # static length only when the index is a constant written in
        # the array's own block; loop-body / dynamic-index writes fall
        # back to full capacity at conversion time
        idx_op = getattr(i, 'op', None)
        cur_block = helper.main_program.current_block()
        if idx_op is not None and idx_op.type == 'fill_constant' \
                and cur_block is array.block:
            meta['static_len'] = max(
                meta.get('static_len', 0),
                int(idx_op.attrs.get('value', 0)) + 1)
        else:
            meta['dynamic'] = True
    # track length = max(len, i+1)
    lv = _array_len_var(array, helper)
    from . import tensor as _t
    one = _t.fill_constant([1], 'int64', 1)
    from . import nn as _nn
    ip1 = _nn.elementwise_add(i, one)
    helper.append_op('elementwise_max', inputs={'X': lv, 'Y': ip1},
                     outputs={'Out': lv}, attrs={'axis': -1},
                     infer_shape=False)
    return array


def array_read(array, i):
    helper = LayerHelper('array_read')
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op('read_from_array', inputs={'X': array, 'I': i},
                     outputs={'Out': out}, infer_shape=False)
    if len(getattr(array, 'shape', ())) > 1:
        out.shape = tuple(array.shape[1:])
    return out


def array_length(array):
    helper = LayerHelper('array_length')
    return _array_len_var(array, helper)


def while_loop(cond, body, loop_vars, is_test=False, name=None,
               max_trip_count=None):
    """Functional while (reference layers/control_flow.py while_loop):
    builds a While block; body outputs are assigned back onto the loop
    vars so the executor's loop carries them.  Pass max_trip_count to
    bound a differentiable loop (see While)."""
    from . import tensor as _t
    if not isinstance(loop_vars, (list, tuple)):
        loop_vars = [loop_vars]
    loop_vars = list(loop_vars)
    pre = cond(*loop_vars)
    w = While(pre, is_test=is_test, name=name,
              max_trip_count=max_trip_count)
    with w.block():
        new_vars = body(*loop_vars)
        if not isinstance(new_vars, (list, tuple)):
            new_vars = [new_vars]
        for old, new in zip(loop_vars, new_vars):
            if new is not old:
                _t.assign(new, old)
        _t.assign(cond(*loop_vars), pre)
    return loop_vars


def cond(pred, true_fn=None, false_fn=None, name=None):
    """Two-branch conditional (reference layers/control_flow.py cond).

    Dense rendering: the false branch computes unconditionally to give
    the outputs their shapes/defaults, then a conditional_block
    overwrites them when pred holds (the executor runs its sub-block
    then).  Both branches must be effect-free.
    """
    from . import tensor as _t
    false_out = false_fn() if false_fn is not None else None
    if false_out is None:
        # side-effect-only conditional: run true_fn in the gated block
        cb = ConditionalBlock(pred)
        with cb.block():
            res = true_fn() if true_fn is not None else None
            if res is not None:
                raise ValueError(
                    'cond: true_fn returned outputs but false_fn '
                    'returned none — both branches must match')
        return None
    helper = LayerHelper('cond', name=name)
    single = not isinstance(false_out, (list, tuple))
    outs = [false_out] if single else list(false_out)
    # copy so the conditional assign does not clobber the false values
    outs = [_t.assign(o) for o in outs]
    cb = ConditionalBlock(pred)
    with cb.block():
        true_out = true_fn() if true_fn is not None else None
        true_list = [true_out] if not isinstance(
            true_out, (list, tuple)) else list(true_out)
        for o, t in zip(outs, true_list):
            _t.assign(t, o)
    return outs[0] if single else outs


def case(pred_fn_pairs, default=None, name=None):
    """Reference layers/control_flow.py case: first matching branch
    wins; rendered as a chain of cond()s evaluated innermost-last."""
    pairs = list(pred_fn_pairs)
    if default is None:
        default = pairs[-1][1]
        pairs = pairs[:-1]
    out = default()
    for pred, fn in reversed(pairs):
        out = cond(pred, fn, lambda o=out: o)
    return out


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Reference layers/control_flow.py switch_case."""
    from . import tensor as _t
    from . import nn as _nn
    pairs = []
    if isinstance(branch_fns, dict):
        items = branch_fns.items()
    else:
        items = enumerate(branch_fns)
    from . import ops as _ops
    for idx, fn in items:
        i = _t.fill_constant([1], branch_index.dtype, int(idx))
        pairs.append((_ops.equal(branch_index, i), fn))
    if default is None:
        default = pairs[-1][1]
        pairs = pairs[:-1]
    out = default()
    for pred, fn in reversed(pairs):
        out = cond(pred, fn, lambda o=out: o)
    return out


def is_empty(x, name=None):
    helper = LayerHelper('is_empty', name=name)
    out = helper.create_variable_for_type_inference('bool')
    helper.append_op('is_empty', inputs={'X': x}, outputs={'Out': out},
                     infer_shape=False)
    out.shape = ()
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    helper = LayerHelper('reorder_lod_tensor_by_rank')
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op('reorder_lod_tensor_by_rank',
                     inputs={'X': x, 'RankTable': rank_table},
                     outputs={'Out': out}, infer_shape=False)
    out.shape = x.shape
    return out


class ConditionalBlock(object):
    """Builder for a conditional_block op (reference
    operators/controlflow/conditional_block_op.cc)."""

    def __init__(self, pred, is_scalar_condition=True, name=None):
        self.helper = LayerHelper('conditional_block', name=name)
        self.pred = pred

    def block(self):
        return _CondBlockGuard(self)


class _CondBlockGuard(object):
    def __init__(self, cb):
        self.cb = cb
        self.program = cb.helper.main_program

    def __enter__(self):
        self.sub_block = self.program._create_block()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        self.program._rollback()
        # declare the branch's external reads (X) and parent-var writes
        # (Out) so dataflow analysis and append_backward can see them
        # (the reference discovers them in ConditionalBlockOp::Run; here
        # the program IR carries them explicitly)
        parent = self.program.current_block()
        sub = self.sub_block
        writes, seen = [], set()
        for op in sub.ops:
            for n in op.output_arg_names:
                if n in seen:
                    continue
                seen.add(n)
                if parent._find_var_recursive(n) is not None \
                        and not sub.has_var(n):
                    writes.append(n)
        reads = sorted(set(
            n for op in sub.ops for n in op.input_arg_names
            if parent._find_var_recursive(n) is not None
            and not sub.has_var(n)))
        self.cb.helper.append_op(
            'conditional_block',
            inputs={'Cond': self.cb.pred, 'X': reads},
            outputs={'Out': writes},
            attrs={'sub_block': self.sub_block.idx,
                   'is_scalar_condition': True},
            infer_shape=False)
        _mark_loop_outputs_differentiable(parent, writes)
        return True


class Switch(object):
    """Reference: layers/control_flow.py Switch — piecewise branch
    builder (used by LR schedules).  Each case body runs in a
    conditional_block gated on its predicate AND no earlier case
    having matched."""

    def __init__(self, name=None):
        self.helper = LayerHelper('switch', name=name)
        self._matched = None  # bool var: some earlier case fired
        self._in_default = False

    class _CaseGuard(object):
        def __init__(self, sw, condition):
            from . import ops as _nn
            from . import tensor as _t
            self.sw = sw
            if condition is None:  # default: no earlier match
                if sw._matched is None:  # no cases at all: always run
                    pred = _t.assign(__import__('numpy').array(
                        [True]))
                else:
                    pred = _nn.logical_not(sw._matched)
            elif sw._matched is None:
                pred = condition
                sw._matched = _t.assign(condition)
            else:
                pred = _nn.logical_and(
                    condition, _nn.logical_not(sw._matched))
                _t.assign(_nn.logical_or(sw._matched, condition),
                          sw._matched)
            self.cb = ConditionalBlock(pred)
            self.guard = self.cb.block()

        def __enter__(self):
            return self.guard.__enter__()

        def __exit__(self, *a):
            return self.guard.__exit__(*a)

    def case(self, condition):
        return Switch._CaseGuard(self, condition)

    def default(self):
        return Switch._CaseGuard(self, None)


class StaticRNN(object):
    """Static-length RNN builder.

    Reference: layers/control_flow.py StaticRNN over
    operators/recurrent_op — a sub-block executed once per time step
    with memory variables.

    As in the JAX package, the step block is captured once as a
    template and UNROLLED at build time (T is static).  Memories thread through the clones; step_input
    slices [B, T, ...] per step; step outputs stack to [B, T, ...].
    """

    BEFORE_RNN_BLOCK = 0
    IN_RNN_BLOCK = 1
    AFTER_RNN_BLOCK = 2

    def __init__(self, name=None):
        self.helper = LayerHelper('static_rnn', name=name)
        self.status = StaticRNN.BEFORE_RNN_BLOCK
        self.seq_len = None
        self._inputs = []      # [(x_var, step_var)]
        self._memories = []    # [(init_var, mem_var, updated_var)]
        self._outputs = []     # [step out var]
        self._template_ops = None
        self._block = None
        self._op_start = None
        self._excluded_ops = []

    class _StepGuard(object):
        def __init__(self, rnn):
            self.rnn = rnn

        def __enter__(self):
            rnn = self.rnn
            rnn.status = StaticRNN.IN_RNN_BLOCK
            rnn._block = rnn.helper.main_program.current_block()
            rnn._op_start = len(rnn._block.ops)
            return self

        def __exit__(self, exc_type, exc_val, exc_tb):
            if exc_type is not None:
                return False
            self.rnn._complete()
            self.rnn.status = StaticRNN.AFTER_RNN_BLOCK
            return True

    def step(self):
        return StaticRNN._StepGuard(self)

    def step_input(self, x):
        """x: [B, T, ...] -> per-step [B, ...] (slice at t=0 for the
        template)."""
        if self.seq_len is None:
            self.seq_len = x.shape[1]
        from . import nn as _nn
        start = len(self._block.ops)
        step0 = _nn.slice(x, axes=[1], starts=[0], ends=[1])
        step0 = _nn.squeeze(step0, axes=[1])
        self._excluded_ops.extend(self._block.ops[start:])
        self._inputs.append((x, step0))
        return step0

    def memory(self, init=None, shape=None, batch_ref=None,
               init_value=0.0, dtype='float32'):
        from . import tensor as _t
        if init is None:
            if batch_ref is None:
                raise ValueError('memory needs init or batch_ref')
            start = len(self._block.ops)
            init = _t.fill_constant_batch_size_like(
                batch_ref, [0] + list(shape), dtype, init_value)
            self._excluded_ops.extend(self._block.ops[start:])
        mem = init  # template reads the init; clones read prev update
        self._memories.append([init, mem, None])
        return mem

    def update_memory(self, mem, var):
        for entry in self._memories:
            if entry[1] is mem:
                entry[2] = var
                return
        raise ValueError('update_memory: unknown memory var')

    def step_output(self, o):
        self._outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete(self):
        excluded = set(id(op) for op in self._excluded_ops)
        self._template_ops = [op for op in
                              self._block.ops[self._op_start:]
                              if id(op) not in excluded]

    def __call__(self, *args):
        """Unroll: replay the template for t = 1..T-1 with renamed
        vars, then stack step outputs to [B, T, ...]."""
        import copy
        from .. import unique_name as un
        from . import nn as _nn
        from . import tensor as _t
        block = self._block
        T = self.seq_len
        step_outs = {o.name: [o] for o in self._outputs}
        # memory chain: template used init; later steps use updates
        mem_map = {}
        for init, mem, upd in self._memories:
            if upd is None:
                raise ValueError('memory never updated')
            mem_map[mem.name] = upd.name

        prev_rename = {}
        for init, mem, upd in self._memories:
            prev_rename[mem.name] = upd.name

        template = self._template_ops
        for t in range(1, T):
            rename = {}
            # step inputs: new slice at t
            for x, step0 in self._inputs:
                st = _nn.slice(x, axes=[1], starts=[t], ends=[t + 1])
                st = _nn.squeeze(st, axes=[1])
                rename[step0.name] = st.name
            rename.update(prev_rename)
            new_prev = {}
            for op in template:
                new_inputs = {s: [rename.get(n, n) for n in ns]
                              for s, ns in op.inputs.items()}
                new_outputs = {}
                for s, ns in op.outputs.items():
                    row = []
                    for n in ns:
                        nn_name = un.generate(n + '_t%d' % t)
                        v = block._find_var_recursive(n)
                        nv = block.create_var(
                            name=nn_name,
                            shape=v.shape if v else (),
                            dtype=v.dtype if v else 'float32')
                        nv.stop_gradient = (v.stop_gradient
                                            if v else False)
                        rename[n] = nn_name
                        row.append(nn_name)
                    new_outputs[s] = row
                block.append_op(op.type, inputs=new_inputs,
                                outputs=new_outputs,
                                attrs=copy.deepcopy(op.attrs),
                                infer_shape=False)
            for o in self._outputs:
                step_outs[o.name].append(
                    block._find_var_recursive(rename[o.name]))
            for init, mem, upd in self._memories:
                new_prev[mem.name] = rename.get(upd.name, upd.name)
            prev_rename = new_prev

        results = []
        for o in self._outputs:
            stacked = _nn.stack([v for v in step_outs[o.name]], axis=1)
            results.append(stacked)
        if len(results) == 1:
            return results[0]
        return results


class IfElse(object):
    """Per-example two-branch select (reference layers/control_flow.py
    IfElse splits rows by a [B,1] bool cond, runs each branch on its
    rows, and merges).  Dense rendering: both branches compute on the
    FULL batch and rows merge by where(cond) — identical results for
    pure branches, and no row count depends on the data."""

    OUT_IF_ELSE_BLOCKS = 0
    IN_IF_ELSE_TRUE_BLOCKS = 1
    IN_IF_ELSE_FALSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        self.helper = LayerHelper('ifelse', name=name)
        self.cond = cond
        self.status = IfElse.OUT_IF_ELSE_BLOCKS
        self._true_outs = []
        self._false_outs = []

    class _Guard(object):
        def __init__(self, ie, is_true):
            self.ie = ie
            self.is_true = is_true

        def __enter__(self):
            self.ie.status = (IfElse.IN_IF_ELSE_TRUE_BLOCKS
                              if self.is_true else
                              IfElse.IN_IF_ELSE_FALSE_BLOCKS)
            return self

        def __exit__(self, exc_type, *a):
            self.ie.status = IfElse.OUT_IF_ELSE_BLOCKS
            return exc_type is None

    def true_block(self):
        return IfElse._Guard(self, True)

    def false_block(self):
        return IfElse._Guard(self, False)

    def input(self, x):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError('IfElse.input() must be inside a block')
        return x  # dense rendering: both branches see the full batch

    def output(self, *outs):
        if self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS:
            self._true_outs.extend(outs)
        elif self.status == IfElse.IN_IF_ELSE_FALSE_BLOCKS:
            self._false_outs.extend(outs)
        else:
            raise ValueError('IfElse.output() must be inside a block')

    def __call__(self):
        if len(self._true_outs) != len(self._false_outs):
            raise ValueError(
                'IfElse: true/false blocks produced %d vs %d outputs'
                % (len(self._true_outs), len(self._false_outs)))
        from . import tensor as _t
        from . import nn as _nn
        merged = []
        for t, f in zip(self._true_outs, self._false_outs):
            c = _t.cast(self.cond, t.dtype)
            one = _t.fill_constant([1], t.dtype, 1.0)
            inv = _nn.elementwise_sub(one, c)
            merged.append(_nn.elementwise_add(
                _nn.elementwise_mul(t, c),
                _nn.elementwise_mul(f, inv)))
        return merged


class DynamicRNN(StaticRNN):
    """Reference layers/control_flow.py DynamicRNN over LoD sequences
    (operators/recurrent_op sorted-by-length batches).

    Dense rendering: sequences arrive padded [B, T, ...] and the step
    block unrolls exactly like StaticRNN; positions past each row's
    length carry padding that downstream sequence ops mask out (the
    framework-wide padded+mask convention, ops/sequence_ops.py)."""

    def block(self):
        return self.step()

    def static_input(self, x):
        # non-sequence input visible at every step
        return x
