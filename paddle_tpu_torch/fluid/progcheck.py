"""fluid.progcheck — static Program verifier + flight-rules lint.

The port's rewrites (GradAllReduce, the comms planner's buckets, AMP,
recompute) change the op-desc graph; without a static check a bad
rewrite surfaces deep inside a lowering or as a wrong number (JAX:
fluid/progcheck.py, whose check families, diagnostic classes, hints,
mutations and reports this module keeps).  Check families, each
emitting structured :class:`Diagnostic` records instead of free-text
raises:

**(a) graph invariants** — op reads of vars declared nowhere
(``undefined_read``), writes to names no block declares
(``undeclared_write``), reads of never-written non-persistable locals
(``read_before_init``), persistables no initializer touches
(``persistable_uninit``), ops whose outputs nothing consumes
(``dead_op``) and vars no op touches (``dead_var``), and control-flow
ops whose ``sub_block`` attr points outside the program or at a block
that is not their child (``torn_subblock``).

**(b) static shape/dtype inference** — the op-desc walk re-derives
every registered op's output specs with ``registry.infer_shapes`` (the
real lowering run on ``meta`` tensors, so the IR cannot drift from the
kernels' plain versions) seeded from feed specs + declared shapes, and
reports the FIRST op whose declared outputs disagree
(``shape_mismatch`` / ``dtype_mismatch``) or whose lowering refuses
(``infer_fail``), by op desc AND the user callstack stamped at
creation.

**(c) sharding legality** — ``check_sharding`` belongs to the mesh
plans of ROADMAP Queue 1 item 13, which the port has not got: it
raises and names the item.

**(d) donation/retrace hazards** — over the plan's segments (the runs
of device ops between host ops, as the JAX package segments a plan):
a segment's state that a later item reads without the segment
republishing it (``use_after_donate``); and op attrs whose hash falls
into the repr fallback with an unstable repr (lambdas, default-repr
objects carrying addresses), which would give every process a
different program fingerprint (``unstable_attr``).

Wiring: ``FLAGS_program_verify`` arms the executor's plan-build hook
(one flag read per plan BUILD; zero per step: plan-cache hits never
come here), and verification is FORCED (invariants + donation,
level='fast') in ``Executor.warmup`` and on the port's rewrites
(``GradAllReduce().transpile``, the comms planner's bucket rewrite).
Diagnostics surface as ``verify/*`` monitor counters, a ``/statusz``
``verify`` section, and — for error-severity classes — a
:class:`ProgramVerifyError` naming the class, the op and the fix,
raised before the program runs.

Fault-injection: the ``progcheck.mutate`` site (fluid.faultinject)
deterministically corrupts an op desc (dangling input, dtype flip,
torn sub-block, ...) so a test proves each defect class is caught by
name in a real executor run.
"""

import threading
import time

from . import monitor
from .flags import get_flag

__all__ = [
    'CLASSES', 'ERROR_CLASSES', 'WARNING_CLASSES', 'MUTATIONS',
    'Diagnostic', 'Report', 'ProgramVerifyError',
    'verify_program', 'verify_plan', 'check_sharding', 'mutate',
    'plan_items',
    'report', 'reset', 'enabled',
]

# ------------------------------------------------------------ diagnostics

# every diagnostic class the verifier can emit; tools/check_progcheck.py
# proves each fires on a seeded defect and check_stat_coverage pins the
# counter family
ERROR_CLASSES = (
    'undefined_read',      # op reads a var no visible block declares
    'undeclared_write',    # op writes a var no visible block declares
    'torn_subblock',       # sub_block attr dangling / not a child block
    'shape_mismatch',      # declared output shape != inferred
    'dtype_mismatch',      # declared output dtype != inferred
    'infer_fail',          # the op's lowering refused to eval_shape
    'shard_unknown_axis',  # PartitionSpec names an axis the mesh lacks
    'shard_indivisible',   # dim not divisible by its axis product
    'shard_conflict',      # axis reused in one spec / two specs per var
    'use_after_donate',    # plan donates a buffer a later item reads
)
WARNING_CLASSES = (
    'read_before_init',    # non-persistable local read before any write
    'persistable_uninit',  # persistable non-param never initialized
    'dead_op',             # op whose outputs nothing consumes
    'dead_var',            # declared var no op reads or writes
    'unstable_attr',       # attr hash falls to an unstable repr
)
CLASSES = ERROR_CLASSES + WARNING_CLASSES

_HINTS = {
    'undefined_read': 'declare the var in this block (or an ancestor) '
                      'with create_var, or fix the rewrite that renamed '
                      'the input',
    'undeclared_write': 'create the output var in the block before '
                        'appending the op (block.create_var)',
    'torn_subblock': 'point sub_block at a block of THIS program whose '
                     'parent_idx chain reaches the op\'s block',
    'shape_mismatch': 'the declared var shape disagrees with what the '
                      'lowering computes — rerun shape inference after '
                      'the rewrite (append_op infers by default) or fix '
                      'the attr that changed the math',
    'dtype_mismatch': 'align the declared var dtype with the lowering '
                      'output (or insert an explicit cast op)',
    'infer_fail': 'the op cannot trace with these input specs — check '
                  'input ranks/dtypes against the lowering',
    'shard_unknown_axis': 'use an axis the mesh defines, or degrade the '
                          'spec with parallel.plan.validate_spec',
    'shard_indivisible': 'pad the dim, pick a smaller axis product, or '
                         'replicate this dim (None in the spec)',
    'shard_conflict': 'give each mesh axis at most one dim per spec and '
                      'each var one spec',
    'use_after_donate': 'republish the var from the donating segment '
                        '(add it to the segment outputs) or copy it '
                        'before the segment writes it',
    'read_before_init': 'feed the var, write it earlier in the program, '
                        'or mark it persistable and initialize it in '
                        'the startup program',
    'persistable_uninit': 'initialize it in the startup program (or '
                          'load it) before the first run',
    'dead_op': 'fetch one of its outputs, mark an output persistable, '
               'or drop the op from the program',
    'dead_var': 'drop the declaration, or wire an op to it',
    'unstable_attr': 'store plain data (str/int/float/list/ndarray) in '
                     'op attrs; object reprs with memory addresses give '
                     'every process a different program fingerprint',
}


class Diagnostic(object):
    """One structured finding: severity, class, where (block/op/var),
    what, and how to fix it — json-able for /statusz and the CLI."""

    __slots__ = ('severity', 'cls', 'block_idx', 'op_index', 'op_type',
                 'var', 'message', 'hint', 'callstack')

    def __init__(self, cls, message, block_idx=None, op_index=None,
                 op_type=None, var=None, callstack=None):
        self.severity = 'error' if cls in ERROR_CLASSES else 'warning'
        self.cls = cls
        self.block_idx = block_idx
        self.op_index = op_index
        self.op_type = op_type
        self.var = var
        self.message = message
        self.hint = _HINTS.get(cls, '')
        self.callstack = list(callstack or [])

    def to_dict(self):
        return {'severity': self.severity, 'class': self.cls,
                'block': self.block_idx, 'op_index': self.op_index,
                'op': self.op_type, 'var': self.var,
                'message': self.message, 'hint': self.hint,
                'callstack': self.callstack}

    def format(self):
        where = []
        if self.block_idx is not None:
            where.append('block %d' % self.block_idx)
        if self.op_index is not None:
            where.append('op #%d' % self.op_index)
        if self.op_type:
            where.append('[%s]' % self.op_type)
        if self.var:
            where.append('var %r' % self.var)
        out = '%s %s: %s — %s' % (self.severity.upper(), self.cls,
                                  ' '.join(where) or 'program',
                                  self.message)
        if self.hint:
            out += '\n    fix: %s' % self.hint
        for fr in self.callstack[:3]:
            out += '\n    at %s' % fr
        return out


class Report(object):
    """One verification's findings over one program."""

    __slots__ = ('label', 'origin', 'diagnostics', 'ops_checked',
                 'shape_checked', 'seconds')

    def __init__(self, label, origin):
        self.label = label
        self.origin = origin
        self.diagnostics = []
        self.ops_checked = 0
        self.shape_checked = 0
        self.seconds = 0.0

    def add(self, diag):
        self.diagnostics.append(diag)

    @property
    def errors(self):
        return [d for d in self.diagnostics if d.severity == 'error']

    @property
    def warnings(self):
        return [d for d in self.diagnostics if d.severity == 'warning']

    def ok(self):
        return not self.errors

    def counts(self):
        out = {}
        for d in self.diagnostics:
            out[d.cls] = out.get(d.cls, 0) + 1
        return out

    def to_dict(self):
        return {'label': self.label, 'origin': self.origin,
                'ok': self.ok(), 'ops_checked': self.ops_checked,
                'shape_checked': self.shape_checked,
                'seconds': self.seconds, 'counts': self.counts(),
                'diagnostics': [d.to_dict()
                                for d in self.diagnostics[:32]]}

    def format(self):
        head = 'progcheck %s (%s): %d op(s), %d error(s), %d warning(s)' \
            % (self.label, self.origin, self.ops_checked,
               len(self.errors), len(self.warnings))
        return '\n'.join([head] + [d.format() for d in self.diagnostics])


class ProgramVerifyError(RuntimeError):
    """An error-severity diagnostic on the pre-trace path.  `.report`
    holds the full :class:`Report`; the message names the first failing
    op, the diagnostic class and the fix hint — the static analog of
    the NaN-provenance FloatingPointError."""

    def __init__(self, rep):
        self.report = rep
        errs = rep.errors
        lines = ['program verification failed (%s, origin=%s): %d '
                 'error(s)' % (rep.label, rep.origin, len(errs))]
        lines.extend(d.format() for d in errs[:8])
        if rep.warnings:
            lines.append('(+%d warning(s) — see /statusz verify)'
                         % len(rep.warnings))
        super(ProgramVerifyError, self).__init__('\n'.join(lines))


# ------------------------------------------------------------- registry

_lock = threading.Lock()
_REPORTS = []          # bounded trail of report dicts (newest last)
_REPORTS_CAP = 32


def enabled():
    return bool(get_flag('FLAGS_program_verify', False))


def _record(rep):
    monitor.add('verify/programs')
    monitor.observe('verify/seconds', rep.seconds)
    if rep.ok() and not rep.warnings:
        monitor.add('verify/clean')
    if rep.errors:
        monitor.add('verify/errors', float(len(rep.errors)))
    if rep.warnings:
        monitor.add('verify/warnings', float(len(rep.warnings)))
    for cls, n in rep.counts().items():
        monitor.add('verify/diagnostics/%s' % cls, float(n))
    with _lock:
        _REPORTS.append(rep.to_dict())
        del _REPORTS[:-_REPORTS_CAP]


def report():
    """The /statusz ``verify`` section: flag state, tallies, and the
    bounded trail of recent verification reports."""
    with _lock:
        trail = list(_REPORTS)
    return {
        'enabled': enabled(),
        'counters': {
            k: monitor.counter_value('verify/' + k)
            for k in ('programs', 'clean', 'errors', 'warnings',
                      'mutations')},
        'by_class': {
            cls: monitor.counter_value('verify/diagnostics/%s' % cls)
            for cls in CLASSES
            if monitor.counter_value('verify/diagnostics/%s' % cls)},
        'reports': trail,
    }


def reset():
    """Drop the report trail (tests)."""
    with _lock:
        del _REPORTS[:]


# --------------------------------------------------------- (a) invariants

# op types interpreted by the executor itself, not the registry walk
_CONTROL_FLOW = ('while', 'conditional_block', 'while_grad',
                 'conditional_block_grad')
# op attrs never part of semantics/fingerprints (compile_cache skips
# them too); the unstable-attr lint must not flag them
_EXEMPT_ATTRS = ('__op_callstack__', '__count_fn__')
# var types that never carry a dense spec
_OPAQUE_VAR_TYPES = ('STEP_SCOPES', 'READER', 'RAW')


def _visible(program, block):
    """Union of var dicts along `block`'s parent chain (guards against
    a torn parent_idx: a cycle or dangling parent stops the walk)."""
    out = {}
    seen = set()
    b = block
    while b is not None and b.idx not in seen:
        seen.add(b.idx)
        for name, v in b.vars.items():
            out.setdefault(name, v)
        p = b.parent_idx
        b = program.blocks[p] if 0 <= p < len(program.blocks) else None
    return out


def _op_callstack(op):
    return op.attrs.get('__op_callstack__') or []


def _side_effect(op):
    """Ops that must never be reported dead: host protocol ops,
    collectives (in-place cross-worker semantics), control flow, and
    ops with no declared outputs at all."""
    from ..ops import registry
    return (op.type in registry.HOST_OPS or
            not registry.is_registered(op.type) or
            op.type in _CONTROL_FLOW or
            op.type.startswith('c_') or
            not op.output_arg_names)


def _check_block_invariants(program, block, rep, feed_set,
                            startup_writes):
    """Graph invariants over one block: undefined/dangling reads,
    undeclared writes, read-before-init, torn sub-blocks.
    `startup_writes` is the name set the paired startup program
    initializes, or None when unknown (persistable_uninit then stays
    silent — the startup contract cannot be checked from one side)."""
    visible = _visible(program, block)
    params = set()
    from .framework import Parameter
    for name, v in visible.items():
        if isinstance(v, Parameter):
            params.add(name)
    from ..ops import registry
    written = set()
    for i, op in enumerate(block.ops):
        rep.ops_checked += 1
        # host ops (save/load/print/py_func/PS pulls) resolve names at
        # RUNTIME through the scope — the v1.6 idiom builds e.g. save
        # programs that name scope-resident vars without declaring
        # them, so block-level declaration is not their contract
        host = op.type in registry.HOST_OPS
        for name in op.input_arg_names:
            v = visible.get(name)
            if v is None:
                if not host:
                    rep.add(Diagnostic(
                        'undefined_read',
                        'input %r of op [%s] is declared in no '
                        'visible block' % (name, op.type),
                        block_idx=block.idx, op_index=i,
                        op_type=op.type, var=name,
                        callstack=_op_callstack(op)))
                continue
            if name in written or name in feed_set or \
                    getattr(v, 'is_data', False) or \
                    v.type in _OPAQUE_VAR_TYPES:
                continue
            if getattr(v, 'persistable', False):
                if startup_writes is not None and \
                        name not in params and \
                        name not in startup_writes and \
                        name not in _writes_anywhere(program):
                    rep.add(Diagnostic(
                        'persistable_uninit',
                        'persistable %r is read but neither this '
                        'program, its startup program, nor a '
                        'parameter initializer writes it' % name,
                        block_idx=block.idx, op_index=i,
                        op_type=op.type, var=name,
                        callstack=_op_callstack(op)))
            elif block.idx == 0:
                # sub-blocks read loop carries bound by the parent —
                # only the global block's order is the execution order
                rep.add(Diagnostic(
                    'read_before_init',
                    '%r is read by op [%s] before any program write '
                    '(not fed, not persistable, not data)'
                    % (name, op.type),
                    block_idx=block.idx, op_index=i, op_type=op.type,
                    var=name, callstack=_op_callstack(op)))
        for name in op.output_arg_names:
            if name not in visible and not host:
                rep.add(Diagnostic(
                    'undeclared_write',
                    'output %r of op [%s] is declared in no visible '
                    'block' % (name, op.type),
                    block_idx=block.idx, op_index=i, op_type=op.type,
                    var=name, callstack=_op_callstack(op)))
            written.add(name)
        sub = op.attrs.get('sub_block')
        if sub is not None:
            ok = isinstance(sub, int) and 0 <= sub < len(program.blocks)
            if ok:
                sb = program.blocks[sub]
                # the sub-block must scope INTO the op's block: its
                # parent chain must reach block.idx (a re-parented or
                # cross-program block is torn even if the index exists)
                chain = set()
                b = sb
                while b is not None and b.idx not in chain:
                    chain.add(b.idx)
                    p = b.parent_idx
                    b = program.blocks[p] \
                        if 0 <= p < len(program.blocks) else None
                ok = block.idx in chain and sb.idx != block.idx
            if not ok:
                rep.add(Diagnostic(
                    'torn_subblock',
                    'op [%s] sub_block=%r does not name a child block '
                    'of block %d (program has %d block(s))'
                    % (op.type, sub, block.idx, len(program.blocks)),
                    block_idx=block.idx, op_index=i, op_type=op.type,
                    callstack=_op_callstack(op)))


_WRITES_MEMO_ATTR = '_progcheck_writes_memo'


def _writes_anywhere(program):
    """Every name written by any op of any block (memoized per program
    version — consulted per persistable read)."""
    memo = getattr(program, _WRITES_MEMO_ATTR, None)
    if memo is not None and memo[0] == program._version:
        return memo[1]
    names = set()
    for b in program.blocks:
        for op in b.ops:
            names.update(op.output_arg_names)
    try:
        setattr(program, _WRITES_MEMO_ATTR, (program._version, names))
    except Exception:
        pass
    return names


def _check_dead(program, rep, feed_set, fetch_set, extra_set):
    """Dead ops/vars over the global block: backward liveness from
    fetches + persistables + extra outputs.  Sub-block ops live with
    their control-flow op (conservative)."""
    block = program.global_block()
    live = set(fetch_set) | set(extra_set)
    dead_ops = []
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        if _side_effect(op):
            live.update(op.input_arg_names)
            if op.attrs.get('sub_block') is not None:
                live.update(_subblock_reads(program, op))
            continue
        outs = op.output_arg_names
        keeps = any(n in live for n in outs)
        if not keeps:
            for n in outs:
                v = block._find_var_recursive(n)
                if v is not None and getattr(v, 'persistable', False):
                    keeps = True
                    break
        if keeps:
            live.update(op.input_arg_names)
            if op.attrs.get('sub_block') is not None:
                live.update(_subblock_reads(program, op))
        else:
            dead_ops.append((i, op))
    for i, op in reversed(dead_ops):
        rep.add(Diagnostic(
            'dead_op',
            'no output of op [%s] (%s) is fetched, persistable, or '
            'read downstream — the run drops its outputs; the op desc '
            'is noise'
            % (op.type, ','.join(op.output_arg_names[:4])),
            block_idx=0, op_index=i, op_type=op.type,
            callstack=_op_callstack(op)))
    touched = set()
    for b in program.blocks:
        for op in b.ops:
            touched.update(op.input_arg_names)
            touched.update(op.output_arg_names)
    for name, v in block.vars.items():
        if name in touched or name in feed_set or name in fetch_set:
            continue
        if getattr(v, 'persistable', False) or \
                getattr(v, 'is_data', False) or \
                v.type in _OPAQUE_VAR_TYPES:
            continue
        rep.add(Diagnostic(
            'dead_var',
            'var %r is declared but no op reads or writes it' % name,
            block_idx=0, var=name))


def _subblock_reads(program, op):
    sub = op.attrs.get('sub_block')
    if not (isinstance(sub, int) and 0 <= sub < len(program.blocks)):
        return ()
    out = set()
    for sop in program.blocks[sub].ops:
        out.update(sop.input_arg_names)
    return out


def _check_unstable_attrs(program, rep):
    """Fingerprint stability: attr values outside the canonical hash
    types fall into compile_cache's repr fallback; a repr carrying a
    memory address (default object/lambda reprs) differs per process."""
    import numpy as np
    stable = (type(None), bool, int, float, str, bytes,
              np.integer, np.floating, np.ndarray)
    for b in program.blocks:
        for i, op in enumerate(b.ops):
            for k, v in op.attrs.items():
                if k in _EXEMPT_ATTRS:
                    continue
                bad = _unstable_value(v, stable)
                if bad is not None:
                    rep.add(Diagnostic(
                        'unstable_attr',
                        'attr %r of op [%s] holds %s — its fingerprint '
                        'hash is the repr fallback and the repr is '
                        'process-unique, so the program fingerprint '
                        'differs in every process'
                        % (k, op.type, bad),
                        block_idx=b.idx, op_index=i, op_type=op.type,
                        callstack=_op_callstack(op)))


def _unstable_value(v, stable):
    """Describe `v` if its hash would be repr-unstable, else None."""
    if isinstance(v, stable):
        return None
    if isinstance(v, (list, tuple)):
        for x in v:
            bad = _unstable_value(x, stable)
            if bad is not None:
                return bad
        return None
    if isinstance(v, dict):
        for x in v.values():
            bad = _unstable_value(x, stable)
            if bad is not None:
                return bad
        return None
    if callable(v):
        return 'a callable (%s)' % type(v).__name__
    r = repr(v)
    if ' at 0x' in r:
        return 'an object with an address-bearing repr (%s)' \
            % type(v).__name__
    return None


# ------------------------------------------------- (b) shape/dtype pass

def _declared_spec(v, feed_specs):
    """(shape tuple, canonical dtype name) for a declared var, or None
    when the declaration carries no usable spec."""
    from . import core
    if v is None or v.type in _OPAQUE_VAR_TYPES:
        return None
    if feed_specs and v.name in feed_specs:
        shape, dtype = feed_specs[v.name]
        return tuple(int(s) for s in shape), core.dtype_name(dtype)
    shape = tuple(getattr(v, 'shape', ()) or ())
    if not shape:
        return None
    return tuple(int(s) for s in shape), core.dtype_name(v.dtype)


def _dims_conflict(declared, inferred):
    """True when two dims are BOTH concrete and different (-1 and
    sentinel products never conflict — feeds refine them)."""
    if len(declared) != len(inferred):
        # rank is structural: a rank change is a conflict even with
        # dynamic dims on one side
        return True
    for d, f in zip(declared, inferred):
        if int(d) > 0 and int(f) > 0 and int(d) != int(f):
            return True
    return False


# sequence/LoD lowerings consume the PADDED (+'@MASK') runtime
# representation, not the declared batch-flattened LoD shape — the
# declared IR spec is the wrong input for a static re-trace, so the
# walk marks their outputs unknown instead of guessing
_LOD_OPS = ('gru', 'lstm', 'lstmp', 'im2sequence', 'linear_chain_crf',
            'crf_decoding')


def _skip_inference(op, visible):
    if op.type.startswith('sequence_') or op.type in _LOD_OPS or \
            (op.type.endswith('_grad') and
             (op.type[:-5].startswith('sequence_') or
              op.type[:-5] in _LOD_OPS)):
        return True
    for n in op.input_arg_names:
        v = visible.get(n)
        if v is not None and getattr(v, 'lod_level', 0):
            return True
    return False


def _program_uses_amp(program):
    """True when any op carries the AMP harmonization attrs: declared
    dtypes then keep the f32 master convention while lowerings run
    bf16/f16, so float-WIDTH disagreements are the design, not a
    defect (kind flips — float vs int — still report)."""
    for b in program.blocks:
        for op in b.ops:
            if '__amp__' in op.attrs or '__amp_gray__' in op.attrs \
                    or '__amp_black__' in op.attrs \
                    or '__amp_black_out__' in op.attrs:
                return True
    return False


def _is_float_name(dtname):
    # bfloat16 registers with numpy as kind 'V', so go by name
    return 'float' in str(dtname)


def _dtype_conflict(declared, inferred, amp):
    if declared == inferred:
        return False
    if amp and _is_float_name(declared) and _is_float_name(inferred):
        return False   # AMP master-f32 declarations, low-width math
    return True


def _check_shapes(program, rep, feed_specs):
    """Static shape/dtype inference over each block: seed the env from
    feed specs + declared shapes, re-infer every registered device op
    through its real lowering, and report the FIRST inconsistency (by
    op desc + creation callstack); downstream disagreements are
    cascades of the first and stay unreported."""
    from . import core
    from ..ops import registry
    amp = _program_uses_amp(program)
    # control-flow loop carries: the executor pins their runtime dtype
    # to the loop-ENTRY dtype, while graph-build inference may have
    # stamped the declaration with the body's promoted dtype (e.g. an
    # int carry incremented by a float step) — the declaration is not
    # the runtime contract there, so carries are exempt from the
    # declared-vs-inferred comparison
    loop_vars = set()
    for b in program.blocks:
        for op in b.ops:
            if op.type in _CONTROL_FLOW:
                loop_vars.update(op.output_arg_names)
    for block in program.blocks:
        visible = _visible(program, block)
        env = {}
        for i, op in enumerate(block.ops):
            if op.type in _CONTROL_FLOW or \
                    op.type in registry.HOST_OPS or \
                    not registry.is_registered(op.type) or \
                    _skip_inference(op, visible):
                for n in op.output_arg_names:
                    env[n] = None   # written, spec unknowable
                continue
            in_specs = {}
            known = True
            for slot, names in op.inputs.items():
                row = []
                for n in names:
                    spec = env.get(n)
                    if spec is None and n in env:
                        known = False
                        break
                    if spec is None:
                        spec = _declared_spec(visible.get(n),
                                              feed_specs)
                    if spec is None:
                        known = False
                        break
                    row.append((spec[0], core.convert_dtype(spec[1])))
                if not known:
                    break
                in_specs[slot] = row
            if not known:
                for n in op.output_arg_names:
                    env[n] = None
                continue
            try:
                out_specs = registry.infer_shapes(op.type, in_specs,
                                                  op.attrs)
            except Exception as e:
                if any(-1 in tuple(spec[0]) for row in
                       in_specs.values() for spec in row):
                    # dynamic-batch inputs infer through a sentinel
                    # size; ops that FACTOR the batch dim (e.g.
                    # temporal_shift's N -> N/seg reshape) cannot
                    # trace it — a sentinel artifact, not a defect
                    for n in op.output_arg_names:
                        env[n] = None
                    continue
                rep.add(Diagnostic(
                    'infer_fail',
                    'op [%s] refused static inference: %s'
                    % (op.type, str(e)[:400]),
                    block_idx=block.idx, op_index=i, op_type=op.type,
                    callstack=_op_callstack(op)))
                return
            rep.shape_checked += 1
            for slot, names in op.outputs.items():
                specs = out_specs.get(slot, [])
                for j, n in enumerate(names):
                    if j >= len(specs):
                        env[n] = None
                        continue
                    shape, dtype = specs[j]
                    dtname = core.dtype_name(dtype)
                    if n in loop_vars:
                        env[n] = (tuple(shape), dtname)
                        continue
                    decl = _declared_spec(visible.get(n), None)
                    if decl is not None:
                        if _dtype_conflict(core.dtype_name(decl[1]),
                                           dtname, amp):
                            rep.add(Diagnostic(
                                'dtype_mismatch',
                                'op [%s] output %r: declared dtype %s, '
                                'lowering computes %s'
                                % (op.type, n, decl[1], dtname),
                                block_idx=block.idx, op_index=i,
                                op_type=op.type, var=n,
                                callstack=_op_callstack(op)))
                            return
                        if _dims_conflict(decl[0], shape):
                            rep.add(Diagnostic(
                                'shape_mismatch',
                                'op [%s] output %r: declared shape %r, '
                                'lowering computes %r'
                                % (op.type, n, tuple(decl[0]),
                                   tuple(shape)),
                                block_idx=block.idx, op_index=i,
                                op_type=op.type, var=n,
                                callstack=_op_callstack(op)))
                            return
                    env[n] = (tuple(shape), dtname)


# ---------------------------------------------- (c) sharding legality

def check_sharding(param_shapes, specs_by_name, axis_sizes,
                   label='plan', origin='sharding', raise_on_error=True,
                   aliases=None):
    """Sharding legality of PartitionSpecs over a mesh (JAX:
    fluid/progcheck.py check_sharding): the port runs data parallel
    only, one process a card; mesh plans are ROADMAP Queue 1 item 13."""
    raise NotImplementedError(
        'progcheck.check_sharding: mesh plans and PartitionSpecs are not '
        'ported (ROADMAP Queue 1 item 13, model parallelism and the '
        'auto-shard planner)')


# ------------------------------------------- (d) plan/donation hazards

class _Segment(object):
    """One run of device ops between host ops of an executor plan, with
    the JAX package's segment dataflow (fluid/executor.py _build_plan):
    `state_names` the names it reads before writing and also writes,
    `input_names` the rest of what it reads first, `output_names` what
    it writes that is persistable, fetched or read later."""

    __slots__ = ('ops', 'state_names', 'input_names', 'output_names')

    def __init__(self, ops):
        self.ops = ops


def plan_items(plan):
    """The executor plan `plan` (fluid/executor.py ``_Plan``) as the JAX
    package's plan items: ``_Segment``s of its device ops, split at each
    host op, which stands as ('host', op).  Built once and kept on the
    plan (``verify_items``), so ``mutate`` can tear it."""
    items = getattr(plan, 'verify_items', None)
    if items is not None:
        return items
    from ..ops import registry
    from .executor import _op_reads
    ops = plan.ops
    items, cur = [], []
    for op in ops:
        od = registry._REGISTRY.get(op.type)
        if od is not None and od.host:
            if cur:
                items.append(_Segment(cur))
                cur = []
            items.append(('host', op))
        else:
            cur.append(op)
    if cur:
        items.append(_Segment(cur))
    block = ops[0].block if ops else None
    keep = set(plan.keep)
    later = [set()] * len(items)
    acc = set()
    for i in range(len(items) - 1, -1, -1):
        later[i] = set(acc)
        it = items[i]
        for op in (it.ops if isinstance(it, _Segment) else [it[1]]):
            acc.update(_op_reads(op))
    for i, it in enumerate(items):
        if not isinstance(it, _Segment):
            continue
        written, first_reads = set(), set()
        for op in it.ops:
            first_reads.update(n for n in _op_reads(op) if n not in written)
            written.update(op.output_arg_names)
        persistable = set(n for n in written if block is not None and
                          getattr(block._find_var_recursive(n),
                                  'persistable', False))
        it.output_names = sorted(written & (persistable | later[i] | keep))
        it.state_names = sorted(first_reads & written)
        it.input_names = sorted(first_reads - written)
    plan.verify_items = items
    return items


def verify_plan(plan, label='plan', origin='plan', raise_on_error=True,
                record=True):
    """Donation legality over an executor plan's segments
    (``plan_items``): a segment's state (read before it writes it) that
    a LATER plan item reads must be republished through the segment's
    outputs, or the later item reads a value the segment no longer
    publishes."""
    t0 = time.perf_counter()
    rep = Report(label, origin)
    items = list(plan_items(plan))
    reads = []
    for it in items:
        if isinstance(it, _Segment):
            reads.append(set(it.state_names) | set(it.input_names))
        else:
            reads.append(set(it[1].input_arg_names))
    for i, it in enumerate(items):
        if not isinstance(it, _Segment):
            continue
        hazard = set(it.state_names) - set(it.output_names)
        if not hazard:
            continue
        for j in range(i + 1, len(items)):
            hit = hazard & reads[j]
            for name in sorted(hit):
                rep.add(Diagnostic(
                    'use_after_donate',
                    'segment %d donates %r without republishing it, '
                    'but plan item %d reads it' % (i, name, j),
                    var=name, op_index=i))
            hazard -= hit
    rep.ops_checked = len(items)
    rep.seconds = time.perf_counter() - t0
    if record:
        _record(rep)
    if raise_on_error and not rep.ok():
        raise ProgramVerifyError(rep)
    return rep


# ------------------------------------------------------------ main entry

def verify_program(program, feed_names=(), fetch_names=(),
                   feed_specs=None, plan=None, label=None,
                   origin='run', level=None, raise_on_error=True,
                   startup_program=None):
    """Run the static pass over `program` and return the Report.

    `level` 'fast' runs the O(ops) invariant + donation + attr checks;
    'full' (the FLAGS_program_verify default) adds the shape/dtype
    inference walk.  `feed_specs` ({name: (shape, dtype)}) seeds the
    inference with concrete boundary shapes (warmup has them).
    `startup_program` enables the persistable_uninit check (one
    program alone cannot see its initializers).  Error-severity
    findings raise ProgramVerifyError unless `raise_on_error` is
    False; warnings only count."""
    t0 = time.perf_counter()
    if level is None:
        level = 'full' if enabled() else 'fast'
    if label is None:
        try:
            from . import memviz
            label = memviz.program_label(program)
        except Exception:
            label = 'program'
    rep = Report(label, origin)
    feed_set = set(feed_names or ())
    fetch_set = set(fetch_names or ())
    extra_set = set(getattr(program, '_extra_output_names', ()) or ())
    startup_writes = None
    if startup_program is not None:
        startup_writes = _writes_anywhere(startup_program)
    for block in program.blocks:
        _check_block_invariants(program, block, rep, feed_set,
                                startup_writes)
    if fetch_set:
        # dead analysis needs to know what the caller observes; with
        # no fetch list every written var is potentially fetched later
        _check_dead(program, rep, feed_set, fetch_set, extra_set)
    _check_unstable_attrs(program, rep)
    if level == 'full' and not rep.errors:
        # an invariant error (dangling read, torn block) makes the
        # inference walk meaningless — report the structural break
        _check_shapes(program, rep, feed_specs)
    if plan is not None:
        prep = verify_plan(plan, label=label, origin=origin,
                           raise_on_error=False, record=False)
        for d in prep.diagnostics:
            rep.add(d)
    rep.seconds = time.perf_counter() - t0
    _record(rep)
    if raise_on_error and not rep.ok():
        raise ProgramVerifyError(rep)
    return rep


# --------------------------------------------------------- fault seeding

# fluid.faultinject 'progcheck.mutate' defect kinds (clause arg), each
# mapped to the diagnostic class it must provoke — the contract
# tools/check_progcheck.py proves in a real executor run
MUTATIONS = {
    1: ('dangling_input', 'undefined_read'),
    2: ('dtype_flip', 'dtype_mismatch'),
    3: ('torn_subblock', 'torn_subblock'),
    4: ('orphan_write', 'undeclared_write'),
    5: ('shape_flip', 'shape_mismatch'),
    6: ('unstable_attr', 'unstable_attr'),
    7: ('dead_op', 'dead_op'),
    8: ('donate_tear', 'use_after_donate'),
}


def mutate(program, kind, plan=None):
    """Deterministically corrupt one op desc (or, kind 'donate_tear',
    the built plan) so the verifier must catch the named defect class.
    `kind` is a ``MUTATIONS`` key (1-8) or a mutation NAME
    ('dtype_flip', ...) — the faultinject clause accepts either
    spelling.  Returns the (mutation name, expected diagnostic class)
    applied, or None when the program has no eligible site.  Counted
    as ``verify/mutations``."""
    from ..ops import registry
    if isinstance(kind, str) and not kind.replace('.', '').isdigit():
        by_name = {n: (n, c) for n, c in MUTATIONS.values()}
        name, cls = by_name.get(kind.strip(), (None, None))
    else:
        name, cls = MUTATIONS.get(int(float(kind)), (None, None))
    if name is None:
        return None
    block = program.global_block()
    # loop carries are exempt from the shape/dtype comparison (their
    # declared dtype is not the runtime contract), so the dtype/shape
    # flips must land on a var the verifier actually checks
    carry_vars = set()
    for b in program.blocks:
        for op in b.ops:
            if op.type in _CONTROL_FLOW:
                carry_vars.update(op.output_arg_names)
    applied = None
    if name == 'dangling_input':
        for op in block.ops:
            for slot, names in op.inputs.items():
                if names:
                    names[0] = '__progcheck_dangling__'
                    applied = (name, cls)
                    break
            if applied:
                break
    elif name == 'dtype_flip':
        for op in block.ops:
            if op.type in _CONTROL_FLOW or \
                    op.type in registry.HOST_OPS:
                continue
            for n in op.output_arg_names:
                v = block.vars.get(n)
                if v is not None and n not in carry_vars and \
                        v.dtype == 'float32':
                    v.dtype = 'int32'
                    applied = (name, cls)
                    break
            if applied:
                break
    elif name == 'torn_subblock':
        for op in block.ops:
            if op.attrs.get('sub_block') is not None:
                op.attrs['sub_block'] = len(program.blocks) + 7
                applied = (name, cls)
                break
    elif name == 'orphan_write':
        for op in block.ops:
            for slot, names in op.outputs.items():
                if names:
                    names[0] = '__progcheck_orphan__'
                    applied = (name, cls)
                    break
            if applied:
                break
    elif name == 'shape_flip':
        for op in block.ops:
            if op.type in _CONTROL_FLOW or \
                    op.type in registry.HOST_OPS:
                continue
            for n in op.output_arg_names:
                v = block.vars.get(n)
                shape = tuple(getattr(v, 'shape', ()) or ())
                if v is not None and n not in carry_vars and \
                        shape and all(int(s) > 0 for s in shape):
                    v.shape = shape[:-1] + (int(shape[-1]) + 1,)
                    applied = (name, cls)
                    break
            if applied:
                break
    elif name == 'unstable_attr':
        for op in block.ops:
            op.attrs['progcheck_unstable'] = object()
            applied = (name, cls)
            break
    elif name == 'dead_op':
        src = None
        for op in block.ops:
            for n in op.output_arg_names:
                v = block.vars.get(n)
                if v is not None and getattr(v, 'shape', ()):
                    src = v
                    break
            if src is not None:
                break
        if src is not None:
            # clone the source spec so the defect is PURE dead code —
            # the shape pass must not trip on a secondary mismatch
            block.create_var(name='__progcheck_dead__',
                             shape=list(src.shape), dtype=src.dtype)
            block.append_op('scale', inputs={'X': src.name},
                            outputs={'Out': '__progcheck_dead__'},
                            attrs={'scale': 1.0}, infer_shape=False)
            applied = (name, cls)
    elif name == 'donate_tear':
        if plan is not None:
            items = plan_items(plan)
            for i, it in enumerate(items):
                if not isinstance(it, _Segment):
                    continue
                later = set()
                for j in range(i + 1, len(items)):
                    jt = items[j]
                    if isinstance(jt, _Segment):
                        later |= set(jt.state_names) | set(
                            jt.input_names)
                    else:
                        later |= set(jt[1].input_arg_names)
                tearable = [n for n in it.output_names
                            if n in it.state_names and n in later]
                if tearable:
                    it.output_names = [n for n in it.output_names
                                       if n != tearable[0]]
                    applied = (name, cls)
                    break
    if applied is not None:
        monitor.add('verify/mutations')
    return applied
