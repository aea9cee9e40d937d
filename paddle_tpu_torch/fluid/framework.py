"""Program IR: Program / Block / Operator / Variable / Parameter.

Reference contract: python/paddle/fluid/framework.py — Program(:3579),
Block(:2153), Operator(:1701), Variable(:802) — backed by the ProgramDesc
protobuf (framework/framework.proto:211).

The program is pure Python data; ``to_dict`` / ``from_dict`` write and
read the same JSON schema as the JAX package, so a ``__model__.json``
saved by either package loads in the other.  Graph-build-time
shape/dtype inference runs each op's lowering on meta tensors
(``ops.registry.infer_shapes``).
"""

import contextlib
import copy
import os
import sys

import numpy as np

from . import core, unique_name
from ..ops import registry


class Variable(object):
    """Reference: python/paddle/fluid/framework.py:802.

    type: 'LOD_TENSOR' | 'SELECTED_ROWS' | 'STEP_SCOPES' | 'READER'
    """

    def __init__(self, block, name=None, shape=None, dtype='float32',
                 lod_level=0, persistable=False, stop_gradient=False,
                 type='LOD_TENSOR', is_data=False, **kwargs):
        self.block = block
        if name is None:
            name = unique_name.generate('_generated_var')
        self.name = name
        self.shape = tuple(shape) if shape is not None else ()
        self.dtype = core.dtype_name(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.type = type
        self.is_data = is_data
        self.op = None  # producing op, set by append_op

    def __repr__(self):
        return "Variable(%s, shape=%s, dtype=%s)" % (
            self.name, self.shape, self.dtype)

    @property
    def grad_name(self):
        return grad_var_name(self.name)

    def astype(self, dtype):
        from .layers import tensor
        return tensor.cast(self, dtype)

    # operators (layers/math_op_patch.py); Variables hash by identity
    def _binary(self, other, op, reverse=False):
        from .layers import math_op_patch
        return math_op_patch.binary(self, other, op, reverse)

    def __add__(self, o):
        return self._binary(o, 'elementwise_add')

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, 'elementwise_sub')

    def __rsub__(self, o):
        return self._binary(o, 'elementwise_sub', reverse=True)

    def __mul__(self, o):
        return self._binary(o, 'elementwise_mul')

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, 'elementwise_div')

    def __rtruediv__(self, o):
        return self._binary(o, 'elementwise_div', reverse=True)

    def __pow__(self, o):
        return self._binary(o, 'elementwise_pow')

    def __neg__(self):
        from .layers import ops
        return ops.scale(self, scale=-1.0)

    def __lt__(self, o):
        return self._binary(o, 'less_than')

    def __le__(self, o):
        return self._binary(o, 'less_equal')

    def __gt__(self, o):
        return self._binary(o, 'greater_than')

    def __ge__(self, o):
        return self._binary(o, 'greater_equal')

    def to_dict(self):
        return dict(name=self.name, shape=list(self.shape), dtype=self.dtype,
                    lod_level=self.lod_level, persistable=self.persistable,
                    stop_gradient=self.stop_gradient, type=self.type,
                    is_data=self.is_data,
                    is_parameter=isinstance(self, Parameter),
                    trainable=getattr(self, 'trainable', False))


class Parameter(Variable):
    """Reference: python/paddle/fluid/framework.py Parameter class."""

    def __init__(self, block, shape, dtype, **kwargs):
        kwargs.setdefault('persistable', True)
        super(Parameter, self).__init__(block, shape=shape, dtype=dtype,
                                        **{k: v for k, v in kwargs.items()
                                           if k not in ('trainable',
                                                        'optimize_attr',
                                                        'regularizer',
                                                        'gradient_clip_attr',
                                                        'do_model_average')})
        self.trainable = kwargs.get('trainable', True)
        self.optimize_attr = kwargs.get('optimize_attr', {'learning_rate': 1.0})
        self.regularizer = kwargs.get('regularizer', None)
        self.gradient_clip_attr = kwargs.get('gradient_clip_attr', None)
        self.do_model_average = kwargs.get('do_model_average', None)


def grad_var_name(name):
    return name + "@GRAD"


def _new_exec_cache():
    """A Program's run-plan cache (fluid/executor.py ``_get_plan``),
    LRU-capped by FLAGS_plan_cache_capacity (0: unbounded), as the JAX
    package's ``_new_exec_cache`` (framework.py:159)."""
    from .compile_cache import LRUCache
    from .flags import get_flag
    return LRUCache(lambda: get_flag('FLAGS_plan_cache_capacity', 64),
                    'executor/plan_cache_evictions')


def _op_is_stochastic(op_type):
    """dropout, or any lowering registered stochastic=True (draws
    randomness without a declared is_test attr) — clone(for_test)
    stamps is_test on these so eval is deterministic."""
    if op_type == 'dropout':
        return True
    od = registry._REGISTRY.get(op_type)
    return bool(od is not None and od.stochastic)


class Operator(object):
    """Reference: python/paddle/fluid/framework.py:1701 + OpDesc
    (framework/framework.proto:173). inputs/outputs map slot -> [var names].
    """

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for v in self.inputs.values() for n in v]

    @property
    def output_arg_names(self):
        return [n for v in self.outputs.values() for n in v]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def __repr__(self):
        return "{%s: (%s) -> (%s)}" % (self.type, self.inputs, self.outputs)

    def to_dict(self):
        return dict(type=self.type, inputs=self.inputs, outputs=self.outputs,
                    attrs={k: _attr_to_jsonable(v)
                           for k, v in self.attrs.items()})


_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _user_callstack(limit=6):
    """User-code frames (outside this package) at op-creation time.
    Reference: framework/op_call_stack.h records the Python stack into
    the op_callstack attr for PADDLE_ENFORCE error reports."""
    frames = []
    f = sys._getframe(2)
    while f is not None and len(frames) < limit:
        fname = f.f_code.co_filename
        if not fname.startswith(_PKG_DIR + os.sep):
            frames.append('%s:%d (%s)' % (fname, f.f_lineno,
                                          f.f_code.co_name))
        f = f.f_back
    return frames


def _attr_to_jsonable(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


class Block(object):
    """Reference: python/paddle/fluid/framework.py:2153."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}     # name -> Variable
        self.ops = []      # [Operator]

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    # -- variables --------------------------------------------------------
    def create_var(self, **kwargs):
        name = kwargs.get('name')
        if name is not None and name in self.vars:
            return self.vars[name]
        v = Variable(self, **kwargs)
        self.vars[v.name] = v
        self.program._bump_version()
        return v

    def create_parameter(self, **kwargs):
        p = Parameter(self, **kwargs)
        self.vars[p.name] = p
        self.program._bump_version()
        return p

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise ValueError("var %s not in block %d" % (name, self.idx))
        return v

    def _find_var_recursive(self, name):
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        return None

    def has_var(self, name):
        return name in self.vars

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # -- ops --------------------------------------------------------------
    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        inputs = _normalize_io(inputs)
        outputs = _normalize_io(outputs)
        attrs = dict(attrs or {})
        if '__op_seed__' not in attrs:
            attrs['__op_seed__'] = self.program._next_op_seed()
        # creation-site stamp (reference: op_callstack attr,
        # framework/op_call_stack.h) so runtime errors point at the
        # user's layer call, not the lowering internals
        if '__op_callstack__' not in attrs:
            attrs['__op_callstack__'] = _user_callstack()
        # role stamp (reference: OpRole attr, framework/op_proto_maker.h):
        # lets clone(for_test=True) prune backward/optimize ops.
        if '__op_role__' not in attrs:
            attrs['__op_role__'] = self.program._current_role
        op = Operator(self, type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.append(op)
        if infer_shape and registry.is_registered(type) \
                and type not in registry.HOST_OPS:
            self._infer_op_shapes(op)
        for names in outputs.values():
            for n in names:
                v = self._find_var_recursive(n)
                if v is not None:
                    v.op = op
        self.program._bump_version()
        return op

    def _prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        return self._insert_op(0, type, inputs, outputs, attrs)

    def _insert_op(self, index, type, inputs=None, outputs=None, attrs=None):
        op = self.append_op(type, inputs, outputs, attrs)
        self.ops.remove(op)
        self.ops.insert(index, op)
        self.program._bump_version()
        return op

    def _remove_op(self, index):
        del self.ops[index]
        self.program._bump_version()

    def _infer_op_shapes(self, op):
        """Set output var shapes/dtypes by running the lowering on meta
        tensors."""
        in_specs = {}
        for slot, names in op.inputs.items():
            row = []
            for n in names:
                v = self._find_var_recursive(n)
                if v is None:
                    raise ValueError(
                        "op %s input %s=%s: variable not found" %
                        (op.type, slot, n))
                if v.op is not None and not registry.is_registered(
                        v.op.type):
                    # produced by an op this port cannot lower yet: its
                    # shape is unknown, so is this op's (the executor
                    # raises NotImplementedError before either runs)
                    return
                row.append((v.shape, v.dtype))
            in_specs[slot] = row
        try:
            out_specs = registry.infer_shapes(op.type, in_specs, op.attrs)
        except Exception as e:
            raise RuntimeError(
                "shape inference failed for op %s (inputs=%s attrs=%s): %s"
                % (op.type, in_specs, {k: v for k, v in op.attrs.items()
                                       if not k.startswith('__')}, e))
        for slot, names in op.outputs.items():
            specs = out_specs.get(slot, [])
            for i, n in enumerate(names):
                v = self._find_var_recursive(n)
                if v is None or i >= len(specs):
                    continue
                shape, dtype = specs[i]
                v.shape = tuple(shape)
                v.dtype = core.dtype_name(dtype)

    def to_dict(self):
        return dict(idx=self.idx, parent_idx=self.parent_idx,
                    vars=[v.to_dict() for v in self.vars.values()],
                    ops=[op.to_dict() for op in self.ops])


def _normalize_io(io):
    out = {}
    for k, v in (io or {}).items():
        if v is None:
            continue
        if isinstance(v, (list, tuple)):
            names = [x.name if isinstance(x, Variable) else x for x in v]
        else:
            names = [v.name if isinstance(v, Variable) else v]
        out[k] = names
    return out


class Program(object):
    """Reference: python/paddle/fluid/framework.py:3579."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0
        self._op_seed_counter = [0]
        self._seed_base = np.random.randint(0, 2 ** 31 - 1)
        self._exec_cache = _new_exec_cache()
        self._current_role = 'forward'
        # a startup program (reference framework.py: program_guard sets
        # it): its random initializers draw from the host generator
        self._is_start_up_program_ = False

    @contextlib.contextmanager
    def _role_guard(self, role):
        """Stamp the ops appended inside with `role` ('backward' /
        'optimize'); clone(for_test=True) prunes them."""
        prev = self._current_role
        self._current_role = role
        try:
            yield
        finally:
            self._current_role = prev

    def _bump_version(self):
        """Every rewrite of the program calls this: the cached run
        plans go with the old version."""
        self._version += 1
        self._exec_cache.clear()

    def _next_op_seed(self):
        self._op_seed_counter[0] += 1
        base = self.random_seed if self.random_seed != 0 else self._seed_base
        return int(base + 1000003 * self._op_seed_counter[0]) % (2 ** 31)

    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def block(self, idx):
        return self.blocks[idx]

    @property
    def num_blocks(self):
        return len(self.blocks)

    def _create_block(self, parent_idx=None):
        """A new block (a while's or a conditional_block's sub-block)
        under the current one, made current."""
        parent_idx = (self.current_block_idx
                      if parent_idx is None else parent_idx)
        b = Block(self, len(self.blocks), parent_idx)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        self._bump_version()
        return b

    def _rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def all_parameters(self):
        out = []
        for b in self.blocks:
            out.extend(b.all_parameters())
        return out

    def list_vars(self):
        for b in self.blocks:
            for v in b.vars.values():
                yield v

    def clone(self, for_test=False):
        """Reference: Program.clone (framework.py:3839). Deep-copies the IR;
        for_test=True flips is_test attrs (dropout/batch_norm eval mode) and
        prunes backward/optimize ops (reference: core.prune_backward +
        _inference_optimize at framework.py:3994-4005), so a cloned eval
        program never mutates parameters or optimizer state."""
        p = Program.__new__(Program)
        p.random_seed = self.random_seed
        p._version = 0
        p._op_seed_counter = list(self._op_seed_counter)
        p._seed_base = self._seed_base
        p._exec_cache = _new_exec_cache()
        p._current_role = 'forward'
        p._is_start_up_program_ = self._is_start_up_program_
        p.current_block_idx = self.current_block_idx
        p.blocks = [Block(p, b.idx, b.parent_idx) for b in self.blocks]
        for b, nb in zip(self.blocks, p.blocks):
            for name, v in b.vars.items():
                d = {k: getattr(v, k) for k in
                     ('name', 'shape', 'dtype', 'lod_level', 'persistable',
                      'stop_gradient', 'type', 'is_data')}
                if isinstance(v, Parameter):
                    nv = Parameter(nb, shape=d.pop('shape'),
                                   dtype=d.pop('dtype'),
                                   trainable=v.trainable,
                                   regularizer=v.regularizer, **d)
                else:
                    nv = Variable(nb, **d)
                nb.vars[name] = nv
            for op in b.ops:
                if for_test and op.attrs.get('__op_role__') in (
                        'backward', 'optimize'):
                    continue
                attrs = copy.deepcopy(op.attrs)
                if for_test and 'is_test' in attrs:
                    attrs['is_test'] = True
                if for_test and _op_is_stochastic(op.type):
                    # stochastic lowerings without a declared is_test
                    # attr: stamp one so eval clones drop the mask
                    attrs['is_test'] = True
                nb.ops.append(Operator(nb, op.type, op.inputs, op.outputs,
                                       attrs))
        return p

    def to_dict(self):
        return dict(version=1, blocks=[b.to_dict() for b in self.blocks],
                    random_seed=self.random_seed)

    @staticmethod
    def from_dict(d):
        p = Program()
        p.random_seed = d.get('random_seed', 0)
        p.blocks = []
        for bd in d['blocks']:
            b = Block(p, bd['idx'], bd['parent_idx'])
            p.blocks.append(b)
        for bd, b in zip(d['blocks'], p.blocks):
            for vd in bd['vars']:
                kw = dict(name=vd['name'], shape=vd['shape'],
                          dtype=vd['dtype'], lod_level=vd.get('lod_level', 0),
                          persistable=vd.get('persistable', False),
                          stop_gradient=vd.get('stop_gradient', False),
                          type=vd.get('type', 'LOD_TENSOR'),
                          is_data=vd.get('is_data', False))
                if vd.get('is_parameter'):
                    kw['trainable'] = vd.get('trainable', True)
                    b.vars[vd['name']] = Parameter(
                        b, shape=kw.pop('shape'), dtype=kw.pop('dtype'), **kw)
                else:
                    b.vars[vd['name']] = Variable(b, **kw)
            for od in bd['ops']:
                b.ops.append(Operator(b, od['type'], od['inputs'],
                                      od['outputs'], od['attrs']))
        return p


# ---------------------------------------------------------------------------
# Default program management
# ---------------------------------------------------------------------------

_main_program_ = Program()
_startup_program_ = Program()
_startup_program_._is_start_up_program_ = True


def default_main_program():
    return _main_program_


def default_startup_program():
    return _startup_program_


def switch_main_program(program):
    global _main_program_
    old = _main_program_
    _main_program_ = program
    return old


def switch_startup_program(program):
    global _startup_program_
    program._is_start_up_program_ = True
    old = _startup_program_
    _startup_program_ = program
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    """Reference: framework.py:4925."""
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)


def cpu_places(device_count=None):
    """[CPUPlace()]: a process runs one replica (JAX: framework.py:602)."""
    return [core.CPUPlace()]


def cuda_places(device_ids=None):
    """CUDAPlaces of `device_ids`, by default this rank's card
    (FLAGS_selected_gpus, which the launcher sets) or, outside the
    launcher, every visible card (reference framework.py cuda_places;
    JAX: :642).  More than one place needs the launcher: one process
    drives one card."""
    if device_ids is None:
        sel = os.environ.get('FLAGS_selected_gpus', '')
        if sel:
            device_ids = [int(c) for c in sel.split(',') if c.strip()]
        else:
            import torch
            device_ids = range(torch.cuda.device_count())
    return [core.CUDAPlace(i) for i in device_ids]


def cuda_pinned_places(device_count=None):
    """Pinned host memory places (reference framework.py
    cuda_pinned_places): one a process, as cpu_places."""
    return [core.CUDAPinnedPlace()]


@contextlib.contextmanager
def name_scope(prefix=None):
    """Reference framework.py name_scope: a naming block for debugging
    tools; it changes no variable or op name, as in the JAX package."""
    yield


def load_op_library(lib_filename):
    """Reference framework.py load_op_library loads a custom C++ op
    library; the port's ops are Python lowerings registered with
    ``ops.registry.register``, so there is nothing to load."""
    import warnings
    warnings.warn('load_op_library loads nothing: register custom ops '
                  'with paddle_tpu_torch.ops.registry.register')


def _version_tuple(v):
    parts = []
    for x in str(v).split('.')[:3]:
        digits = ''
        for ch in x:
            if not ch.isdigit():
                break
            digits += ch
        parts.append(int(digits) if digits else 0)
    return tuple(parts + [0] * (3 - len(parts)))


def require_version(min_version, max_version=None):
    """Raise unless the package's version is within [min_version,
    max_version] (reference framework.py require_version)."""
    from .. import __version__ as ver
    if _version_tuple(ver) < _version_tuple(min_version):
        raise Exception('installed version %s < required %s'
                        % (ver, min_version))
    if max_version is not None and \
            _version_tuple(ver) > _version_tuple(max_version):
        raise Exception('installed version %s > allowed %s'
                        % (ver, max_version))
