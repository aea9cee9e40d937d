"""Core runtime objects: places, Scope, dtype conversion, LoDTensor.

Reference framework core:
  - Place        (reference: paddle/fluid/platform/place.h:26-98)
  - Scope        (reference: paddle/fluid/framework/scope.h:46-99)
  - LoDTensor    (reference: paddle/fluid/framework/lod_tensor.h:52-219)

Values in a Scope are torch tensors on the place's device (numpy arrays
and LoDTensors are accepted and moved to the device on first use).
``CUDAPlace`` is a real CUDA device: resolving it without CUDA raises,
it never turns into the CPU quietly.  Only ``CPUPlace`` runs on the CPU.
"""

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Places
# ---------------------------------------------------------------------------


class Place(object):
    """Device tag. Reference: platform/place.h boost::variant of places."""

    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, self.device_id)

    def torch_device(self):
        raise NotImplementedError


class CPUPlace(Place):
    def __init__(self):
        super(CPUPlace, self).__init__(0)

    def torch_device(self):
        return torch.device('cpu')


class CUDAPlace(Place):
    """GPU `device_id` of this process (reference: platform/place.h:79)."""

    def torch_device(self):
        if not torch.cuda.is_available():
            raise RuntimeError(
                '%r: CUDA is not available in this process (torch %s). '
                'Pass fluid.CPUPlace() (or AnalysisConfig.disable_gpu()) '
                'to run on the CPU.' % (self, torch.__version__))
        return torch.device('cuda', self.device_id)


class CUDAPinnedPlace(CPUPlace):
    """Page-locked host memory (reference: platform/place.h:62): tensors
    of this place are CPU tensors; the readers pin what they stage for
    the card."""


# ---------------------------------------------------------------------------
# dtype conversion
# ---------------------------------------------------------------------------

# Reference dtype enum: framework/framework.proto:104 (VarType.Type)
_TORCH_DTYPES = {
    "bool": torch.bool,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}

# Numeric values of VarType.Type for proto-level compat
# (framework/framework.proto:104-131).
VARTYPE_TO_NAME = {
    0: "bool", 1: "int16", 2: "int32", 3: "int64", 4: "float16",
    5: "float32", 6: "float64", 20: "uint8", 21: "int8", 22: "bfloat16",
}


def convert_dtype(dtype):
    """Accept str ('float32'), numpy dtype, torch dtype or VarType int;
    return the torch dtype.  Unlike the JAX package, 64-bit types keep
    their width: int64 ids stay int64."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, int):
        dtype = VARTYPE_TO_NAME[dtype]
    if not isinstance(dtype, str):
        dtype = np.dtype(dtype).name
    return _TORCH_DTYPES[dtype]


def dtype_name(dtype):
    return _DTYPE_NAMES[convert_dtype(dtype)]


# ---------------------------------------------------------------------------
# LoDTensor
# ---------------------------------------------------------------------------


class LoDTensor(object):
    """Dense tensor + level-of-detail offsets for variable-length batches.

    Reference: framework/lod_tensor.h:52 (LoD = vector<Vector<size_t>>).
    The data is a numpy array or a torch tensor; the LoD rides along on
    the host.
    """

    def __init__(self, data, lod=None):
        self.data = data
        self.lod = [list(level) for level in (lod or [])]


# ---------------------------------------------------------------------------
# Scope
# ---------------------------------------------------------------------------


class Scope(object):
    """name -> value map with parent-chain lookup and child scopes.

    Reference: framework/scope.h:46 (Var/FindVar/kids).

    The scope is versioned for the executor's argument binder (JAX:
    fluid/core.py:216-290): ``_struct_version`` counts structural
    changes only, a name appearing in or leaving this scope's own dict;
    overwriting a name (a step's write-back of a parameter) does not
    bump it.  A binder caches which dict along the parent chain holds
    each name and revalidates against ``_chain_token()``, so a steady
    step reads each scope value with one dict read.
    """

    def __init__(self, parent=None):
        self._vars = {}
        self.parent = parent
        self.kids = []
        self._struct_version = 0

    def new_scope(self):
        kid = Scope(self)
        self.kids.append(kid)
        return kid

    def var(self, name):
        if name not in self._vars:
            self._vars[name] = None
            self._struct_version += 1
        return name

    def set_var(self, name, value):
        if name not in self._vars:
            self._struct_version += 1
        self._vars[name] = value

    def find_scope(self, name):
        """The scope along the parent chain that holds `name`, or None."""
        s = self
        while s is not None:
            if name in s._vars:
                return s
            s = s.parent
        return None

    def find_var(self, name):
        s = self.find_scope(name)
        return None if s is None else s._vars[name]

    def has_var(self, name):
        return self.find_var(name) is not None

    def erase(self, name):
        if self._vars.pop(name, _ERASED) is not _ERASED:
            self._struct_version += 1

    def local_var_names(self):
        return list(self._vars.keys())

    def _owner_vars(self, name):
        """The ``_vars`` dict along the parent chain that holds `name`,
        or None; valid while ``_chain_token()`` is unchanged."""
        s = self.find_scope(name)
        return None if s is None else s._vars

    def _chain_token(self):
        """Structural version summed over the parent chain: a cached
        owner dict stays valid while it is unchanged."""
        t = 0
        s = self
        while s is not None:
            t += s._struct_version
            s = s.parent
        return t


_ERASED = object()  # pop sentinel for Scope.erase

_global_scope = Scope()


def global_scope():
    return _global_scope


class _ScopeGuard(object):
    def __init__(self, scope):
        self.scope = scope

    def __enter__(self):
        global _global_scope
        self._old = _global_scope
        _global_scope = self.scope

    def __exit__(self, *a):
        global _global_scope
        _global_scope = self._old


def scope_guard(scope):
    return _ScopeGuard(scope)


def as_array(value):
    """Pull the dense value out of whatever the scope holds."""
    if isinstance(value, LoDTensor):
        return value.data
    return value


def to_numpy(value):
    """Host numpy copy of a scope value (tensor, LoDTensor or array)."""
    value = as_array(value)
    if isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16:
            raise TypeError('numpy has no bfloat16: cast the tensor first')
        value = value.detach()
        if value.device.type == 'cpu':
            # a copy: the executor writes the state in place
            return value.numpy().copy()
        return value.cpu().numpy()
    return np.asarray(value)


def is_compiled_with_cuda():
    """Whether the installed torch was built with CUDA (the JAX
    package's answers False)."""
    return torch.backends.cuda.is_built()
