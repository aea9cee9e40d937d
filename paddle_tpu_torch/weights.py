"""Parameters and optimizer state as numpy arrays in and out of a scope.

``load_numpy_params`` puts {name: ndarray} (for example the JAX
package's startup values, or a checkpoint read with numpy) into a scope
as tensors on a place's device; ``dump_numpy_params`` is its inverse.
Together they start two programs from the same state.  For a training
program that state is every persistable variable its startup program
sets: the parameters, the MLM/NSP heads' included, the learning rate,
the beta powers and the zero moments (``startup_names``); passing the
program makes ``load_numpy_params`` check that each of them is given,
with its declared shape.  ``numpy_state`` reads such a state out of a
scope, the port's or the JAX package's (whose values numpy reads
through the array protocol), so a trained state moves across too: the
image models' parameters, moving means and variances, and momentum
velocities.  An accumulator that the sharded optimizer state keeps by
rows reads whole (its rows all-gathered: every rank of the job calls
``numpy_state`` on it).
"""

import numpy as np
import torch

from .fluid import core, io
from .fluid.parallel_executor import whole_value


def startup_names(startup_program):
    """Names of the persistable variables `startup_program` sets (it
    declares exactly those)."""
    return sorted(v.name for v in io._persistable_vars(startup_program))


def load_numpy_params(scope, params, place, program=None):
    """Set each params[name] in `scope` as a tensor on `place`.  With
    `program` (a startup program), every variable it sets must be in
    `params` with the shape it declares."""
    if program is not None:
        block = program.global_block()
        for name in startup_names(program):
            if name not in params:
                raise KeyError('no value for %r, which the startup program '
                               'sets' % name)
            want = tuple(block._find_var_recursive(name).shape)
            got = tuple(np.shape(params[name]))
            if want != got:
                raise ValueError('%r has shape %s, the program declares %s'
                                 % (name, got, want))
    device = place.torch_device()
    for name, arr in params.items():
        # a copy: the caller's array (possibly read-only) stays its own
        scope.set_var(name, torch.tensor(np.asarray(arr), device=device))


def numpy_state(scope, names):
    """{name: ndarray} of `names` in `scope` or its parents.  The scope
    is this package's (tensors, LoDTensors) or any other whose
    ``find_var`` returns a value numpy can read through ``__array__``
    (the JAX package's arrays and LoDTensors), so no package but numpy
    is needed to take the JAX package's state."""
    out = {}
    for name in names:
        value = scope.find_var(name)
        if value is None:
            raise KeyError('%r is not set in the scope' % name)
        value = core.as_array(whole_value(value))
        out[name] = (core.to_numpy(value)
                     if isinstance(value, torch.Tensor)
                     else np.array(value))
    return out


def dump_numpy_params(scope):
    """{name: ndarray} of the tensors held in `scope` itself (not its
    parents)."""
    return {n: core.to_numpy(scope.find_var(n))
            for n in scope.local_var_names()
            if isinstance(scope.find_var(n), torch.Tensor)}
