"""Host-level ops: print, save, load, save_combine, load_combine and
py_func (JAX: ops/host_ops.py:16-110; reference operators/save_op.cc,
load_op.cc, save_combine_op.cc, load_combine_op.cc, print_op.cc,
py_func_op.cc; feed and fetch are in tensor_ops.py).

The executor runs them on the host between its device ops (a plan
holding one is never captured in a CUDA graph), each as
``fn(ctx, op, ins) -> outs``: `ins` are the op's input values as the
executor read them, the outputs go where any op's go (the scope for a
persistable variable, else the step's values).  The files are the JAX
package's, byte for byte: ``save`` writes ``<file_path>.npy``,
``save_combine`` ``<file_path>.npz`` with one member a variable.  The
selected-rows and id-sharding host ops come with the parameter server
(ROADMAP Queue 1 item 14).
"""

import os

import numpy as np
import torch

from ..fluid import core
from .registry import register_host


def _host(value):
    return core.to_numpy(value)


def _device(ctx, arr):
    return torch.as_tensor(np.asarray(arr), device=ctx.device)


@register_host('print', runs=True)
def print_op(ctx, op, ins):
    name = op.input('In')[0]
    val = ins['In'][0]
    print('%s %s %s' % (op.attrs.get('message', ''), name, _host(val)))
    return {'Out': [val]}


def _parent_dir(path):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


@register_host('save', runs=True)
def save(ctx, op, ins):
    path = op.attrs['file_path']
    _parent_dir(path)
    np.save(path + '.npy', _host(ins['X'][0]), allow_pickle=False)
    return {}


@register_host('load', runs=True)
def load(ctx, op, ins):
    return {'Out': [_device(ctx, np.load(op.attrs['file_path'] + '.npy'))]}


@register_host('save_combine', runs=True)
def save_combine(ctx, op, ins):
    path = op.attrs['file_path']
    _parent_dir(path)
    np.savez(path + '.npz', **{name: _host(v) for name, v in
                               zip(op.input('X'), ins['X'])})
    return {}


@register_host('load_combine', runs=True)
def load_combine(ctx, op, ins):
    with np.load(op.attrs['file_path'] + '.npz') as data:
        return {'Out': [_device(ctx, data[name])
                        for name in op.output('Out')]}


_PY_FUNCS = {}


def register_py_func(fid, fn):
    _PY_FUNCS[fid] = fn


@register_host('py_func', runs=True)
def py_func(ctx, op, ins):
    """Host Python escape hatch (reference operators/py_func_op.cc):
    the registered function on numpy inputs, its results back on the
    device."""
    outs = _PY_FUNCS[op.attrs['func_id']](*[_host(v) for v in
                                             ins.get('X', [])])
    if outs is None:
        outs = []
    if not isinstance(outs, (list, tuple)):
        outs = [outs]
    return {'Out': [_device(ctx, v) for v in outs]}
