"""Model save/load. Reference: python/paddle/fluid/io.py —
save_persistables(:544), load_persistables(:822),
save_inference_model(:1010), load_inference_model(:1214).

The on-disk format is the JAX package's: persistables in one .npz (the
reference's save_combine single-file layout), the inference model as
``__model__.json`` (Program.to_dict) beside ``__model_params__.npz``.
A model either package saved loads in the other unchanged.  An
optimizer accumulator that the sharded optimizer state
(``ReduceStrategy.Reduce``) keeps by rows is saved whole, as the JAX
package's global arrays are: its rows are all-gathered, so every rank
of the data-parallel job calls the save; a load puts the whole value
back, and the next data-parallel step keeps its rows again.  Loaded
values land in the scope as tensors on the loading executor's device,
so a predictor moves its parameters to the device once, at load.
"""

import json
import os

import numpy as np
import torch

from . import core
from . import framework
from .framework import Program
from .parallel_executor import whole_value


def _atomic_write(path, write_fn):
    """One atomic-publish helper for every save this module performs:
    `write_fn(tmp)` produces the bytes at a `<path>.tmp-<pid>` sibling
    (returning the actual file it wrote when the writer renames or
    suffixes, e.g. np.savez appending '.npz'), then ONE ``os.replace``
    publishes, so a kill mid-save never shadows a previously good file
    with a torn one, and a failed write leaves no debris."""
    tmp = path + '.tmp-%d' % os.getpid()
    wrote = None
    try:
        wrote = write_fn(tmp) or tmp
        os.replace(wrote, path)
    finally:
        for t in {tmp, wrote or tmp}:
            if os.path.exists(t):
                os.unlink(t)


def _atomic_savez(path, arrs):
    def write(tmp):
        # np.savez appends .npz to a suffix-less target: report (and
        # on failure, clean) the name it actually wrote
        suffixed = tmp if tmp.endswith('.npz') else tmp + '.npz'
        try:
            np.savez(tmp, **arrs)
        except BaseException:
            if os.path.exists(suffixed):
                os.unlink(suffixed)
            raise
        return suffixed if os.path.exists(suffixed) else tmp
    _atomic_write(path, write)


def _atomic_json_dump(path, doc):
    def write(tmp):
        with open(tmp, 'w') as f:
            json.dump(doc, f)
    _atomic_write(path, write)


def _persistable_vars(program):
    return [v for v in program.list_vars()
            if v.persistable and v.type == 'LOD_TENSOR']


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    main_program = main_program or framework.default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if (predicate is None or predicate(v))]
    scope = core.global_scope()
    os.makedirs(dirname, exist_ok=True)
    arrs = {}
    for v in vars:
        val = scope.find_var(v.name)
        if val is None:
            raise RuntimeError('save: var %s not in scope' % v.name)
        arrs[v.name] = core.to_numpy(whole_value(val))
    _atomic_savez(os.path.join(dirname, (filename or '__model_params__') +
                               '.npz'), arrs)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    main_program = main_program or framework.default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if (predicate is None or predicate(v))]
    npz = os.path.join(dirname, (filename or '__model_params__') + '.npz')
    scope = core.global_scope()
    device = executor.device if executor is not None else None
    with np.load(npz) as data:
        for v in vars:
            if v.name not in data:
                raise RuntimeError('load: var %s missing in checkpoint'
                                   % v.name)
            scope.set_var(v.name,
                          torch.from_numpy(data[v.name]).to(device))


def save_persistables(executor, dirname, main_program=None, filename=None):
    main_program = main_program or framework.default_main_program()
    save_vars(executor, dirname, main_program,
              vars=_persistable_vars(main_program), filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    main_program = main_program or framework.default_main_program()
    load_vars(executor, dirname, main_program,
              vars=_persistable_vars(main_program), filename=filename)


def _prune_for_inference(program, feeded_var_names, target_vars):
    """Backward slice from targets. Reference: framework/prune.h."""
    p = program.clone(for_test=True)
    block = p.global_block()
    needed = set(v.name if isinstance(v, framework.Variable) else v
                 for v in target_vars)
    keep = []
    for op in reversed(block.ops):
        if set(op.output_arg_names) & needed:
            keep.append(op)
            for n in op.input_arg_names:
                needed.add(n)
    block.ops = list(reversed(keep))
    p._bump_version()
    return p


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None,
                         export_for_deployment=True,
                         program_only=False):
    main_program = main_program or framework.default_main_program()
    os.makedirs(dirname, exist_ok=True)
    pruned = _prune_for_inference(main_program, feeded_var_names,
                                  target_vars)
    model = {
        'program': pruned.to_dict(),
        'feed_names': list(feeded_var_names),
        'fetch_names': [v.name if isinstance(v, framework.Variable) else v
                        for v in target_vars],
    }
    model_filename = model_filename or '__model__'
    _atomic_json_dump(os.path.join(dirname, model_filename + '.json'),
                      model)
    if not program_only:
        save_persistables(executor, dirname, main_program,
                          filename=params_filename)
    return model['fetch_names']


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    model_filename = model_filename or '__model__'
    json_path = os.path.join(dirname, model_filename + '.json')
    if not os.path.exists(json_path) and os.path.exists(
            os.path.join(dirname, model_filename)):
        raise NotImplementedError(
            '%s holds a binary reference-fluid __model__ (ProgramDesc '
            'protobuf); this port reads the JSON inference model only'
            % dirname)
    with open(json_path) as f:
        model = json.load(f)
    program = Program.from_dict(model['program'])
    load_persistables(executor, dirname, program, filename=params_filename)
    fetch_vars = [program.global_block().var(n)
                  for n in model['fetch_names']]
    return program, model['feed_names'], fetch_vars
