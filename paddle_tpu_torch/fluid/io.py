"""Model save/load. Reference: python/paddle/fluid/io.py —
save_persistables(:544), load_persistables(:822),
save_inference_model(:1010), load_inference_model(:1214); JAX:
fluid/io.py.

The default on-disk format is the JAX package's: persistables in one
.npz (the reference's save_combine single-file layout), the inference
model as ``__model__.json`` (Program.to_dict) beside
``__model_params__.npz``.  A model either package saved loads in the
other unchanged.  ``save_format='paddle'`` writes the reference's
binary LoDTensor files instead (one file a variable, or one combined
``filename``; fluid/paddle_format.py), and a directory written by
reference fluid loads as it is: its variables by sniffing the
LoDTensor header, its binary ``__model__`` ProgramDesc through the
protobuf parser.  An optimizer accumulator that the sharded optimizer
state (``ReduceStrategy.Reduce``) keeps by rows is saved whole, as the
JAX package's global arrays are: its rows are all-gathered, so every
rank of the data-parallel job calls the save; a load puts the whole
value back, and the next data-parallel step keeps its rows again.

A loaded value is written into the tensor the scope already holds
when shape and dtype match (as ``Executor._write_state`` writes a
step's state), so a load between steps keeps every CUDA graph that
reads the variable (fluid/cuda_graph.py checks the tensors' identity);
otherwise it lands in the scope as a new tensor on the loading
executor's device, so a predictor moves its parameters to the device
once, at load.
"""

import json
import os

import numpy as np
import torch

from . import core
from . import framework
from . import paddle_format
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


def is_persistable(var):
    return var.persistable


def _scope_arrays(scope, vars):
    out = []
    for v in vars:
        val = scope.find_var(v.name)
        if val is None:
            raise RuntimeError('save: var %s not in scope' % v.name)
        out.append((v.name, core.to_numpy(whole_value(val))))
    return out


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, save_format='native'):
    """save_format='native': one .npz (the default everywhere).
    save_format='paddle': the reference's binary LoDTensor layout, one
    file a variable named after it (save_op.cc), or every stream
    concatenated into `filename` (save_combine_op.h), so a model
    trained here loads in reference fluid unchanged."""
    main_program = main_program or framework.default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if (predicate is None or predicate(v))]
    if save_format not in ('native', 'paddle'):
        raise ValueError("save_format must be 'native' or 'paddle'")
    os.makedirs(dirname, exist_ok=True)
    arrs = _scope_arrays(core.global_scope(), vars)
    if save_format == 'paddle':
        def tensors(path, records):
            _atomic_write(path, lambda tmp: paddle_format.save_tensors(
                tmp, records))
        if filename is not None:
            tensors(os.path.join(dirname, filename), arrs)
        else:
            for name, arr in arrs:
                tensors(os.path.join(dirname, name), [(name, arr)])
        return
    _atomic_savez(os.path.join(dirname, (filename or '__model_params__') +
                               '.npz'), dict(arrs))


def _put(scope, name, arr, device):
    """Write a loaded array into the tensor `scope` holds for `name` in
    place where shape and dtype match (the CUDA graphs that read it stay
    valid), else set a new tensor on `device`."""
    value = torch.from_numpy(np.ascontiguousarray(arr))
    cur = scope.find_var(name)
    if isinstance(cur, torch.Tensor) and cur.shape == value.shape and \
            cur.dtype == value.dtype and not cur.is_inference() and \
            getattr(cur, '_pt_row_shard', None) is None:
        cur.copy_(value)
        return
    scope.set_var(name, value.to(device))


def _load_vars_paddle_format(dirname, vars, filename, device):
    """Reference-format files: per-var LoDTensor files (save_op.cc) or
    one combined stream (save_combine_op.h, records in the SAME var
    order the saver iterated: the program's var order, which both sides
    derive from the same program)."""
    scope = core.global_scope()
    if filename is not None and os.path.exists(
            os.path.join(dirname, filename)):
        records = paddle_format.load_tensors(os.path.join(dirname,
                                                          filename))
        if len(records) != len(vars):
            raise RuntimeError(
                'combined params file %s holds %d tensors, program '
                'expects %d' % (filename, len(records), len(vars)))
        for v, (arr, _lod) in zip(vars, records):
            # positional pairing is the save_combine contract; a shape
            # check catches order mismatches before they become
            # silently swapped weights
            want = tuple(int(d) for d in (v.shape or ()))
            if want and -1 not in want and tuple(arr.shape) != want:
                raise RuntimeError(
                    'combined params order mismatch: record for %r has '
                    'shape %s, program declares %s'
                    % (v.name, tuple(arr.shape), want))
            _put(scope, v.name, arr, device)
        return
    for v in vars:
        path = os.path.join(dirname, v.name)
        if not os.path.exists(path):
            raise RuntimeError('load: var %s missing in checkpoint dir '
                               '%s' % (v.name, dirname))
        (arr, _lod), = paddle_format.load_tensors(path, count=1)
        _put(scope, v.name, arr, device)


def _dir_is_paddle_format(dirname, vars, filename):
    if filename is not None:
        p = os.path.join(dirname, filename)
        if os.path.exists(p) and not p.endswith('.npz'):
            return paddle_format.looks_like_lod_tensor_file(p)
    for v in vars[:3]:
        p = os.path.join(dirname, v.name)
        if os.path.exists(p) and \
                paddle_format.looks_like_lod_tensor_file(p):
            return True
    return False


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    main_program = main_program or framework.default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if (predicate is None or predicate(v))]
    device = executor.device if executor is not None else None
    npz = os.path.join(dirname, (filename or '__model_params__') + '.npz')
    if not os.path.exists(npz) and _dir_is_paddle_format(
            dirname, vars, filename):
        # a directory written by reference fluid (or save_format
        # 'paddle'): binary LoDTensor files
        _load_vars_paddle_format(dirname, vars, filename, device)
        return
    scope = core.global_scope()
    with np.load(npz) as data:
        for v in vars:
            if v.name not in data:
                raise RuntimeError('load: var %s missing in checkpoint'
                                   % v.name)
            _put(scope, v.name, data[v.name], device)


def save_params(executor, dirname, main_program=None, filename=None,
                save_format='native'):
    main_program = main_program or framework.default_main_program()
    save_vars(executor, dirname, main_program,
              vars=main_program.all_parameters(), filename=filename,
              save_format=save_format)


def load_params(executor, dirname, main_program=None, filename=None):
    main_program = main_program or framework.default_main_program()
    load_vars(executor, dirname, main_program,
              vars=main_program.all_parameters(), filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      save_format='native'):
    """Save every persistable variable (the reference's and the JAX
    package's plain route).  The executor's step, which seeds the
    dropout masks, is not saved: a fresh executor resumes drawing the
    masks of step 0 on."""
    main_program = main_program or framework.default_main_program()
    save_vars(executor, dirname, main_program,
              vars=_persistable_vars(main_program), filename=filename,
              save_format=save_format)


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
        # binary __model__ written by reference fluid: parse the
        # ProgramDesc protobuf and its feed/fetch scaffolding
        return _load_reference_inference_model(
            dirname, executor, model_filename, params_filename)
    with open(json_path) as f:
        model = json.load(f)
    program = Program.from_dict(model['program'])
    load_persistables(executor, dirname, program, filename=params_filename)
    fetch_vars = [program.global_block().var(n)
                  for n in model['fetch_names']]
    return program, model['feed_names'], fetch_vars


def _load_reference_inference_model(dirname, executor, model_filename,
                                    params_filename):
    """save_inference_model's layout as reference fluid writes it: the
    binary ProgramDesc in `__model__`, the parameters as per-var
    LoDTensor files (or one combined `params_filename`)."""
    with open(os.path.join(dirname, model_filename), 'rb') as f:
        program = paddle_format.parse_program_desc(f.read())
    program, feed_names, fetch_names = \
        paddle_format.strip_feed_fetch(program)
    _load_vars_paddle_format(
        dirname, _persistable_vars(program), params_filename,
        executor.device if executor is not None else None)
    fetch_vars = [program.global_block().var(n) for n in fetch_names]
    return program, feed_names, fetch_vars


def save_train_model(dirname, main_program, startup_program, feed_names,
                     fetch_vars):
    """Serialize a full training job (main + startup programs) so it can
    be driven without Python authoring (reference:
    paddle/fluid/train/demo/demo_trainer.cc)."""
    os.makedirs(dirname, exist_ok=True)
    _atomic_json_dump(os.path.join(dirname, 'main.json'),
                      main_program.to_dict())
    _atomic_json_dump(os.path.join(dirname, 'startup.json'),
                      startup_program.to_dict())
    spec = {
        'feed_names': list(feed_names),
        'fetch_names': [v.name if isinstance(v, framework.Variable) else v
                        for v in fetch_vars],
    }
    _atomic_json_dump(os.path.join(dirname, 'train_spec.json'), spec)


def load_train_model(dirname):
    """Counterpart of save_train_model; returns
    (main_program, startup_program, feed_names, fetch_names)."""
    with open(os.path.join(dirname, 'main.json')) as f:
        main = Program.from_dict(json.load(f))
    with open(os.path.join(dirname, 'startup.json')) as f:
        startup = Program.from_dict(json.load(f))
    with open(os.path.join(dirname, 'train_spec.json')) as f:
        spec = json.load(f)
    return main, startup, spec['feed_names'], spec['fetch_names']


def get_program_parameter(program):
    return program.all_parameters()


def save(program, model_path):
    """New-style single-file save (reference io.py:1492)."""
    save_persistables(None, os.path.dirname(model_path) or '.', program,
                      filename=os.path.basename(model_path))


def load(program, model_path, executor=None):
    load_persistables(executor, os.path.dirname(model_path) or '.',
                      program, filename=os.path.basename(model_path))


# reference parity: fluid.io.DataLoader (python/paddle/fluid/reader.py
# re-exported through fluid.io in v1.6)
from .reader import DataLoader, PyReader  # noqa: E402,F401
