"""The port's model formats (fluid/paddle_format.py, fluid/io.py)
against the JAX package's, on the CPU.

- LoDTensor streams: the port's writer gives the JAX writer's bytes, for
  every dtype the reference format names and with LoD levels; each
  package reads the other's file back bitwise; combined
  (save_combine) files likewise.
- ProgramDesc: bytes encoded here by a few-line protobuf writer of the
  reference's framework.proto (independent of either package's codec)
  parse, in both packages, to equal ``to_dict()`` (every attribute
  type, negative dims, feed/fetch stripped in `col` order).
- A model directory in the reference layout (that binary
  ``__model__`` beside per-variable LoDTensor files, or one combined
  params file) is served by the port's load_inference_model + Executor
  with the JAX package's answers (rtol 1e-6: f32 products summed in
  another order) and a numpy oracle's.
- save_format='paddle' writes the JAX package's files byte for byte, per
  variable and combined; save_params/load_params, fluid.io.save/load
  and save_train_model/load_train_model round trip, the last also from
  the JAX package's files; a load writes into the tensor the scope
  holds when shape and dtype match.
"""

import json
import os
import struct

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import paddle_format as jpf

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.fluid import paddle_format as tpf

DTYPES = ['float32', 'float64', 'float16', 'int64', 'int32', 'int16',
          'int8', 'uint8', 'bool']


def _array(dtype, shape=(3, 5), seed=0):
    rng = np.random.RandomState(seed)
    if dtype == 'bool':
        return rng.rand(*shape) > 0.5
    if dtype.startswith('float'):
        return rng.randn(*shape).astype(dtype)
    return rng.randint(0, 100, shape).astype(dtype)


@pytest.mark.parametrize('dtype', DTYPES)
def test_lod_tensor_bytes_are_the_jax_writers(tmp_path, dtype):
    arr = _array(dtype)
    lod = [np.array([0, 2, 3], np.uint64)] if dtype == 'float32' else ()
    tp, jp = str(tmp_path / 't'), str(tmp_path / 'j')
    with open(tp, 'wb') as f:
        tpf.write_lod_tensor(f, arr, lod)
    with open(jp, 'wb') as f:
        jpf.write_lod_tensor(f, arr, lod)
    assert open(tp, 'rb').read() == open(jp, 'rb').read()
    for reader, path in ((tpf, jp), (jpf, tp)):
        (back, back_lod), = reader.load_tensors(path)
        assert back.dtype == arr.dtype and back.tobytes() == arr.tobytes()
        assert [list(x) for x in back_lod] == [list(x) for x in lod]
    assert tpf.looks_like_lod_tensor_file(tp)


def test_combined_streams_are_the_jax_writers(tmp_path):
    records = [('a', _array('float32')), ('b', _array('int64', (7,))),
               ('c', _array('float64', (2, 2, 2)))]
    tp, jp = str(tmp_path / 't'), str(tmp_path / 'j')
    tpf.save_tensors(tp, records)
    jpf.save_tensors(jp, records)
    assert open(tp, 'rb').read() == open(jp, 'rb').read()
    got = tpf.load_tensors(jp)
    assert [a.tobytes() for a, _ in got] == \
        [a.tobytes() for _, a in records]
    with pytest.raises(EOFError):
        tpf.load_tensors(jp, count=4)
    (np.save(str(tmp_path / 'n.npy'), records[0][1]))
    assert not tpf.looks_like_lod_tensor_file(str(tmp_path / 'n.npy'))


# -- a few-line protobuf writer (proto2 wire format) --------------------

def _varint(n):
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        out.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
        n >>= 7
        if not n:
            return bytes(out)


def _f(num, value):
    """Field `num`: an int (varint), a float (fixed32), bytes/str
    (length-delimited) or a list of any of them (repeated)."""
    if isinstance(value, list):
        return b''.join(_f(num, v) for v in value)
    if isinstance(value, bool) or isinstance(value, int):
        return _varint(num << 3) + _varint(int(value))
    if isinstance(value, float):
        return _varint(num << 3 | 5) + struct.pack('<f', value)
    if isinstance(value, str):
        value = value.encode()
    return _varint(num << 3 | 2) + _varint(len(value)) + value


FP32, INT64 = 5, 3  # VarType.Type
LOD_TENSOR, FEED_MINIBATCH, FETCH_LIST = 7, 9, 10


def _var(name, dims=None, dtype=FP32, kind=LOD_TENSOR, persistable=False):
    vtype = _f(1, kind)
    if dims is not None:
        vtype += _f(3, _f(1, _f(1, dtype) + _f(2, list(dims))) + _f(2, 0))
    return _f(1, name) + _f(2, vtype) + _f(3, persistable)


def _op(type_, ins, outs, attrs=()):
    body = b''.join(_f(1, _f(1, s) + _f(2, list(a))) for s, a in ins)
    body += b''.join(_f(2, _f(1, s) + _f(2, list(a))) for s, a in outs)
    body += _f(3, type_)
    for name, atype, field, val in attrs:
        body += _f(4, _f(1, name) + _f(2, atype) + _f(field, val))
    return body


def _model_pb(w, b):
    """The inference ProgramDesc reference fluid saves for
    relu(x @ w + b): feed -> mul -> elementwise_add -> relu -> fetch."""
    vars_ = [_var('feed', kind=FEED_MINIBATCH),
             _var('fetch', kind=FETCH_LIST), _var('x', [-1, 4]),
             _var('w', w.shape, persistable=True),
             _var('b', b.shape, persistable=True),
             _var('mul_out', [-1, 2]), _var('add_out', [-1, 2]),
             _var('relu_out', [-1, 2])]
    ops = [_op('feed', [('X', ['feed'])], [('Out', ['x'])],
               [('col', 0, 3, 0)]),
           _op('mul', [('X', ['x']), ('Y', ['w'])], [('Out', ['mul_out'])],
               [('x_num_col_dims', 0, 3, 1), ('y_num_col_dims', 0, 3, 1)]),
           _op('elementwise_add', [('X', ['mul_out']), ('Y', ['b'])],
               [('Out', ['add_out'])], [('axis', 0, 3, 1)]),
           _op('relu', [('X', ['add_out'])], [('Out', ['relu_out'])]),
           _op('fetch', [('X', ['relu_out'])], [('Out', ['fetch'])],
               [('col', 0, 3, 0)])]
    block = _f(1, 0) + _f(2, 0) + b''.join(_f(3, v) for v in vars_) + \
        b''.join(_f(4, o) for o in ops)
    return _f(1, block)


def test_program_desc_parses_to_the_jax_packages_program():
    attrs = [('i', 0, 3, -7), ('f', 1, 4, 0.25), ('s', 2, 5, 'hi'),
             ('ints', 3, 6, [1, -2, 3]), ('floats', 4, 7, [0.5, -1.5]),
             ('strs', 5, 8, ['a', 'bc']), ('bool', 6, 10, True),
             ('bools', 7, 11, [True, False]), ('blk', 8, 12, 0),
             ('long', 9, 13, -(1 << 40)), ('blks', 10, 14, [0]),
             ('longs', 11, 15, [1 << 40, -3])]
    block = _f(1, 0) + _f(2, 0) + _f(3, _var('v', [-1, 3, 2], INT64)) + \
        _f(3, _var('u', [5, -1])) + \
        _f(4, _op('scale', [('X', ['v'])], [('Out', ['v'])], attrs))
    data = _f(1, block)
    tprog, jprog = tpf.parse_program_desc(data), jpf.parse_program_desc(data)
    want = jprog.to_dict()
    # the JAX package keeps int64 variables as int32 (x64 off)
    assert want['blocks'][0]['vars'][0]['dtype'] == 'int32'
    want['blocks'][0]['vars'][0]['dtype'] = 'int64'
    assert tprog.to_dict() == want
    op = tprog.global_block().ops[0]
    assert op.attrs == {'i': -7, 'f': 0.25, 's': 'hi', 'ints': [1, -2, 3],
                        'floats': [0.5, -1.5], 'strs': ['a', 'bc'],
                        'bool': True, 'bools': [True, False], 'blk': 0,
                        'long': -(1 << 40), 'blks': [0],
                        'longs': [1 << 40, -3]}
    v = tprog.global_block().var('v')
    assert (tuple(v.shape), v.dtype) == ((-1, 3, 2), 'int64')
    w, b = _array('float32', (4, 2)), _array('float32', (2,), 1)
    tp, tfeeds, tfetches = tpf.strip_feed_fetch(
        tpf.parse_program_desc(_model_pb(w, b)))
    jp, jfeeds, jfetches = jpf.strip_feed_fetch(
        jpf.parse_program_desc(_model_pb(w, b)))
    assert (tfeeds, tfetches) == (jfeeds, jfetches) == (['x'], ['relu_out'])
    assert tp.to_dict() == jp.to_dict()
    assert [o.type for o in tp.global_block().ops] == \
        ['mul', 'elementwise_add', 'relu']


@pytest.mark.parametrize('combined', [False, True])
def test_reference_model_dir_serves_the_jax_answers(tmp_path, combined):
    rng = np.random.RandomState(5)
    w = rng.randn(4, 2).astype('float32')
    b = rng.randn(2).astype('float32')
    d = str(tmp_path / 'refinf')
    os.makedirs(d)
    with open(os.path.join(d, '__model__'), 'wb') as f:
        f.write(_model_pb(w, b))
    params = None
    if combined:  # the persistables in program order: w, b
        params = '__params__'
        tpf.save_tensors(os.path.join(d, params), [('w', w), ('b', b)])
    else:
        tpf.save_tensors(os.path.join(d, 'w'), [('w', w)])
        tpf.save_tensors(os.path.join(d, 'b'), [('b', b)])
    xd = rng.randn(8, 4).astype('float32')
    answers = []
    for fluid in (jfluid, tfluid):
        with fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor(fluid.CPUPlace())
            program, feeds, fetches = fluid.io.load_inference_model(
                d, exe, params_filename=params)
            assert feeds == ['x'] and [v.name for v in fetches] == \
                ['relu_out']
            answers.append(np.asarray(exe.run(program, feed={'x': xd},
                                              fetch_list=fetches)[0]))
    np.testing.assert_allclose(answers[1], answers[0], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(answers[1], np.maximum(xd @ w + b, 0),
                               rtol=1e-5, atol=1e-6)


def _net(fluid, seed=3):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[4], dtype='float32')
        h = fluid.layers.fc(x, size=8, act='relu')
        out = fluid.layers.fc(h, size=2)
        loss = fluid.layers.mean(out)
        fluid.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, out


def _state(main):
    rng = np.random.RandomState(9)
    return {v.name: rng.randn(*[int(d) for d in v.shape]).astype(
        'float32') for v in tio._persistable_vars(main)}


def _put_state(fluid, state):
    scope = fluid.Scope()
    for n, v in state.items():
        scope.set_var(n, v if fluid is jfluid else torch.tensor(v))
    return scope


@pytest.mark.parametrize('filename', [None, '__params__'])
def test_save_format_paddle_writes_the_jax_files(tmp_path, filename):
    dirs = {}
    for fluid in (jfluid, tfluid):
        main, startup, _ = _net(fluid)
        state = _state(main)
        d = str(tmp_path / fluid.__name__)
        with fluid.scope_guard(_put_state(fluid, state)):
            fluid.io.save_persistables(fluid.Executor(fluid.CPUPlace()), d,
                                       main, filename=filename,
                                       save_format='paddle')
        dirs[fluid] = d
    names = sorted(os.listdir(dirs[tfluid]))
    assert names == sorted(os.listdir(dirs[jfluid]))
    assert len(names) == (1 if filename else len(state))
    for n in names:
        with open(os.path.join(dirs[tfluid], n), 'rb') as a, \
                open(os.path.join(dirs[jfluid], n), 'rb') as b:
            assert a.read() == b.read(), n
    # and the JAX package's files load back in the port
    main, startup, _ = _net(tfluid)
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        tfluid.io.load_persistables(tfluid.Executor(tfluid.CPUPlace()),
                                    dirs[jfluid], main, filename=filename)
    for n, v in state.items():
        assert np.array_equal(scope.find_var(n).numpy(), v), n


def test_params_save_load_and_single_file_save_load(tmp_path):
    main, startup, out = _net(tfluid)
    state = _state(main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(_put_state(tfluid, state)):
        tfluid.io.save_params(exe, str(tmp_path / 'p'), main)
        tfluid.io.save(main, str(tmp_path / 'one' / 'model'))
    assert os.listdir(str(tmp_path / 'p')) == ['__model_params__.npz']
    with np.load(str(tmp_path / 'p' / '__model_params__.npz')) as f:
        assert sorted(f.files) == sorted(
            p.name for p in main.all_parameters())
    for load in (lambda: tfluid.io.load_params(exe, str(tmp_path / 'p'),
                                               main),
                 lambda: tfluid.io.load(main, str(tmp_path / 'one' /
                                                  'model'), exe)):
        scope = tfluid.Scope()
        with tfluid.scope_guard(scope):
            load()
        for p in main.all_parameters():
            assert np.array_equal(scope.find_var(p.name).numpy(),
                                  state[p.name])
    assert tfluid.io.get_program_parameter(main) == main.all_parameters()


def test_train_model_round_trip_and_from_the_jax_files(tmp_path):
    specs = []
    for fluid in (tfluid, jfluid):
        main, startup, out = _net(fluid)
        d = str(tmp_path / fluid.__name__)
        fluid.io.save_train_model(d, main, startup, ['x'], [out])
        specs.append(d)
    for d in specs:
        main, startup, feeds, fetches = tfluid.io.load_train_model(d)
        ref, ref_start, out = _net(tfluid)
        assert main.to_dict()['blocks'][0]['vars'] == \
            ref.to_dict()['blocks'][0]['vars']
        assert [o.type for o in main.global_block().ops] == \
            [o.type for o in ref.global_block().ops]
        assert (feeds, fetches) == (['x'], [out.name])
        with open(os.path.join(d, 'train_spec.json')) as f:
            assert json.load(f)['feed_names'] == ['x']


def test_a_load_writes_into_the_scopes_tensor(tmp_path):
    main, startup, _ = _net(tfluid)
    state = _state(main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        held = {n: scope.find_var(n) for n in state}
        for fmt in ('native', 'paddle'):
            d = str(tmp_path / fmt)
            with tfluid.scope_guard(_put_state(tfluid, state)):
                tfluid.io.save_persistables(exe, d, main, save_format=fmt)
            tfluid.io.load_persistables(exe, d, main)
            for n, v in state.items():
                assert scope.find_var(n) is held[n], n
                assert np.array_equal(held[n].numpy(), v)
            for t in held.values():
                t.zero_()
        # a shape the scope does not hold takes a new tensor
        scope.set_var('fc_0.w_1', torch.zeros(3))
        tfluid.io.load_persistables(exe, d, main)
        assert tuple(scope.find_var('fc_0.w_1').shape) == (8,)
