"""The tensor-array family and the helper ops the loops and decoders
reach (ops/tensor_ops.py, math_ops.py, activation_ops.py, misc_ops.py)
against the JAX package's lowerings on the CPU: write_to_array,
read_from_array (an index past the end clamped, as lax's dynamic
slicing clamps it), lod_tensor_to_array, array_to_lod_tensor,
shrink_rnn_memory, split_lod_tensor, merge_lod_tensor, select_input,
select_output, reorder_lod_tensor_by_rank, is_empty,
fill_constant_batch_size_like, elementwise_mod, elementwise_floordiv,
the logical ops, tanh and log: each op's forward and the gradient of
every floating input (torch_attention_cases.check).

Tolerance: 0 (bitwise) for the copies, selections, integer arithmetic
and comparisons; 1e-6 (rtol, with a floor of 1e-6 of the largest
magnitude) for tanh and log and their gradients (libm against XLA's
expansions).
"""

import numpy as np
import pytest

from torch_attention_cases import check


def _f(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype('float32')


def _i(v):
    return np.array([v], 'int64')


@pytest.mark.parametrize('index', [0, 3, 9])
def test_write_and_read_array(index):
    arr, x = _f(4, 2, 3), _f(2, 3, seed=1)
    check('write_to_array', {'X': [x], 'I': [_i(index)], 'Array': [arr]},
          {}, 0)
    check('read_from_array', {'X': [arr], 'I': [_i(index)]}, {}, 0)


def test_lod_tensor_to_array_and_back():
    check('lod_tensor_to_array', {'X': [_f(3, 5, 2)]}, {}, 0)
    check('array_to_lod_tensor', {'X': [_f(5, 3, 2)]}, {}, 0)


def test_shrink_rnn_memory():
    check('shrink_rnn_memory', {'X': [_f(4, 3)], 'I': [_i(2)],
                                'RankTable': [np.array([5, 2, 3, 1],
                                                       'int64')]}, {}, 0)


def test_split_and_merge_lod_tensor():
    mask = np.array([[True], [False], [True]])
    check('split_lod_tensor', {'X': [_f(3, 4)], 'Mask': [mask]}, {}, 0)
    check('merge_lod_tensor', {'InTrue': [_f(3, 4)],
                               'InFalse': [_f(3, 4, seed=1)],
                               'Mask': [mask]}, {}, 0)


@pytest.mark.parametrize('branch', [0, 1, 2])
def test_select_input_and_output(branch):
    xs = [_f(2, 3, seed=s) for s in range(3)]
    check('select_input', {'X': xs, 'Mask': [np.array([branch], 'int32')]},
          {}, 0)
    check('select_output', {'X': [xs[0]],
                            'Mask': [np.array([branch], 'int32')]},
          {'branches': 3}, 0)


def test_reorder_and_is_empty():
    check('reorder_lod_tensor_by_rank',
          {'X': [_f(4, 3)], 'RankTable': [np.array([2, 0, 3, 1], 'int64')]},
          {}, 0)
    check('is_empty', {'X': [_f(2, 0)]}, {}, 0)
    check('is_empty', {'X': [_f(2, 1)]}, {}, 0)


def test_fill_constant_batch_size_like():
    check('fill_constant_batch_size_like', {'Input': [_f(2, 7)]},
          {'shape': [0, 4, 3], 'dtype': 'float32', 'value': 1.5,
           'input_dim_idx': 1, 'output_dim_idx': 2}, 0)


def test_integer_mod_and_floordiv():
    x = np.array([[7, -7, 0, 13], [-1, 5, 20, -20]], 'int64')
    y = np.array([3, -4, 5, 6], 'int64')
    for op in ('elementwise_mod', 'elementwise_floordiv'):
        check(op, {'X': [x], 'Y': [y]}, {'axis': -1}, 0)


def test_logical_ops():
    rng = np.random.RandomState(0)
    a, b = rng.rand(3, 4) > 0.5, rng.rand(3, 4) > 0.5
    for op in ('logical_and', 'logical_or', 'logical_xor'):
        check(op, {'X': [a], 'Y': [b]}, {}, 0)
    check('logical_not', {'X': [a]}, {}, 0)


def test_tanh_and_log():
    check('tanh', {'X': [_f(3, 5)]}, {}, 1e-6)
    check('log', {'X': [np.abs(_f(3, 5)) + 0.1]}, {}, 1e-6)
