"""The op lowerings that the learning-rate schedules, gradient clipping,
the regularizers and the Wide&Deep model add to the port, against the
JAX package's lowerings of the same ops: the same numpy inputs and
attrs go through both registries, forward and, where the op is
differentiable, through the synthesized grad op (<type>_grad: the
registry's torch.autograd over the forward lowering against the JAX
package's jax.vjp) with the same cotangent.

Tolerance rtol = atol = 1e-6 (f32 on both sides; transcendental
functions and sums in another order differ by an ulp or two); bitwise
where the op compares, casts, copies or counts.  Inputs keep away from
the points where a function has no derivative (a relu at 0, a min at a
tie), so both packages differentiate the same branch.
"""

import numpy as np
import pytest

from paddle_tpu.ops import registry as jreg

import torch

from paddle_tpu_torch.ops import registry as treg

from torch_op_cases import run_jax, run_torch

TOL = dict(rtol=1e-6, atol=1e-6)
_R = np.random.RandomState(4)


def _f(*shape, lo=None):
    x = _R.randn(*shape).astype('float32')
    return x if lo is None else (np.abs(x) + lo).astype('float32')


def _check(op, ins, attrs, bitwise=False, grad=True):
    """Forward, then (grad=True) the grad op with a random cotangent on
    every float output."""
    want = run_jax(op, ins, attrs)
    got = run_torch(op, ins, attrs)
    assert got.keys() == want.keys(), op
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            assert g.shape == w.shape, (op, slot, g.shape, w.shape)
            if bitwise:
                np.testing.assert_array_equal(g, w, err_msg=op)
            else:
                np.testing.assert_allclose(g, w, err_msg=op, **TOL)
    if not grad:
        return
    gins = dict(ins)
    for slot, vals in want.items():
        gins['GRAD::' + slot] = [
            np.asarray(np.random.RandomState(9).randn(*np.shape(v)),
                       'float32') for v in vals]
    want = run_jax(op + '_grad', gins, attrs)
    got = run_torch(op + '_grad', gins, attrs)
    assert got.keys() == want.keys(), op
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            assert g.shape == w.shape, (op, slot)
            np.testing.assert_allclose(g, w, err_msg='%s %s' % (op, slot),
                                       **TOL)


# the min/max operands differ everywhere (no ties)
_Y_FAR = (_f(2, 3, 4) + 3.0).astype('float32')


@pytest.mark.parametrize('op', ['elementwise_sub', 'elementwise_mul',
                                'elementwise_div', 'elementwise_min',
                                'elementwise_max'])
def test_elementwise_binary_ops_and_grads_match_jax(op):
    x = _f(2, 3, 4)
    y_div = _f(2, 3, 4, lo=0.5)
    for ins, attrs in (
            ({'X': [x], 'Y': [y_div if op == 'elementwise_div' else _Y_FAR]},
             {'axis': -1}),
            ({'X': [x], 'Y': [_f(3, lo=0.5)]}, {'axis': 1}),
            ({'X': [x], 'Y': [_f(1, lo=0.5)]}, {'axis': -1})):
        _check(op, ins, attrs)


def test_compare_ops_match_jax_bitwise():
    x = np.array([[0.0, 1.0, 2.0], [3.0, -1.0, 2.0]], 'float32')
    y = np.array([[0.0, 2.0, 1.0], [3.0, 0.0, 2.5]], 'float32')
    for op in ('less_than', 'greater_equal'):
        _check(op, {'X': [x], 'Y': [y]}, {'axis': -1}, bitwise=True,
               grad=False)
        _check(op, {'X': [x], 'Y': [np.float32([1.5])]}, {'axis': -1},
               bitwise=True, grad=False)
        out = run_torch(op, {'X': [x], 'Y': [y]}, {})['Out'][0]
        assert out.dtype == np.bool_
        assert treg.get(op).no_grad_out_slots == ('Out',)


@pytest.mark.parametrize('ops', [('relu', 'sigmoid'), ('exp', 'cos'),
                                 ('sqrt', 'reciprocal')],
                         ids=['activations', 'schedules', 'positive_x'])
def test_unary_ops_and_grads_match_jax(ops):
    for op in ops:
        positive = op in ('sqrt', 'reciprocal')
        _check(op, {'X': [_f(3, 7, lo=0.25) if positive else _f(3, 7)]}, {})


def test_piecewise_constant_ops_and_pow_match_jax():
    """floor and sign (zero gradient) and pow with the schedules'
    factors."""
    x = (_f(4, 5) * 3).astype('float32')
    _check('floor', {'X': [x]}, {}, bitwise=True)
    _check('sign', {'X': [x]}, {}, bitwise=True)
    for factor in (1.0, 2.0, -0.5, 0.5):
        _check('pow', {'X': [_f(4, 5, lo=0.5)]}, {'factor': factor})


@pytest.mark.parametrize('attrs', [
    {'dim': [1], 'keep_dim': False, 'reduce_all': False},
    {'dim': [-1, 0], 'keep_dim': True, 'reduce_all': False},
    {'dim': [0], 'keep_dim': False, 'reduce_all': True},
    {'dim': [0], 'keep_dim': True, 'reduce_all': True}],
    ids=['dim1', 'dims_keep', 'all', 'all_keep'])
def test_reduce_sum_and_grad_match_jax(attrs):
    _check('reduce_sum', {'X': [_f(3, 4, 5)]}, attrs)


def test_clip_ops_and_grads_match_jax():
    x = _f(5, 6)
    x[np.abs(np.abs(x) - 0.5) < 1e-3] = 0.25  # no element at a bound
    _check('clip', {'X': [x]}, {'min': -0.5, 'max': 0.5})
    for max_norm in (0.5, 100.0):  # clipped, and left as it is
        _check('clip_by_norm', {'X': [x]}, {'max_norm': max_norm})


def test_squared_l2_norm_and_grad_match_jax():
    got = run_torch('squared_l2_norm', {'X': [_f(7, 9)]}, {})['Out'][0]
    assert got.shape == (1,)
    _check('squared_l2_norm', {'X': [_f(7, 9)]}, {})


@pytest.mark.parametrize('case', ['cast', 'concat', 'fill_any_like',
                                  'increment'])
def test_tensor_ops_and_grads_match_jax(case):
    if case == 'cast':
        labels = _R.randint(0, 2, (6, 1)).astype('int32')
        _check('cast', {'X': [labels]}, {'out_dtype': 'float32'},
               bitwise=True, grad=False)
        _check('cast', {'X': [_f(3, 4) * 5]}, {'out_dtype': 'int32'},
               bitwise=True, grad=False)
        _check('cast', {'X': [_f(3, 4)]}, {'out_dtype': 'float32'},
               bitwise=True)
    elif case == 'concat':
        for axis in (0, 1, -1):
            xs = [_f(2, 3), _f(2, 3), _f(2, 3)]
            _check('concat', {'X': xs}, {'axis': axis}, bitwise=True)
        _check('concat', {'X': [_f(4, 2), _f(4, 5)]}, {'axis': 1},
               bitwise=True)
    elif case == 'fill_any_like':
        _check('fill_any_like', {'X': [_f(3, 2)]}, {'value': 1.0},
               bitwise=True)
    else:
        counter = np.float32([4.0])
        _check('increment', {'X': [counter]}, {'step': 1.0}, bitwise=True)
        got = run_torch('increment', {'X': [counter]}, {})['Out'][0]
        assert got.tolist() == [5.0]


@pytest.mark.parametrize('attrs', [{'ignore_index': -100, 'normalize': False},
                                   {'ignore_index': -1, 'normalize': True}])
def test_sigmoid_cross_entropy_with_logits_and_grad_match_jax(attrs):
    x = (_f(8, 1) * 4).astype('float32')
    label = _R.randint(0, 2, (8, 1)).astype('float32')
    label[:2] = -1.0
    _check('sigmoid_cross_entropy_with_logits',
           {'X': [x], 'Label': [label]}, attrs)


def test_meta_shape_inference_of_the_new_ops_matches_jax():
    cases = [
        ('elementwise_mul', {'X': [((-1, 3, 4), 'float32')],
                             'Y': [((3,), 'float32')]}, {'axis': 1}),
        ('less_than', {'X': [((1,), 'float32')], 'Y': [((1,), 'float32')]},
         {}),
        ('reduce_sum', {'X': [((-1, 26, 1), 'float32')]},
         {'dim': [1], 'keep_dim': False, 'reduce_all': False}),
        ('concat', {'X': [((-1, 13), 'float32'), ((-1, 416), 'float32')]},
         {'axis': 1}),
        ('squared_l2_norm', {'X': [((30, 4), 'float32')]}, {}),
        ('cast', {'X': [((-1, 1), 'int64')]}, {'out_dtype': 'float32'}),
        ('sigmoid_cross_entropy_with_logits',
         {'X': [((-1, 1), 'float32')], 'Label': [((-1, 1), 'float32')]},
         {}),
    ]
    for op, specs, attrs in cases:
        want = jreg.infer_shapes(op, specs, attrs)
        got = treg.infer_shapes(op, specs, attrs)
        assert {s: [tuple(sh) for sh, _ in v] for s, v in got.items()} == \
            {s: [tuple(sh) for sh, _ in v] for s, v in want.items()}, op
    (_, dtype), = treg.infer_shapes('less_than', cases[1][1], {})['Out']
    assert dtype == torch.bool
