"""The tensor ops of the attention-chain slice against the JAX package,
on the CPU: transpose2/transpose, reshape, squeeze2/squeeze, unsqueeze,
expand, stack, gather, shape, range and one_hot/one_hot_v2, each
forward and, where it has one, its gradient (autograd against
jax.vjp), from the same numpy inputs (tests/torch_attention_cases.py).

Tolerances: bitwise wherever the JAX op is exact, which is every
forward here (copies, views, comparisons, integer ranges) and every
gradient that moves or adds at most two values (a+b is commutative);
expand's gradient sums 8 copies a position in an order of its own, so
it gets rtol 1e-5 with a floor of 1e-5 of its largest magnitude.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as tfluid

from torch_attention_cases import check, programs
from torch_image_cases import run_torch, same_block

_R = np.random.RandomState(3)


def _f(*shape):
    return _R.randn(*shape).astype('float32')


def _scalar(v, dtype):
    return np.array([v], dtype)


# (id, op, inputs, attrs, forward tolerance, gradient tolerance)
CASES = [
    ('transpose2', 'transpose2', {'X': [_f(2, 3, 4, 5)]},
     {'axis': [0, 2, 1, 3]}, 0, 0),
    ('transpose', 'transpose', {'X': [_f(2, 3, 4)]}, {'axis': [2, 0, 1]},
     0, 0),
    ('reshape', 'reshape', {'X': [_f(2, 3, 8)]}, {'shape': [0, -1]}, 0, 0),
    # axis 2 has size 3 and stays
    ('squeeze2_listed', 'squeeze2', {'X': [_f(2, 1, 3, 1)]},
     {'axes': [1, 2, -1]}, 0, 0),
    ('squeeze2_all', 'squeeze2', {'X': [_f(2, 1, 3, 1)]}, {}, 0, 0),
    ('squeeze_v1', 'squeeze', {'X': [_f(2, 1, 3, 1)]}, {'axes': [-1]}, 0,
     0),
    ('unsqueeze_v1', 'unsqueeze', {'X': [_f(2, 3)]}, {'axes': [0, 2]}, 0,
     0),
    ('expand', 'expand', {'X': [_f(2, 1, 3)]}, {'expand_times': [1, 4, 2]},
     0, 1e-5),
    ('stack', 'stack', {'X': [_f(2, 3), _f(2, 3), _f(2, 3)]}, {'axis': 1},
     0, 0),
    # a repeated row and a negative index
    ('gather_rows', 'gather',
     {'X': [_f(6, 3)], 'Index': [np.array([0, 5, 2, 2, -1], 'int64')]},
     {}, 0, 0),
    ('gather_axis1_2d_index', 'gather',
     {'X': [_f(4, 6, 3)], 'Index': [np.array([[0, 5], [2, 4]], 'int32')]},
     {'axis': 1}, 0, 0),
    ('shape', 'shape', {'Input': [_f(2, 3, 4)]}, {}, 0, 0),
    ('range_f32', 'range',
     {'Start': [_scalar(0.5, 'float32')], 'End': [_scalar(5, 'float32')],
      'Step': [_scalar(1.5, 'float32')]},
     {'__static__': [0.5, 5.0, 1.5]}, 0, 0),
    ('range_int64', 'range',
     {'Start': [_scalar(0, 'int64')], 'End': [_scalar(7, 'int64')],
      'Step': [_scalar(2, 'int64')]},
     {'__static__': [0.0, 7.0, 2.0]}, 0, 0),
    # a trailing 1 dropped; ids past either end give rows of 0
    ('one_hot_trailing_1', 'one_hot',
     {'X': [np.array([[1], [3], [0], [7], [-1]], 'int64')]}, {'depth': 5},
     0, 0),
    ('one_hot_v2_bt', 'one_hot_v2',
     {'X': [_R.randint(0, 9, (3, 4)).astype('int64')]}, {'depth': 9}, 0, 0),
]


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    _, op, ins, attrs, tol, grad_tol = case
    check(op, ins, attrs, tol, grad_tol)


def test_range_without_static_bounds_raises():
    ins = {s: [_scalar(v, 'int64')] for s, v in
           (('Start', 0), ('End', 4), ('Step', 1))}
    with pytest.raises(NotImplementedError, match='python scalars'):
        run_torch('range', ins, {})


def test_gather_past_the_end_raises():
    with pytest.raises(IndexError):
        run_torch('gather', {'X': [_f(3, 2)],
                             'Index': [np.array([3], 'int64')]}, {})


def test_layers_build_like_jax():
    """log_softmax, one_hot, label_smooth, squeeze, stack, expand,
    gather, shape and range build the JAX package's ops, attrs and
    variables, and the port runs the program."""
    def build(fluid, _):
        L = fluid.layers
        x = L.data('x', shape=[3, 5], dtype='float32')
        ids = L.data('ids', shape=[3, 1], dtype='int64')
        oh = L.one_hot(ids, depth=5)
        sm = L.label_smooth(oh, epsilon=0.2)
        ls = L.log_softmax(x, axis=1)
        sq = L.squeeze(L.unsqueeze(x, [3]), [3])
        st = L.stack([x, sq], axis=1)
        ex = L.expand(x, [1, 2, 1])
        ga = L.gather(L.reshape(x, [-1, 5]), L.range(0, 4, 2, 'int64'))
        sh = L.shape(x)
        return [sm, ls, st, ex, ga, sh]
    progs = programs(build, None, None)
    same_block(progs['jax'][0].to_dict()['blocks'][0],
               progs['torch'][0].to_dict()['blocks'][0])
    rng = np.random.RandomState(0)
    feed = {'x': rng.randn(2, 3, 5).astype('float32'),
            'ids': rng.randint(0, 5, (2, 3, 1)).astype('int64')}
    outs = []
    for key, fluid in (('jax', jfluid), ('torch', tfluid)):
        main, startup, fetch = progs[key]
        with fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            outs.append(exe.run(main, feed=feed, fetch_list=fetch))
    for j, t, tol in zip(*outs, (0, 1e-5, 0, 0, 0, 0)):
        j = np.asarray(j)
        assert t.shape == j.shape
        if tol:
            np.testing.assert_allclose(t, j, rtol=tol, atol=tol)
        else:
            np.testing.assert_array_equal(t, j.astype(t.dtype))
