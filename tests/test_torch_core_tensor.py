"""The tensor op types of the core slice (the JAX package's
ops/tensor_ops.py beyond the port's first ones) on the CPU against the
JAX package (torch_attention_cases.check: forward, and the gradient of
each floating input by torch.autograd against jax.vjp).

Tolerances: bitwise (tol 0) for the copies, views, index and integer
ops (flatten, strided_slice, tiling, unstack, gather_nd, scatter's
overwrite, embedding, pad, pad2d, where, where_index, diag, tril_triu,
flip, reverse, roll, index_select, share_data, split_byref,
coalesce_tensor, integer cumsum); their gradients and float cumsum,
scatter's add and minus within rtol TOL = 1e-5 plus 1e-5 of the largest
magnitude.  The draws (truncated_gaussian_random,
uniform_random_batch_size_like, shuffle_batch) come from the port's
counter hash, not jax threefry: they are held by their distribution
(moments and a chi-square over bins, each at > 5 sigma of its sampling
error) beside the JAX package's draws of the same op, and by their
replay on the same step.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import registry as treg

from torch_attention_cases import check
from torch_image_cases import run_jax, run_torch

TOL = 1e-5


def _x(shape=(3, 4, 5), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype('float32')


def test_flatten_ops_bitwise():
    x = _x((2, 3, 4, 5))
    for op in ('flatten2', 'flatten'):
        for axis in (0, 1, 3):
            check(op, {'X': [x]}, {'axis': axis}, 0)
    check('flatten_contiguous_range', {'X': [x]},
          {'start_axis': 1, 'stop_axis': 2}, 0)
    check('flatten_contiguous_range', {'X': [x]},
          {'start_axis': 0, 'stop_axis': -1}, 0)


def test_strided_slice_bitwise():
    x = _x((6, 7, 5))
    for attrs in ({'axes': [0, 1], 'starts': [1, 0], 'ends': [5, 7],
                   'strides': [2, 3]},
                  {'axes': [1], 'starts': [-1], 'ends': [-8],
                   'strides': [-2]},
                  {'axes': [0, 2], 'starts': [5, 4], 'ends': [0, 1],
                   'strides': [-1, -3]}):
        check('strided_slice', {'Input': [x]}, attrs, 0)


def test_tiling_and_unstack_bitwise():
    x = _x((2, 1, 3))
    check('expand_as', {'X': [x], 'target_tensor': [_x((4, 3, 3))]}, {}, 0,
          grad_tol=TOL)
    check('tile', {'X': [x]}, {'repeat_times': [2, 3, 1]}, 0, grad_tol=TOL)
    for axis in (0, 2, -1):
        check('unstack', {'X': [_x()]}, {'axis': axis}, 0)


def test_gather_nd_bitwise():
    x = _x((4, 5, 3))
    idx = np.array([[[0, 1], [3, -1]], [[2, 2], [0, 1]]], 'int64')
    check('gather_nd', {'X': [x], 'Index': [idx]}, {}, 0, grad_tol=TOL)
    check('gather_nd', {'X': [x], 'Index': [np.array([[1], [3], [1]],
                                                     'int64')]}, {}, 0,
          grad_tol=TOL)


def test_scatter_overwrite_and_add():
    x = _x((6, 3))
    upd = _x((3, 3), 1)
    check('scatter', {'X': [x], 'Ids': [np.array([4, 0, 2], 'int64')],
                      'Updates': [upd]}, {'overwrite': True}, 0,
          grad_tol=TOL)
    check('scatter', {'X': [x], 'Ids': [np.array([4, 0, 4], 'int64')],
                      'Updates': [upd]}, {'overwrite': False}, TOL)


def test_embedding_bitwise():
    w = _x((10, 4))
    ids = np.array([[1, 3], [0, 9]], 'int64')
    check('embedding', {'W': [w], 'Ids': [ids]}, {'padding_idx': 3}, 0,
          grad_tol=TOL)


@pytest.mark.parametrize('attrs', [
    {'axis': 1}, {'axis': -1, 'reverse': True},
    {'axis': 0, 'exclusive': True},
    {'axis': 2, 'exclusive': True, 'reverse': True},
    {'flatten': True}])
def test_cumsum_matches_jax(attrs):
    check('cumsum', {'X': [_x()]}, attrs, TOL)
    ints = np.random.RandomState(2).randint(-5, 5, (3, 4, 5)).astype(
        'int32')
    check('cumsum', {'X': [ints]}, attrs, 0)


def test_pad_ops_bitwise():
    x = _x((2, 3, 4, 5))
    check('pad', {'X': [x]}, {'paddings': [0, 1, 2, 0, 1, 1, 0, 3],
                              'pad_value': 0.5}, 0, grad_tol=TOL)
    for fmt in ('NCHW', 'NHWC'):
        for mode in ('constant', 'reflect', 'edge'):
            check('pad2d', {'X': [x]}, {'paddings': [1, 2, 2, 1],
                                        'mode': mode, 'pad_value': -1.0,
                                        'data_format': fmt}, 0,
                  grad_tol=TOL)


def test_where_and_where_index_bitwise():
    r = np.random.RandomState(3)
    cond = r.rand(3, 4) > 0.5
    check('where', {'Condition': [cond], 'X': [_x((3, 4))],
                    'Y': [_x((3, 4), 1)]}, {}, 0, grad_tol=TOL)
    for c, cap in ((cond, 12), (cond, 3), (r.rand(2, 3, 2) > 0.7, 6),
                   (np.zeros((4,), bool), 2),
                   (r.randint(0, 2, (5,)).astype('float32'), 5)):
        check('where_index', {'Condition': [c]}, {'capacity': cap}, 0)


def test_where_index_without_capacity_raises_in_both():
    ins = {'Condition': [np.ones((2, 2), bool)]}
    for run in (run_jax, run_torch):
        with pytest.raises(NotImplementedError, match='capacity'):
            run('where_index', ins, {})


def test_diag_and_triangles_bitwise():
    check('diag', {'Diagonal': [_x((5,))]}, {}, 0, grad_tol=TOL)
    check('diag', {'Diagonal': [np.arange(4, dtype='int64')]}, {}, 0)
    for lower in (True, False):
        for d in (-1, 0, 2):
            check('tril_triu', {'X': [_x((2, 4, 5))]},
                  {'lower': lower, 'diagonal': d}, 0, grad_tol=TOL)


def test_flip_reverse_roll_bitwise():
    x = _x()
    check('flip', {'X': [x]}, {'axis': [0, 2]}, 0, grad_tol=TOL)
    check('reverse', {'X': [x]}, {'axis': [1]}, 0, grad_tol=TOL)
    check('roll', {'X': [x]}, {'shifts': [2, -1], 'axis': [0, 2]}, 0,
          grad_tol=TOL)
    check('roll', {'X': [x]}, {'shifts': [7], 'axis': []}, 0, grad_tol=TOL)


def test_index_select_and_minus():
    x = _x()
    check('index_select', {'X': [x], 'Index': [np.array([3, 0, -1, 3],
                                                        'int64')]},
          {'dim': 2}, 0, grad_tol=TOL)
    check('minus', {'X': [x], 'Y': [_x(seed=1)]}, {}, TOL)


def test_aliases_and_coalesce_bitwise():
    x = _x()
    check('share_data', {'X': [x]}, {}, 0)
    check('split_byref', {'X': [x]}, {'axis': 1, 'num': 2}, 0)
    check('split_byref', {'X': [x]}, {'axis': 2, 'sections': [1, -1, 2]}, 0)
    check('coalesce_tensor', {'Input': [x, _x((7,), 1), _x((2, 2), 2)]},
          {}, 0)


def _ctx(step, seed=0):
    return treg.LowerCtx(step=step, op_seed=seed, device='cpu',
                         random_seed=7)


def _draw(op, ins, attrs, step=1):
    return treg.get(op).run(_ctx(step), {s: [torch.as_tensor(v)
                                             for v in vs]
                                         for s, vs in ins.items()},
                            attrs)['Out'][0].numpy()


def test_truncated_gaussian_by_statistics():
    """mean + std * N(0, 1) truncated to [-2, 2]: the port's moments
    against the truncated normal's (mean 0, std 0.879586) and the JAX
    package's draws' within 5 sigma of the sampling error; a replay of
    the same step draws the same values, another step others."""
    attrs = {'shape': [400, 500], 'mean': 1.0, 'std': 0.5,
             'dtype': 'float32'}
    t = _draw('truncated_gaussian_random', {}, attrs)
    j = run_jax('truncated_gaussian_random', {}, attrs)['Out'][0]
    n = t.size
    sd = 0.5 * 0.8795857
    for v in (t, j):
        z = (v - 1.0) / 0.5
        assert z.min() >= -2.0 and z.max() <= 2.0
        assert abs(v.mean() - 1.0) < 5 * sd / np.sqrt(n)
        assert abs(v.std() - sd) < 5 * sd / np.sqrt(2 * n)
    np.testing.assert_array_equal(
        t, _draw('truncated_gaussian_random', {}, attrs))
    assert not np.array_equal(
        t, _draw('truncated_gaussian_random', {}, attrs, step=2))


def test_uniform_batch_size_like_by_statistics():
    """The batch dim taken from Input; uniform on [min, max): a
    chi-square over 20 bins below its 0.99999 quantile (52.6), for the
    port and the JAX package alike."""
    ref = np.zeros((3000, 7), 'float32')
    attrs = {'shape': [-1, 50], 'min': -2.0, 'max': 3.0,
             'input_dim_idx': 0, 'output_dim_idx': 0}
    t = _draw('uniform_random_batch_size_like', {'Input': [ref]}, attrs)
    j = run_jax('uniform_random_batch_size_like', {'Input': [ref]},
                attrs)['Out'][0]
    for v in (t, j):
        assert v.shape == (3000, 50) and v.dtype == np.float32
        assert v.min() >= -2.0 and v.max() < 3.0
        counts = np.histogram(v, bins=20, range=(-2.0, 3.0))[0]
        expect = v.size / 20
        assert ((counts - expect) ** 2 / expect).sum() < 52.6


def test_shuffle_batch_is_a_permutation():
    x = _x((64, 3))
    ctx = _ctx(3)
    outs = treg.get('shuffle_batch').run(ctx, {'X': [torch.as_tensor(x)]},
                                         {})
    idx = outs['ShuffleIdx'][0].numpy()
    assert sorted(idx.tolist()) == list(range(64))
    assert not np.array_equal(idx, np.arange(64))
    np.testing.assert_array_equal(outs['Out'][0].numpy(), x[idx])
    again = treg.get('shuffle_batch').run(_ctx(3), {'X': [torch.as_tensor(
        x)]}, {})
    np.testing.assert_array_equal(again['ShuffleIdx'][0].numpy(), idx)
