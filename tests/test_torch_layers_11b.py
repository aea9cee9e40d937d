"""The layers of this slice (fluid/layers/nn.py: conv2d_transpose,
adaptive_pool2d, auc, smooth_l1, lrn, image_resize, resize_bilinear,
resize_nearest; fluid/layers/more_layers.py: instance_norm, group_norm,
temporal_shift, grid_sampler, log_loss, huber_loss, kldiv_loss,
mse_loss, rank, size, gaussian_random_batch_size_like, soft_relu,
image_resize_short) through whole programs on the CPU: each program is
built by one function in both packages (torch_program_cases.build_both)
and must serialize alike, main and startup (same_program: ops, inputs,
outputs, attrs, variables), then runs from the JAX package's startup
state on the same numpy feeds (run_both).

Tolerance (assert_runs_close): integer fetches bitwise, float fetches
within rtol TOL = 1e-5 plus 1e-5 of their largest magnitude, the
gradients (fluid.gradients) within GRAD_TOL = 1e-4; auc's statistics
bitwise.  gaussian_random_batch_size_like draws from the port's
counter hash, not jax threefry: its program is compared, and its
values by their moments.
"""

import numpy as np

from torch_program_cases import (assert_runs_close, build_both, run_both,
                                 same_program)

TOL = 1e-5
GRAD_TOL = 1e-4


def _both(build, feeds, tol=TOL, seed=3):
    progs = build_both(build, seed=seed)
    same_program(progs['jax'][0], progs['torch'][0])
    same_program(progs['jax'][1], progs['torch'][1])
    out = run_both(progs, feeds)
    assert_runs_close(out, tol)
    return progs, out


def _img(shape, seed=0, name='x'):
    return {name: np.random.RandomState(seed).randn(*shape).astype(
        'float32')}


def test_conv2d_transpose_layer_and_its_gradients():
    def build(fluid):
        L = fluid.layers
        x = L.data('x', [4, 5, 6], dtype='float32')
        x.stop_gradient = False
        a = L.conv2d_transpose(x, 6, filter_size=3, stride=2, padding=1,
                               act='relu')
        b = L.conv2d_transpose(x, 4, filter_size=[2, 3], stride=[1, 2],
                               padding=[1, 0, 0, 2], dilation=2, groups=2,
                               bias_attr=False)
        total = L.sums([L.mean(a), L.mean(b)])
        return [a, b] + fluid.gradients(total, [x])
    _both(build, [_img((2, 4, 5, 6)), _img((2, 4, 5, 6), 1)], GRAD_TOL)


def test_adaptive_pool2d():
    def build(fluid):
        L = fluid.layers
        x = L.data('x', [3, 7, 9], dtype='float32')
        return [L.adaptive_pool2d(x, [3, 2], 'max'),
                L.adaptive_pool2d(x, [2, 4], 'avg'),
                L.adaptive_pool2d(x, [1, 1], 'avg')]
    _both(build, [_img((2, 3, 7, 9))])


def test_auc_accumulates_its_statistics():
    def build(fluid):
        L = fluid.layers
        p = L.data('p', [2], dtype='float32')
        label = L.data('label', [1], dtype='int64')
        auc, _, stats = L.auc(p, label, num_thresholds=63)
        auc2, _, stats2 = L.auc(p, label)
        return [auc] + stats + [auc2] + stats2
    rng = np.random.RandomState(5)
    feeds = []
    for _ in range(3):
        q = rng.rand(32).astype('float32')
        feeds.append({'p': np.stack([1 - q, q], 1),
                      'label': (rng.rand(32, 1) < q[:, None]).astype(
                          'int64')})
    _, out = _both(build, feeds)
    for run in ('jax', 'torch'):
        stats = out[run][-1]
        assert stats[1].sum() + stats[2].sum() == 96
    for k in range(3):
        for i in (1, 2, 4, 5):
            np.testing.assert_array_equal(out['torch'][k][i],
                                          out['jax'][k][i])


def test_loss_layers_and_their_gradients():
    def build(fluid):
        L = fluid.layers
        x = L.data('x', [5], dtype='float32')
        y = L.data('y', [5], dtype='float32')
        x.stop_gradient = False
        p = L.sigmoid(x)
        lab = L.cast(L.greater_than(y, L.fill_constant([1], 'float32', 0.)),
                     'float32')
        outs = [L.smooth_l1(x, y, sigma=2.0), L.log_loss(p, lab),
                L.huber_loss(x, y, 0.5), L.mse_loss(x, y),
                L.kldiv_loss(L.log(p), L.softmax(y)),
                L.kldiv_loss(x, L.abs(y), reduction='batchmean')]
        total = L.sums([L.mean(o) for o in outs])
        return outs + fluid.gradients(total, [x])
    feeds = [dict(_img((4, 5)), **_img((4, 5), 1, 'y')) for _ in range(1)]
    _both(build, feeds, GRAD_TOL)


def test_lrn_and_resize_layers():
    def build(fluid):
        L = fluid.layers
        x = L.data('x', [6, 6, 10], dtype='float32')
        return [L.lrn(x), L.lrn(x, n=3, k=2.0, alpha=1e-2, beta=0.5),
                L.image_resize(x, out_shape=[12, 15]),
                L.resize_bilinear(x, out_shape=[4, 7]),
                L.resize_nearest(x, scale=1.5),
                L.resize_nearest(x, out_shape=[5, 3]),
                L.image_resize_short(x, 9),
                L.image_resize_short(x, 4, resample='NEAREST')]
    _both(build, [_img((2, 6, 6, 10))])


def test_instance_and_group_norm_layers():
    def build(fluid):
        L = fluid.layers
        x = L.data('x', [6, 4, 5], dtype='float32')
        x.stop_gradient = False
        a = L.instance_norm(x)
        b = L.group_norm(x, groups=3, act='relu')
        c = L.group_norm(x, groups=2, bias_attr=False)
        total = L.sums([L.reduce_sum(L.square(v)) for v in (a, b, c)])
        return [a, b, c] + fluid.gradients(total, [x])
    feed = _img((2, 6, 4, 5))
    feed['x'] = feed['x'] * 3.0 + 1.0
    _both(build, [feed], GRAD_TOL)


def test_temporal_shift_and_grid_sampler_layers():
    def build(fluid):
        L = fluid.layers
        x = L.data('x', [8, 5, 6], dtype='float32')
        g = L.data('g', [3, 4, 2], dtype='float32')
        return [L.temporal_shift(x, seg_num=2, shift_ratio=0.25),
                L.grid_sampler(x, g)]
    feed = _img((4, 8, 5, 6))
    feed['g'] = np.random.RandomState(2).uniform(-1.1, 1.1, (4, 3, 4, 2))\
        .astype('float32')
    _both(build, [feed])


def test_rank_size_and_soft_relu_layers():
    def build(fluid):
        L = fluid.layers
        x = L.data('x', [3, 7], dtype='float32')
        return [L.rank(x), L.size(x), L.soft_relu(x),
                L.soft_relu(x, threshold=2.0)]
    feed = _img((5, 3, 7))
    feed['x'] *= 20.0
    _, out = _both(build, [feed])
    assert int(out['torch'][0][0]) == 3
    assert int(np.asarray(out['torch'][0][1]).reshape(-1)[0]) == 105


def test_gaussian_random_batch_size_like_layer():
    """The same program; the draws have the layer's shape and dtype, mean
    and std within 6 sigma of their sampling error, and the next step
    draws anew."""
    def build(fluid):
        L = fluid.layers
        x = L.data('x', [3], dtype='float32')
        return [L.gaussian_random_batch_size_like(x, [-1, 400], mean=1.0,
                                                  std=2.0)]
    progs = build_both(build)
    same_program(progs['jax'][0], progs['torch'][0])
    feed = _img((600, 3))
    out = run_both(progs, [feed, feed])
    for run in ('jax', 'torch'):
        a, b = (np.asarray(r[0]) for r in out[run])
        assert a.shape == (600, 400) and a.dtype == np.float32
        n = a.size
        assert abs(a.mean() - 1.0) < 6 * 2.0 / np.sqrt(n), run
        assert abs(a.std() - 2.0) < 6 * 2.0 / np.sqrt(2 * n), run
        assert not np.array_equal(a, b), run
