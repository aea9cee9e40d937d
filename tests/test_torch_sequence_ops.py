"""The 17 sequence op types (ops/sequence_ops.py) against the JAX
package's lowerings on the CPU, on padded [B, T, ...] batches with a
mask: each op's forward and its gradient (torch.autograd over the
port's lowering against jax.vjp over the JAX package's) from the same
numpy inputs and seeded cotangents (torch_attention_cases.check); then
the sequence_lod layers and nets.sequence_conv_pool in programs built
with either package's `fluid`.

Tolerance: 1e-5 (rtol, with a floor of 1e-5 of the largest magnitude)
for f32 values, forward and gradient: the ops are gathers, masks and
short f32 sums or products whose order differs between XLA and
PyTorch; integer outputs (lengths, ids) bitwise.  The text
classifier's 3 SGD steps: each loss within 1e-4 (rel), after two
updates whose f32 differences the steps carry on.
"""

import numpy as np
import pytest

from torch_attention_cases import check
from torch_program_cases import (assert_runs_close, build_both, run_both,
                                 same_program)

TOL = 1e-5
LENGTHS = np.array([5, 2, 3])


def _rng(seed=0):
    return np.random.RandomState(seed)


def _mask(lengths=LENGTHS, t=5):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(
        'float32')


def _f(*shape, seed=0):
    return _rng(seed).randn(*shape).astype('float32')


def test_sequence_mask():
    check('sequence_mask', {'X': [np.array([3, 0, 6, 1], 'int64')]},
          {'maxlen': 6, 'out_dtype': 'float32'}, TOL)


@pytest.mark.parametrize('pooltype', ['SUM', 'AVERAGE', 'SQRT', 'MAX',
                                      'LAST', 'FIRST'])
def test_sequence_pool(pooltype):
    check('sequence_pool', {'X': [_f(3, 5, 4)], 'Mask': [_mask()]},
          {'pooltype': pooltype}, TOL)


def test_sequence_softmax():
    check('sequence_softmax', {'X': [_f(3, 5)], 'Mask': [_mask()]}, {}, TOL)


def test_sequence_expand():
    check('sequence_expand', {'X': [_f(3, 4)], 'Y': [_f(3, 5, 2)]}, {}, TOL)
    check('sequence_expand', {'X': [_f(3, 1, 4)], 'Y': [_f(3, 5, 2)]}, {},
          TOL)


def test_sequence_reshape():
    check('sequence_reshape', {'X': [_f(2, 6, 4)]}, {'new_dim': 8}, TOL)


def test_sequence_conv():
    check('sequence_conv', {'X': [_f(3, 5, 3)], 'Filter': [_f(9, 4, seed=1)],
                            'Mask': [_mask()]},
          {'contextLength': 3, 'contextStart': -1}, TOL)
    check('sequence_conv', {'X': [_f(3, 5, 3)], 'Filter': [_f(12, 2, seed=2)]},
          {'contextLength': 4, 'contextStart': -2}, TOL)


def test_im2sequence():
    check('im2sequence', {'X': [_f(2, 3, 6, 7)]},
          {'kernels': [2, 3], 'strides': [2, 1],
           'paddings': [1, 0, 0, 2]}, TOL)


def test_sequence_pad_and_unpad():
    check('sequence_pad', {'X': [_f(3, 5, 2)], 'Mask': [_mask()],
                           'PadValue': [np.array([-7.0], 'float32')]},
          {}, TOL)
    check('sequence_unpad', {'X': [_f(3, 5, 2)],
                             'Length': [LENGTHS.astype('int64')]}, {}, TOL)


def test_sequence_concat():
    check('sequence_concat',
          {'X': [_f(3, 4, 2), _f(3, 3, 2, seed=1)],
           'Mask': [_mask([4, 1, 2], 4), _mask([0, 3, 2], 3)]}, {}, TOL)


def test_sequence_slice():
    check('sequence_slice', {'X': [_f(3, 5, 2)],
                             'Offset': [np.array([0, 2, 1], 'int64')],
                             'Length': [np.array([3, 1, 4], 'int64')]},
          {}, TOL)


def test_sequence_erase():
    x = _rng(3).randint(0, 6, (3, 6)).astype('int64')
    check('sequence_erase', {'X': [x], 'Mask': [_mask([6, 4, 5], 6)]},
          {'tokens': [2, 5]}, TOL)


def test_sequence_enumerate():
    x = _rng(4).randint(1, 9, (3, 6)).astype('int64')
    check('sequence_enumerate', {'X': [x], 'Mask': [_mask([6, 2, 4], 6)]},
          {'win_size': 3, 'pad_value': 0}, TOL)


def test_sequence_reverse():
    check('sequence_reverse', {'X': [_f(3, 5, 2)], 'Mask': [_mask()]}, {},
          TOL)


def test_sequence_expand_as():
    check('sequence_expand_as', {'X': [_f(3, 4)], 'Y': [_f(3, 5)],
                                 'Mask': [_mask()]}, {}, TOL)


def test_sequence_scatter():
    ids = np.array([[0, 3, 3, 9], [1, 0, 7, 2]], 'int64')
    check('sequence_scatter', {'X': [_f(10, 3)], 'Ids': [ids],
                               'Updates': [_f(2, 4, 3, seed=1)],
                               'Mask': [_mask([4, 2], 4)]}, {}, TOL)


def test_lod_reset():
    check('lod_reset', {'X': [_f(3, 5, 2)],
                        'Y': [np.array([1, 5, 3], 'int64')]}, {}, TOL)
    check('lod_reset', {'X': [_f(3, 5, 2)]}, {'target_lod': [2, 2, 4]}, TOL)


def _sequence_layers(fluid):
    """Every sequence_lod layer on one padded batch, and a loss over
    the float ones."""
    layers = fluid.layers
    x = layers.data('x', shape=[5, 4], dtype='float32')
    x.stop_gradient = False
    lens = layers.data('lens', shape=[1], dtype='int64')
    ids = layers.data('ids', shape=[5], dtype='int64')
    mask = layers.sequence_mask(layers.reshape(lens, [-1]), maxlen=5,
                                dtype='float32')
    conv = layers.sequence_conv(x, 6, filter_size=3, mask=mask, act='tanh')
    pooled = [layers.sequence_pool(conv, t, mask=mask)
              for t in ('sum', 'average', 'sqrt', 'max')]
    first = layers.sequence_first_step(x, mask=mask)
    last = layers.sequence_last_step(x, mask=mask)
    soft = layers.sequence_softmax(layers.reduce_sum(x, dim=[2]), mask=mask)
    rev = layers.sequence_reverse(x, mask=mask)
    exp = layers.sequence_expand_as(last, soft, mask=mask)
    pad, length = layers.sequence_pad(
        x, layers.fill_constant([1], 'float32', 0.0), mask=mask)
    erased, _ = layers.sequence_erase(ids, [3], mask=mask)
    windows = layers.sequence_enumerate(ids, 2, mask=mask)
    feats = layers.concat(pooled + [first, last], axis=1)
    loss = layers.elementwise_add(
        layers.mean(feats), layers.mean(layers.elementwise_mul(
            layers.reduce_sum(rev, dim=[2]), soft)))
    loss = layers.elementwise_add(loss, layers.mean(exp))
    loss = layers.elementwise_add(loss, layers.mean(pad))
    fluid.backward.append_backward(loss)
    return [loss, fluid.default_main_program()._grad_name_map['x'], length,
            erased, windows]


def test_sequence_lod_layers_program():
    progs = build_both(_sequence_layers)
    same_program(progs['jax'][0], progs['torch'][0])
    rng = _rng(5)
    feed = {'x': rng.randn(3, 5, 4).astype('float32'),
            'lens': LENGTHS.reshape(3, 1).astype('int64'),
            'ids': rng.randint(1, 6, (3, 5)).astype('int64')}
    assert_runs_close(run_both(progs, [feed]), TOL)


def test_sequence_conv_pool_trains_like_jax():
    """nets.sequence_conv_pool in a small text classifier: 3 SGD steps
    in both packages from the same startup state."""
    def build(fluid):
        layers = fluid.layers
        words = layers.data('words', shape=[6], dtype='int64')
        mask = layers.data('mask', shape=[6], dtype='float32')
        label = layers.data('label', shape=[1], dtype='int64')
        emb = layers.embedding(words, size=[20, 8])
        feat = fluid.nets.sequence_conv_pool(emb, 5, 3, act='tanh',
                                             pool_type='max', mask=mask)
        loss = layers.mean(layers.softmax_with_cross_entropy(
            layers.fc(feat, 2), label))
        fluid.optimizer.SGD(0.5).minimize(loss)
        return [loss]

    rng = _rng(6)
    feeds = [{'words': rng.randint(0, 20, (4, 6)).astype('int64'),
              'mask': _mask([6, 3, 1, 5], 6)[[0, 1, 2, 3]],
              'label': rng.randint(0, 2, (4, 1)).astype('int64')}
             for _ in range(3)]
    out = run_both(build_both(build), feeds)
    assert_runs_close(out, 1e-4)
