"""The text-matching ops (ops/lang_ops.py: pyramid_hash,
filter_by_instag, var_conv_2d, tree_conv; ops/nn_ops.py: row_conv) and
the layers of the slice (im2sequence, row_conv, sum, sums,
filter_by_instag, lod_append) on the CPU against the JAX package:

- pyramid_hash bitwise: its uint32 multiply-add hash (mod 2**32) picks
  the same rows for ids up to 2**31, with a mask and pyramid layers 2
  to 4, so the summed rows are the same floats added in the same
  order; its gradient within 1e-5;
- filter_by_instag exactly, var_conv_2d (with and without the mask,
  stride 1 and 2), tree_conv (ragged edge sets with negative padding,
  siblings counted) and row_conv within 1e-5 (forward and gradients;
  torch_attention_cases.check);
- the layers build the JAX package's programs and give the same
  fetches (within 1e-5), a gradient among them.
"""

import numpy as np
import pytest

from torch_attention_cases import check
from torch_image_cases import run_jax, run_torch
from torch_program_cases import (assert_runs_close, build_both, run_both,
                                 same_program)

TOL = 1e-5


def _f(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype('float32')


@pytest.mark.parametrize('layers', [2, 3, 4])
def test_pyramid_hash_rows_bitwise(layers):
    r = np.random.RandomState(layers)
    ids = r.randint(0, 1 << 31, (3, 9)).astype('int64')
    mask = (np.arange(9)[None] < np.array([9, 5, 2])[:, None]).astype(
        'float32')
    ins = {'X': [ids], 'W': [_f(1009, 6, seed=1)], 'Mask': [mask]}
    attrs = {'pyramid_layer': layers}
    want, got = run_jax('pyramid_hash', ins, attrs), \
        run_torch('pyramid_hash', ins, attrs)
    np.testing.assert_array_equal(got['Out'][0], want['Out'][0])
    check('pyramid_hash', ins, attrs, 0, TOL)


def test_filter_by_instag_exact():
    ins = {'Ins': [_f(6, 3)], 'Ins_tag': [np.array([1, 2, 3, 2, 7, 5])],
           'Filter_tag': [np.array([2, 5])]}
    check('filter_by_instag', ins, {}, 0, TOL)


@pytest.mark.parametrize('stride,mask', [(1, False), (1, True), (2, True)])
def test_var_conv_2d(stride, mask):
    ins = {'X': [_f(2, 3, 7, 9)], 'W': [_f(4, 3 * 9, seed=1)]}
    if mask:
        ins['Mask'] = [(np.random.RandomState(2).rand(2, 1, 7, 9) < 0.7
                        ).astype('float32')]
    check('var_conv_2d', ins, {'output_channel': 4, 'input_channel': 3,
                               'stride_h': stride, 'stride_w': stride},
          TOL, TOL)


def test_tree_conv():
    edges = np.array([[[0, 1], [0, 2], [0, 3], [1, 4], [2, 5], [-1, -1]],
                      [[0, 1], [1, 2], [1, 3], [3, 4], [-1, -1], [-1, -1]]])
    check('tree_conv', {'NodesVector': [_f(2, 6, 5)], 'EdgeSet': [edges],
                        'Filter': [_f(5, 3, 4, 2, seed=1)]}, {}, TOL, TOL)


@pytest.mark.parametrize('context', [1, 3])
def test_row_conv(context):
    check('row_conv', {'X': [_f(2, 6, 4)], 'Filter': [_f(context, 4, seed=1)]},
          {}, TOL, TOL)


def _layers(fluid):
    layers = fluid.layers
    img = layers.data('img', shape=[2, 6, 6], dtype='float32')
    seq = layers.data('seq', shape=[5, 4], dtype='float32')
    tag = layers.data('tag', shape=[1], dtype='int64')
    filt = layers.data('filt', shape=[2], dtype='int64',
                       append_batch_size=False)
    seq.stop_gradient = False
    patches = layers.im2sequence(img, filter_size=[3, 3], stride=[2, 2],
                                 padding=[1, 1])
    conv = layers.row_conv(seq, future_context_size=2, act='relu')
    total = layers.sum([conv, seq])
    summed = layers.sums([total, layers.lod_append(seq, [0, 5])])
    rows, weight = layers.filter_by_instag(
        layers.reshape(summed, [-1, 20]), tag, filt)
    loss = layers.mean(rows)
    fluid.backward.append_backward(loss)
    grad = fluid.default_main_program()._grad_name_map['seq']
    return [patches, summed, rows, weight, loss, grad]


def test_layers_build_and_run_the_jax_programs():
    progs = build_both(_layers)
    same_program(progs['jax'][0], progs['torch'][0])
    feed = {'img': _f(3, 2, 6, 6), 'seq': _f(3, 5, 4, seed=1),
            'tag': np.array([[1], [4], [2]], 'int64'),
            'filt': np.array([2, 4], 'int64')}
    assert_runs_close(run_both(progs, [feed]), TOL)
