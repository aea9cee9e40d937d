"""CTC (ops/lang_ops.py: warpctc, ctc_align, edit_distance) and its
layers on the CPU against the JAX package:

- warpctc against optax.ctc_loss through the JAX op: the loss within
  rtol 1e-5 with and without norm_by_times, its gradient within 1e-5
  of the largest magnitude (torch_attention_cases.check); an infeasible
  alignment (more labels than frames) costs the same large finite loss
  (log 0 is optax's log_epsilon, -1e5), within rtol 1e-5, and the
  gradient of its row within 2e-3 of the largest magnitude: the
  log-domain sums near -1e5 keep f32's 2**-7 resolution there, so exp
  and log1p differ in the last places between XLA and PyTorch; a
  second run is bitwise the first;
- ctc_align exactly, with lengths, repeats, blanks and padding_value;
- edit_distance exactly, against a plain Levenshtein too, normalized
  or not, with ignored tokens and empty sequences;
- the warpctc, ctc_greedy_decoder and edit_distance layers: the same
  program in both packages and the same fetches.
"""

import numpy as np
import pytest

from torch_attention_cases import check, close, cotangents, grads_jax, \
    grads_torch
from torch_image_cases import run_jax, run_torch
from torch_program_cases import (assert_runs_close, build_both, run_both,
                                 same_program)

TOL = 1e-5
B, T, V, L = 4, 12, 6, 4


def _ctc_ins(seed=0, logit_len=(12, 9, 7, 12), label_len=(4, 2, 3, 1)):
    r = np.random.RandomState(seed)
    return {'Logits': [r.randn(B, T, V).astype('float32')],
            'Label': [r.randint(1, V, (B, L)).astype('int64')],
            'LogitsLength': [np.array(logit_len, 'int64')],
            'LabelLength': [np.array(label_len, 'int64')]}


@pytest.mark.parametrize('norm', [False, True])
def test_warpctc_matches_optax(norm):
    ins = _ctc_ins()
    ins['Label'][0][0, :2] = 3          # a repeated label needs a blank
    check('warpctc', ins, {'blank': 0, 'norm_by_times': norm}, TOL, TOL)


def test_warpctc_blank_not_zero():
    ins = _ctc_ins(1)
    ins['Label'][0][ins['Label'][0] == V - 1] = 1
    check('warpctc', ins, {'blank': V - 1}, TOL, TOL)


def test_warpctc_infeasible_alignment_is_finite_like_optax():
    # row 2: 4 labels with a repeat need 5 frames, it has 3
    ins = _ctc_ins(2, logit_len=(12, 9, 3, 12), label_len=(4, 2, 4, 1))
    ins['Label'][0][2] = [1, 1, 2, 3]
    want = run_jax('warpctc', ins, {})['Loss'][0]
    got = run_torch('warpctc', ins, {})['Loss'][0]
    assert np.isfinite(got).all() and got[2, 0] > 9e4
    close(got, want, TOL, 'Loss')
    np.testing.assert_array_equal(run_torch('warpctc', ins, {})['Loss'][0],
                                  got)
    cts = cotangents('warpctc', {'Loss': [want]}, 0)
    gj = grads_jax('warpctc', ins, {}, cts)['GRAD::Logits'][0]
    gt = grads_torch('warpctc', ins, {}, cts)['GRAD::Logits'][0]
    feasible = [0, 1, 3]
    close(gt[feasible], gj[feasible], TOL, 'feasible rows')
    close(gt[2], gj[2], 2e-3, 'infeasible row')


def test_ctc_align_exact():
    x = np.array([[0, 1, 1, 0, 2, 2, 0, 3],
                  [3, 3, 3, 0, 0, 1, 1, 1],
                  [1, 0, 1, 0, 1, 0, 1, 0],
                  [0, 0, 0, 0, 0, 0, 0, 0]], 'int64')
    for attrs in ({'blank': 0}, {'blank': 0, 'padding_value': -1},
                  {'blank': 1, 'padding_value': 9}):
        for lengths in (None, np.array([8, 5, 7, 0], 'int64')):
            ins = {'Input': [x]}
            if lengths is not None:
                ins['InputLength'] = [lengths]
            want, got = run_jax('ctc_align', ins, attrs), \
                run_torch('ctc_align', ins, attrs)
            for s in want:
                np.testing.assert_array_equal(
                    got[s][0], want[s][0].reshape(got[s][0].shape))


def _levenshtein(a, b):
    d = np.arange(len(b) + 1, dtype=float)
    for i in range(1, len(a) + 1):
        prev, d[0] = d.copy(), i
        for j in range(1, len(b) + 1):
            d[j] = min(prev[j - 1] + (a[i - 1] != b[j - 1]), prev[j] + 1,
                       d[j - 1] + 1)
    return d[len(b)]


@pytest.mark.parametrize('attrs', [{}, {'normalized': True},
                                   {'ignored_tokens': [0, 2]},
                                   {'normalized': True,
                                    'ignored_tokens': [1]}])
def test_edit_distance_exact(attrs):
    r = np.random.RandomState(3)
    hyp = r.randint(0, 4, (5, 9)).astype('int64')
    ref = r.randint(0, 4, (5, 6)).astype('int64')
    ins = {'Hyps': [hyp], 'Refs': [ref],
           'HypsLength': [np.array([9, 4, 0, 7, 1], 'int64')],
           'RefsLength': [np.array([6, 6, 3, 0, 1], 'int64')]}
    want, got = run_jax('edit_distance', ins, attrs), \
        run_torch('edit_distance', ins, attrs)
    np.testing.assert_array_equal(got['Out'][0], want['Out'][0])
    np.testing.assert_array_equal(got['SequenceNum'][0],
                                  want['SequenceNum'][0])
    if attrs:
        return
    for b in range(5):
        h = hyp[b, :ins['HypsLength'][0][b]]
        f = ref[b, :ins['RefsLength'][0][b]]
        assert got['Out'][0][b, 0] == _levenshtein(h, f)


def test_edit_distance_without_lengths():
    r = np.random.RandomState(4)
    ins = {'Hyps': [r.randint(0, 3, (3, 7))],
           'Refs': [r.randint(0, 3, (3, 11))]}
    want, got = run_jax('edit_distance', ins, {}), \
        run_torch('edit_distance', ins, {})
    np.testing.assert_array_equal(got['Out'][0], want['Out'][0])


def _ctc_layers(fluid):
    layers = fluid.layers
    x = layers.data('x', shape=[B, T, 8], dtype='float32',
                    append_batch_size=False)
    x.stop_gradient = False
    label = layers.data('label', shape=[B, L], dtype='int64',
                        append_batch_size=False)
    x_len = layers.data('x_len', shape=[B], dtype='int64',
                        append_batch_size=False)
    label_len = layers.data('label_len', shape=[B], dtype='int64',
                            append_batch_size=False)
    logits = layers.fc(x, size=V, num_flatten_dims=2)
    loss = layers.mean(layers.warpctc(logits, label, blank=0,
                                      norm_by_times=True,
                                      input_length=x_len,
                                      label_length=label_len))
    fluid.backward.append_backward(loss)
    decoded, dec_len = layers.ctc_greedy_decoder(logits, blank=0,
                                                 input_length=x_len)
    dist, seq_num = layers.edit_distance(decoded, label, normalized=False,
                                         input_length=dec_len,
                                         label_length=label_len)
    grad = fluid.default_main_program()._grad_name_map['x']
    return [loss, grad, decoded, dec_len, dist, seq_num]


def test_ctc_layers_program_matches_jax():
    progs = build_both(_ctc_layers)
    same_program(progs['jax'][0], progs['torch'][0])
    ins = _ctc_ins(5)
    r = np.random.RandomState(6)
    feed = {'x': r.randn(B, T, 8).astype('float32'),
            'label': ins['Label'][0], 'x_len': ins['LogitsLength'][0],
            'label_len': ins['LabelLength'][0]}
    out = run_both(progs, [feed])
    assert_runs_close(out, TOL)
