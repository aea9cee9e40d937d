"""The 7 recurrent op types (ops/rnn_ops.py: lstm, gru, gru_unit,
lstm_unit, lstmp, cudnn_lstm, attention_lstm) against the JAX package's
lowerings on the CPU: each op's forward and gradient (torch.autograd
over the port's time loop against jax.vjp over the JAX package's
lax.scan) from the same numpy inputs and seeded cotangents
(torch_attention_cases.check), with a mask, reversed, with H0 / C0;
then the recurrent layers (dynamic_lstm, dynamic_gru, dynamic_lstmp,
lstm_unit, gru_unit, the stacked and bidirectional lstm, LSTMCell and
GRUCell) in programs built with either package's `fluid`.

Tolerance: 1e-5 (rtol, with a floor of 1e-5 of the largest magnitude)
for the forward; 1e-4 for gradients, which sum the steps' products
back through time in another order; the no-grad slots (LastH, LastC,
Gate, ResetHiddenPrev, AttentionedX) take no cotangent; the layers'
programs, whose fetches are the loss, gradients and outputs, within
1e-4.
"""

import numpy as np
import pytest

from torch_attention_cases import check, close
from torch_image_cases import run_jax, run_torch
from torch_program_cases import (assert_runs_close, build_both, run_both,
                                 same_program)

TOL = 1e-5
GRAD_TOL = 1e-4
B, T, H = 3, 5, 4


def _f(*shape, seed=0, scale=0.5):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        'float32')


def _mask():
    return (np.arange(T)[None, :] < np.array([5, 2, 4])[:, None]).astype(
        'float32')


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('extras', ['plain', 'mask_h0_c0'])
def test_lstm(reverse, extras):
    ins = {'Input': [_f(B, T, 4 * H)], 'Weight': [_f(H, 4 * H, seed=1)]}
    if extras != 'plain':
        ins.update(Mask=[_mask()], H0=[_f(B, H, seed=2)],
                   C0=[_f(B, H, seed=3)])
    check('lstm', ins, {'is_reverse': reverse}, TOL, GRAD_TOL)


@pytest.mark.parametrize('reverse', [False, True])
def test_gru(reverse):
    check('gru', {'Input': [_f(B, T, 3 * H)], 'Weight': [_f(H, 3 * H, seed=1)],
                  'Mask': [_mask()], 'H0': [_f(B, H, seed=2)]},
          {'is_reverse': reverse}, TOL, GRAD_TOL)


def test_gru_unit():
    check('gru_unit', {'Input': [_f(B, 3 * H)], 'HiddenPrev': [_f(B, H, seed=1)],
                       'Weight': [_f(H, 3 * H, seed=2)],
                       'Bias': [_f(1, 3 * H, seed=3)]}, {}, TOL, GRAD_TOL)


def test_lstm_unit():
    check('lstm_unit', {'X': [_f(B, 4 * H)], 'C_prev': [_f(B, H, seed=1)]},
          {'forget_bias': 1.0}, TOL, GRAD_TOL)


def test_lstmp():
    check('lstmp', {'Input': [_f(B, T, 4 * H)], 'Weight': [_f(3, 4 * H, seed=1)],
                    'ProjWeight': [_f(H, 3, seed=2)], 'Mask': [_mask()],
                    'C0': [_f(B, H, seed=3)]}, {}, TOL, GRAD_TOL)


@pytest.mark.parametrize('layers,bidirec', [(1, False), (2, True)])
def test_cudnn_lstm(layers, bidirec):
    d = 3
    dirs = 2 if bidirec else 1
    n = 0
    din = d
    for _ in range(layers):
        n += dirs * (din * 4 * H + H * 4 * H + 4 * H)
        din = H * dirs
    check('cudnn_lstm', {'Input': [_f(T, B, d)], 'W': [_f(n, seed=1)],
                         'InitH': [_f(layers * dirs, B, H, seed=2)],
                         'InitC': [_f(layers * dirs, B, H, seed=3)]},
          {'hidden_size': H, 'num_layers': layers, 'is_bidirec': bidirec},
          TOL, GRAD_TOL)


def test_attention_lstm():
    """With AttentionBias the forward alone: the softmax over T is
    shift-invariant, so the bias's gradient is 0 in exact arithmetic and
    rounding noise (~1e-7) on either side; without it, forward and
    gradient."""
    m = 3
    ins = {'X': [_f(B, T, m)], 'C0': [_f(B, H, seed=1)],
           'H0': [_f(B, H, seed=2)],
           'AttentionWeight': [_f(m + H, 1, seed=3)],
           'LSTMWeight': [_f(m + H, 4 * H, seed=5)],
           'LSTMBias': [_f(1, 4 * H, seed=6)], 'Mask': [_mask()]}
    check('attention_lstm', ins, {}, TOL, GRAD_TOL)
    ins['AttentionBias'] = [_f(1, 1, seed=4)]
    want = run_jax('attention_lstm', ins, {})
    got = run_torch('attention_lstm', ins, {})
    for s in want:
        close(got[s][0], want[s][0], TOL, s)


def _feed(seed=7):
    rng = np.random.RandomState(seed)
    return {'x': rng.randn(B, T, 6).astype('float32'), 'mask': _mask(),
            'h0': rng.randn(B, H).astype('float32')}


def _grads_of(fluid, loss, names):
    fluid.backward.append_backward(loss)
    gmap = fluid.default_main_program()._grad_name_map
    return [loss] + [gmap[n] for n in names]


def _dynamic_layers(fluid):
    layers = fluid.layers
    x = layers.data('x', shape=[T, 6], dtype='float32')
    x.stop_gradient = False
    mask = layers.data('mask', shape=[T], dtype='float32')
    h0 = layers.data('h0', shape=[H], dtype='float32')
    h0.stop_gradient = False
    proj = layers.fc(x, 4 * H, num_flatten_dims=2)
    hid, cell = layers.dynamic_lstm(proj, 4 * H, mask=mask, h_0=h0,
                                    is_reverse=True)
    gproj = layers.fc(x, 3 * H, num_flatten_dims=2)
    ghid = layers.dynamic_gru(gproj, H, mask=mask, h_0=h0)
    pproj, pcell = layers.dynamic_lstmp(proj, 4 * H, 2)
    loss = layers.elementwise_add(
        layers.mean(layers.elementwise_mul(hid, ghid)),
        layers.elementwise_add(layers.mean(cell), layers.mean(pproj)))
    return _grads_of(fluid, loss, ['x', 'h0']) + [hid, ghid, pcell]


def _unit_layers(fluid):
    layers = fluid.layers
    x = layers.data('x', shape=[T, 6], dtype='float32')
    x.stop_gradient = False
    h0 = layers.data('h0', shape=[H], dtype='float32')
    h0.stop_gradient = False
    xt = layers.reshape(layers.slice(x, axes=[1], starts=[0], ends=[1]),
                        [-1, 6])
    h1, c1 = layers.lstm_unit(xt, h0, h0, forget_bias=0.5)
    g, _, _ = layers.gru_unit(layers.fc(xt, 3 * H), h1, 3 * H)
    lcell = layers.LSTMCell(H)
    out, (h2, c2) = lcell(xt, [g, c1])
    gcell = layers.GRUCell(H)
    gout, _ = gcell(out, h2)
    loss = layers.mean(layers.elementwise_add(gout, c2))
    return _grads_of(fluid, loss, ['x', 'h0']) + [h1, g, gout]


def _stacked_lstm(fluid, bidirec):
    layers = fluid.layers
    x = layers.data('x', shape=[T, 6], dtype='float32')
    x.stop_gradient = False
    out, last_h, last_c = layers.lstm(x, None, None, T, H, num_layers=2,
                                      is_bidirec=bidirec)
    loss = layers.mean(out)
    return _grads_of(fluid, loss, ['x']) + [out, last_h, last_c]


@pytest.mark.parametrize('build', ['dynamic', 'units', 'lstm',
                                   'lstm_bidirec'])
def test_recurrent_layers(build):
    fn = {'dynamic': _dynamic_layers, 'units': _unit_layers,
          'lstm': lambda f: _stacked_lstm(f, False),
          'lstm_bidirec': lambda f: _stacked_lstm(f, True)}[build]
    progs = build_both(fn)
    same_program(progs['jax'][0], progs['torch'][0])
    assert_runs_close(run_both(progs, [_feed()]), GRAD_TOL)
