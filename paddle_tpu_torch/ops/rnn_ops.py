"""Recurrent op lowerings: LSTM / GRU as a loop over time steps.

Reference kernels: operators/lstm_op.*, gru_op.*, cudnn_lstm_op.cu,
operators/math/sequence2batch.h (LoD batch reordering) and the fused
operators/fused/attention_lstm_op.cc.  As in the JAX package
(ops/rnn_ops.py, a lax.scan each), sequences are padded [B, T, D] with
a mask [B, T], and a row whose sequence has ended keeps its state; the
time loop is a Python loop of PyTorch ops, one step after another, and
autograd differentiates through it.  Gate order follows the reference:
input, forget, cell (candidate), output for the LSTM ops; update,
reset, candidate for the GRU ops.  No cuDNN RNN: each step is the
products and elementwise ops of the JAX package's step.
"""

import torch

from .math_ops import _product
from .registry import register


def _freeze(m, new, old):
    """new where the step is inside the sequence (m = 1), else old."""
    return m * new + (1 - m) * old


def _step_mask(mask, t, like):
    return None if mask is None else mask[:, t][:, None].to(like.dtype)


def _lstm_cell(gates, cp):
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f) * cp + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _state(ins, slot, b, h, like):
    if ins.get(slot):
        return ins[slot][0]
    return torch.zeros((b, h), dtype=like.dtype, device=like.device)


def _time_order(t, reverse):
    return range(t - 1, -1, -1) if reverse else range(t)


@register('lstm', no_grad_out_slots=('LastH', 'LastC'))
def lstm(ctx, ins, attrs):
    """Input [B,T,4H] (x @ W + b, projected before), Weight [H,4H] (the
    recurrence), optional H0/C0 [B,H], optional Mask [B,T].  Outputs
    Hidden [B,T,H], Cell [B,T,H], LastH, LastC."""
    x = ins['Input'][0]
    w = ins['Weight'][0]
    b, t, h4 = x.shape
    h = h4 // 4
    mask = ins['Mask'][0] if ins.get('Mask') else None
    hp, cp = _state(ins, 'H0', b, h, x), _state(ins, 'C0', b, h, x)
    if x.device.type == 'meta':
        # shape inference (registry.infer_shapes), where a dynamic time
        # axis is a sentinel far too long to step through
        seq = torch.empty((b, t, h), dtype=x.dtype, device='meta')
        return {'Hidden': [seq], 'Cell': [seq], 'LastH': [hp],
                'LastC': [cp]}
    hs, cs = [None] * t, [None] * t
    for k in _time_order(t, attrs.get('is_reverse', False)):
        hh, c = _lstm_cell(x[:, k] + _product(hp, w), cp)
        m = _step_mask(mask, k, hh)
        if m is not None:
            hh, c = _freeze(m, hh, hp), _freeze(m, c, cp)
        hs[k], cs[k] = hp, cp = hh, c
    return {'Hidden': [torch.stack(hs, dim=1)],
            'Cell': [torch.stack(cs, dim=1)], 'LastH': [hp], 'LastC': [cp]}


@register('gru', no_grad_out_slots=('LastH',))
def gru(ctx, ins, attrs):
    """Input [B,T,3H] (projected before), Weight [H,3H], optional H0,
    Mask.  Gate order: update (z), reset (r), candidate (reference
    operators/gru_op.h)."""
    x = ins['Input'][0]
    w = ins['Weight'][0]
    b, t, h3 = x.shape
    h = h3 // 3
    mask = ins['Mask'][0] if ins.get('Mask') else None
    hp = _state(ins, 'H0', b, h, x)
    w_zr, w_c = w[:, :2 * h], w[:, 2 * h:]
    hs = [None] * t
    for k in _time_order(t, attrs.get('is_reverse', False)):
        xt = x[:, k]
        zr = torch.sigmoid(xt[:, :2 * h] + _product(hp, w_zr))
        z, r = torch.chunk(zr, 2, dim=-1)
        c = torch.tanh(xt[:, 2 * h:] + _product(r * hp, w_c))
        hh = (1 - z) * hp + z * c
        m = _step_mask(mask, k, hh)
        if m is not None:
            hh = _freeze(m, hh, hp)
        hs[k] = hp = hh
    return {'Hidden': [torch.stack(hs, dim=1)], 'LastH': [hp]}


@register('gru_unit', no_grad_out_slots=('Gate', 'ResetHiddenPrev'))
def gru_unit(ctx, ins, attrs):
    """One GRU step (reference operators/gru_unit_op.h).  Input [B,3H]
    (x @ Wx, projected before), HiddenPrev [B,H], Weight [H,3H] (the
    update and reset gates' columns, then the candidate's)."""
    x = ins['Input'][0]
    hp = ins['HiddenPrev'][0]
    w = ins['Weight'][0]
    h = hp.shape[-1]
    if ins.get('Bias'):
        x = x + ins['Bias'][0].reshape(1, -1)
    zr = torch.sigmoid(x[:, :2 * h] + _product(hp, w[:, :2 * h]))
    z, r = zr[:, :h], zr[:, h:]
    rhp = r * hp
    c = torch.tanh(x[:, 2 * h:] + _product(rhp, w[:, 2 * h:]))
    return {'Hidden': [(1 - z) * hp + z * c],
            'Gate': [torch.cat([zr, c], dim=-1)], 'ResetHiddenPrev': [rhp]}


@register('lstm_unit')
def lstm_unit(ctx, ins, attrs):
    """One LSTM step (reference operators/lstm_unit_op.h): X [B,4H] in
    gate order i|f|o|g, C_prev [B,H], the forget_bias attr."""
    x = ins['X'][0]
    cp = ins['C_prev'][0]
    h = cp.shape[-1]
    i = torch.sigmoid(x[:, :h])
    f = torch.sigmoid(x[:, h:2 * h] + attrs.get('forget_bias', 0.0))
    o = torch.sigmoid(x[:, 2 * h:3 * h])
    g = torch.tanh(x[:, 3 * h:])
    c = f * cp + i * g
    return {'C': [c], 'H': [o * torch.tanh(c)]}


@register('lstmp', no_grad_out_slots=('LastH', 'LastC'))
def lstmp(ctx, ins, attrs):
    """LSTM with a recurrent projection (reference operators/lstmp_op.h):
    Input [B,T,4H] projected before, Weight [P,4H] (the recurrence over
    the projected state), ProjWeight [H,P].  Outputs Projection
    [B,T,P], Cell [B,T,H]."""
    x = ins['Input'][0]
    w = ins['Weight'][0]
    wp = ins['ProjWeight'][0]
    b, t, h4 = x.shape
    h = h4 // 4
    mask = ins['Mask'][0] if ins.get('Mask') else None
    rp = torch.zeros((b, wp.shape[1]), dtype=x.dtype, device=x.device)
    cp = _state(ins, 'C0', b, h, x)
    rs, cs = [], []
    for k in range(t):
        hh, c = _lstm_cell(x[:, k] + _product(rp, w), cp)
        r = _product(hh, wp)
        m = _step_mask(mask, k, r)
        if m is not None:
            r, c = _freeze(m, r, rp), _freeze(m, c, cp)
        rp, cp = r, c
        rs.append(r)
        cs.append(c)
    return {'Projection': [torch.stack(rs, dim=1)],
            'Cell': [torch.stack(cs, dim=1)], 'LastH': [rp], 'LastC': [cp]}


@register('cudnn_lstm', no_grad_out_slots=('LastH', 'LastC'))
def cudnn_lstm(ctx, ins, attrs):
    """Multi-layer (bi)LSTM from one flat weight blob (reference
    operators/cudnn_lstm_op.cu, which hands it to cuDNN; here the JAX
    package's layout and loop): for each (layer, direction) Wx [D,4H]
    | Wh [H,4H] | bias [4H].  Input [T,B,D] (time-major, as the
    reference), InitH/InitC [L*dirs,B,H]."""
    x = ins['Input'][0]
    w = ins['W'][0].reshape(-1)
    hidden = attrs['hidden_size']
    layers = attrs.get('num_layers', 1)
    dirs = 2 if attrs.get('is_bidirec', False) else 1
    t, b, _ = x.shape
    zeros = torch.zeros((layers * dirs, b, hidden), dtype=x.dtype,
                        device=x.device)
    h0 = ins['InitH'][0] if ins.get('InitH') else zeros
    c0 = ins['InitC'][0] if ins.get('InitC') else zeros

    def run_dir(xs, wx, wh, bias, hp, cp, rev):
        hs = [None] * t
        for k in _time_order(t, rev):
            hp, cp = _lstm_cell(_product(xs[k], wx) + _product(hp, wh) +
                                bias, cp)
            hs[k] = hp
        return torch.stack(hs), hp, cp

    off = 0
    outs = x
    last_h, last_c = [], []
    for layer in range(layers):
        din = outs.shape[-1]
        per_dir = []
        for dr in range(dirs):
            nwx, nwh = din * 4 * hidden, hidden * 4 * hidden
            wx = w[off:off + nwx].reshape(din, 4 * hidden)
            off += nwx
            wh = w[off:off + nwh].reshape(hidden, 4 * hidden)
            off += nwh
            bias = w[off:off + 4 * hidden]
            off += 4 * hidden
            idx = layer * dirs + dr
            hs, lh, lc = run_dir(outs, wx, wh, bias, h0[idx], c0[idx],
                                 rev=dr == 1)
            per_dir.append(hs)
            last_h.append(lh)
            last_c.append(lc)
        outs = torch.cat(per_dir, -1) if dirs == 2 else per_dir[0]
    return {'Out': [outs], 'LastH': [torch.stack(last_h)],
            'LastC': [torch.stack(last_c)]}


@register('attention_lstm', no_grad_out_slots=('AttentionedX',))
def attention_lstm(ctx, ins, attrs):
    """Reference operators/fused/attention_lstm_op.cc: at each step
    every timestep is scored against the previous hidden, softmaxed
    over T, and the attended context vector goes through an LSTM
    cell."""
    x = ins['X'][0]  # [B,T,M]
    c0 = ins['C0'][0]  # [B,D]
    hp = ins['H0'][0] if ins.get('H0') else torch.zeros_like(c0)
    att_w = ins['AttentionWeight'][0]  # [M+D,1]
    att_b = ins['AttentionBias'][0] if ins.get('AttentionBias') else None
    lstm_w = ins['LSTMWeight'][0]  # [M+D,4D]
    lstm_b = ins['LSTMBias'][0]  # [1,4D]
    mask = ins['Mask'][0] if ins.get('Mask') else None
    b, t, _ = x.shape
    d = c0.shape[-1]
    cp = c0
    hs, cs = [], []
    for _ in range(t):
        hexp = hp[:, None, :].expand(b, t, d)
        e = _product(torch.cat([x, hexp], -1), att_w)  # [B,T,1]
        if att_b is not None:
            e = e + att_b.reshape(1, 1, -1)
        e = e[..., 0]
        if mask is not None:
            e = torch.where(mask > 0, e, torch.full_like(e, -1e9))
        a = torch.softmax(e, dim=1)
        ctx_vec = torch.einsum('bt,btm->bm', a, x)
        gates = _product(torch.cat([ctx_vec, hp], -1), lstm_w) + \
            lstm_b.reshape(1, -1)
        hp, cp = _lstm_cell(gates, cp)
        hs.append(hp)
        cs.append(cp)
    return {'Hidden': [torch.stack(hs, dim=1)],
            'Cell': [torch.stack(cs, dim=1)], 'AttentionedX': [x]}
