"""Recurrent layers on padded+mask batches: dynamic_lstm / dynamic_gru /
dynamic_lstmp, the single-step units, the stacked lstm, the RNN cells
and the beam-search decoders.

Reference: python/paddle/fluid/layers/rnn.py and layers/nn.py
dynamic_lstm (over operators/lstm_op with LoD).  As in the JAX
package's layers/rnn.py: [B, T, D] with a mask, a time loop inside one
op (ops/rnn_ops.py), and dynamic_decode unrolled at build time.
"""
from ..layer_helper import LayerHelper


def dynamic_lstm(input, size, mask=None, h_0=None, c_0=None,
                 param_attr=None, bias_attr=None, use_peepholes=False,
                 is_reverse=False, gate_activation='sigmoid',
                 cell_activation='tanh', candidate_activation='tanh',
                 dtype='float32', name=None):
    """input: [B, T, 4*H] pre-projected (as in the reference, where the
    x->4H projection is a preceding fc).  size = 4*H."""
    helper = LayerHelper('lstm', name=name)
    hidden_size = size // 4
    w = helper.create_parameter(param_attr,
                                shape=[hidden_size, 4 * hidden_size],
                                dtype=dtype)
    bias = helper.create_parameter(bias_attr, shape=[4 * hidden_size],
                                   dtype=dtype, is_bias=True)
    from . import nn as _nn
    x = _nn.elementwise_add(input, bias, axis=2)
    inputs = {'Input': x, 'Weight': w}
    if mask is not None:
        inputs['Mask'] = mask
    if h_0 is not None:
        inputs['H0'] = h_0
    if c_0 is not None:
        inputs['C0'] = c_0
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    last_c = helper.create_variable_for_type_inference(dtype)
    helper.append_op('lstm', inputs=inputs,
                     outputs={'Hidden': hidden, 'Cell': cell,
                              'LastH': last_h, 'LastC': last_c},
                     attrs={'is_reverse': is_reverse})
    return hidden, cell


def dynamic_gru(input, size, mask=None, h_0=None, param_attr=None,
                bias_attr=None, is_reverse=False, dtype='float32',
                name=None):
    """input: [B, T, 3*H] pre-projected; size = H."""
    helper = LayerHelper('gru', name=name)
    w = helper.create_parameter(param_attr, shape=[size, 3 * size],
                                dtype=dtype)
    bias = helper.create_parameter(bias_attr, shape=[3 * size],
                                   dtype=dtype, is_bias=True)
    from . import nn as _nn
    x = _nn.elementwise_add(input, bias, axis=2)
    inputs = {'Input': x, 'Weight': w}
    if mask is not None:
        inputs['Mask'] = mask
    if h_0 is not None:
        inputs['H0'] = h_0
    hidden = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    helper.append_op('gru', inputs=inputs,
                     outputs={'Hidden': hidden, 'LastH': last_h},
                     attrs={'is_reverse': is_reverse})
    return hidden


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """Single LSTM step (reference layers/nn.py lstm_unit) — composed
    from elementwise ops for StaticRNN-style loops."""
    from . import nn as _nn
    from . import ops as _ops
    from . import tensor as _tensor
    concat = _tensor.concat([x_t, hidden_t_prev], axis=1)
    hidden_size = hidden_t_prev.shape[1]
    gates = _nn.fc(concat, size=4 * hidden_size, param_attr=param_attr,
                   bias_attr=bias_attr)
    i, f, g, o = _nn.split(gates, 4, dim=1)
    i = _ops.sigmoid(i)
    f = _ops.sigmoid(_ops.scale(f, bias=forget_bias))
    g = _ops.tanh(g)
    o = _ops.sigmoid(o)
    c = _nn.elementwise_add(_nn.elementwise_mul(f, cell_t_prev),
                            _nn.elementwise_mul(i, g))
    h = _nn.elementwise_mul(o, _ops.tanh(c))
    return h, c


def beam_search(pre_ids, pre_scores, scores, beam_size, end_id, name=None):
    """One dense beam-search step (static [B,K] beams, see
    ops/lang_ops.py beam_search).  `scores` are per-candidate log-probs
    [B,K,V]; returns (selected_ids [B,K], selected_scores [B,K],
    parent_idx [B,K])."""
    helper = LayerHelper('beam_search', name=name)
    ids = helper.create_variable_for_type_inference('int64')
    sel = helper.create_variable_for_type_inference(scores.dtype)
    parent = helper.create_variable_for_type_inference('int64')
    helper.append_op('beam_search',
                     inputs={'PreIds': pre_ids, 'PreScores': pre_scores,
                             'Scores': scores},
                     outputs={'SelectedIds': ids, 'SelectedScores': sel,
                              'ParentIdx': parent},
                     attrs={'beam_size': beam_size, 'end_id': end_id})
    for v in (ids, parent):
        v.stop_gradient = True
    return ids, sel, parent


def gather_tree(ids, parents):
    """Backtrace beam-search parents into full sequences:
    ids/parents [T,B,K] -> [T,B,K]."""
    helper = LayerHelper('gather_tree')
    out = helper.create_variable_for_type_inference('int64')
    helper.append_op('gather_tree', inputs={'Ids': ids, 'Parents': parents},
                     outputs={'Out': out})
    out.stop_gradient = True
    return out


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation='tanh', gate_activation='sigmoid',
             origin_mode=False):
    """One GRU step (reference layers/nn.py gru_unit): input is the
    pre-projected x@Wx [B, 3H], size = 3*hidden_dim."""
    helper = LayerHelper('gru_unit')
    D = size // 3
    w = helper.create_parameter(param_attr, [D, 3 * D], input.dtype)
    ins = {'Input': input, 'HiddenPrev': hidden, 'Weight': w}
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [1, 3 * D], input.dtype,
                                    is_bias=True)
        ins['Bias'] = b
    hidden_out = helper.create_variable_for_type_inference(input.dtype)
    gate = helper.create_variable_for_type_inference(input.dtype)
    reset_hp = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op('gru_unit', inputs=ins,
                     outputs={'Hidden': hidden_out, 'Gate': gate,
                              'ResetHiddenPrev': reset_hp},
                     infer_shape=False)
    hidden_out.shape = tuple(hidden.shape)          # [B, D]
    reset_hp.shape = tuple(hidden.shape)            # [B, D] (r*h_prev)
    gate.shape = (hidden.shape[0], 3 * D)
    return hidden_out, reset_hp, gate


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers=1,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """cuDNN-style fused LSTM (reference layers/nn.py lstm over
    cudnn_lstm op): input [B, T, D] -> hidden [B, T, H] (or [B, T, 2H]
    bidirectional: forward + is_reverse passes concatenated)."""
    from . import nn as _nn
    from . import tensor as _t
    helper = LayerHelper('lstm', name=name)
    b, t = input.shape[0], input.shape[1]

    if (init_h is not None or init_c is not None) and \
            (num_layers > 1 or is_bidirec):
        raise ValueError(
            'lstm: init_h/init_c are supported for num_layers=1 '
            'unidirectional (pass [B, H] states); stacked/bidirec '
            'initial states are not implemented')

    def one_direction(x, reverse, h0=None, c0=None):
        proj = _nn.fc(x, 4 * hidden_size, num_flatten_dims=2)
        w = helper.create_parameter(None, [hidden_size,
                                           4 * hidden_size],
                                    input.dtype)
        ins = {'Input': proj, 'Weight': w}
        if h0 is not None:
            ins['H0'] = h0
        if c0 is not None:
            ins['C0'] = c0
        hidden = helper.create_variable_for_type_inference(input.dtype)
        cell = helper.create_variable_for_type_inference(input.dtype)
        last_h = helper.create_variable_for_type_inference(input.dtype)
        last_c = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op('lstm',
                         inputs=ins,
                         outputs={'Hidden': hidden, 'Cell': cell,
                                  'LastH': last_h, 'LastC': last_c},
                         attrs={'is_reverse': reverse},
                         infer_shape=False)
        for v, sh in ((hidden, (b, t, hidden_size)),
                      (cell, (b, t, hidden_size)),
                      (last_h, (b, hidden_size)),
                      (last_c, (b, hidden_size))):
            v.shape = tuple(sh)
        return hidden, last_h, last_c

    x = input
    for layer in range(num_layers):
        fwd, last_h, last_c = one_direction(
            x, False, init_h if layer == 0 else None,
            init_c if layer == 0 else None)
        if is_bidirec:
            bwd, last_hb, last_cb = one_direction(x, True)
            x = _t.concat([fwd, bwd], axis=2)
            last_h = _t.concat([last_h, last_hb], axis=1)
            last_c = _t.concat([last_c, last_cb], axis=1)
        else:
            x = fwd
        # dropout BETWEEN layers only (reference cudnn semantics)
        if dropout_prob and not is_test and layer < num_layers - 1:
            x = _nn.dropout(x, dropout_prob)
    return x, last_h, last_c


def dynamic_lstmp(input, size, proj_size, param_attr=None,
                  bias_attr=None, use_peepholes=False, is_reverse=False,
                  gate_activation='sigmoid', cell_activation='tanh',
                  candidate_activation='tanh',
                  proj_activation='tanh', dtype='float32', name=None,
                  h_0=None, c_0=None, cell_clip=None, proj_clip=None):
    """Projected LSTM (reference layers/nn.py dynamic_lstmp over
    lstmp_op): input [B, T, 4H] pre-projected; hidden projected to
    proj_size between steps."""
    helper = LayerHelper('lstmp', name=name)
    H = size // 4
    w = helper.create_parameter(param_attr, [proj_size, 4 * H], dtype)
    proj_w = helper.create_parameter(None, [H, proj_size], dtype)
    ins = {'Input': input, 'Weight': w, 'ProjWeight': proj_w}
    if h_0 is not None:
        ins['H0'] = h_0
    if c_0 is not None:
        ins['C0'] = c_0
    projection = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    last_c = helper.create_variable_for_type_inference(dtype)
    helper.append_op('lstmp', inputs=ins,
                     outputs={'Projection': projection, 'Cell': cell,
                              'LastH': last_h, 'LastC': last_c},
                     attrs={'is_reverse': is_reverse},
                     infer_shape=False)
    b, t = input.shape[0], input.shape[1]
    projection.shape = (b, t, proj_size)
    cell.shape = (b, t, H)
    return projection, cell


class RNNCell(object):
    """Reference layers/rnn.py RNNCell: call(inputs, states) ->
    (outputs, new_states)."""

    def call(self, inputs, states, **kwargs):
        raise NotImplementedError

    def __call__(self, inputs, states, **kwargs):
        return self.call(inputs, states, **kwargs)

    def get_initial_states(self, batch_ref, shape=None, dtype='float32',
                           init_value=0.0, batch_dim_idx=0):
        from . import tensor as _t
        shape = list(shape or [self.hidden_size])
        return _t.fill_constant_batch_size_like(
            batch_ref, [0] + shape, dtype, init_value,
            input_dim_idx=batch_dim_idx)

    @property
    def state_shape(self):
        return [self.hidden_size]


class GRUCell(RNNCell):
    """Reference layers/rnn.py GRUCell over gru_unit."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation=None, activation=None, dtype='float32',
                 name='GRUCell'):
        self.hidden_size = hidden_size
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._dtype = dtype

    def call(self, inputs, states):
        from . import nn as _nn
        proj = _nn.fc(inputs, 3 * self.hidden_size,
                      param_attr=self._param_attr, bias_attr=False)
        new_hidden, _, _ = gru_unit(proj, states, 3 * self.hidden_size,
                                    param_attr=self._param_attr,
                                    bias_attr=self._bias_attr)
        return new_hidden, new_hidden


class LSTMCell(RNNCell):
    """Reference layers/rnn.py LSTMCell over the lstm_unit step."""

    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation=None, activation=None,
                 forget_bias=1.0, dtype='float32', name='LSTMCell'):
        self.hidden_size = hidden_size
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._forget_bias = forget_bias

    def call(self, inputs, states):
        h, c = states
        new_h, new_c = lstm_unit(inputs, h, c,
                                 forget_bias=self._forget_bias,
                                 param_attr=self._param_attr,
                                 bias_attr=self._bias_attr)
        return new_h, [new_h, new_c]

    @property
    def state_shape(self):
        return [[self.hidden_size], [self.hidden_size]]


class Decoder(object):
    """Reference layers/rnn.py Decoder contract for dynamic_decode."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError


class BeamSearchDecoder(Decoder):
    """Dense beam search (reference layers/rnn.py BeamSearchDecoder):
    static [B*K] beams; each step expands K*V candidates, keeps the
    top-K per batch (scores accumulate log-probs), and gathers cell
    states by parent beam — used through dynamic_decode."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = start_token
        self.end_token = end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def _tile_beam(self, s):
        from . import nn as _nn
        e = _nn.unsqueeze(s, axes=[1])
        e = _nn.expand(e, expand_times=[1, self.beam_size] +
                       [1] * (len(s.shape) - 1))
        return _nn.reshape(e, shape=[-1] + list(s.shape[1:]))

    def initialize(self, initial_cell_states):
        from . import tensor as _t
        import numpy as _np
        init = initial_cell_states
        states = list(init) if isinstance(init, (list, tuple)) else \
            [init]
        tiled = [self._tile_beam(s) for s in states]
        b = states[0].shape[0]
        ids = _t.fill_constant([b * self.beam_size, 1], 'int64',
                               self.start_token)
        # first step: only beam 0 live (others at -inf) so the K beams
        # diverge instead of duplicating the same argmax
        init_sc = _np.full((b, self.beam_size), -1e9, 'float32')
        init_sc[:, 0] = 0.0
        scores = _t.assign(init_sc.reshape(b * self.beam_size, 1))
        cell_states = tiled if isinstance(init, (list, tuple)) else \
            tiled[0]
        return ids, (cell_states, scores)

    def step(self, time, inputs, states):
        from . import nn as _nn
        from . import tensor as _t
        from . import ops as _ops
        from . import more_layers as _m
        ids, (cell_states, beam_scores) = inputs
        K = self.beam_size
        emb = self.embedding_fn(ids) if self.embedding_fn else ids
        emb = _nn.reshape(emb, shape=[emb.shape[0], -1]) \
            if len(emb.shape) > 2 else emb
        out, new_states = self.cell.call(emb, cell_states)
        logits = self.output_fn(out) if self.output_fn else out
        V = logits.shape[-1]
        logp = _nn.elementwise_sub(
            logits,
            _ops.log(_nn.reduce_sum(_ops.exp(logits), dim=[-1],
                                    keep_dim=True)))
        total = _nn.elementwise_add(logp, beam_scores)   # [B*K, V]
        flat = _nn.reshape(total, shape=[-1, K * V])     # [B, K*V]
        top_sc, top_idx = _nn.topk(flat, k=K)            # [B, K]
        vconst = _t.fill_constant([1], top_idx.dtype, V)
        parent_in_batch = _m.elementwise_floordiv(top_idx, vconst)
        next_ids = _m.elementwise_mod(top_idx, vconst)   # [B, K]
        # flat row index into [B*K]: b*K + parent
        b = flat.shape[0]
        import numpy as _np
        base = _t.assign((_np.arange(b, dtype='int64')[:, None] *
                          K).astype('int64'))
        rows = _nn.elementwise_add(
            _t.cast(parent_in_batch, 'int64'), base)     # [B, K]
        rows_flat = _nn.reshape(rows, shape=[-1])
        states_list = new_states if isinstance(new_states,
                                               (list, tuple)) else \
            [new_states]
        gathered = [_nn.gather(st, rows_flat) for st in states_list]
        new_cell = gathered if isinstance(new_states, (list, tuple)) \
            else gathered[0]
        next_ids_col = _nn.reshape(_t.cast(next_ids, 'int64'),
                                   shape=[-1, 1])
        new_scores = _nn.reshape(top_sc, shape=[-1, 1])
        return next_ids_col, (new_cell, new_scores), rows_flat


def dynamic_decode(decoder, inits=None, max_step_num=20,
                   output_time_major=False, **kwargs):
    """Unrolled decode loop (reference layers/rnn.py dynamic_decode):
    T = max_step_num static steps; returns stacked ids [B*K, T] plus
    final (states, scores).  Parents from each step are stacked
    alongside so beam_search_decode/gather_tree can backtrack."""
    from . import nn as _nn
    from . import tensor as _t
    ids, states = decoder.initialize(inits)
    step_ids, step_parents = [], []
    for t in range(max_step_num):
        out = decoder.step(t, (ids, states), None)
        if len(out) == 3:
            next_ids, states, parents = out
            step_parents.append(parents)
        else:
            next_ids, states = out
        step_ids.append(next_ids)
        ids = next_ids
    from . import nn as _nn
    if step_parents and hasattr(decoder, 'beam_size'):
        # backtrack: stack [T, B, K] ids + parent beam indices and
        # follow the links so returned rows ARE the hypotheses
        K = decoder.beam_size
        ids_t = _t.concat(
            [_nn.reshape(_t.cast(i, 'int64'), shape=[1, -1, K])
             for i in step_ids], axis=0)
        par_t = _t.concat(
            [_nn.reshape(
                _m_mod(_t.cast(p, 'int64'), K), shape=[1, -1, K])
             for p in step_parents], axis=0)
        traced = gather_tree(ids_t, par_t)          # [T, B, K]
        out = _nn.reshape(_nn.transpose(traced, perm=[1, 2, 0]),
                          shape=[-1, len(step_ids)])  # [B*K, T]
        return out, states
    cols = [_t.cast(i, 'int64') for i in step_ids]
    out = _t.concat(cols, axis=1)  # [B*K, T]
    return out, states


def _m_mod(x, k):
    from . import tensor as _t
    from . import more_layers as _m
    kv = _t.fill_constant([1], x.dtype, k)
    return _m.elementwise_mod(x, kv)


def beam_search_decode(ids, scores, beam_size, end_id, name=None):
    """Backtrack beams into full sequences (reference
    operators/beam_search_decode_op.cc walks the LoDTensorArray's
    parent links).  Dense rendering: per-step parent indices are what
    beam_search() already returns, so pass `ids` as the stacked
    selected ids [T, B, K] and `scores` as the stacked parent indices;
    gather_tree follows the links."""
    sentence_ids = gather_tree(ids, scores)
    return sentence_ids, scores
