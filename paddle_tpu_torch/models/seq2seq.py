"""An LSTM encoder-decoder (seq2seq) at the widths of PaddleNLP's seq2seq
example for IWSLT'15 en->vi, the base model without attention: 2 LSTM
layers, hidden and embeddings 512, source vocabulary 17,191, target
vocabulary 7,709, dropout 0.2, beam 10, maximum length 50 (batch 128,
Adam 1e-3 and a global-norm clip of 5.0 in its training script).

Each builder takes the `fluid` module it builds with as its first
argument and uses nothing else, so the same function builds the
program in either package (the tests build it with both and compare;
chip_smoke builds it with this package's):

- ``build_train``: the source embedding, then per layer an ``fc`` to 4H
  and a masked ``dynamic_lstm``, with dropout between the layers; the
  decoder teacher-forced through a ``layers.While`` bounded by
  ``max_trip_count`` = target length + 1, whose loop state is the h and c of two
  ``LSTMCell``s and the summed masked cross-entropy of each step's
  ``fc`` to the target vocabulary.  The body reads the step's target
  embedding, label and mask with ``array_read`` of time-major tensors
  (closure reads).  The loss is the mean over the target tokens.
- ``build_beam_decode``: the encoder, then ``BeamSearchDecoder`` and
  ``dynamic_decode`` (unrolled at build time) over the same cells,
  which share the trained weights by ParamAttr name.
- ``build_while_decode``: the reference book's decode: a forward-only
  ``layers.While`` that stops when every beam has ended or the length
  reaches ``max_len``; the body runs ``layers.beam_search`` and writes
  each step's ids and parents with ``array_write``, and ``gather_tree``
  backtracks them.

The data is synthetic, made from a seed (``synthetic_batch``).
"""

import collections

import numpy as np

Seq2SeqConfig = collections.namedtuple(
    'Seq2SeqConfig', ['src_vocab', 'tgt_vocab', 'hidden', 'emb', 'layers',
                      'dropout', 'beam', 'max_len', 'bos', 'eos'])

BASE = Seq2SeqConfig(src_vocab=17191, tgt_vocab=7709, hidden=512, emb=512,
                     layers=2, dropout=0.2, beam=10, max_len=50, bos=0,
                     eos=1)
TINY = Seq2SeqConfig(src_vocab=40, tgt_vocab=30, hidden=16, emb=12,
                     layers=2, dropout=0.0, beam=3, max_len=6, bos=0, eos=1)


def zipf_ids(vocab, shape, rng):
    """Ids in [2, vocab) drawn by Zipf's law, p(id) proportional to
    1 / (id - 1), as the words of a text are: the most frequent word,
    id 2, is then some 4x as frequent as eos (once a sentence of ~37),
    so a model that learns the unigram counts does not end every beam
    at once."""
    cdf = np.cumsum(1.0 / np.arange(1, vocab - 1))
    return 2 + np.searchsorted(cdf / cdf[-1], rng.random_sample(shape),
                               side='right')


def synthetic_batch(cfg, batch, src_len, tgt_len, rng):
    """Feeds of one batch: ids from ``zipf_ids`` with lengths drawn in
    [len // 2, len], the target ending in eos, padding 0; tgt_in is the
    target shifted right behind bos."""
    s_len = rng.randint(max(src_len // 2, 1), src_len + 1, batch)
    t_len = rng.randint(max(tgt_len // 2, 1), tgt_len + 1, batch)
    src = zipf_ids(cfg.src_vocab, (batch, src_len), rng)
    src[np.arange(src_len)[None, :] >= s_len[:, None]] = 0
    tgt = zipf_ids(cfg.tgt_vocab, (batch, tgt_len), rng)
    tgt[np.arange(batch), t_len - 1] = cfg.eos
    tgt[np.arange(tgt_len)[None, :] >= t_len[:, None]] = 0
    tgt_in = np.concatenate([np.full((batch, 1), cfg.bos), tgt[:, :-1]], 1)
    return {'src': src.astype('int64'), 'src_len': s_len.astype('int64'),
            'tgt_in': tgt_in.astype('int64'), 'tgt_out': tgt.astype('int64'),
            'tgt_len': t_len.astype('int64')}


def _encoder(fluid, cfg, batch, src_len, is_test):
    """The encoder's final (h, c) of each layer, [B, H] each, in the
    order h0, c0, h1, c1, ..."""
    layers = fluid.layers
    src = layers.data('src', shape=[batch, src_len], dtype='int64',
                      append_batch_size=False)
    lens = layers.data('src_len', shape=[batch], dtype='int64',
                       append_batch_size=False)
    mask = layers.sequence_mask(lens, maxlen=src_len, dtype='float32')
    x = layers.embedding(src, size=[cfg.src_vocab, cfg.emb],
                         param_attr=fluid.ParamAttr('src_emb'))
    states = []
    for i in range(cfg.layers):
        proj = layers.fc(x, 4 * cfg.hidden, num_flatten_dims=2,
                         param_attr=fluid.ParamAttr('enc_l%d_proj' % i),
                         bias_attr=False)
        h, c = layers.dynamic_lstm(
            proj, 4 * cfg.hidden, mask=mask,
            param_attr=fluid.ParamAttr('enc_l%d_w' % i),
            bias_attr=fluid.ParamAttr('enc_l%d_b' % i))
        states += [layers.sequence_last_step(h, mask=mask),
                   layers.sequence_last_step(c, mask=mask)]
        x = h
        if cfg.dropout and i < cfg.layers - 1:
            x = layers.dropout(x, cfg.dropout, is_test=is_test,
                               dropout_implementation='upscale_in_train')
    return states


def decoder_cell(fluid, cfg):
    """The decoder's stacked LSTMCells as one RNNCell: states h0, c0, h1,
    c1, ...; the weights named dec_l<i>_w / dec_l<i>_b."""
    layers = fluid.layers
    cells = [layers.LSTMCell(cfg.hidden,
                             param_attr=fluid.ParamAttr('dec_l%d_w' % i),
                             bias_attr=fluid.ParamAttr('dec_l%d_b' % i))
             for i in range(cfg.layers)]

    class StackedLSTMCell(layers.RNNCell):
        hidden_size = cfg.hidden

        def call(self, inputs, states):
            x, new = inputs, []
            for i, cell in enumerate(cells):
                x, hc = cell.call(x, [states[2 * i], states[2 * i + 1]])
                new += hc
            return x, new

    return StackedLSTMCell()


def _tgt_embedding(fluid, cfg, ids):
    return fluid.layers.embedding(ids, size=[cfg.tgt_vocab, cfg.emb],
                                  param_attr=fluid.ParamAttr('tgt_emb'))


def _logits(fluid, cfg, x):
    return fluid.layers.fc(x, cfg.tgt_vocab,
                           param_attr=fluid.ParamAttr('out_w'),
                           bias_attr=fluid.ParamAttr('out_b'))


def build_train(fluid, cfg, batch, src_len, tgt_len):
    """The training program's loss (call inside program_guard); the
    decoder's While runs at most tgt_len + 1 trips."""
    layers = fluid.layers
    states = _encoder(fluid, cfg, batch, src_len, is_test=False)
    tgt_in = layers.data('tgt_in', shape=[batch, tgt_len], dtype='int64',
                         append_batch_size=False)
    tgt_out = layers.data('tgt_out', shape=[batch, tgt_len], dtype='int64',
                          append_batch_size=False)
    tgt_lens = layers.data('tgt_len', shape=[batch], dtype='int64',
                           append_batch_size=False)
    tmask = layers.sequence_mask(tgt_lens, maxlen=tgt_len, dtype='float32')
    # time-major [T, B, ...] tensors the loop body reads at its counter
    emb_tm = layers.transpose(_tgt_embedding(fluid, cfg, tgt_in),
                              perm=[1, 0, 2])
    label_tm = layers.transpose(layers.unsqueeze(tgt_out, axes=[2]),
                                perm=[1, 0, 2])
    mask_tm = layers.transpose(layers.unsqueeze(tmask, axes=[2]),
                               perm=[1, 0, 2])
    cell = decoder_cell(fluid, cfg)
    total = layers.fill_constant([1], 'float32', 0.0)
    i = layers.fill_constant([1], 'int64', 0)
    n = layers.fill_constant([1], 'int64', tgt_len)
    cond = layers.less_than(i, n)
    loop = layers.While(cond, max_trip_count=tgt_len + 1)
    with loop.block():
        x_t = layers.array_read(emb_tm, i)
        y_t = layers.array_read(label_tm, i)
        m_t = layers.array_read(mask_tm, i)
        out, new_states = cell.call(x_t, states)
        ce = layers.softmax_with_cross_entropy(_logits(fluid, cfg, out), y_t)
        step = layers.reduce_sum(layers.elementwise_mul(ce, m_t))
        layers.assign(layers.elementwise_add(total, step), total)
        for s, ns in zip(states, new_states):
            layers.assign(ns, s)
        layers.increment(i)
        layers.assign(layers.less_than(i, n), cond)
    return layers.elementwise_div(total, layers.reduce_sum(tmask))


def _tile_beams(fluid, x, beam):
    """[B, ...] -> [B * beam, ...], each row repeated beam times."""
    layers = fluid.layers
    e = layers.expand(layers.unsqueeze(x, axes=[1]),
                      expand_times=[1, beam] + [1] * (len(x.shape) - 1))
    return layers.reshape(e, shape=[-1] + list(x.shape[1:]))


def _first_beam_scores(batch, beam):
    """Beam 0 live, the others at -1e9: the beams then diverge from the
    first step on instead of repeating one hypothesis."""
    s = np.full((batch, beam), -1e9, 'float32')
    s[:, 0] = 0.0
    return s


def build_beam_decode(fluid, cfg, batch, src_len):
    """(ids [B * beam, max_len], scores [B * beam, 1]) of
    BeamSearchDecoder + dynamic_decode (call inside program_guard)."""
    layers = fluid.layers
    states = _encoder(fluid, cfg, batch, src_len, is_test=True)
    decoder = layers.BeamSearchDecoder(
        decoder_cell(fluid, cfg), start_token=cfg.bos, end_token=cfg.eos,
        beam_size=cfg.beam,
        embedding_fn=lambda ids: _tgt_embedding(fluid, cfg, ids),
        output_fn=lambda x: _logits(fluid, cfg, x))
    ids, (_, scores) = layers.dynamic_decode(
        decoder, inits=states, max_step_num=cfg.max_len)
    return ids, scores


def build_while_decode(fluid, cfg, batch, src_len):
    """(sequences [T, B, beam] from gather_tree, the step ids [T, B,
    beam], the parents [T, B, beam], the final scores [B, beam], the
    trips the loop ran [1]) of the book's decode loop (call inside
    program_guard), T = cfg.max_len.  Steps the loop did not reach keep eos
    ids and each beam as its own parent."""
    layers = fluid.layers
    k, t = cfg.beam, cfg.max_len
    states = [_tile_beams(fluid, s, k)
              for s in _encoder(fluid, cfg, batch, src_len, is_test=True)]
    cell = decoder_cell(fluid, cfg)
    pre_ids = layers.fill_constant([batch, k], 'int64', cfg.bos)
    pre_scores = layers.assign(_first_beam_scores(batch, k))
    ids_arr = layers.fill_constant([t, batch, k], 'int64', cfg.eos)
    parents_arr = layers.expand(
        layers.reshape(layers.range(0, k, 1, 'int64'), shape=[1, 1, k]),
        expand_times=[t, batch, 1])
    row_base = layers.assign(np.arange(batch, dtype='int64')[:, None] * k)
    eos = layers.fill_constant([1], 'int64', cfg.eos)
    n_beams = layers.fill_constant([1], 'float32', batch * k)
    i = layers.fill_constant([1], 'int64', 0)
    n = layers.fill_constant([1], 'int64', t)
    cond = layers.less_than(i, n)
    loop = layers.While(cond)
    with loop.block():
        emb = _tgt_embedding(fluid, cfg, layers.reshape(pre_ids, [-1, 1]))
        out, new_states = cell.call(emb, states)
        logp = layers.log_softmax(_logits(fluid, cfg, out))
        sel_ids, sel_scores, parents = layers.beam_search(
            pre_ids, pre_scores, layers.reshape(logp, [batch, k, -1]),
            beam_size=k, end_id=cfg.eos)
        rows = layers.reshape(layers.elementwise_add(parents, row_base),
                              [-1])
        for s, ns in zip(states, new_states):
            layers.assign(layers.gather(ns, rows), s)
        layers.array_write(sel_ids, i, array=ids_arr)
        layers.array_write(parents, i, array=parents_arr)
        layers.assign(sel_ids, pre_ids)
        layers.assign(sel_scores, pre_scores)
        layers.increment(i)
        ended = layers.reduce_sum(layers.cast(layers.equal(sel_ids, eos),
                                              'float32'))
        layers.assign(layers.logical_and(layers.less_than(i, n),
                                         layers.less_than(ended, n_beams)),
                      cond)
    return (layers.gather_tree(ids_arr, parents_arr), ids_arr, parents_arr,
            pre_scores, i)
