"""Beam-search decoding in the port against the JAX package on the CPU:
the beam_search and gather_tree ops (ops/lang_ops.py), equal scores
picked in index order as jax.lax.top_k picks them, the decoders of
models/seq2seq.py (BeamSearchDecoder + dynamic_decode, and the book's
While loop over layers.beam_search with gather_tree) and the reference
book's machine-translation and sentiment programs of
tests/test_book_lang.py, each built with either package's `fluid` and
run from the JAX package's startup state.

Tolerance: ids, parents and every integer value bitwise; scores within
1e-5 (rtol, with a floor of 1e-5 of the largest magnitude: log-softmax
sums in another order); the book programs' training losses within 1e-4
(rel) over their steps, which carry each step's f32 differences on.
"""

import numpy as np
import pytest

from paddle_tpu_torch.models import seq2seq

from torch_attention_cases import check
from torch_image_cases import run_jax, run_torch
from torch_program_cases import (assert_runs_close, build_both, run_both,
                                 same_program)

TOL = 1e-5
CFG = seq2seq.TINY
B, S = 4, 7


def test_beam_search_freezes_finished_beams():
    rng = np.random.RandomState(0)
    b, k, v = 3, 4, 9
    pre_ids = rng.randint(2, v, (b, k)).astype('int64')
    pre_ids[0, 1] = pre_ids[2, 3] = 1  # finished beams (end_id 1)
    scores = np.log(np.random.RandomState(1).dirichlet(
        np.ones(v), (b, k))).astype('float32')
    ins = {'PreIds': [pre_ids],
           'PreScores': [rng.randn(b, k).astype('float32')],
           'Scores': [scores]}
    check('beam_search', ins, {'beam_size': k, 'end_id': 1}, TOL)
    got = run_torch('beam_search', ins, {'beam_size': k, 'end_id': 1})
    # a finished beam's only continuation is end_id at its own score
    kept = got['ParentIdx'][0] == 1
    assert (got['SelectedIds'][0][0][kept[0]] == 1).all()


def test_beam_search_ties_pick_the_lower_index():
    b, k, v = 2, 3, 5
    scores = np.zeros((b, k, v), 'float32')
    scores[0, :, 2] = -1.0  # equal candidates in every beam
    scores[1] = -0.5
    ins = {'PreIds': [np.full((b, k), 3, 'int64')],
           'PreScores': [np.zeros((b, k), 'float32')], 'Scores': [scores]}
    attrs = {'beam_size': k, 'end_id': 1}
    want, got = run_jax('beam_search', ins, attrs), \
        run_torch('beam_search', ins, attrs)
    for s in ('SelectedIds', 'ParentIdx'):
        np.testing.assert_array_equal(got[s][0], want[s][0])
    # flat indices 0, 1, 3 of row 0 (beam 0's tokens 0, 1, 3); 0, 1, 2 of
    # row 1
    np.testing.assert_array_equal(got['SelectedIds'][0], [[0, 1, 3],
                                                          [0, 1, 2]])
    np.testing.assert_array_equal(got['ParentIdx'][0], 0)


def test_gather_tree():
    rng = np.random.RandomState(2)
    t, b, k = 6, 3, 4
    check('gather_tree', {'Ids': [rng.randint(0, 20, (t, b, k)).astype(
        'int64')], 'Parents': [rng.randint(0, k, (t, b, k)).astype('int64')]},
        {}, TOL)


def _decode_feed(seed=3):
    f = seq2seq.synthetic_batch(CFG, B, S, 5, np.random.RandomState(seed))
    return {'src': f['src'], 'src_len': f['src_len']}


@pytest.mark.parametrize('decoder', ['dynamic_decode', 'while'])
def test_seq2seq_decoders(decoder):
    build = {'dynamic_decode': seq2seq.build_beam_decode,
             'while': seq2seq.build_while_decode}[decoder]
    train = build_both(lambda f: seq2seq.build_train(f, CFG, B, S, 5))
    progs = build_both(lambda f: list(build(f, CFG, B, S)))
    same_program(progs['jax'][0], progs['torch'][0])
    # the decode program reads the training program's parameters: run
    # its startup, then the decode on the same scope
    both = {k: (progs[k][0], train[k][1], progs[k][2]) for k in progs}
    out = run_both(both, [_decode_feed()])
    assert_runs_close(out, TOL)
    ids = out['torch'][0][0]
    assert ((ids >= 0) & (ids < CFG.tgt_vocab)).all()


def _book_mt(fluid):
    """tests/test_book_lang.py's machine translation: a GRU encoder, a
    teacher-forced GRU decoder and Adam (book ch. 8)."""
    src_vocab, tgt_vocab, emb_dim, hid, ts, tt = 40, 30, 16, 16, 8, 6
    layers = fluid.layers
    src = layers.data('src', shape=[ts], dtype='int64')
    tgt_in = layers.data('tgt_in', shape=[tt], dtype='int64')
    tgt_out = layers.data('tgt_out', shape=[tt], dtype='int64')
    semb = layers.embedding(src, size=[src_vocab, emb_dim],
                            param_attr=fluid.ParamAttr('semb'))
    enc = layers.dynamic_gru(layers.fc(semb, size=3 * hid,
                                       num_flatten_dims=2), size=hid)
    enc_last = layers.sequence_pool(enc, 'last')
    temb = layers.embedding(tgt_in, size=[tgt_vocab, emb_dim],
                            param_attr=fluid.ParamAttr('temb'))
    tproj = layers.fc(temb, size=3 * hid, num_flatten_dims=2,
                      param_attr=fluid.ParamAttr('tproj_w'),
                      bias_attr=fluid.ParamAttr('tproj_b'))
    dec = layers.dynamic_gru(tproj, size=hid, h_0=enc_last,
                             param_attr=fluid.ParamAttr('dgru'),
                             bias_attr=fluid.ParamAttr('dgru_b'))
    logits = layers.fc(dec, size=tgt_vocab, num_flatten_dims=2,
                       param_attr=fluid.ParamAttr('out_w'),
                       bias_attr=fluid.ParamAttr('out_b'))
    probs = layers.softmax(logits)
    loss = layers.mean(layers.cross_entropy(
        layers.reshape(probs, [-1, tgt_vocab]),
        layers.reshape(tgt_out, [-1, 1])))
    fluid.optimizer.Adam(1e-2).minimize(loss)
    return [loss]


def _book_mt_step(fluid):
    """The book's step-by-step decode program: one beam_search step over
    the shared decoder weights."""
    tgt_vocab, emb_dim, hid, beam = 30, 16, 16, 3
    layers = fluid.layers
    pre_ids = layers.data('pre_ids', shape=[beam], dtype='int64')
    pre_scores = layers.data('pre_scores', shape=[beam], dtype='float32')
    h_in = layers.data('h_in', shape=[beam, hid], dtype='float32')
    temb = layers.embedding(pre_ids, size=[tgt_vocab, emb_dim],
                            param_attr=fluid.ParamAttr('temb'))
    tproj = layers.fc(layers.reshape(temb, [-1, emb_dim]), size=3 * hid,
                      param_attr=fluid.ParamAttr('tproj_w'),
                      bias_attr=fluid.ParamAttr('tproj_b'))
    dec = layers.dynamic_gru(layers.reshape(tproj, [-1, 1, 3 * hid]),
                             size=hid, h_0=layers.reshape(h_in, [-1, hid]),
                             param_attr=fluid.ParamAttr('dgru'),
                             bias_attr=fluid.ParamAttr('dgru_b'))
    logits = layers.fc(layers.reshape(dec, [-1, hid]), size=tgt_vocab,
                       param_attr=fluid.ParamAttr('out_w'),
                       bias_attr=fluid.ParamAttr('out_b'))
    scores = layers.reshape(layers.log_softmax(logits), [-1, beam, tgt_vocab])
    ids, sel, parents = layers.beam_search(pre_ids, pre_scores, scores,
                                           beam_size=beam, end_id=1)
    tree = layers.gather_tree(layers.unsqueeze(ids, axes=[0]),
                              layers.unsqueeze(parents, axes=[0]))
    return [ids, sel, parents, tree]


def test_book_machine_translation():
    rng = np.random.RandomState(1)
    feeds = []
    for _ in range(4):
        s = rng.randint(2, 40, (8, 8)).astype('int64')
        t_full = np.zeros((8, 6), 'int64')
        t_full[:, 0] = s[:, 0] % 30
        for k in range(1, 6):
            t_full[:, k] = (t_full[:, k - 1] + 3) % 30
        feeds.append({'src': s, 'tgt_out': t_full, 'tgt_in': np.concatenate(
            [np.zeros((8, 1), 'int64'), t_full[:, :-1]], 1)})
    progs = build_both(_book_mt, seed=12)
    same_program(progs['jax'][0], progs['torch'][0])
    assert_runs_close(run_both(progs, feeds), 1e-4)
    step = build_both(_book_mt_step)
    both = {k: (step[k][0], progs[k][1], step[k][2]) for k in step}
    scores = np.full((2, 3), -1e9, 'float32')
    scores[:, 0] = 0
    out = run_both(both, [{
        'pre_ids': np.zeros((2, 3), 'int64'), 'pre_scores': scores,
        'h_in': rng.randn(2, 3, 16).astype('float32')}])
    assert_runs_close(out, TOL)


def test_book_understand_sentiment():
    """tests/test_book_lang.py's sentiment classifier (book ch. 6): a
    sequence_conv branch and a dynamic_lstm branch, max-pooled under the
    mask, trained with Adam on synthetic padded reviews."""
    seq_len, vocab = 16, 50

    def build(fluid):
        layers = fluid.layers
        words = layers.data('words', shape=[seq_len], dtype='int64')
        mask = layers.data('mask', shape=[seq_len], dtype='float32')
        label = layers.data('label', shape=[1], dtype='int64')
        emb = layers.embedding(words, size=[vocab, 32])
        conv = layers.sequence_conv(emb, num_filters=32, filter_size=3,
                                    mask=mask)
        pooled = layers.sequence_pool(conv, 'max', mask=mask)
        proj = layers.fc(emb, 4 * 32, num_flatten_dims=2)
        h, _ = layers.dynamic_lstm(proj, size=4 * 32, mask=mask)
        lpool = layers.sequence_pool(h, 'max', mask=mask)
        logits = layers.fc(layers.concat([pooled, lpool], axis=1), 2)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.Adam(2e-3).minimize(loss)
        return [loss]

    rng = np.random.RandomState(3)
    feeds = []
    for _ in range(4):
        n = rng.randint(3, seq_len + 1, 8)
        m = (np.arange(seq_len)[None, :] < n[:, None]).astype('float32')
        feeds.append({'words': (rng.randint(1, vocab, (8, seq_len)) *
                                m).astype('int64'), 'mask': m,
                      'label': rng.randint(0, 2, (8, 1)).astype('int64')})
    progs = build_both(build)
    same_program(progs['jax'][0], progs['torch'][0])
    assert_runs_close(run_both(progs, feeds), 1e-4)
