"""Semantic role labelling with a linear-chain CRF: the Fluid v1.6 book's
label_semantic_roles (python/paddle/fluid/tests/book/
test_label_semantic_roles.py), its ``db_lstm`` at the book's widths:
word and predicate embeddings of 32, a mark embedding of 5, hidden 512
(so each ``dynamic_lstm`` has 128 units), depth 8 with the direction
alternating, the CRF's transition at learning rate 1e-3 of the base
rate, sparse embeddings, batch 10, SGD on
``exponential_decay(0.01, 100000, 0.5, staircase=True)``, and the sizes
of the CoNLL-2005 dictionaries: 44,068 words, 3,162 predicates and 59
IOB labels over 29 chunk types.

Each builder takes the `fluid` module it builds with as its first
argument and uses nothing else, so the same function builds the
program in either package (the tests build it with both and compare;
chip_smoke builds it with this package's):

- ``build_train``: eight embeddings (the sentence and the five words
  around the predicate share the frozen ``emb`` table, as the book's
  pretrained one; the predicate's ``vemb``; the mark's), an ``fc`` with
  tanh on each and their ``sums``; a ``dynamic_lstm`` (relu candidate,
  sigmoid gate and cell, as the book asks; both packages' lstm op runs
  its own tanh and sigmoid), then depth - 1 times the ``sums`` of an
  ``fc`` of the last mix and of the last LSTM, and a ``dynamic_lstm``
  reversed every other layer; the feature ``sums`` to the labels;
  ``linear_chain_crf`` on the ``crfw`` transition and the SGD step;
  then ``crf_decoding`` on the same transition.
- ``build_eval``: the training program's ``clone(for_test=True)`` with
  ``chunk_eval`` (IOB, the config's chunk types) on the decoded paths.

Ragged sentences are padded by ``DataLoader.from_generator(...,
bucket_boundaries=...)``, which feeds each sequence field padded to its
bucket and ``word@MASK``; the lengths reach the CRF as the ``length``
feed (int64 [B, 1]).  The data is synthetic, made from a seed
(``synthetic_samples``); the word table starts from random weights, not
the dataset's pretrained embedding.
"""

import collections

import numpy as np

from .seq2seq import zipf_ids

SRLConfig = collections.namedtuple(
    'SRLConfig', ['word_vocab', 'pred_vocab', 'chunk_types', 'word_dim',
                  'mark_dim', 'hidden', 'depth', 'mix_hidden_lr', 'lr',
                  'decay_steps', 'decay_rate', 'batch'])

BASE = SRLConfig(word_vocab=44068, pred_vocab=3162, chunk_types=29,
                 word_dim=32, mark_dim=5, hidden=512, depth=8,
                 mix_hidden_lr=1e-3, lr=0.01, decay_steps=100000,
                 decay_rate=0.5, batch=10)
TINY = SRLConfig(word_vocab=120, pred_vocab=20, chunk_types=4, word_dim=8,
                 mark_dim=3, hidden=16, depth=2, mix_hidden_lr=1e-3, lr=0.05,
                 decay_steps=100000, decay_rate=0.5, batch=4)

# the sample fields in order, each a sequence of the sentence's length,
# then the length; the word field's mask comes from the loader
SEQUENCE_FIELDS = ('word', 'ctx_n2', 'ctx_n1', 'ctx_0', 'ctx_p1', 'ctx_p2',
                   'verb', 'mark', 'target')
MASK = 'word@MASK'
MARK_VOCAB = 2


def labels(cfg):
    """The IOB label count: B and I of each chunk type, and O."""
    return 2 * cfg.chunk_types + 1


def synthetic_samples(cfg, seed, n, max_len=100):
    """`n` samples, each a tuple of SEQUENCE_FIELDS (int64 lists of the
    sentence's length) and [length]: lengths from a log-normal with a
    mean near 25, cut to [4, max_len]; word ids by Zipf's law
    (seq2seq.zipf_ids); a predicate position, the predicate's id and
    the five words around it repeated over the sentence, and the mark
    1 within two words of the predicate.  The labels are learnable:
    each word's chunk type is a function of its id (O for a third of
    the ids), B where the type starts and I where it goes on from the
    word before."""
    rng = np.random.RandomState(seed)
    lengths = np.clip(np.round(rng.lognormal(3.1, 0.5, n)), 4,
                      max_len).astype(int)
    out = []
    for length in lengths:
        words = zipf_ids(cfg.word_vocab, (length,), rng)
        p = int(rng.randint(0, length))
        ctx = [[int(words[min(max(p + off, 0), length - 1)])] * length
               for off in (-2, -1, 0, 1, 2)]
        verb = [int(zipf_ids(cfg.pred_vocab, (), rng))] * length
        mark = [int(abs(i - p) <= 2) for i in range(length)]
        kinds = (words * 7) % (cfg.chunk_types * 3 // 2)
        target = []
        for i, k in enumerate(kinds):
            if k >= cfg.chunk_types:
                target.append(2 * cfg.chunk_types)
            else:
                target.append(2 * int(k) + int(i > 0 and kinds[i - 1] == k))
        out.append(tuple([list(map(int, words))] + ctx +
                         [verb, mark, target, [int(length)]]))
    return out


def pad_batch(samples, boundary):
    """The feeds the bucketed loader makes of `samples` padded to
    `boundary`: every sequence field and its '@MASK', and length."""
    b = len(samples)
    feed = {}
    for i, name in enumerate(SEQUENCE_FIELDS):
        rows = np.zeros((b, boundary), 'int64')
        mask = np.zeros((b, boundary), 'float32')
        for r, s in enumerate(samples):
            rows[r, :len(s[i])] = s[i]
            mask[r, :len(s[i])] = 1.0
        feed[name] = rows
        feed[name + '@MASK'] = mask
    feed['length'] = np.asarray([s[-1] for s in samples], 'int64')
    return feed


def feed_vars(fluid):
    """The data layers in sample order: the sequence fields (lod_level
    1, so the bucketed loader pads them) and length [B, 1]."""
    layers = fluid.layers
    seqs = [layers.data(name, shape=[-1], dtype='int64', lod_level=1)
            for name in SEQUENCE_FIELDS]
    return seqs + [layers.data('length', shape=[1], dtype='int64')]


def db_lstm(fluid, cfg, word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, verb,
            mark, mask):
    """The book's db_lstm: [B, T, labels] emissions."""
    layers = fluid.layers
    emb_attr = fluid.ParamAttr(name='emb', trainable=False)
    embs = [layers.embedding(x, size=[cfg.word_vocab, cfg.word_dim],
                             is_sparse=True, param_attr=emb_attr)
            for x in (word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2)]
    embs.append(layers.embedding(verb, size=[cfg.pred_vocab, cfg.word_dim],
                                 is_sparse=True, param_attr='vemb'))
    embs.append(layers.embedding(mark, size=[MARK_VOCAB, cfg.mark_dim],
                                 is_sparse=True))
    hidden_0 = layers.sums([layers.fc(e, size=cfg.hidden, act='tanh',
                                      num_flatten_dims=2) for e in embs])
    lstm_0, _ = layers.dynamic_lstm(hidden_0, size=cfg.hidden, mask=mask,
                                    candidate_activation='relu',
                                    gate_activation='sigmoid',
                                    cell_activation='sigmoid')
    mix, lstm = hidden_0, lstm_0
    for i in range(1, cfg.depth):
        mix = layers.sums([
            layers.fc(mix, size=cfg.hidden, act='tanh', num_flatten_dims=2),
            layers.fc(lstm, size=cfg.hidden, act='tanh',
                      num_flatten_dims=2)])
        lstm, _ = layers.dynamic_lstm(mix, size=cfg.hidden, mask=mask,
                                      candidate_activation='relu',
                                      gate_activation='sigmoid',
                                      cell_activation='sigmoid',
                                      is_reverse=(i % 2) == 1)
    return layers.sums([
        layers.fc(mix, size=labels(cfg), act='tanh', num_flatten_dims=2),
        layers.fc(lstm, size=labels(cfg), act='tanh', num_flatten_dims=2)])


def build_train(fluid, cfg):
    """The training program's ops in the current program: (feed vars,
    mean CRF cost, Viterbi paths [B, T])."""
    layers = fluid.layers
    feeds = feed_vars(fluid)
    word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, verb, mark, target, \
        length = feeds
    mask = layers.data(MASK, shape=[-1], dtype='float32')
    feature = db_lstm(fluid, cfg, word, ctx_n2, ctx_n1, ctx_0, ctx_p1,
                      ctx_p2, verb, mark, mask)
    cost = layers.linear_chain_crf(
        feature, target, length=length,
        param_attr=fluid.ParamAttr(name='crfw',
                                   learning_rate=cfg.mix_hidden_lr))
    loss = layers.mean(cost)
    fluid.optimizer.SGD(learning_rate=layers.exponential_decay(
        cfg.lr, cfg.decay_steps, cfg.decay_rate, staircase=True)
    ).minimize(loss)
    decode = layers.crf_decoding(feature, fluid.ParamAttr(name='crfw'),
                                 length=length)
    return feeds + [mask], loss, decode


def build_eval(fluid, cfg, main, decode):
    """main.clone(for_test=True) with chunk_eval (IOB) on the decoded
    paths: (program, [precision, recall, F1, inferred, labelled and
    correct chunks])."""
    test = main.clone(for_test=True)
    block = test.global_block()
    with fluid.program_guard(test, fluid.Program()):
        outs = fluid.layers.chunk_eval(
            block.var(decode.name), block.var('target'), 'IOB',
            cfg.chunk_types, seq_length=block.var('length'))
    return test, list(outs)
