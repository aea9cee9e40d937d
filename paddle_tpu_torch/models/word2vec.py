"""word2vec CBOW, built with the port's fluid layers into the same
Program the JAX package builds (models/word2vec.py).

Reference model: python/paddle/fluid/tests/book/test_word2vec.py (the
N-gram context words' embeddings from one shared table, concatenated,
a sigmoid hidden layer and a softmax over the vocabulary).
"""

from .. import fluid

EMB_SIZE = 32
N_GRAM = 4


def build(vocab_size=2000, emb_size=EMB_SIZE):
    """(feeds {'word_0' .. 'word_3', 'target'}, prediction [N, vocab],
    mean cross-entropy loss) of [N, 1] int64 context words and target;
    the four lookups share the table 'shared_w'."""
    layers = fluid.layers
    words = [layers.data('word_%d' % i, shape=[1], dtype='int64')
             for i in range(N_GRAM)]
    target = layers.data('target', shape=[1], dtype='int64')
    embs = []
    for w in words:
        e = layers.embedding(w, size=[vocab_size, emb_size],
                             param_attr=fluid.ParamAttr(name='shared_w'))
        embs.append(layers.reshape(e, [0, emb_size]))
    concat = layers.concat(embs, axis=1)
    hidden = layers.fc(concat, size=256, act='sigmoid')
    pred = layers.fc(hidden, size=vocab_size, act='softmax')
    loss = layers.mean(layers.cross_entropy(pred, target))
    feeds = {w.name: w for w in words}
    feeds['target'] = target
    return feeds, pred, loss


def synthetic_batch(vocab_size, batch, rng):
    """A batch of `batch` contexts drawn from `rng` (a numpy
    RandomState), the target a function of the context so the task is
    learnable."""
    ctx = rng.randint(0, vocab_size, (batch, N_GRAM)).astype('int64')
    target = ((ctx.sum(1) + 1) % vocab_size).astype('int64')[:, None]
    out = {'word_%d' % i: ctx[:, i:i + 1] for i in range(N_GRAM)}
    out['target'] = target
    return out
