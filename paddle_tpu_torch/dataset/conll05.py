"""CoNLL-2005 SRL loader (reference python/paddle/dataset/conll05.py
API): get_dict()/get_embedding()/test() — the label-semantic-roles
book-chapter input.  Records are 9-slot tuples:
(word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, pred_ids, mark, label_ids).

Synthetic only, as the JAX package's loader: deterministic sentences
whose labels are a function of word/predicate distance, so the CRF has
learnable signal.
"""

import numpy as np


WORD_VOCAB = 1000
PRED_VOCAB = 60
LABEL_COUNT = 59
EMB_DIM = 32


def get_dict():
    """(word_dict, verb_dict, label_dict)."""
    word_dict = {'w%d' % i: i for i in range(WORD_VOCAB)}
    verb_dict = {'v%d' % i: i for i in range(PRED_VOCAB)}
    label_dict = {'l%d' % i: i for i in range(LABEL_COUNT)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    """Deterministic pretrained-style word embedding table."""
    rng = np.random.RandomState(77)
    return rng.randn(WORD_VOCAB, EMB_DIM).astype('float32') * 0.1


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        length = int(rng.randint(4, 15))
        words = rng.randint(0, WORD_VOCAB, length)
        pred_pos = int(rng.randint(0, length))
        pred = int(words[pred_pos]) % PRED_VOCAB
        ctx = []
        for off in (-2, -1, 0, 1, 2):
            p = min(max(pred_pos + off, 0), length - 1)
            ctx.append([int(words[p])] * length)
        mark = [1 if i == pred_pos else 0 for i in range(length)]
        label = [(int(w) + abs(i - pred_pos)) % LABEL_COUNT
                 for i, w in enumerate(words)]
        yield (list(map(int, words)), ctx[0], ctx[1], ctx[2], ctx[3],
               ctx[4], [pred] * length, mark, label)


def test():
    def reader():
        yield from _synthetic(200, 51)
    return reader
